"""The port's model and serving steps, held against the JAX package.

The same weights (``repro.models.lm.init`` carried over by
``repro_torch.convert.params_from_numpy``) and the same numpy inputs go
through both packages at a small Qwen3-shaped size (qk_norm, GQA, SiLU-GLU,
RMSNorm, untied embeddings; 2 layers, d_model 64). Tolerance: atol =
rtol = 1e-5 (fp32; matmul and softmax sums run in different orders). The
serve steps are also held at bfloat16, teacher-forced, with the gates that
test_serve_steps_match_at_bf16 states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import serve_model as jsm
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import serve_model as tsm
from repro_torch.models import lm

ATOL = RTOL = 1e-5


def small_cfgs():
    jcfg = dataclasses.replace(jget_config("qwen3-8b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                               dtype="float32")
    return jcfg, tcfg


def jax_params(jcfg, seed=0):
    params = jlm.init(jcfg, jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", ["qwen3-8b", "tiny-lm", "llama3-8b",
                                  "qwen2.5-3b", "olmo-1b", "nemotron-4-15b",
                                  "recurrentgemma-2b", "rwkv6-3b",
                                  "whisper-tiny", "internvl2-26b"])
def test_config_copies_match(name):
    """The port keeps its own copies of the configs; they must describe
    the same networks."""
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jget_config(name))
    assert dataclasses.asdict(get_config(name).reduced()) == \
        dataclasses.asdict(jget_config(name).reduced())
    assert get_config(name).param_count() == jget_config(name).param_count()


def test_convert_layout_and_param_count():
    jcfg, tcfg = small_cfgs()
    _, tree = jax_params(jcfg)
    p = params_from_numpy(tcfg, tree)
    assert len(p["layers"]) == tcfg.num_layers
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert lm.param_count(p) == n_jax
    assert set(p["layers"][0]["attn"]) == {"wq", "wk", "wv", "wo",
                                           "q_norm", "k_norm"}


def test_forward_logits_match():
    jcfg, tcfg = small_cfgs()
    params, tree = jax_params(jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    want = np.asarray(jlm.forward(jcfg, params, jnp.asarray(tokens)))
    got = lm.forward(tcfg, params_from_numpy(tcfg, tree),
                     torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_init_is_seeded_and_scaled():
    _, tcfg = small_cfgs()
    a = lm.init(tcfg, torch.Generator().manual_seed(3), "cpu")
    b = lm.init(tcfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a["layers"][1]["ffn"]["w2"], b["layers"][1]["ffn"]["w2"])
    std = float(a["layers"][0]["attn"]["wq"].std())
    assert abs(std * np.sqrt(tcfg.d_model) - 1.0) < 0.1


def _same_pools(tstate, jstate):
    """Pools and observation windows agree; the port's extra sink page and
    sink query slot (the last ones) have no JAX counterpart."""
    for key in ("k", "v"):
        np.testing.assert_allclose(tstate["pools"][key].numpy()[:, :-1],
                                   np.asarray(jstate["pools"][key]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tstate["qwin"].numpy()[:, :-1],
                               np.asarray(jstate["qwin"]), rtol=RTOL,
                               atol=ATOL)


def _install(state, tables, seq_lens, qslots, to):
    state = dict(state)
    state["block_tables"] = to(tables)
    state["seq_lens"] = to(seq_lens)
    state["qslot"] = to(qslots)
    return state


def test_serve_steps_match():
    """Paged prefill (last-token logits, pool and observation-window
    contents) and three decode steps with an inactive row, against the JAX
    package's steps with the Pallas kernels interpreted."""
    jcfg, tcfg = small_cfgs()
    params, tree = jax_params(jcfg, seed=1)
    tparams = params_from_numpy(tcfg, tree)
    jspec = jsm.ServeSpec(n_slots=3, block_size=4, max_blocks=6,
                          n_total_blocks=20, m_qslots=2, window=4,
                          prefill_rows=2, prefill_len=16, dtype="float32",
                          attn_backend="pallas-interpret")
    tspec = tsm.ServeSpec(n_slots=3, block_size=4, max_blocks=6,
                          n_total_blocks=20, m_qslots=2, window=4,
                          prefill_rows=2, prefill_len=16)
    tables = np.full((3, 6), -1, np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[2, :5] = [2, 11, 4, 5, 6]
    lengths = np.array([11, 16], np.int32)
    seq = np.array([11, 0, 16], np.int32)
    qslots = np.array([1, -1, 0], np.int32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    slots = np.array([0, 2], np.int32)
    zero = np.zeros(2, np.int32)

    jstate = _install(jsm.make_state(jcfg, jspec), tables, seq, qslots,
                      jnp.asarray)
    jl, jstate = jax.jit(jsm.build_prefill_step(jcfg, jspec))(
        params, jstate, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(lengths), jnp.asarray(zero))
    tstate = _install(tsm.make_state(tcfg, tspec, "cpu"), tables, seq,
                      qslots, torch.from_numpy)
    tl = tsm.build_prefill_step(tcfg, tspec)(
        tparams, tstate, torch.from_numpy(toks).long(),
        torch.from_numpy(slots), torch.from_numpy(lengths),
        torch.from_numpy(zero))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    _same_pools(tstate, jstate)

    jstate["positions"] = jnp.asarray(seq)
    tstate["positions"] = torch.from_numpy(seq.copy())
    active = np.array([True, False, True])
    jdecode = jax.jit(jsm.build_decode_step(jcfg, jspec))
    tdecode = tsm.build_decode_step(tcfg, tspec)
    tok = np.array([5, 9, 7], np.int32)
    for _ in range(3):
        jl, jstate = jdecode(params, jstate, jnp.asarray(tok),
                             jnp.asarray(active))
        tl = tdecode(tparams, tstate, torch.from_numpy(tok).long(),
                     torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], rtol=RTOL,
                                   atol=ATOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tstate["seq_lens"].numpy(),
                                  np.asarray(jstate["seq_lens"]))
    _same_pools(tstate, jstate)


def _f32(a):
    """A bf16 (or fp32) array or tensor as fp32 numpy, exactly."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _rel_l2(got, want):
    g, w = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


BF16_REL_L2 = 2e-2      # bf16 rounds at other places in the two frameworks
BF16_GAP = 0.25         # a greedy token is held where JAX's top-2 gap is wider


def test_serve_steps_match_at_bf16():
    """The serve steps at ``dtype="bfloat16"``, teacher-forced: a paged
    prefill, then 16 decode steps (an inactive row among them) that both
    packages take on the JAX package's greedy tokens, from the same
    installed state, with the JAX kernels interpreted. The two frameworks
    round bf16 at other places (tests/test_torch_bf16.py), so at every
    step the logits are held to a relative L2 of 2e-2, and the port's
    argmax to JAX's token wherever JAX's top-2 gap exceeds 0.25; the K/V
    pools and windows are bf16 and within 2e-2, F stays fp32."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in small_cfgs())
    params, tree = jax_params(jcfg, seed=1)
    tparams = params_from_numpy(tcfg, tree, dtype=torch.bfloat16)
    shape = dict(n_slots=3, block_size=4, max_blocks=10, n_total_blocks=40,
                 m_qslots=2, window=4, prefill_rows=2, prefill_len=16,
                 dtype="bfloat16")
    jspec = jsm.ServeSpec(**shape, attn_backend="pallas-interpret")
    tspec = tsm.ServeSpec(**shape)
    tables = np.full((3, 10), -1, np.int32)
    tables[0, :8] = [3, 7, 1, 9, 20, 21, 22, 23]
    tables[2, :9] = [2, 11, 4, 5, 6, 30, 31, 32, 33]
    lengths = np.array([11, 16], np.int32)
    seq = np.array([11, 0, 16], np.int32)
    qslots = np.array([1, -1, 0], np.int32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    slots = np.array([0, 2], np.int32)
    zero = np.zeros(2, np.int32)

    jstate = _install(jsm.make_state(jcfg, jspec), tables, seq, qslots,
                      jnp.asarray)
    jl, jstate = jax.jit(jsm.build_prefill_step(jcfg, jspec))(
        params, jstate, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(lengths), jnp.asarray(zero))
    tstate = _install(tsm.make_state(tcfg, tspec, "cpu"), tables, seq,
                      qslots, torch.from_numpy)
    pools = tstate["pools"]
    assert pools["k"].dtype == pools["v"].dtype == torch.bfloat16
    assert tstate["qwin"].dtype == torch.bfloat16
    assert pools["f"].dtype == torch.float32
    assert jstate["pools"]["k"].dtype == jnp.bfloat16
    tl = tsm.build_prefill_step(tcfg, tspec)(
        tparams, tstate, torch.from_numpy(toks).long(),
        torch.from_numpy(slots), torch.from_numpy(lengths),
        torch.from_numpy(zero))
    assert tl.dtype == torch.float32
    assert _rel_l2(tl, jl) <= BF16_REL_L2

    def same_pools():
        for key in ("k", "v"):
            assert _rel_l2(pools[key][:, :-1], jstate["pools"][key]) \
                <= BF16_REL_L2, key
        assert _rel_l2(tstate["qwin"][:, :-1], jstate["qwin"]) \
            <= BF16_REL_L2
    same_pools()

    jstate["positions"] = jnp.asarray(seq)
    tstate["positions"] = torch.from_numpy(seq.copy())
    active = np.array([True, False, True])
    jdecode = jax.jit(jsm.build_decode_step(jcfg, jspec))
    tdecode = tsm.build_decode_step(tcfg, tspec)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    tok = np.array([tok[0], 9, tok[1]], np.int32)
    held = 0
    for _ in range(16):
        jl, jstate = jdecode(params, jstate, jnp.asarray(tok),
                             jnp.asarray(active))
        tl = tdecode(tparams, tstate, torch.from_numpy(tok).long(),
                     torch.from_numpy(active))
        want = np.asarray(jl)[active]
        got = tl.numpy()[active]
        assert _rel_l2(got, want) <= BF16_REL_L2
        top2 = np.sort(want, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > BF16_GAP
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        held += int(clear.sum())
        tok = np.where(active, np.asarray(jl).argmax(-1), tok).astype(
            np.int32)
    assert held >= 16            # the gate held most steps' tokens
    np.testing.assert_array_equal(tstate["seq_lens"].numpy(),
                                  np.asarray(jstate["seq_lens"]))
    same_pools()
