"""InternVL2-26B (an InternLM2-20B backbone taking a stub vision
frontend's patch embeddings as a prefix) in the port, held against the
JAX package at ``reduced()`` widths (d_model 64, 2 layers, 4 prefix
embeddings) and fp32, on weights from ``repro.models.lm.init`` carried
over by ``convert.params_from_numpy``:

  * the forward with ``prefix_embeds`` and the loss over the text
    positions at 1e-5, the loss's gradients at a relative L2 of 1e-4 per
    leaf;
  * a prefill with ``prefix_embeds`` at ``start_pos`` 0 against the JAX
    package's: last logits, the K/V pool entries and the observation
    window at 1e-4, then decode steps against the JAX forward;
  * the facade against the JAX facade (``kernel_backend="jnp"``), which
    serve the backbone on text: equal greedy streams, finish reasons and
    compression counts at ``decode_steps`` 1 and 4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SamplingParams as JSP
from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.core import serve_model as jsm
from repro.models import lm as jlm
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import serve_model as tsm
from repro_torch.models import lm
from repro_torch.training import optimizer as opt

NAME = "internvl2-26b"
TOL = 1e-5
SERVE_TOL = 1e-4
GRAD_REL_L2 = 1e-4
#: ROADMAP §C's probe shapes
SHAPES = dict(block_size=8, n_total_blocks=64, max_batch=4,
              max_model_len=160, prefill_rows=2, prefill_len=64)
NEW_TOKENS = 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored after: the
    suite runs six workers on a few cores, where torch's default of one
    spinning thread a core makes these small ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget_config(NAME).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(NAME).reduced(), dtype="float32")
    params = jax.jit(jlm.init, static_argnums=0)(jcfg, jax.random.key(0))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params,
                tparams=params_from_numpy(tcfg,
                                          jax.tree.map(np.array, params)))


def patches(cfg, B, seed=3):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal((B, cfg.num_prefix_embeds,
                                        cfg.d_model))).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def jax_forward(model, tokens, pe):
    return np.asarray(jax.jit(jlm.forward, static_argnums=0)(
        model["jcfg"], model["params"], jnp.asarray(tokens),
        prefix_embeds=jnp.asarray(pe)))


# ----------------------------------------------------------------------
# module level

def test_config_is_the_jax_packages():
    cfg = get_config(NAME)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(NAME))
    assert cfg.num_prefix_embeds == 256 and cfg.reduced().num_prefix_embeds \
        == 4
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.head_dim) == (6, 128)


def test_forward_with_prefix_embeds_matches_jax(model):
    tokens = np.random.default_rng(5).integers(0, 256, (2, 11))
    pe = patches(model["tcfg"], 2)
    want = jax_forward(model, tokens, pe)
    got = lm.forward(model["tcfg"], model["tparams"],
                     torch.from_numpy(tokens),
                     prefix_embeds=torch.from_numpy(pe))
    assert got.shape == (2, 4 + 11, 256)
    close(got, want, TOL)


def test_loss_and_gradients_match_jax(model):
    """The loss covers the text positions only; the prefix's gradient
    flows through attention into every layer."""
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 256, (2, 16)),
             "labels": rng.integers(0, 256, (2, 16)),
             "prefix_embeds": patches(model["tcfg"], 2, seed=8)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(model["jcfg"], p,
                              jax.tree.map(jnp.asarray, batch),
                              vocab_chunk=8)))(model["params"])
    p = params_from_numpy(model["tcfg"],
                          jax.tree.map(np.array, model["params"]))
    xs = opt.tree_leaves(p)
    for x in xs:
        x.requires_grad_(True)
    loss = lm.lm_loss(model["tcfg"], p, {k: torch.from_numpy(v)
                                         for k, v in batch.items()},
                      vocab_chunk=8)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=TOL,
                                                 abs=TOL)
    ref = opt.tree_leaves(params_from_numpy(model["tcfg"],
                                            jax.tree.map(np.array, jg)))
    assert len(ref) == len(xs)
    for g, r in zip(grads, ref):
        g = torch.zeros_like(r) if g is None else g
        if float(r.norm()) == 0.0:
            assert float(g.norm()) == 0.0
        else:
            assert float((g - r).norm() / r.norm()) < GRAD_REL_L2


# ----------------------------------------------------------------------
# serve level

SPEC = dict(n_slots=2, block_size=4, max_blocks=8, n_total_blocks=32,
            m_qslots=2, window=4, prefill_rows=2, prefill_len=16,
            dtype="float32")


def test_prefill_with_prefix_matches_jax_then_decode(model):
    """Two rows of 13 and 9 tokens, each after its 4 patch embeddings, in
    one prefill call at ``start_pos`` 0: the last logits, every K/V pool
    entry and the observation windows equal the JAX package's; then 5
    teacher-forced decode steps match the JAX forward over the prefix and
    the tokens."""
    cfg, jcfg = model["tcfg"], model["jcfg"]
    npx, lens, n_dec = cfg.num_prefix_embeds, [13, 9], 5
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 256, n + n_dec) for n in lens]
    toks = np.zeros((2, 16), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = seqs[i][:n]
    pe = patches(cfg, 2, seed=12)
    bt = np.full((2, 8), -1, np.int32)
    bt[0, :6], bt[1, :6] = np.arange(6), 10 + np.arange(6)
    qslot = np.array([1, 0], np.int32)
    jst = jsm.make_state(jcfg, jsm.ServeSpec(**SPEC))
    jst["block_tables"] = jnp.asarray(bt)
    jst["qslot"] = jnp.asarray(qslot)
    jlog, jst = jax.jit(jsm.build_prefill_step(jcfg, jsm.ServeSpec(**SPEC)))(
        model["params"], jst, jnp.asarray(toks, jnp.int32),
        jnp.asarray([0, 1], jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.zeros((2,), jnp.int32), prefix_embeds=jnp.asarray(pe))
    st = tsm.make_state(cfg, tsm.ServeSpec(**SPEC), "cpu")
    st["block_tables"].copy_(torch.from_numpy(bt))
    st["qslot"].copy_(torch.from_numpy(qslot))
    logits = tsm.build_prefill_step(cfg, tsm.ServeSpec(**SPEC))(
        model["tparams"], st, torch.from_numpy(toks),
        torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32),
        prefix_embeds=torch.from_numpy(pe))
    close(logits, jlog, SERVE_TOL)
    for k in ("k", "v"):
        close(st["pools"][k][:, :32], jst["pools"][k], SERVE_TOL)
    close(st["qwin"][:, :2], jst["qwin"], SERVE_TOL)
    # the pools hold the prefix's entries too: row 0's 4 + 13 fill four
    # blocks of 4 and the first entry of its fifth
    blk4 = st["pools"]["k"][0, 4].abs().sum((-1, -2))
    assert blk4[0] > 0 and float(blk4[1:].sum()) == 0
    want = [jax_forward(model, seqs[i][None], pe[i:i + 1])[0]
            for i in range(2)]
    for i, n in enumerate(lens):
        close(logits[i], want[i][npx + n - 1], SERVE_TOL)
    n_in = np.array([npx + n for n in lens], np.int32)
    st["seq_lens"].copy_(torch.from_numpy(n_in))
    st["positions"].copy_(torch.from_numpy(n_in))
    decode = tsm.build_decode_step(cfg, tsm.ServeSpec(**SPEC))
    active = torch.tensor([True, True])
    for t in range(n_dec):
        tok = torch.tensor([int(seqs[i][lens[i] + t]) for i in range(2)])
        out = decode(model["tparams"], st, tok, active)
        for i, n in enumerate(lens):
            close(out[i], want[i][npx + n + t], SERVE_TOL)


# ----------------------------------------------------------------------
# facade level

def prompts(n=6, seed=1):
    """Seeded prompts of 12-60 tokens (no repeated-token runs)."""
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 256, int(k))]
            for k in rng.integers(12, 61, n)]


def served(outs):
    return [(o.token_ids, o.finish_reason,
             o.metrics.compression.n_compressions) for o in outs]


@pytest.fixture(scope="module")
def port_k1(model):
    z = Zipage(model["tcfg"], model["tparams"], device="cpu", **SHAPES)
    return served(z.generate(prompts(),
                             SamplingParams(max_new_tokens=NEW_TOKENS)))


@pytest.mark.parametrize("k", [1, 4])
def test_facade_streams_match_jax(model, port_k1, k):
    ps = prompts()
    jz = JZipage(model["jcfg"], model["params"], kernel_backend="jnp",
                 decode_steps=k, **SHAPES)
    tz = Zipage(model["tcfg"], model["tparams"], device="cpu",
                decode_steps=k, **SHAPES)
    assert tz.engine.compression_enabled and tz.engine.prefix_ok
    want = served(jz.generate(ps, JSP(max_new_tokens=NEW_TOKENS)))
    got = served(tz.generate(ps, SamplingParams(max_new_tokens=NEW_TOKENS)))
    assert got == want
    assert got == port_k1
    assert sum(c for _, _, c in got) >= 1
    assert tz.num_free_blocks == SHAPES["n_total_blocks"]
