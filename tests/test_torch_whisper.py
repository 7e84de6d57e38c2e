"""Whisper-tiny (the encoder-decoder backbone) in the port, held against
the JAX package at ``reduced()`` widths (d_model 64, 2 decoder and 2
encoder layers, ``cross_seq_len`` 8) and fp32, on weights from
``repro.models.lm.init`` carried over by ``convert.params_from_numpy``:

  * the encoder (``lm.encode``), the cross attention, the forward with
    frame embeddings and the loss at 1e-5, the loss's gradients at a
    relative L2 of 1e-4 per leaf;
  * the serve pair: a 13-token prompt prefilled in calls of 8 and 5, then
    teacher-forced decode steps, against the JAX ``lm.forward`` of the
    whole sequence over the same frames (1e-4), the per-slot
    cross-attention KV written in place;
  * the facade against the JAX facade (``kernel_backend="jnp"``): equal
    greedy streams, finish reasons and compression counts at
    ``decode_steps`` 1 and 4, with compression firing;
  * the engine's gating: no prefix caching, swap warns and recomputes, a
    snapshot round-trips ``cross_kv`` into the engine's own buffers.
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
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariants
from repro_torch.core import serve_model as tsm
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.training import optimizer as opt

NAME = "whisper-tiny"
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
    tree = jax.tree.map(np.array, params)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params,
                tparams=params_from_numpy(tcfg, tree))


def frames(cfg, B, seed=3):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal((B, cfg.cross_seq_len, cfg.d_model))
            ).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ----------------------------------------------------------------------
# module level

def test_config_is_the_jax_packages():
    assert dataclasses.asdict(get_config(NAME)) == \
        dataclasses.asdict(jget_config(NAME))
    assert dataclasses.asdict(get_config(NAME).reduced()) == \
        dataclasses.asdict(jget_config(NAME).reduced())


def test_params_carry_the_encoder_and_cross_attention(model):
    tp, tcfg = model["tparams"], model["tcfg"]
    assert len(tp["encoder"]["layers"]) == tcfg.encoder_layers == 2
    for p in tp["layers"]:
        assert set(p["cross"]) == {"wq", "wk", "wv", "wo"}
        assert p["ln_x"]["scale"].dtype == torch.float32
    mine = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert lm.param_count(mine) == lm.param_count(tp)
    enc = model["params"]["encoder"]
    np.testing.assert_array_equal(
        tp["encoder"]["layers"][1]["attn"]["wq"].numpy(),
        np.asarray(enc["layers"]["0"]["attn"]["wq"][1]))
    bf = params_from_numpy(tcfg, jax.tree.map(np.array, model["params"]),
                           dtype=torch.bfloat16)
    assert bf["layers"][0]["ln_x"]["scale"].dtype == torch.float32
    assert bf["layers"][0]["cross"]["wk"].dtype == torch.bfloat16
    assert bf["encoder"]["final_norm"]["scale"].dtype == torch.float32


def test_encode_matches_jax(model):
    fe = frames(model["jcfg"], 2)
    want = jlm.encode(model["jcfg"], model["params"], jnp.asarray(fe))
    got = lm.encode(model["tcfg"], model["tparams"], torch.from_numpy(fe))
    assert got.shape == (2, model["tcfg"].cross_seq_len, 64)
    close(got, want, TOL)


def test_cross_attn_forward_matches_jax(model):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jp = model["params"]["main"]["0"]["cross"]
    jp0 = jax.tree.map(lambda a: a[0], jp)
    want = jL.cross_attn_forward(model["jcfg"], jp0, jnp.asarray(x),
                                 jnp.asarray(mem))
    got = L.cross_attn_forward(model["tcfg"],
                               model["tparams"]["layers"][0]["cross"],
                               torch.from_numpy(x), torch.from_numpy(mem))
    close(got, want, TOL)


def test_forward_with_frame_embeds_matches_jax(model):
    tokens = np.random.default_rng(5).integers(0, 256, (2, 11))
    fe = frames(model["jcfg"], 2, seed=6)
    want = jax.jit(jlm.forward, static_argnums=0)(
        model["jcfg"], model["params"], jnp.asarray(tokens),
        frame_embeds=jnp.asarray(fe))
    got = lm.forward(model["tcfg"], model["tparams"],
                     torch.from_numpy(tokens),
                     frame_embeds=torch.from_numpy(fe))
    close(got, want, TOL)
    with pytest.raises(ValueError, match="frame_embeds"):
        lm.forward(model["tcfg"], model["tparams"], torch.from_numpy(tokens))


def test_loss_and_gradients_match_jax(model):
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 256, (2, 16)),
             "labels": rng.integers(0, 256, (2, 16)),
             "frame_embeds": frames(model["jcfg"], 2, seed=8)}
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
    assert float(loss.detach()) == pytest.approx(float(jl), rel=TOL, abs=TOL)
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

def test_prefill_in_two_calls_and_decode_match_forward(model):
    """A 13-token prompt in prefill calls of 8 and 5 on slot 1 (slot 0
    holds another request's cross KV), then 6 teacher-forced decode
    steps: each prefill call's last logits and every decode's match the
    JAX forward over the same frames."""
    cfg, n_dec = model["tcfg"], 6
    seq = np.random.default_rng(9).integers(0, 256, 13 + n_dec)
    fe = frames(cfg, 1, seed=10)
    want = np.asarray(jax.jit(jlm.forward, static_argnums=0)(
        model["jcfg"], model["params"], jnp.asarray(seq[None]),
        frame_embeds=jnp.asarray(fe)))[0]
    spec = tsm.ServeSpec(n_slots=2, block_size=4, max_blocks=8,
                         n_total_blocks=32, m_qslots=2, window=4,
                         prefill_rows=2, prefill_len=8, dtype="float32")
    st = tsm.make_state(cfg, spec, "cpu")
    assert st["cross_kv"]["k"].shape == (2, 2, 8, cfg.num_kv_heads, 16)
    bt = np.full((2, 8), -1, np.int32)
    bt[1, :] = np.arange(8)
    st["block_tables"].copy_(torch.from_numpy(bt))
    st["qslot"].copy_(torch.tensor([-1, 0], dtype=torch.int32))
    buffers = [t.data_ptr() for t in st["cross_kv"].values()]
    prefill = tsm.build_prefill_step(cfg, spec)
    decode = tsm.build_decode_step(cfg, spec)
    other = torch.full_like(st["cross_kv"]["k"][:, 0], 7.0)
    st["cross_kv"]["k"][:, 0] = other
    fe2 = np.concatenate([np.zeros_like(fe), fe])      # row 0 pads
    for start, n in ((0, 8), (8, 5)):
        toks = np.zeros((2, 8), np.int64)
        toks[1, :n] = seq[start:start + n]
        logits = prefill(model["tparams"], st, torch.from_numpy(toks),
                         torch.tensor([-1, 1], dtype=torch.int32),
                         torch.tensor([0, n], dtype=torch.int32),
                         torch.tensor([0, start], dtype=torch.int32),
                         frame_embeds=torch.from_numpy(fe2))
        close(logits[1], want[start + n - 1], SERVE_TOL)
    assert [t.data_ptr() for t in st["cross_kv"].values()] == buffers
    assert torch.equal(st["cross_kv"]["k"][:, 0], other)   # pad row wrote none
    memory = lm.encode(cfg, model["tparams"], torch.from_numpy(fe))
    for li, p in enumerate(model["tparams"]["layers"]):
        k, v = L.cross_kv(cfg, p["cross"], memory)
        assert torch.equal(st["cross_kv"]["k"][li, 1], k[0])
        assert torch.equal(st["cross_kv"]["v"][li, 1], v[0])
    st["seq_lens"].copy_(torch.tensor([0, 13], dtype=torch.int32))
    st["positions"].copy_(torch.tensor([0, 13], dtype=torch.int32))
    active = torch.tensor([False, True])
    for t in range(n_dec):
        tok = torch.tensor([0, int(seq[13 + t])])
        logits = decode(model["tparams"], st, tok, active)
        close(logits[1], want[13 + t], SERVE_TOL)


def test_prefill_matches_jax_serve_path(model):
    """Both rows in one call of the JAX package's prefill on the same
    frames: last logits, the K/V pool entries and the cross KV."""
    cfg, jcfg = model["tcfg"], model["jcfg"]
    kw = dict(n_slots=2, block_size=4, max_blocks=8, n_total_blocks=32,
              m_qslots=2, window=4, prefill_rows=2, prefill_len=16,
              dtype="float32")
    lens = [13, 9]
    rng = np.random.default_rng(11)
    toks = np.zeros((2, 16), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, n)
    fe = frames(cfg, 2, seed=12)
    bt = np.full((2, 8), -1, np.int32)
    bt[0, :4], bt[1, :4] = np.arange(4), 10 + np.arange(4)
    jst = jsm.make_state(jcfg, jsm.ServeSpec(**kw))
    jst["block_tables"] = jnp.asarray(bt)
    jlog, jst = jax.jit(jsm.build_prefill_step(jcfg, jsm.ServeSpec(**kw)))(
        model["params"], jst, jnp.asarray(toks, jnp.int32),
        jnp.asarray([0, 1], jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.zeros((2,), jnp.int32), frame_embeds=jnp.asarray(fe))
    st = tsm.make_state(cfg, tsm.ServeSpec(**kw), "cpu")
    st["block_tables"].copy_(torch.from_numpy(bt))
    logits = tsm.build_prefill_step(cfg, tsm.ServeSpec(**kw))(
        model["tparams"], st, torch.from_numpy(toks),
        torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), frame_embeds=torch.from_numpy(fe))
    close(logits, jlog, SERVE_TOL)
    for k in ("k", "v"):
        close(st["pools"][k][:, :32], jst["pools"][k], SERVE_TOL)
        close(st["cross_kv"][k], jst["cross_kv"][k], SERVE_TOL)


# ----------------------------------------------------------------------
# facade level

def prompts(n=6, seed=1):
    """Seeded prompts of 12-60 tokens (no repeated-token runs)."""
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 256, int(k))]
            for k in rng.integers(12, 61, n)]


def greedy(n=NEW_TOKENS):
    return dict(max_new_tokens=n)


def served(outs):
    return [(o.token_ids, o.finish_reason,
             o.metrics.compression.n_compressions) for o in outs]


@pytest.fixture(scope="module")
def port_k1(model):
    z = Zipage(model["tcfg"], model["tparams"], device="cpu", **SHAPES)
    return served(z.generate(prompts(), SamplingParams(**greedy())))


@pytest.mark.parametrize("k", [1, 4])
def test_facade_streams_match_jax(model, port_k1, k):
    ps = prompts()
    jz = JZipage(model["jcfg"], model["params"], kernel_backend="jnp",
                 decode_steps=k, **SHAPES)
    tz = Zipage(model["tcfg"], model["tparams"], device="cpu",
                decode_steps=k, **SHAPES)
    assert tz.engine.compression_enabled and not tz.engine.prefix_ok
    want = served(jz.generate(ps, JSP(**greedy())))
    got = served(tz.generate(ps, SamplingParams(**greedy())))
    assert got == want
    assert got == port_k1
    assert sum(c for _, _, c in got) >= 1
    assert tz.num_free_blocks == SHAPES["n_total_blocks"]


def test_swap_warns_and_recomputes(model, port_k1):
    with pytest.warns(UserWarning, match="cannot swap"):
        z = Zipage(model["tcfg"], model["tparams"], device="cpu",
                   preemption_mode="swap", swap_space_blocks=24, **SHAPES)
    assert z.engine.scheduler.p.preemption_mode == "recompute"
    assert z.engine.swap_pool is None
    assert served(z.generate(prompts(), SamplingParams(**greedy()))) == \
        port_k1


def test_snapshot_restore_carries_cross_kv(model, monkeypatch):
    monkeypatch.setattr(invariants, "enabled", lambda: True)

    def engine():
        return Zipage(model["tcfg"], model["tparams"], device="cpu",
                      decode_steps=4, **SHAPES).engine
    eng = engine()
    rids = [eng.add_request(p, SamplingParams(**greedy()))
            for p in prompts(4, seed=2)]
    for _ in range(3):
        eng.step()
    # the engine's zero frames encode to zeros: plant a seeded cross KV,
    # which the continuation reads, so a lost round trip changes streams
    gen = torch.Generator().manual_seed(0)
    for t in eng.state["cross_kv"].values():
        t.copy_(torch.randn(t.shape, generator=gen))
    snap = eng.snapshot()
    done_a = eng.run(max_steps=500)
    eng2 = engine()
    ptrs = {k: t.data_ptr() for k, t in eng2.state["cross_kv"].items()}
    eng2.restore(snap)
    assert {k: t.data_ptr() for k, t in eng2.state["cross_kv"].items()} \
        == ptrs
    assert torch.equal(eng2.state["cross_kv"]["v"], snap["device"]
                       ["cross_kv"]["v"])
    done_b = eng2.run(max_steps=500)
    out = [[(d[r].output, d[r].finish_reason) for r in rids]
           for d in (done_a, done_b)]
    assert out[0] == out[1]
