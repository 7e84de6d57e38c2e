"""RecurrentGemma-2B and RWKV6-3B through the facade, held against the
JAX package's facade (``kernel_backend="jnp"``) on the same weights, at
``reduced()`` widths and fp32:

  * six prompts of 12-30 tokens, each within one prefill call, 24 new
    tokens each (RecurrentGemma's 32-token ring wraps in decode), greedy
    and seeded, at ``decode_steps`` 1, 4 and 8: equal streams and finish
    reasons, logprobs within atol = rtol = 1e-5, no compression in either
    package (it is off for local-window and attention-free configs), the
    pool whole again after the serve, and the port's K = 1 and K = 8
    streams and logprobs equal bit for bit;
  * the streaming surface (``add_request`` / ``step``, the async
    ``stream``) gives ``generate()``'s streams;
  * a snapshot mid-serve, the recurrent state (``rec``) included,
    restores into a fresh engine and continues with the same streams;
  * ``preemption_mode="swap"`` warns and preempts by recompute, as the
    JAX engine does (a ring's pages and the recurrent state are per
    slot); under a tight pool each RecurrentGemma request holds its whole
    ring from admission and the streams equal an ample pool's.
"""
import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import SamplingParams as JSP
from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariants

TOL = 1e-5
NAMES = ["recurrentgemma-2b", "rwkv6-3b"]
SHAPES = dict(block_size=4, n_total_blocks=64, max_batch=4,
              max_model_len=128, prefill_rows=2, prefill_len=32)
NEW_TOKENS = 24
SAMPLED = [dict(temperature=0.6, top_p=0.95, top_k=20, seed=2**31 + 7),
           dict(temperature=0.8, top_k=5, seed=11),
           dict(temperature=1.0, top_p=0.9, seed=0)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def sanitized(monkeypatch):
    monkeypatch.setattr(invariants, "enabled", lambda: True)


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    name = request.param
    jcfg = dataclasses.replace(jget_config(name).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    params = jlm.init(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, params=params,
                tparams=params_from_numpy(tcfg, tree))


def prompts(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, int(k))]
            for k in rng.integers(12, 31, n)]


def mixed(n=6):
    """Greedy and seeded requests, all with logprobs."""
    return [dict(max_new_tokens=NEW_TOKENS, logprobs=True,
                 **({} if i % 2 == 0 else SAMPLED[i // 2 % 3]))
            for i in range(n)]


def outputs(outs):
    return [(o.token_ids, o.logprobs, o.finish_reason) for o in outs]


@pytest.fixture(scope="module")
def port_k1(model):
    """The port's streams at ``decode_steps`` 1, the other K's yardstick."""
    z = Zipage(model["tcfg"], model["tparams"], device="cpu", **SHAPES)
    ps = prompts(model["tcfg"].vocab_size)
    return outputs(z.generate(ps, [SamplingParams(**d) for d in mixed()]))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_facade_streams_match_jax(model, port_k1, k):
    ps = prompts(model["tcfg"].vocab_size)
    jz = JZipage(model["jcfg"], model["params"], kernel_backend="jnp",
                 decode_steps=k, **SHAPES)
    tz = Zipage(model["tcfg"], model["tparams"], device="cpu",
                decode_steps=k, **SHAPES)
    assert not tz.engine.compression_enabled and not tz.engine.prefix_ok
    jo = jz.generate(ps, [JSP(**d) for d in mixed()])
    to = tz.generate(ps, [SamplingParams(**d) for d in mixed()])
    assert [o.token_ids for o in to] == [o.token_ids for o in jo]
    assert [o.finish_reason for o in to] == [o.finish_reason for o in jo]
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=TOL,
                                   atol=TOL)
        assert a.metrics.compression.n_compressions == 0
        assert b.metrics.compression.n_compressions == 0
    assert tz.num_free_blocks == SHAPES["n_total_blocks"]
    assert jz.num_free_blocks == SHAPES["n_total_blocks"]
    if model["tcfg"].local_window:
        assert max(len(p) for p in ps) + NEW_TOKENS > \
            model["tcfg"].local_window          # the ring wraps in decode
    assert outputs(to) == port_k1             # bit for bit across K


def test_streaming_surface_matches_generate(model):
    """``add_request`` / ``step`` and the async ``stream`` give the
    streams of ``generate()``."""
    ps = prompts(model["tcfg"].vocab_size, n=3, seed=5)
    sps = [SamplingParams(**d) for d in mixed(3)]
    z = Zipage(model["tcfg"], model["tparams"], device="cpu", **SHAPES)
    ref = [o.token_ids for o in z.generate(ps, sps)]
    rids = [z.add_request(p, sp) for p, sp in zip(ps, sps)]
    while z.has_unfinished():
        z.step()
    assert [z.output(r).token_ids for r in rids] == ref

    async def main():
        async def one(p, sp):
            toks = []
            async for chunk in z.stream(p, sp):
                toks.extend(chunk.token_ids)
            return toks
        out = await asyncio.gather(*(one(p, sp) for p, sp in zip(ps, sps)))
        await z._aio.drain()
        return out
    assert asyncio.run(main()) == ref
    assert z.num_free_blocks == SHAPES["n_total_blocks"]


def test_snapshot_restore_carries_recurrent_state(model):
    ps = prompts(model["tcfg"].vocab_size, n=4, seed=2)

    def engine():
        return Zipage(model["tcfg"], model["tparams"], device="cpu",
                      decode_steps=4, **SHAPES).engine
    eng = engine()
    rids = [eng.add_request(p, SamplingParams(**d))
            for p, d in zip(ps, mixed(4))]
    for _ in range(4):
        eng.step()
    assert all(len(r.output) for r in eng.running)
    snap = eng.snapshot()
    assert "rec" in snap["device"]
    assert any(bool(t.abs().sum() > 0) for t in snap["device"]["rec"].values())
    done_a = eng.run(max_steps=500)
    eng2 = engine()
    rec_buffers = {k: t.data_ptr() for k, t in eng2.state["rec"].items()}
    eng2.restore(snap)
    assert {k: t.data_ptr() for k, t in eng2.state["rec"].items()} == \
        rec_buffers
    done_b = eng2.run(max_steps=500)
    out = [[(d[r].output, d[r].logprobs, d[r].finish_reason) for r in rids]
           for d in (done_a, done_b)]
    assert out[0] == out[1]


def test_swap_warns_and_recomputes(model):
    with pytest.warns(UserWarning, match="cannot swap"):
        z = Zipage(model["tcfg"], model["tparams"], device="cpu",
                   preemption_mode="swap", swap_space_blocks=24, **SHAPES)
    eng = z.engine
    assert eng.scheduler.p.preemption_mode == "recompute"
    assert eng.swap_pool is None and eng.bm.swap_space_blocks == 0
    ps = prompts(model["tcfg"].vocab_size, n=4, seed=3)
    sps = [SamplingParams(**d) for d in mixed(4)]
    ample = Zipage(model["tcfg"], model["tparams"], device="cpu", **SHAPES)
    assert outputs(z.generate(ps, sps)) == outputs(ample.generate(ps, sps))


def test_tight_pool_holds_whole_rings():
    """Each RecurrentGemma request holds its ring (window / block_size
    blocks) from admission to its end; a pool of two rings serves two at
    a time, and the streams equal an ample pool's."""
    name = "recurrentgemma-2b"
    jcfg = dataclasses.replace(jget_config(name).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.key(0)))
    params = params_from_numpy(tcfg, tree)
    ring = tcfg.local_window // SHAPES["block_size"]
    tight = dict(SHAPES, n_total_blocks=2 * ring)
    z = Zipage(tcfg, params, device="cpu", **tight)
    eng = z.engine
    seen = []

    def hook(entry):
        seen.append((len(eng.running), len(eng.waiting),
                     [r.n_blocks for r in eng.running]))
    eng.step_hooks.append(hook)
    ps = prompts(tcfg.vocab_size, n=5, seed=4)
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS)] * 5
    got = [o.token_ids for o in z.generate(ps, sps)]
    assert all(n == ring for _, _, blocks in seen for n in blocks)
    assert max(n for n, _, _ in seen) == 2
    assert any(w for _, w, _ in seen)
    assert z.num_free_blocks == tight["n_total_blocks"]
    ample = Zipage(tcfg, params, device="cpu", **SHAPES)
    assert got == [o.token_ids for o in ample.generate(ps, sps)]
