"""The port's async surface (``repro_torch.api.aio``) on the CPU.

  * the seven contracts of tests/test_aio.py on the port's facade, each
    followed by the whole-engine sanitizer (the qwin-ownership shadow is a
    between-steps check, so it is reset first);
  * ``generate_async`` and ``stream`` streams, greedy and seeded
    (threefry), equal to the JAX package's ``generate()`` on the same
    weights: tokens equal, logprobs within atol = rtol = 1e-5 (fp32), with
    compression firing;
  * a request whose three eos ids widen the eos pad from 1 to 4, submitted
    while other requests stream: it equals its greedy twin and the others
    their references.

Each test runs its own ``asyncio.run``; the facades are module-wide, and
the loop rebinds to each fresh event loop lazily. Shapes as in
tests/test_aio.py.
"""
import asyncio
import dataclasses
import threading

import jax
import numpy as np
import pytest

from repro.api import SamplingParams as JSP
from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.api import (EngineDraining, EngineSaturated, SamplingParams,
                             Zipage)
from repro_torch.api.aio import AsyncEngineLoop
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariants

JCFG = dataclasses.replace(jget_config("tiny-lm"), dtype="float32")
JPARAMS = jlm.init(JCFG, jax.random.key(0))
CFG = dataclasses.replace(get_config("tiny-lm"), dtype="float32")
PARAMS = params_from_numpy(CFG, jax.tree.map(np.asarray, JPARAMS))
N_BLOCKS = 64
SHAPES = dict(block_size=8, n_total_blocks=N_BLOCKS, max_batch=4,
              m_qslots=4, n_max=3, window=4, max_model_len=128,
              prefill_rows=2, prefill_len=64)
TOL = 1e-5

Z = Zipage(CFG, PARAMS, device="cpu", **SHAPES)
P1, P2 = [1, 2, 3, 4, 5], [9, 8, 7]


@pytest.fixture(scope="module")
def jz():
    return JZipage(JCFG, JPARAMS, kernel_backend="jnp", **SHAPES)


def sp(n, seed=0, temperature=0.0):
    return SamplingParams(max_new_tokens=n, seed=seed,
                          temperature=temperature)


def run(coro):
    result = asyncio.run(coro)
    assert Z.num_free_blocks == N_BLOCKS       # every test leaves it clean
    Z.engine._qwin_shadow.clear()              # between-steps check: reset
    invariants.check_engine(Z.engine)
    return result


# ----------------------------------------------------------------------
# tests/test_aio.py's contracts on the port


def test_generate_async_matches_sync_generate():
    hot = sp(12, seed=11, temperature=0.9)
    ref, = Z.generate([P1], hot)

    async def main():
        out = await Z.generate_async(P1, hot)
        await Z._aio.drain()
        return out

    out = run(main())
    assert out.token_ids == ref.token_ids
    assert out.finish_reason == "length"
    assert out.usage.total_tokens == len(P1) + 12


def test_stream_chunks_match_sync_generate():
    hot = sp(15, seed=3, temperature=1.1)
    ref, = Z.generate([P1], hot)

    async def main():
        toks, final = [], None
        async for chunk in Z.stream(P1, hot):
            assert chunk.index == len(toks)
            toks.extend(chunk.token_ids)
            final = chunk
        await Z._aio.drain()
        return toks, final

    toks, final = run(main())
    assert toks == ref.token_ids
    assert final.finish_reason == "length"
    assert final.usage.completion_tokens == 15


def test_concurrent_generate_async_batches_together():
    refs = Z.generate([P1, P2, P1], [sp(8), sp(8, seed=2), sp(6)])

    async def main():
        outs = await asyncio.gather(
            Z.generate_async(P1, sp(8)),
            Z.generate_async(P2, sp(8, seed=2)),
            Z.generate_async(P1, sp(6)))
        await Z._aio.drain()
        return outs

    outs = run(main())
    for out, ref in zip(outs, refs):
        assert out.token_ids == ref.token_ids


def test_async_abort_mid_flight_reclaims():
    async def main():
        aio = await Z._ensure_aio()
        rid = await aio.add_request(P1, sp(40))
        stream = aio.stream_outputs(rid)
        first = await asyncio.wait_for(stream.__anext__(), 30)
        assert first.chunk.token_ids
        final = await aio.abort(rid)
        assert final.finish_reason == "abort" and final.finished
        # the stream flushes the terminal snapshot, then closes
        tail = [o async for o in stream]
        assert tail and tail[-1].finish_reason == "abort"
        await aio.drain()

    run(main())


def test_backpressure_saturated_raises_with_retry_after():
    # pre-fill the scheduler's waiting queue synchronously: backpressure
    # must reject before the loop even starts (no timing dependence)
    parked = Z.add_request(P1, sp(30))

    async def main():
        aio = AsyncEngineLoop(Z, max_queued_requests=1)
        with pytest.raises(EngineSaturated) as e:
            await aio.add_request(P2, sp(4))
        assert e.value.retry_after >= 1.0
        assert e.value.backlog == 1 and e.value.limit == 1
        assert not aio.started               # rejected without spin-up

    asyncio.run(main())
    Z.abort(parked)
    assert Z.num_free_blocks == N_BLOCKS


def test_drain_finishes_running_and_rejects_new():
    async def main():
        aio = await Z._ensure_aio()
        rid = await aio.add_request(P1, sp(20))
        drainer = asyncio.create_task(aio.drain())
        await asyncio.sleep(0)                # let drain close intake
        with pytest.raises(EngineDraining):
            await aio.add_request(P2, sp(4))
        final = None
        async for out in aio.stream_outputs(rid):
            final = out
        await drainer
        # running request finished normally despite the drain
        assert final.finished and final.finish_reason == "length"
        assert final.usage.completion_tokens == 20

    run(main())


def test_step_hooks_and_listeners():
    entries, batches = [], []
    Z.engine.step_hooks.append(entries.append)
    Z.add_listener(batches.append)
    try:
        out, = Z.generate([P1], sp(5))
    finally:
        Z.engine.step_hooks.remove(entries.append)
        Z.remove_listener(batches.append)
    assert entries and all("t_total" in e for e in entries)
    streamed = [t for outs in batches for o in outs
                if o.request_id == out.request_id
                for t in o.chunk.token_ids]
    assert streamed == out.token_ids


def test_a_failed_step_fails_every_stream(monkeypatch):
    """No step failure is served as a stream: the loop fans the exception
    out to every open stream and re-raises it from its task."""
    gate = threading.Event()

    def broken():
        gate.wait(30)
        raise RuntimeError("device lost")

    monkeypatch.setattr(Z, "step", broken)

    async def main():
        aio = AsyncEngineLoop(Z)
        rids = await asyncio.gather(aio.add_request(P1, sp(8)),
                                    aio.add_request(P2, sp(8)))
        streams = [aio.stream_outputs(r) for r in rids]
        gate.set()
        for stream in streams:
            with pytest.raises(RuntimeError, match="device lost"):
                async for _ in stream:
                    pass
        with pytest.raises(RuntimeError, match="device lost"):
            await aio._task
        assert aio.draining
        with pytest.raises(EngineDraining):
            await aio.add_request(P1, sp(8))
        await aio.drain()
        return rids

    rids = asyncio.run(main())
    monkeypatch.undo()
    for rid in rids:
        Z.abort(rid)
    assert Z.num_free_blocks == N_BLOCKS
    assert not Z._listeners


# ----------------------------------------------------------------------
# against the JAX package on the same weights

PROMPTS = [[1, 2, 3, 4, 5] * 6, list(range(10, 80)), list(range(100, 121)),
           [9, 8, 7]]
SAMPLED = [dict(temperature=0.6, top_p=0.95, top_k=20, seed=2**31 + 7),
           dict(temperature=0.8, top_k=5, seed=11)]


def _params(pkg_sp):
    """Two greedy and two seeded requests of 40 tokens with logprobs."""
    return [pkg_sp(max_new_tokens=40, logprobs=True),
            pkg_sp(max_new_tokens=40, logprobs=True, **SAMPLED[0]),
            pkg_sp(max_new_tokens=40, logprobs=True),
            pkg_sp(max_new_tokens=40, logprobs=True, **SAMPLED[1])]


def _same_as_jax(got_tokens, got_lps, jo):
    assert got_tokens == [o.token_ids for o in jo]
    for lp, o in zip(got_lps, jo):
        np.testing.assert_allclose(lp, o.logprobs, rtol=TOL, atol=TOL)


def test_generate_async_equals_the_jax_generate(jz):
    jo = jz.generate(PROMPTS, _params(JSP))
    assert min(o.metrics.compression.n_compressions for o in jo) > 0

    async def main():
        outs = await asyncio.gather(*[
            Z.generate_async(p, s) for p, s in zip(PROMPTS,
                                                    _params(SamplingParams))])
        await Z._aio.drain()
        return outs

    outs = run(main())
    _same_as_jax([o.token_ids for o in outs], [o.logprobs for o in outs], jo)
    assert [o.finish_reason for o in outs] == [o.finish_reason for o in jo]
    assert [dataclasses.astuple(o.usage) for o in outs] == \
        [dataclasses.astuple(o.usage) for o in jo]
    assert [o.metrics.compression.n_compressions for o in outs] == \
        [o.metrics.compression.n_compressions for o in jo]


def test_stream_equals_the_jax_generate(jz):
    jo = jz.generate(PROMPTS, _params(JSP))

    async def collect(p, s):
        toks, lps, last = [], [], None
        async for chunk in Z.stream(p, s):
            assert chunk.index == len(toks)
            toks.extend(chunk.token_ids)
            lps.extend(chunk.logprobs)
            last = chunk
        return toks, lps, last

    async def main():
        res = await asyncio.gather(*[
            collect(p, s) for p, s in zip(PROMPTS, _params(SamplingParams))])
        await Z._aio.drain()
        return res

    res = run(main())
    _same_as_jax([r[0] for r in res], [r[1] for r in res], jo)
    for (_t, _l, last), o in zip(res, jo):
        assert last.finish_reason == o.finish_reason == "length"
        assert last.usage.completion_tokens == 40
        assert last.usage.prompt_tokens == len(o.prompt_token_ids)


def test_eos_ids_widen_the_pad_mid_flight(jz):
    """Two greedy requests stream; after their first chunks a third
    arrives whose eos_ids hold three ids that its greedy twin never
    emits. The eos pad widens from 1 to 4 inside a step of the loop's
    worker thread, the third request equals its twin (and the JAX
    package's), and the first two equal their references."""
    twin, = jz.generate([PROMPTS[2]], JSP(max_new_tokens=40))
    eos = tuple(t for t in range(CFG.vocab_size)
                if t not in twin.token_ids)[:3]
    refs = jz.generate(PROMPTS[:2], JSP(max_new_tokens=40))
    assert Z.engine._eos_width == 1

    async def collect(p, s, first=None):
        toks = []
        async for chunk in Z.stream(p, s):
            toks.extend(chunk.token_ids)
            if first is not None and not first.is_set():
                first.set()
        return toks

    async def main():
        firsts = [asyncio.Event(), asyncio.Event()]
        running = [asyncio.create_task(collect(p, SamplingParams(
            max_new_tokens=40), f)) for p, f in zip(PROMPTS[:2], firsts)]
        for f in firsts:
            await f.wait()
        out = await Z.generate_async(PROMPTS[2], SamplingParams(
            max_new_tokens=40, eos_ids=eos))
        streams = await asyncio.gather(*running)
        await Z._aio.drain()
        return out, streams

    out, streams = run(main())
    assert Z.engine._eos_width == 4
    assert out.token_ids == twin.token_ids
    assert out.finish_reason == "length"
    assert streams == [o.token_ids for o in refs]


def test_many_streams_and_aborts_under_a_short_switch_interval():
    """Twelve streams on four decode slots, three aborted after their first
    chunk, with the interpreter switching threads every 10 us: the worker
    thread's steps and the event loop's intake, fan-out and aborts
    interleave finely. Every stream that was not aborted equals its
    request served alone; the aborted ones end in "abort"; the pool and
    the sanitizer are clean."""
    import sys

    prompts = [list(range(3 + i, 12 + 2 * i)) for i in range(12)]
    params = [sp(16, seed=i, temperature=0.8 if i % 2 else 0.0)
              for i in range(12)]
    refs = [Z.generate([p], s)[0].token_ids for p, s in zip(prompts, params)]
    aborted = {2, 5, 9}

    async def collect(i):
        aio = await Z._ensure_aio()
        rid = await aio.add_request(prompts[i], params[i])
        toks, last = [], None
        async for out in aio.stream_outputs(rid):
            toks.extend(out.chunk.token_ids if out.chunk else [])
            last = out
            if i in aborted and last.finish_reason is None:
                await aio.abort(rid)
        return toks, last.finish_reason

    async def main():
        got = await asyncio.wait_for(
            asyncio.gather(*[collect(i) for i in range(12)]), 300)
        await Z._aio.drain()
        return got

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = run(main())
    finally:
        sys.setswitchinterval(before)
    for i, ((toks, reason), ref) in enumerate(zip(got, refs)):
        if i in aborted:
            assert reason == "abort" and toks == ref[:len(toks)]
        else:
            assert reason == "length" and toks == ref
