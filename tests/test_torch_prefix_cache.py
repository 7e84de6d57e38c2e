"""The port's prefix cache, raw and compressed, held to the contract of
tests/test_prefix_cache.py and against the JAX engine on the same tiny-lm
weights (``convert.params_from_numpy``), at that file's shapes (block 4,
64 blocks, n_max 3, window 2, greedy).

Each scenario runs on both engines, which must agree on the tokens and on
what the cache did: ``n_cached``, ``pos_gap``, compression, and the
cache's counters (hits, segment hits, cached tokens per block). Within the
port a cache hit must be invisible in the tokens: the hit run equals a run
without the cache under the same compression.

``cache_compressed_prefixes``: a prompt-pure first compression registers
its condensed payload as a segment; once the raw chain is gone (explicitly
invalidated, or evicted under ``prefix_cache_watermark``) a request with
that prompt as its prefix adopts the segment, ``pos_gap`` tokens of
history fewer in the cache than in its positions. The survivor margins of
every compression the port runs are recorded and must stay above MARGIN
before streams are compared (ROADMAP §C "Survivor near-ties"). Every port
engine audits its whole state after each step.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.compression import CompressOptions as JCompress
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import ZipageEngine as JEngine
from repro.core.sampling import SamplingParams as JSP
from repro.models import lm as jlm
from repro_torch.api.config import build_engine_options, route_overrides
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression, invariants
from repro_torch.core.compression import CompressOptions
from repro_torch.core.engine import EngineOptions, ZipageEngine
from repro_torch.core.invariants import audit_engine
from repro_torch.core.sampling import SamplingParams

MARGIN = 1e-6
SHAPES = dict(block_size=4, n_total_blocks=64, max_batch=4, m_qslots=4,
              n_max=3, window=2, max_model_len=256, prefill_rows=2,
              prefill_len=64, prefix_caching=True, temperature=0.0)
STATS = ("prefix_hits", "prefix_hit_tokens", "prefix_segment_hits",
         "prefix_cached_blocks", "prefix_cached_tokens",
         "cached_tokens_per_block")


@pytest.fixture(autouse=True)
def sanitized(monkeypatch):
    monkeypatch.setattr(invariants, "enabled", lambda: True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: tiny-lm's ops are too small to gain from more,
    and beside the suite's other workers the threads contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def margins(monkeypatch):
    """The smallest k-th vs (k+1)-th final-score margin of each compression
    the port runs."""
    seen = []
    select = compression._select_survivors

    def recording(cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                  hist_lens, T):
        out = select(cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                     hist_lens, T)
        top = torch.sort(out[3], dim=1, descending=True)[0]
        live = seq_lens > 0
        if bool(live.any()):
            seen.append(float((top[:, k_keep - 1]
                               - top[:, k_keep])[live].min()))
        return out

    monkeypatch.setattr(compression, "_select_survivors", recording)
    return seen


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jget_config("tiny-lm"), dtype="float32")
    jparams = jlm.init(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, params_from_numpy(get_config("tiny-lm"), tree)


def engines(weights, **kw):
    """(port engine, JAX engine) at SHAPES with ``kw``."""
    jcfg, jparams, tparams = weights
    opts = dict(SHAPES, **kw)
    port = ZipageEngine(get_config("tiny-lm"), tparams, EngineOptions(
        **opts, compress=CompressOptions(window=2)), device="cpu")
    ref = JEngine(jcfg, jparams, JOptions(**opts,
                                          compress=JCompress(window=2)))
    return port, ref


def submit(eng, prompt, n):
    sp = SamplingParams if isinstance(eng, ZipageEngine) else JSP
    return eng.add_request(prompt, sp(max_new_tokens=n))


def finish(eng, rid, cap=500):
    while rid not in eng.finished:
        eng.step()
        assert eng.step_count < cap
    return eng.finished[rid]


def summary(r):
    return dict(output=r.output, n_cached=r.n_cached, pos_gap=r.pos_gap,
                compressed=r.compressed, n_compressions=r.n_compressions)


def scenario(eng, first, then, n_first, n_then, invalidate=False):
    """Serve ``first`` to its end, then each of ``then`` together; returns
    the later requests' summaries and the cache's counters."""
    finish(eng, submit(eng, first, n_first))
    if invalidate:
        eng.bm.invalidate_blocks(list(eng.bm.block_hash))
        eng.bm.check_invariants()
    segments = len(eng.bm.segments)
    rids = [submit(eng, p, n_then) for p in then]
    eng.run(max_steps=400)
    stats = {k: eng.metrics[-1][k] for k in STATS}
    return [summary(eng.finished[r]) for r in rids], stats, segments


def both(weights, *args, knobs=(), **kw):
    port, ref = engines(weights, **dict(knobs))
    got = scenario(port, *args, **kw)
    want = scenario(ref, *args, **kw)
    assert got == want
    assert audit_engine(port) == []
    port.bm.check_invariants()
    return got, port


def test_hit_and_miss_streams_bit_identical(weights):
    """A full-prompt hit is capped one block short, so the continuation
    equals the cold run's; both engines agree."""
    p = list(range(2, 10))
    (outs, stats, _), port = both(weights, p, [p], 8, 8,
                                  knobs=dict(n_max=6))
    assert outs[0]["n_cached"] == 4
    assert outs[0]["output"] == port.finished[0].output
    assert stats["prefix_hits"] >= 1


def test_multi_turn_reuse_beyond_prompt(weights):
    """Register-at-finish: the next turn (prior stream + new tokens) hits
    past the first prompt's boundary."""
    port, ref = engines(weights, n_max=6)
    prompt = list(range(1, 11))
    outs = []
    for eng in (port, ref):
        req1 = finish(eng, submit(eng, prompt, 6))
        stream = prompt + req1.output
        req2 = finish(eng, submit(eng, stream + [77, 78], 6))
        outs.append((req1.output, summary(req2),
                     eng.metrics[-1]["prefix_hit_tokens"]))
    assert outs[0] == outs[1]
    assert outs[0][1]["n_cached"] == 12 > len(prompt)
    assert audit_engine(port) == []


@pytest.mark.parametrize("n_max", [6, 3])
def test_radix_hit_equals_miss(weights, margins, n_max):
    """A shared-prefix workload: the radix cache-hit run equals a run
    without the cache under the same compression config, on both
    engines (with compression on, n_max = 3, the streams are lossy, so
    hit ≡ miss is the bar)."""
    shared = list(range(1, 13))
    later = [shared + [40 + i] for i in range(2)]
    (hit, _, _), _ = both(weights, shared + [30], later, 10, 10,
                          knobs=dict(n_max=n_max))
    assert all(r["n_cached"] >= 12 for r in hit)
    (miss, _, _), _ = both(weights, shared + [30], later, 10, 10,
                           knobs=dict(n_max=n_max, prefix_caching=False))
    assert [r["output"] for r in hit] == [r["output"] for r in miss]
    assert all(r["n_cached"] == 0 for r in miss)
    if n_max == 3:
        assert any(r["n_compressions"] for r in hit)
        assert margins and min(margins) > MARGIN


def test_cached_prefix_survives_compression(weights, margins):
    """Compressing the request that registered a prefix moves its KV to
    fresh blocks (copy-on-write) and parks the raw originals in the cache;
    the hit is invisible in the tokens."""
    shared = list(range(1, 13))
    (hit, _, _), port = both(weights, shared + [30], [shared + [40]], 25, 8)
    assert port.finished[0].n_compressions > 0
    assert hit[0]["n_cached"] >= 12
    (miss, _, _), _ = both(weights, shared + [30], [shared + [40]], 25, 8,
                           knobs=dict(prefix_caching=False))
    assert hit[0]["output"] == miss[0]["output"]
    assert margins and min(margins) > MARGIN


def test_compressed_segment_adoption_end_to_end(weights, margins):
    """The JAX package's contract: once the raw chain is invalidated, the
    next same-prompt request adopts the segment, 16 tokens of history for
    8 KV entries, and decodes to completion; both engines agree on the
    stream, pos_gap, n_cached and the cache's counters."""
    prefix = list(range(1, 17))
    (outs, stats, segments), port = both(
        weights, prefix, [prefix + [60, 61, 62]], 10, 8, invalidate=True,
        knobs=dict(cache_compressed_prefixes=True))
    assert segments == 1
    k = port.budget_blocks * port.opts.block_size
    assert outs[0]["pos_gap"] == 16 - k
    assert outs[0]["compressed"] and outs[0]["n_cached"] == 16
    assert len(outs[0]["output"]) == 8
    assert stats["prefix_segment_hits"] >= 1
    assert stats["cached_tokens_per_block"] > port.opts.block_size
    assert margins and min(margins) > MARGIN


def test_segment_adopted_after_watermark_eviction(weights, margins):
    """The production path: under a watermark of 3 unreferenced cached
    blocks, the raw chain of the first prompt is evicted leaf first while
    its segment (newer) stays, so four extensions of the prompt adopt the
    segment; both engines agree."""
    prefix = list(range(1, 17))
    later = [prefix + [60 + i, 70 + i] for i in range(4)]
    (outs, stats, segments), port = both(
        weights, prefix, later, 10, 12,
        knobs=dict(cache_compressed_prefixes=True,
                   prefix_cache_watermark=0.05))
    assert segments == 1
    assert [r["pos_gap"] for r in outs] == [16 - 8] * 4
    assert stats["prefix_segment_hits"] >= 4
    assert stats["cached_tokens_per_block"] > port.opts.block_size
    assert all(r["n_compressions"] > 0 for r in outs)
    assert margins and min(margins) > MARGIN
    assert port.bm.num_free == 64 and len(port.bm.cached_free) <= 3


@pytest.mark.parametrize("knobs", [dict(n_max=None),
                                   dict(prefix_caching=False)])
def test_compressed_prefixes_inert_without_compression_or_cache(weights,
                                                                knobs):
    """As in the JAX engine, the knob is silently inert unless compression
    and the prefix cache are both on."""
    port, ref = engines(weights, cache_compressed_prefixes=True, **knobs)
    assert port.scheduler.p.cache_compressed_prefixes is False
    assert ref.scheduler.p.cache_compressed_prefixes is False
    on, _ = engines(weights, cache_compressed_prefixes=True)
    assert on.scheduler.p.cache_compressed_prefixes is True


def test_api_routes_cache_knobs():
    cache, sched, runner = route_overrides(
        prefix_cache_policy="flat", prefix_cache_watermark=0.5,
        cache_compressed_prefixes=True, policy="cache_aware")
    opts = build_engine_options(cache, sched, runner)
    assert opts.prefix_cache_policy == "flat"
    assert opts.prefix_cache_watermark == 0.5
    assert opts.cache_compressed_prefixes is True
    assert opts.policy == "cache_aware"
