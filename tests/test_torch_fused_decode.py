"""Multi-step fused decode, the unfused decode path and snapshot/restore of
the port's engine, held to the contract of tests/test_fused_decode.py: the
JAX engine's unfused output (``kernel_backend="jnp"``) is the reference,
and the port's engine at ``decode_steps`` 1, 5 and 8 and its unfused path
must give the same tokens and finish reasons, with logprobs within
atol = rtol = 1e-5 (fp32, two frameworks), on tiny-lm at fp32 with that
file's shapes, prompts and greedy + seeded sampling mix.

These prompts compress (n_max = 3 at block 8: a 24-token cap). Survivor
sets are checked before the streams are trusted: at every compression the
engine runs, the JAX package's compress op (``backend="jnp"``) runs on the
same inputs, and the survivors it moves must equal the port's on every live
(layer, request, head) whose k-th vs (k+1)-th final-score margin is above
1e-4 (ROADMAP §C "Survivor near-ties"; 5 of these prompts' 40 streams sit
below it, at 1.4e-5 and up, and are not compared).

CPU only: the chunks run eagerly. ``DecodeGraphs``' launch accounting is
driven here through a stand-in for ``torch.cuda``'s graph API; the graphs
themselves run in tests/test_torch_gpu.py and chip_smoke.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.compression import CompressOptions as JCompress
from repro.core.compression import build_compress_fn as jbuild
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import ZipageEngine as JEngine
from repro.core.engine import _fused_chunk_sizes as j_chunk_sizes
from repro.core.sampling import SamplingParams as JSP
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression, decode_graphs
from repro_torch.core.compression import CompressOptions
from repro_torch.core.engine import EngineOptions, ZipageEngine, \
    _fused_chunk_sizes
from repro_torch.core.sampling import SamplingParams
from repro_torch.kernels import native

TOL = 1e-5
MARGIN = 1e-4
SHAPES = dict(block_size=8, n_total_blocks=64, max_batch=4, m_qslots=4,
              n_max=3, window=4, max_model_len=256, prefill_rows=2,
              prefill_len=64)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [10, 11, 12, 13, 14, 15, 16],
           [20, 21]]
MIXED = [dict(max_new_tokens=28),
         dict(max_new_tokens=28, temperature=0.8, top_k=5, seed=7),
         dict(max_new_tokens=28, temperature=1.1, top_p=0.9, seed=3),
         dict(max_new_tokens=28, temperature=0.7, seed=11, logprobs=True)]
MODES = {"unfused": dict(fuse_sampling=False), "k1": dict(decode_steps=1),
         "k5": dict(decode_steps=5), "k8": dict(decode_steps=8)}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jget_config("tiny-lm"), dtype="float32")
    jparams = jlm.init(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, params_from_numpy(get_config("tiny-lm"), tree)


def jax_unfused(weights, sps):
    jcfg, jparams, _ = weights
    eng = JEngine(jcfg, jparams, JOptions(
        **SHAPES, compress=JCompress(window=4), kernel_backend="jnp",
        fuse_sampling=False))
    rids = [eng.add_request(p, JSP(**sp)) for p, sp in zip(PROMPTS, sps)]
    done = eng.run(max_steps=500)
    return [(done[r].output, done[r].logprobs, done[r].finish_reason)
            for r in rids]


@pytest.fixture(scope="module")
def ref(weights):
    """The JAX engine's unfused output on the MIXED requests."""
    return jax_unfused(weights, MIXED)


@pytest.fixture
def margins(monkeypatch):
    """The k-th vs (k+1)-th final-score margins (n_live, h) of each layer
    of every compression the port runs, in call order."""
    seen = []
    select = compression._select_survivors

    def recording(cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                  hist_lens, T):
        out = select(cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                     hist_lens, T)
        final = out[3]                                   # (n, T, h)
        top = torch.sort(final, dim=1, descending=True)[0]
        seen.append(top[:, k_keep - 1] - top[:, k_keep])
        return out

    monkeypatch.setattr(compression, "_select_survivors", recording)
    return seen


def make_engine(weights, **kw):
    _, _, tparams = weights
    opts = dict(SHAPES, compress=CompressOptions(window=4))
    opts.update(kw)
    return ZipageEngine(get_config("tiny-lm"), tparams,
                        EngineOptions(**opts), device="cpu")


def run_port(weights, sps=MIXED, **kw):
    eng = make_engine(weights, **kw)
    rids = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(PROMPTS, sps)]
    done = eng.run(max_steps=500)
    return [(done[r].output, done[r].logprobs, done[r].finish_reason)
            for r in rids], eng


def assert_same(got, want):
    for (gt, glp, gf), (wt, wlp, wf) in zip(got, want):
        assert gt == wt
        assert gf == wf
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)




@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_the_jax_unfused_engine(weights, ref, margins, mode):
    got, eng = run_port(weights, **MODES[mode])
    assert margins, "no compression ran"
    assert_same(got, ref)
    assert any(lp for _, lp, _ in got)               # logprobs compared
    k = eng.opts.decode_steps
    if k > 1:
        assert max(m["decode_horizon"] for m in eng.metrics) > 1
        assert eng.step_count < 40                   # multi-step engaged
    assert all(m["decode_horizon"] <= k for m in eng.metrics)
    assert sum(m["n_compressing"] for m in eng.metrics) > 0
    eng.bm.check_invariants()
    assert eng.bm.num_free == eng.opts.n_total_blocks


@pytest.mark.parametrize("mode", ["unfused", "k1", "k8"])
def test_eos_mid_horizon(weights, ref, margins, mode):
    """An eos sampled inside a chunk stops the stream at the same token
    as the JAX unfused engine (the in-chunk active-mask gating)."""
    base = ref[0][0]
    eos = base[len(base) // 2]
    sps = [dict(MIXED[0], eos_ids=(eos,))] + MIXED[1:]
    want = jax_unfused(weights, sps)
    assert want[0][2] == "stop" and len(want[0][0]) < len(base)
    got, _ = run_port(weights, sps, **MODES[mode])
    assert margins, "no compression ran"
    assert_same(got, want)


def test_stop_sequences_pin_the_horizon(weights, ref, margins):
    """Host-side stop matching caps that request at one token a step; the
    output (truncated at the stop) equals the JAX unfused engine's, and
    the batch's horizon opens again once it finishes."""
    base = ref[0][0]
    sps = [dict(MIXED[0], stop=(tuple(base[10:12]),))] + MIXED[1:]
    want = jax_unfused(weights, sps)
    assert want[0][2] == "stop"
    got, eng = run_port(weights, sps, decode_steps=8)
    assert margins, "no compression ran"
    assert_same(got, want)
    assert any(m["decode_horizon"] > 1 for m in eng.metrics)


def test_survivors_match_jax_where_the_margin_is_clear(weights, margins):
    """Every compression of a K = 8 serve, replayed through the JAX
    package's compress op on the same pools, windows and plan: the K and
    V it moves into the destination blocks equal the port's, bit for bit,
    on each live (layer, request, head) whose margin is above MARGIN."""
    jcfg = weights[0]
    eng = make_engine(weights, decode_steps=8)
    calls = []
    build = eng._compress_fn

    def recording(width):
        fn = build(width)

        def compress(pools, qwin, req):
            before = {k: v.clone() for k, v in pools.items()}
            q = qwin.clone()
            out = fn(pools, qwin, req)
            calls.append((width, before, q, [a.clone() for a in req],
                          {k: v.clone() for k, v in pools.items()}))
            return out
        return compress

    eng._compress_fn = recording
    for p, sp in zip(PROMPTS, MIXED):
        eng.add_request(p, SamplingParams(**sp))
    eng.run(max_steps=500)
    L = jcfg.num_layers
    assert calls and len(margins) == L * len(calls)
    compared = total = 0
    for c, (width, before, qwin, req, after) in enumerate(calls):
        jfn = jbuild(jcfg, block_size=SHAPES["block_size"],
                     max_blocks=width, budget_blocks=eng.budget_blocks,
                     opts=JCompress(window=4, backend="jnp"))
        jpools, _, _ = jfn({k: v[:, :-1].numpy() for k, v in before.items()},
                           qwin[:, :-1].numpy(),
                           tuple(a.numpy() for a in req))
        _, dest, qslots, _, _ = (a.numpy() for a in req)
        for i in np.flatnonzero(qslots >= 0):
            for l in range(L):
                for h in range(jcfg.num_kv_heads):
                    total += 1
                    if not float(margins[c * L + l][i, h]) > MARGIN:
                        continue
                    compared += 1
                    for key in ("k", "v"):
                        np.testing.assert_array_equal(
                            after[key][l, dest[i], :, h].numpy(),
                            np.asarray(jpools[key])[l, dest[i], :, h])
    assert compared >= 0.75 * total, (compared, total)


def _buffers(eng):
    out = {f"dec.{k}": v for k, v in eng._dec.items()}
    for k, v in eng.state.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            out[f"state.{k}.{kk}"] = vv
    return {k: v.data_ptr() for k, v in out.items()}


def test_snapshot_restore_mid_horizon(weights, ref):
    """A snapshot between multi-step chunks restores into a fresh engine,
    into its existing buffers, and continues with identical streams."""
    eng = make_engine(weights, decode_steps=8)
    rids = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(PROMPTS, MIXED)]
    for _ in range(3):
        eng.step()
    assert any(len(r.output) for r in eng.running)   # genuinely mid-stream
    assert any(m["decode_horizon"] > 1 for m in eng.metrics)
    snap = eng.snapshot()
    done_a = eng.run(max_steps=500)
    eng2 = make_engine(weights, decode_steps=8)
    before = _buffers(eng2)
    eng2.restore(snap)
    assert _buffers(eng2) == before
    assert eng2.snapshot()["device"]["pools"]["k"].equal(
        snap["device"]["pools"]["k"])
    done_b = eng2.run(max_steps=500)
    assert _buffers(eng2) == before                  # pushes copy too
    out_a = [(done_a[r].output, done_a[r].logprobs, done_a[r].finish_reason)
             for r in rids]
    out_b = [(done_b[r].output, done_b[r].logprobs, done_b[r].finish_reason)
             for r in rids]
    assert out_a == out_b
    assert_same(out_b, ref)


@pytest.mark.parametrize("src,dst", [("unfused", "k8"), ("k8", "unfused")])
def test_restore_across_modes(weights, src, dst):
    """A snapshot taken under one decode mode resumes identically under
    the other: every device mirror is invalidated on restore."""
    eng = make_engine(weights, **MODES[src])
    rids = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(PROMPTS, MIXED)]
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    done_a = eng.run(max_steps=500)
    eng2 = make_engine(weights, **MODES[dst])
    eng2.restore(snap)
    done_b = eng2.run(max_steps=500)
    assert [done_b[r].output for r in rids] == [done_a[r].output
                                                for r in rids]


def test_restore_refuses_another_engine_shape(weights):
    snap = make_engine(weights).snapshot()
    with pytest.raises(ValueError, match="shape"):
        make_engine(weights, max_batch=2).restore(snap)


def test_fused_chunk_sizes_match_jax():
    for k in range(1, 33):
        sizes = _fused_chunk_sizes(k)
        assert sizes == j_chunk_sizes(k)
        assert sum(sizes) == k
        assert all(s & (s - 1) == 0 for s in sizes)
        if k >= 4:
            assert len(sizes) >= 2       # pipelined fetch has two chunks
    assert _fused_chunk_sizes(8) == [4, 4]


def test_engine_properties_match_jax(weights):
    """free_slots, free_qslots, admission_scale and _ewma are the
    scheduler's, as in the JAX engine, step by step."""
    jcfg, jparams, _ = weights
    jeng = JEngine(jcfg, jparams, JOptions(
        **SHAPES, compress=JCompress(window=4), kernel_backend="jnp"))
    teng = make_engine(weights)
    for name in ("free_slots", "free_qslots", "admission_scale", "_ewma"):
        assert getattr(teng, name) == getattr(jeng, name), name
    for p, sp in zip(PROMPTS, MIXED):
        jeng.add_request(p, JSP(**sp))
        teng.add_request(p, SamplingParams(**sp))
    for _ in range(4):
        jeng.step()
        teng.step()
        assert teng.free_slots == jeng.free_slots
        assert teng.free_qslots == jeng.free_qslots
        assert teng.free_slots is teng.scheduler.free_slots
        assert teng.admission_scale == teng.scheduler.admission_scale
        assert 0.25 <= teng.admission_scale <= 1.0
        assert teng._ewma == teng.scheduler.ewma is not None
    for eng in (jeng, teng):             # the setter writes the scheduler's
        eng._ewma = 0.125
        assert eng.scheduler.ewma == 0.125


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: the capture runs
    the function once, and a replay runs it again into the same output
    tensors."""

    capturing = None

    def __init__(self):
        self.fn = self.out = None

    def replay(self):
        for dst, src in zip(self.out, self.fn()):
            dst.copy_(src)


class _FakeGraphContext:
    def __init__(self, graph, pool=None, capture_error_mode="global"):
        self.graph = graph
        self.mode = capture_error_mode

    def __enter__(self):
        _FakeGraph.capturing = self.graph
        if self.graph is not None:
            self.graph.mode = self.mode

    def __exit__(self, *exc):
        _FakeGraph.capturing = None


def test_graph_replays_count_the_captured_launches(monkeypatch):
    """Warm-up and capture calls add no launch; every replay adds the
    launches made during its capture; the caps read zero while the graph
    is being captured and are restored afterwards."""
    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    cuda = torch.cuda
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: (0, 0))
    monkeypatch.setattr(cuda, "Stream", Stream)
    monkeypatch.setattr(cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(cuda, "stream", lambda s: _FakeGraphContext(None))
    monkeypatch.setattr(cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(cuda, "graph", _FakeGraphContext)
    caps = torch.tensor([3, 1], dtype=torch.int32)
    seen_caps = []

    def run(k, greedy):
        seen_caps.append(caps.tolist())
        for _ in range(k):
            native.count_launch("ragged_paged_attention")
        native.count_launch("paged_score")
        out = (torch.full((k, 2), 7), torch.zeros(k, 2))
        g = _FakeGraph.capturing
        if g is not None:
            g.fn = lambda: (torch.full((k, 2), 7), torch.ones(k, 2))
            g.out = out
        return out

    native.reset_launch_counts()
    graphs = decode_graphs.DecodeGraphs(run, caps)
    graphs.capture(4, True, 1)
    # the async loop's worker thread captures while the event loop's
    # thread serves: a capture is confined to its thread
    assert graphs.graphs[(4, True, 1)][0].mode == "thread_local"
    assert all(n == 0 for n in native.launch_counts.values())
    assert seen_caps == [[0, 0]] * (decode_graphs.WARMUP_CALLS + 1)
    assert caps.tolist() == [3, 1]
    assert graphs.launches() == {(4, True, 1): {
        "ragged_paged_attention": 4, "paged_score": 1}}
    tok, _ = graphs.replay(4, True, 1)
    tok, lp = graphs.replay(4, True, 1)
    assert tok.shape == (4, 2) and (tok == 7).all() and (lp == 1).all()
    assert native.launch_counts["ragged_paged_attention"] == 2 * 4
    assert native.launch_counts["paged_score"] == 2
    assert graphs.replays == 2
    with pytest.raises(RuntimeError, match="no decode graph"):
        graphs.replay(2, True, 1)
    graphs.recapture(2)
    assert set(graphs.graphs) == {(4, True, 2)}
    native.reset_launch_counts()


def test_capture_runs_with_the_cyclic_collector_off(monkeypatch):
    """A graph captured while the garbage collector may run can be
    invalidated by a dead engine's graph being destroyed mid-capture: the
    collector is off during the capture, and on again after it (also when
    the capture raises)."""
    import gc
    seen = []

    class Context(_FakeGraphContext):
        def __enter__(self):
            seen.append(gc.isenabled())

    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    cuda = torch.cuda
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: (0, 0))
    monkeypatch.setattr(cuda, "Stream", Stream)
    monkeypatch.setattr(cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(cuda, "stream", lambda s: _FakeGraphContext(None))
    monkeypatch.setattr(cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(cuda, "graph", Context)
    calls = []

    def run(k, greedy):
        calls.append(gc.isenabled())
        if greedy is None and not gc.isenabled():
            raise RuntimeError("capture failed")
        return torch.zeros(k, 2), torch.zeros(k, 2)

    graphs = decode_graphs.DecodeGraphs(run, torch.zeros(2, dtype=torch.int32))
    assert gc.isenabled()
    graphs.capture(1, True, 1)
    assert seen == [False] and calls[-1] is False
    assert calls[:decode_graphs.WARMUP_CALLS] == [True] * 3
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.capture(1, None, 1)
    assert gc.isenabled()
