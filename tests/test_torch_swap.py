"""The port's host swap tier, held to the contract of tests/test_swap.py and
against the JAX engine on the same tiny-lm weights
(``convert.params_from_numpy``), at that file's tight shapes: 10 blocks of
8 for 4 requests that want about 4 blocks each, so preemption fires.

Swap-mode preemption must be invisible in the token streams: a victim's
KV and observation window are parked in the host swap pool and restored
bit for bit. So within the port recompute, swap, auto and an ample pool
give the same tokens and logprobs bit for bit, at ``decode_steps`` 1 and
8 and unfused; against the JAX engine's swap run the tokens are equal and
the logprobs within atol = rtol = 1e-5 (fp32, two frameworks).

These prompts compress (n_max = 3 at block 8). The k-th vs (k+1)-th
survivor margins of every compression the port runs are recorded and
must stay above MARGIN before the streams are compared (ROADMAP §C
"Survivor near-ties"). Every port engine audits its whole state after
each step (the sanitizer, with its swap-pool check).

The scheduler units of tests/test_swap.py run on the port's scheduler
and the JAX package's, on the same ops, with equal results.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.block_manager import BlockManager as JBlockManager
from repro.core.compression import CompressOptions as JCompress
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import ZipageEngine as JEngine
from repro.core.request import Request as JRequest
from repro.core.sampling import SamplingParams as JSP
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import SchedulerParams as JSchedulerParams
from repro.models import lm as jlm
from repro_torch.api import SamplingParams as ApiSamplingParams
from repro_torch.api import Zipage
from repro_torch.api.config import build_engine_options, route_overrides
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression, invariants, paged, serve_model
from repro_torch.core.block_manager import BlockManager
from repro_torch.core.compression import CompressOptions
from repro_torch.core.engine import EngineOptions, ZipageEngine
from repro_torch.core.request import Request, State
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.scheduler import Scheduler, SchedulerParams

TOL = 1e-5
MARGIN = 1e-6
TIGHT = dict(block_size=8, n_total_blocks=10, max_batch=4, m_qslots=4,
             n_max=3, window=4, max_model_len=256, prefill_rows=2,
             prefill_len=64)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [10, 11, 12, 13, 14, 15, 16],
           [20, 21]]
MIXED = [dict(max_new_tokens=28),
         dict(max_new_tokens=28, temperature=0.8, top_k=5, seed=7),
         dict(max_new_tokens=28, temperature=1.1, top_p=0.9, seed=3),
         dict(max_new_tokens=28, temperature=0.7, seed=11, logprobs=True)]
MODES = {"recompute": dict(preemption_mode="recompute"),
         "swap": dict(preemption_mode="swap", swap_space_blocks=24),
         "auto": dict(preemption_mode="auto", swap_space_blocks=24),
         "ample": dict(n_total_blocks=64)}
DECODE = {"k1": {}, "k8": dict(decode_steps=8),
          "unfused": dict(fuse_sampling=False)}


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
    the port runs, in call order."""
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


def make_engine(weights, **kw):
    opts = dict(TIGHT, compress=CompressOptions(window=4))
    opts.update(kw)
    return ZipageEngine(get_config("tiny-lm"), weights[2],
                        EngineOptions(**opts), device="cpu")


def make_jax_engine(weights, **kw):
    jcfg, jparams, _ = weights
    opts = dict(TIGHT, compress=JCompress(window=4))
    opts.update(kw)
    return JEngine(jcfg, jparams, JOptions(**opts))


def total(eng, key):
    return sum(m[key] for m in eng.metrics)


def streams(done, rids):
    return [(done[r].output, done[r].logprobs) for r in rids]


def run_port(weights, **kw):
    eng = make_engine(weights, **kw)
    rids = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(PROMPTS, MIXED)]
    return streams(eng.run(max_steps=2000), rids), eng


@pytest.fixture(scope="module")
def jax_swap(weights):
    """The JAX engine's streams under swap preemption at TIGHT."""
    eng = make_jax_engine(weights, **MODES["swap"])
    rids = [eng.add_request(p, JSP(**sp)) for p, sp in zip(PROMPTS, MIXED)]
    out = streams(eng.run(max_steps=2000), rids)
    assert total(eng, "n_swapped_out") > 0
    return out


@pytest.fixture(scope="module")
def port_ample(weights):
    return run_port(weights, **MODES["ample"])[0]


def assert_close_to(got, want):
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)


def assert_drained(eng):
    bm = eng.bm
    bm.check_invariants()
    assert bm.num_free == eng.opts.n_total_blocks
    assert len(bm.swap_free) == eng.opts.swap_space_blocks
    assert bm.swapped == {} and not eng.scheduler.swapped
    assert eng._swap_qwin == {}


# ----------------------------------------------------------------------
# token-stream parity under forced preemption


@pytest.mark.parametrize("decode", list(DECODE))
@pytest.mark.parametrize("mode", list(MODES))
def test_modes_give_one_stream_equal_to_jax(weights, jax_swap, port_ample,
                                            margins, mode, decode):
    """recompute ≡ swap ≡ auto ≡ an ample pool, tokens and logprobs bit
    for bit within the port, at K = 1, K = 8 and unfused; equal to the
    JAX engine's swap streams. The tight runs preempt; swap moves blocks
    both ways; nothing leaks."""
    got, eng = run_port(weights, **MODES[mode], **DECODE[decode])
    assert margins and min(margins) > MARGIN, min(margins)
    assert got == port_ample
    assert_close_to(got, jax_swap)
    assert any(lp for _, lp in got)
    if mode == "ample":
        assert total(eng, "n_preempted") == 0
        return
    assert total(eng, "n_preempted") > 0
    assert total(eng, "n_swapped_out") == total(eng, "n_swapped_in")
    if mode != "auto":                # auto picks per victim
        assert (total(eng, "n_swapped_out") > 0) == (mode == "swap")
    if decode == "k8":
        assert max(m["decode_horizon"] for m in eng.metrics) > 1
    assert_drained(eng)


def test_swap_telemetry_and_accounting(weights):
    _, eng = run_port(weights, **MODES["swap"])
    assert_drained(eng)
    block = eng._kv_block_bytes()
    assert block == eng.scheduler.p.block_bytes > 0
    moved = total(eng, "n_swapped_out") + total(eng, "n_swapped_in")
    # each direction moves the victim's blocks once
    assert eng.metrics[-1]["swap_bytes"] % block == 0
    assert eng.metrics[-1]["swap_bytes"] >= moved * block
    assert 0.0 <= eng.metrics[-1]["swap_util"] <= 1.0


def test_swap_pool_is_block_major_and_plain_on_the_cpu(weights):
    eng = make_engine(weights, **MODES["swap"])
    for k, leaf in eng.state["pools"].items():
        host = eng.swap_pool[k]
        assert host.device.type == "cpu" and not host.is_pinned()
        assert host.shape == (24, leaf.shape[0]) + tuple(leaf.shape[2:])
        assert host.dtype == leaf.dtype


def test_restored_window_and_blocks_are_the_parked_bits(weights):
    """A swap-out followed by its swap-in restores every layer's blocks
    of all three pool leaves and the observation-window row bit for bit,
    into other blocks and another query slot."""
    eng = make_engine(weights, **MODES["swap"])
    gen = torch.Generator().manual_seed(3)
    for leaf in eng.state["pools"].values():
        leaf.normal_(generator=gen)
    eng.state["qwin"].normal_(generator=gen)
    r = Request(rid=7, prompt=[1, 2, 3], max_new_tokens=4)
    r.blocks, r.slot, r.qslot, r.output = [4, 2, 3, 7], 1, 2, [5, 9]
    r.n_prefilled = r.prefill_target = 3
    src = {k: v[:, r.blocks].clone() for k, v in eng.state["pools"].items()}
    win = eng.state["qwin"][:, 2].clone()
    eng._swap_out_blocks(r, r.blocks, [5, 6, 0, 1])
    for k, host in eng.swap_pool.items():
        assert torch.equal(host[[5, 6, 0, 1]].transpose(0, 1), src[k])
    r.slot, r.qslot = 3, 0
    assert eng._swap_in_blocks(r, [5, 6, 0, 1], [8, 0, 9, 1])
    for k, v in eng.state["pools"].items():
        assert torch.equal(v[:, [8, 0, 9, 1]], src[k])
    assert torch.equal(eng.state["qwin"][:, 0], win)
    assert eng.tokens_next[3] == 9 and eng._tokens_dirty
    assert eng._swap_qwin == {}


def test_block_copies_match_jax():
    """``paged.gather_kv_blocks`` / ``scatter_kv_blocks`` against the JAX
    package's on the same pool: a -1 id reads page 0 on the gather side;
    on the scatter side JAX drops it, the port writes the sink page."""
    from repro.core import paged as jpaged
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(3, 7, 4, 2, 8)).astype(np.float32)
    ids = np.array([5, -1, 2, 0], np.int32)
    got = paged.gather_kv_blocks(torch.from_numpy(pool), torch.from_numpy(ids))
    want = np.asarray(jpaged.gather_kv_blocks(pool, ids))
    np.testing.assert_array_equal(got.numpy(), want)
    vals = rng.normal(size=(3, 4, 4, 2, 8)).astype(np.float32)
    port = torch.from_numpy(np.concatenate([pool, pool[:, :1]], 1))
    paged.scatter_kv_blocks(port, torch.from_numpy(ids), torch.from_numpy(vals))
    want = np.asarray(jpaged.scatter_kv_blocks(jax.numpy.asarray(pool), ids,
                                               vals))
    np.testing.assert_array_equal(port[:, :-1].numpy(), want)
    np.testing.assert_array_equal(port[:, -1].numpy(), vals[:, 1])


def test_swap_steps_round_trip_block_major():
    cfg = get_config("tiny-lm")
    spec = serve_model.ServeSpec(n_slots=2, block_size=4, max_blocks=4,
                                 n_total_blocks=6, m_qslots=2, window=2)
    st = serve_model.make_state(cfg, spec, "cpu")
    for leaf in st["pools"].values():
        leaf.uniform_()
    ids = torch.tensor([3, 1])
    out = serve_model.build_swap_out_step(cfg, spec)(st["pools"], ids)
    for k, v in out.items():
        assert v.is_contiguous() and v.shape[:2] == (2, cfg.num_layers)
        assert torch.equal(v.transpose(0, 1), st["pools"][k][:, [3, 1]])
    ptrs = {k: v.data_ptr() for k, v in st["pools"].items()}
    serve_model.build_swap_in_step(cfg, spec)(st["pools"],
                                              torch.tensor([0, -1]), out)
    assert ptrs == {k: v.data_ptr() for k, v in st["pools"].items()}
    for k, v in st["pools"].items():
        assert torch.equal(v[:, 0], out[k][0])
        assert torch.equal(v[:, -1], out[k][1])       # -1: the sink page


# ----------------------------------------------------------------------
# scheduler units of tests/test_swap.py, on both schedulers


PKGS = {"port": (Scheduler, SchedulerParams, BlockManager, Request),
        "jax": (JScheduler, JSchedulerParams, JBlockManager, JRequest)}


def make_swap_sched(pkg, n_blocks=16, block_size=4, swap_blocks=8,
                    prefix_ok=False, **kw):
    S, P, BM, _ = PKGS[pkg]
    base = dict(block_size=block_size, max_batch=4, m_qslots=4, n_max=3,
                window=2, prefill_rows=4, compression_enabled=True,
                budget_blocks=2, prefix_ok=prefix_ok,
                preemption_mode="swap", block_bytes=100)
    base.update(kw)
    s = S(P(**base), BM(n_blocks, block_size, enable_prefix_cache=prefix_ok,
                        swap_space_blocks=swap_blocks))
    log = []
    s.swap_executor = lambda r, src, dst: log.append(
        ("out", r.rid, list(src), list(dst)))
    s.swap_in_executor = lambda r, src, dst: log.append(
        ("in", r.rid, list(src), list(dst)))
    return s, log


def waiting_request(pkg, rid, n_prompt, n_out):
    return PKGS[pkg][3](rid=rid, prompt=list(range(1, n_prompt + 1)),
                        max_new_tokens=n_out, arrival=float(rid))


def _running(pkg, s, rid, n_prompt, n_out, n_blocks, **attrs):
    r = waiting_request(pkg, rid, n_prompt, n_out)
    r.blocks = s.bm.allocate(n_blocks)
    r.state = type(r.state).RUNNING
    for k, v in attrs.items():
        setattr(r, k, v)
    return r


def auto_cost_model(pkg):
    s, _ = make_swap_sched(pkg, preemption_mode="auto")
    short = _running(pkg, s, 0, 8, 4, 2)
    compressed = _running(pkg, s, 1, 8, 40, 3, compressed=True,
                          output=list(range(30)))
    out = [s._preempt_mode(short), s._preempt_mode(compressed)]
    s.swap_executor = None
    out.append(s._preempt_mode(compressed))
    s2, _ = make_swap_sched(pkg, preemption_mode="swap")
    r = _running(pkg, s2, 0, 8, 4, 2)
    out.append(s2._preempt_mode(r))
    s2.bm.swap_free = []
    out.append(s2._preempt_mode(r))
    return out


def test_auto_cost_model_picks_per_victim():
    """auto: a compressed victim (few blocks, long history) swaps, a short
    uncompressed one recomputes (a tie recomputes); swap degrades to
    recompute without an executor or with a full host pool."""
    got = auto_cost_model("port")
    assert got == auto_cost_model("jax")
    assert got == ["recompute", "swap", "recompute", "swap", "recompute"]


def swap_cycle(pkg):
    s, log = make_swap_sched(pkg, n_blocks=16, prefix_ok=True)
    a = waiting_request(pkg, 0, 8, 20)
    b = waiting_request(pkg, 1, 8, 20)
    s.add_request(a)
    s.add_request(b)
    plan = s.schedule()
    assert len(plan.admitted) == 2 and b.n_shared == 2
    shared = list(a.blocks)
    refs = [[s.bm.ref[blk] for blk in shared]]
    for r in (a, b):
        r.n_prefilled = r.prefill_target
        r.output = [1]
    s._swap_out(a, None)
    assert a.state.name == "SWAPPED" and a.blocks == []
    refs.append([s.bm.ref[blk] for blk in shared])
    s.bm.check_invariants()
    plan2 = s.schedule()
    assert plan2.swapped_in == [a] and a.state.name == "RUNNING"
    assert set(a.blocks).isdisjoint(shared)
    assert all(blk in s.bm.block_hash for blk in shared)
    refs.append([s.bm.ref[blk] for blk in a.blocks + shared])
    s.bm.check_invariants()
    return log, refs, (s.n_swapped_out, s.n_swapped_in, s.swap_bytes,
                       s.bm.swapped, len(s.swapped))


def test_swap_cycle_preserves_prefix_cache_refcounts():
    """Shared prefix blocks are copy-on-swap: a sharer's swap-out drops
    only its own reference, and its swap-in restores private copies."""
    got = swap_cycle("port")
    assert got == swap_cycle("jax")
    log, refs, counters = got
    assert refs == [[2, 2], [1, 1], [1, 1, 1, 1]]
    assert [e[0] for e in log] == ["out", "in"]
    assert counters == (1, 1, 400, {}, 0)


def swapped_queue_blocks_admission(pkg):
    s, _ = make_swap_sched(pkg, n_blocks=8)
    v = waiting_request(pkg, 0, 8, 20)
    s.add_request(v)
    assert s.schedule().admitted == [v]
    v.n_prefilled = v.prefill_target
    s._swap_out(v, None)
    s.bm.allocate(s.bm.num_free)
    s.add_request(waiting_request(pkg, 1, 4, 4))
    plan = s.schedule()
    return plan.admitted, plan.swapped_in, s.has_work()


def test_swapped_queue_blocks_fresh_admission():
    got = swapped_queue_blocks_admission("port")
    assert got == swapped_queue_blocks_admission("jax") == ([], [], True)


def test_scheduler_abort_of_swapped_request_releases_host_blocks():
    for pkg in PKGS:
        s, _ = make_swap_sched(pkg)
        r = waiting_request(pkg, 0, 8, 20)
        s.add_request(r)
        s.schedule()
        r.n_prefilled = r.prefill_target
        s._swap_out(r, None)
        assert s.bm.swap_util > 0
        assert s.abort(r.rid) is r
        assert s.bm.swapped == {} and not s.swapped
        assert s.bm.swap_util == 0.0
        s.bm.check_invariants()


# ----------------------------------------------------------------------
# engine level: abort, snapshot/restore, the leak property


FIVE = [[30 + i, 2, 3, 4, 5] for i in range(5)]


def boot(make, sp_cls, weights, **kw):
    eng = make(weights, **MODES["swap"], prefix_caching=False, **kw)
    rids = [eng.add_request(p, sp_cls(max_new_tokens=30)) for p in FIVE]
    return eng, rids


def step_until_swapped(eng):
    for _ in range(400):
        eng.step()
        if eng.scheduler.swapped:
            return
    raise AssertionError("never caught a non-empty swapped queue")


@pytest.fixture(scope="module")
def jax_five(weights):
    eng, rids = boot(make_jax_engine, JSP, weights)
    return [out for out, _ in streams(eng.run(max_steps=2000), rids)]


@pytest.mark.parametrize("decode", ["k1", "k8"])
def test_snapshot_restore_with_nonempty_swapped_queue(weights, jax_five,
                                                      margins, decode):
    """A snapshot taken while a request's KV is parked on the host
    restores into a fresh engine, into its own buffers and host pool, and
    the streams equal the uninterrupted run's and the JAX engine's."""
    eng, rids = boot(make_engine, SamplingParams, weights, **DECODE[decode])
    step_until_swapped(eng)
    snap = eng.snapshot()
    assert snap["requests"]["swapped"] and snap["swap_qwin"]
    assert snap["host"]["n_swapped_out"] > 0
    done_a = eng.run(max_steps=2000)
    eng2, _ = boot(make_engine, SamplingParams, weights, **DECODE[decode])
    pool = {k: v.data_ptr() for k, v in eng2.swap_pool.items()}
    eng2.restore(snap)
    assert pool == {k: v.data_ptr() for k, v in eng2.swap_pool.items()}
    assert torch.equal(eng2.swap_pool["k"], snap["swap_pool"]["k"])
    assert eng2.scheduler.swapped
    assert eng2.scheduler.n_swapped_out == snap["host"]["n_swapped_out"]
    done_b = eng2.run(max_steps=2000)
    out_a = [done_a[r].output for r in rids]
    assert [done_b[r].output for r in rids] == out_a == jax_five
    assert margins and min(margins) > MARGIN
    assert_drained(eng2)


def test_restore_swap_snapshot_without_swap_tier_degrades(weights):
    """Restored into an engine without a swap tier, the swapped requests
    re-enter as recompute admissions and still finish; their parked
    windows are dropped."""
    eng, rids = boot(make_engine, SamplingParams, weights)
    step_until_swapped(eng)
    snap = eng.snapshot()
    plain = make_engine(weights, prefix_caching=False)
    assert plain.swap_pool is None
    plain.restore(snap)
    assert plain.scheduler.swapped and plain._swap_qwin == {}
    done = plain.run(max_steps=2000)
    assert sorted(done) == sorted(rids)
    assert all(len(done[r].output) == 30 for r in rids)
    plain.bm.check_invariants()
    assert plain.bm.num_free == plain.opts.n_total_blocks


def abort_swapped(make, sp_cls, weights):
    eng, rids = boot(make, sp_cls, weights)
    step_until_swapped(eng)
    victim = eng.scheduler.swapped[0].rid
    assert victim in eng._swap_qwin
    assert eng.abort(victim)
    assert victim not in eng._swap_qwin
    done = eng.run(max_steps=2000)
    return victim, {r: (done[r].finish_reason, done[r].output)
                    for r in rids}, eng


def test_abort_of_a_swapped_request(weights):
    """Aborting a request while its KV is parked frees its host blocks and
    its parked window; the others finish as in the JAX engine."""
    victim, got, eng = abort_swapped(make_engine, SamplingParams, weights)
    jvictim, want, _ = abort_swapped(make_jax_engine, JSP, weights)
    assert victim == jvictim
    assert got == want
    assert got[victim][0] == "abort"
    assert_drained(eng)


def test_quality_stats_reach_a_swapped_request(weights):
    """Compression telemetry drained at the start of a step lands on a
    request that was swapped out since its compression launched."""
    eng = make_engine(weights, **MODES["swap"])
    r = Request(rid=3, prompt=[1], max_new_tokens=1)
    r.state = State.SWAPPED
    eng.scheduler.swapped.append(r)
    eng._pending_quality = ([3], torch.tensor([[0.25, 0.5]]))
    eng._drain_quality_stats()
    assert (r.redundancy, r.attn_entropy) == (0.25, 0.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_swap_pool_accounting_never_leaks(weights, seed):
    """Random oversubscribed workloads under auto mode leave both pools
    full and every queue empty; the finished set equals the JAX
    engine's."""
    def run(make, sp_cls):
        rng = np.random.default_rng(seed)
        eng = make(weights, preemption_mode="auto", swap_space_blocks=16,
                   prefix_caching=bool(seed % 2))
        rids = []
        for _ in range(6):
            p = rng.integers(1, 50, size=int(rng.integers(2, 9))).tolist()
            sp = sp_cls(max_new_tokens=int(rng.integers(8, 30)),
                        temperature=float(rng.choice([0.0, 0.9])),
                        seed=int(rng.integers(0, 100)))
            rids.append(eng.add_request(p, sp))
        done = eng.run(max_steps=3000)
        return eng, {r: len(done[r].output) for r in rids}

    eng, lens = run(make_engine, SamplingParams)
    assert lens == run(make_jax_engine, JSP)[1]
    assert_drained(eng)


# ----------------------------------------------------------------------
# facade


def test_swap_cost_per_token_is_public_config():
    cache, sched, runner = route_overrides(preemption_mode="auto",
                                           swap_space_blocks=8,
                                           swap_cost_per_token=0.125)
    assert sched.swap_cost_per_token == 0.125
    opts = build_engine_options(cache, sched, runner)
    assert opts.swap_cost_per_token == 0.125
    assert opts.swap_space_blocks == 8
    with pytest.raises(ValueError, match="swap_space_blocks"):
        Zipage.from_config("tiny-lm", device="cpu", block_size=8,
                           n_total_blocks=32, preemption_mode="swap")


def test_facade_surfaces_swap_telemetry(weights):
    z = Zipage(get_config("tiny-lm"), weights[2], device="cpu",
               **dict(TIGHT, preemption_mode="swap", swap_space_blocks=24))
    outs = z.generate(PROMPTS, [ApiSamplingParams(max_new_tokens=24)] * 4,
                      max_steps=2000)
    assert all(o.usage.completion_tokens == 24 for o in outs)
    stats = z.scheduler_stats
    for key in ("preemption_mode", "n_swapped_out", "n_swapped_in",
                "n_swapped", "swap_bytes", "swap_util"):
        assert key in stats
    assert stats["preemption_mode"] == "swap"
    assert sum(m["n_swapped_out"] for m in z.metrics) > 0
    assert max(m["swap_bytes"] for m in z.metrics) > 0
