"""The port's host-only modules of A3, held against the JAX package's.

  * ``repro_torch.core.invariants``, the ``ZIPAGE_SANITIZE=1`` sanitizer:
    a healthy run audits clean after every step, and each seeded
    corruption of ``tests/test_invariants.py`` is reported with the same
    message; writes into the sink page and sink query slot are not, nor is
    the window row of a request admitted, prefilled and preempted within
    one step (which the JAX package's audit reports).
    The flag is set through ``monkeypatch.setenv`` only, so no later engine
    of either package in the same worker audits itself.
  * ``repro_torch.core.memory_planner``: equal to the JAX package's at the
    same ``dtype_bytes``, and its per-block bytes those of the port's pools.
  * The port's copy of the scheduler: the JAX package's ``Scheduler`` and
    the port's are driven by the same add / abort / step streams, with the
    engine's host bookkeeping done alike on both sides and the same fixed
    step latencies fed to ``observe_latency`` (a slow wall-clock step
    halves admission, so no clock is read), and their ``SchedulerOutputs``,
    stats and per-request state must be equal at every step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import block_manager as jbm
from repro.core import memory_planner as jmp
from repro.core import request as jreq
from repro.core import sampling as jsampling
from repro.core import scheduler as jsched
from repro_torch.api import SamplingParams
from repro_torch.configs import get_config
from repro_torch.core import block_manager as tbm
from repro_torch.core import invariants
from repro_torch.core import memory_planner as tmp
from repro_torch.core import request as treq
from repro_torch.core import sampling as tsampling
from repro_torch.core import scheduler as tsched
from repro_torch.core.compression import CompressOptions
from repro_torch.core.engine import EngineOptions, ZipageEngine
from repro_torch.core.request import State
from repro_torch.models import lm

CFG = get_config("tiny-lm")
PARAMS = lm.init(CFG, torch.Generator().manual_seed(0), "cpu")
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [10, 11, 12, 13, 14, 15, 16],
           [20, 21]]


def make_engine(**kw):
    base = dict(block_size=8, n_total_blocks=64, max_batch=4, m_qslots=2,
                n_max=3, window=4, max_model_len=256, prefill_rows=2,
                prefill_len=64, compress=CompressOptions(window=4),
                temperature=0.0)
    base.update(kw)
    return ZipageEngine(CFG, PARAMS, EngineOptions(**base), device="cpu")


def submit(eng, prompt, n):
    return eng.add_request(prompt, SamplingParams(
        temperature=eng.opts.temperature, seed=eng._default_seed(),
        max_new_tokens=n))


def running_engine(steps=3, **kw):
    eng = make_engine(**kw)
    for p in PROMPTS:
        submit(eng, p, 24)
    for _ in range(steps):
        eng.step()
    assert eng.running, "fixture expects live requests"
    return eng


# ----------------------------------------------------------------------
# the flag and the per-step hook


def test_enabled_parses_env(monkeypatch):
    for v, want in (("1", True), ("true", True), ("ON", True),
                    ("0", False), ("", False)):
        monkeypatch.setenv("ZIPAGE_SANITIZE", v)
        assert invariants.enabled() is want
    monkeypatch.delenv("ZIPAGE_SANITIZE")
    assert invariants.enabled() is False


def test_engine_reads_the_flag_and_audits_every_step(monkeypatch):
    monkeypatch.setenv("ZIPAGE_SANITIZE", "1")
    eng = make_engine(n_max=3, m_qslots=4)
    monkeypatch.delenv("ZIPAGE_SANITIZE")
    assert eng.sanitize is True and make_engine().sanitize is False
    audits = []
    check = invariants.check_engine
    monkeypatch.setattr(invariants, "check_engine",
                        lambda e: audits.append(e.step_count) or check(e))
    for p in PROMPTS:
        submit(eng, p, 30)
    done = eng.run(max_steps=500)
    assert all(len(r.output) == 30 for r in done.values())
    assert sum(r.n_compressions for r in done.values()) > 0
    assert audits == list(range(1, eng.step_count + 1))


def test_healthy_run_audits_clean_every_step():
    eng = make_engine(n_max=3, m_qslots=4)
    for p in PROMPTS:
        submit(eng, p, 30)
    while eng.scheduler.has_work():
        eng.step()
        assert invariants.audit_engine(eng) == []
        assert eng.step_count < 500
    eng.bm.check_invariants()


def test_step_hook_raises_when_armed():
    eng = running_engine()
    eng.sanitize = True                        # as if ZIPAGE_SANITIZE=1
    eng.bm.release([next(r for r in eng.running if r.blocks).blocks[0]])
    with pytest.raises(invariants.InvariantViolation,
                       match="double-free|more than once|holder"):
        eng.step()


def test_step_hook_quiet_when_disarmed(monkeypatch):
    monkeypatch.delenv("ZIPAGE_SANITIZE", raising=False)
    eng = running_engine()
    assert eng.sanitize is False
    eng.bm.release([next(r for r in eng.running if r.blocks).blocks[0]])
    eng.step()                                 # no raise


# ----------------------------------------------------------------------
# seeded corruptions (tests/test_invariants.py, on the port's engine)


def test_double_free_is_detected():
    eng = running_engine()
    victim = next(r for r in eng.running if r.blocks)
    blk = victim.blocks[0]
    eng.bm.release([blk])
    msgs = invariants.audit_engine(eng)
    assert any("double-free" in m and f"block {blk}" in m for m in msgs), msgs


def test_leaked_reference_is_detected():
    eng = running_engine()
    leaked = eng.bm.allocate(1)[0]
    msgs = invariants.audit_engine(eng)
    assert any("leaked reference" in m and f"block {leaked}" in m
               for m in msgs), msgs


def test_self_aliased_block_table_is_detected():
    eng = running_engine()
    victim = next(r for r in eng.running if r.blocks)
    victim.blocks.append(victim.blocks[0])
    msgs = invariants.audit_engine(eng)
    assert any("more than once" in m and f"rid {victim.rid}" in m
               for m in msgs), msgs


def test_orphaned_slot_is_detected():
    eng = running_engine()
    victim = next(r for r in eng.running if r.slot >= 0)
    eng.scheduler.free_slots.append(victim.slot)
    msgs = invariants.audit_engine(eng)
    assert any("both free and held" in m and str(victim.slot) in m
               for m in msgs), msgs


def test_leaked_slot_is_detected():
    eng = running_engine()
    victim = next(r for r in eng.running if r.slot >= 0)
    slot = victim.slot
    victim.slot = -1
    msgs = invariants.audit_engine(eng)
    assert any("leaked" in m and f"[{slot}]" in m for m in msgs), msgs


def test_queue_overlap_is_detected():
    eng = running_engine()
    r = eng.running[0]
    eng.scheduler.waiting.append(r)
    msgs = invariants.audit_engine(eng)
    assert any("queues must be disjoint" in m and f"rid {r.rid}" in m
               for m in msgs), msgs


def test_wrong_state_in_queue_is_detected():
    eng = running_engine()
    eng.running[0].state = State.FINISHED
    msgs = invariants.audit_engine(eng)
    assert any("sits in the 'running' queue with state 'finished'" in m
               for m in msgs), msgs


def test_waiting_request_holding_blocks_is_detected():
    eng = make_engine()
    rid = submit(eng, [1, 2, 3], 8)
    next(r for r in eng.waiting if r.rid == rid).blocks = [0, 1]
    msgs = invariants.audit_engine(eng)
    assert any("only running requests hold device blocks" in m
               for m in msgs), msgs


def test_budget_overdraw_is_detected():
    eng = running_engine(token_budget=16)
    eng.metrics.append({"step": eng.step_count,
                        "n_scheduled_tokens": 99, "token_budget": 16})
    msgs = invariants.audit_engine(eng)
    assert any("overdraw" in m and "99" in m for m in msgs), msgs


def test_win_count_without_qslot_is_detected():
    eng = running_engine()
    r = eng.running[0]
    r.qslot, r.win_count = -1, 2
    msgs = invariants.audit_engine(eng)
    assert any("without a qslot" in m and f"rid {r.rid}" in m
               for m in msgs), msgs


def test_output_overflow_is_detected():
    eng = running_engine()
    r = eng.running[0]
    r.output = list(range(r.max_new_tokens + 3))
    msgs = invariants.audit_engine(eng)
    assert any("max_new_tokens" in m and f"rid {r.rid}" in m
               for m in msgs), msgs


def test_prefill_cursor_regression_is_detected():
    eng = running_engine()
    r = eng.running[0]
    r.n_prefilled, r.prefill_target = 5, 2
    msgs = invariants.audit_engine(eng)
    assert any("chunked-prefill bookkeeping" in m for m in msgs), msgs


def test_block_cap_violation_is_detected():
    eng = running_engine()
    r = next(x for x in eng.running if x.blocks and not x.compressed)
    r.blocks.extend(eng.bm.allocate(4))
    msgs = invariants.audit_engine(eng)
    assert any("over-allocation" in m and f"rid {r.rid}" in m
               for m in msgs), msgs


def test_compressed_block_cap_violation_is_detected():
    eng = make_engine(n_max=3, m_qslots=4)
    for p in PROMPTS:
        submit(eng, p, 40)
    while not any(r.compressed for r in eng.running):
        eng.step()
        assert eng.step_count < 100
    r = next(x for x in eng.running if x.compressed)
    r.blocks.extend(eng.bm.allocate(6))
    msgs = invariants.audit_engine(eng)
    assert any("paper block cap violated" in m and f"rid {r.rid}" in m
               for m in msgs), msgs


def test_device_mirror_divergence_is_detected():
    eng = running_engine()
    r = next(x for x in eng.running if x.slot >= 0)
    assert eng._pushed_version == eng.scheduler.version
    eng.state["seq_lens"] = eng.state["seq_lens"].clone()
    eng.state["seq_lens"][r.slot] += 1
    msgs = invariants.audit_engine(eng)
    assert any(f"rid {r.rid} slot {r.slot}: device seq_len" in m
               for m in msgs), msgs


def test_corrupted_device_seq_lens_caught_right_after_a_push():
    """The pushed tables are copies of the host mirrors on the CPU too: a
    write into the device ``seq_lens`` just after a push (no decode step
    in between) leaves the mirror as it was, and the audit catches it."""
    eng = running_engine()
    eng._push_host_state(force=True)
    r = next(x for x in eng.running if x.slot >= 0)
    eng.state["seq_lens"][r.slot] += 1
    assert eng.host_seq[r.slot] == r.seq_len
    with pytest.raises(invariants.InvariantViolation,
                       match=f"rid {r.rid} slot {r.slot}: device seq_len"):
        invariants.check_engine(eng)


def test_qwin_write_to_free_row_is_detected():
    eng = make_engine(m_qslots=2, max_batch=2)
    eng.host_qslot.fill(-1)
    assert invariants.audit_engine(eng) == []   # arms the shadows
    q = eng.scheduler.free_qslots[0]
    eng.state["qwin"][:, q] += 1.0
    msgs = invariants.audit_engine(eng)
    assert any(f"free qslot {q}" in m and "does not own" in m
               for m in msgs), msgs
    assert invariants.audit_engine(eng) == []   # re-armed, not re-reported


def test_qwin_shadow_retired_for_dispatched_qslots():
    eng = make_engine(m_qslots=2, max_batch=2)
    eng.host_qslot.fill(-1)
    assert invariants.audit_engine(eng) == []
    q = eng.scheduler.free_qslots[0]
    eng.host_qslot[0] = q                       # legitimately dispatched
    eng.state["qwin"][:, q] += 1.0
    assert invariants.audit_engine(eng) == []


def test_window_of_a_request_preempted_in_its_admission_step():
    """Under a tight pool a request is admitted with a query slot,
    prefilled (its window row written) and recompute-preempted in the same
    step; the step's pushes mapped that slot, so the row is no violation,
    while a later write into it, once free, is."""
    eng = make_engine(block_size=16, n_total_blocks=40, max_batch=16,
                      m_qslots=16, n_max=4, max_model_len=512,
                      prefill_rows=4, prefill_len=128)
    rng = np.random.default_rng(0)
    for n in rng.integers(40, 181, 16):
        submit(eng, [int(x) for x in rng.integers(0, CFG.vocab_size, n)],
               128)
    seen = None
    for _ in range(6):
        admitted = {r.rid: r.qslot for r in eng.running}
        eng.step()
        assert invariants.audit_engine(eng) == []
        new = {r.rid for r in eng.scheduler.waiting if r.preempt_count} - \
            set(admitted)
        if new and seen is None:
            seen = new
    assert seen, "no request was preempted in its admission step"
    q = eng.scheduler.free_qslots[-1]
    eng.state["qwin"][:, q] += 1.0
    eng._step_qslots = set()
    eng.host_qslot.fill(-1)
    invariants.audit_engine(eng)
    eng.state["qwin"][:, q] += 1.0
    assert any(f"free qslot {q}" in m for m in invariants.audit_engine(eng))


def test_healthy_swap_run_audits_clean():
    eng = make_engine(n_total_blocks=10, max_batch=4, m_qslots=4,
                      prefix_caching=False, preemption_mode="swap",
                      swap_space_blocks=16)
    for p in PROMPTS:
        submit(eng, p, 24)
    while eng.scheduler.has_work():
        eng.step()
        assert invariants.audit_engine(eng) == []
        assert eng.step_count < 800
    assert sum(m["n_swapped_out"] for m in eng.metrics) > 0


def test_swap_pool_leak_is_detected():
    eng = running_engine(preemption_mode="swap", swap_space_blocks=16,
                         prefix_caching=False)
    eng.bm.swapped[9999] = [eng.bm.swap_free.pop()]   # rid not in queue
    msgs = invariants.audit_engine(eng)
    assert any("rid 9999" in m and "swap-pool leak" in m for m in msgs), msgs


def test_sink_page_and_sink_query_slot_are_not_audited():
    """Dropped writes land in the sink page and the sink query slot (the
    last ones) on every step; nothing owns them, so no audit reads them."""
    eng = running_engine()
    assert invariants.audit_engine(eng) == []
    eng.state["qwin"][:, -1] += 1.0
    for pool in eng.state["pools"].values():
        pool[:, -1] += 1.0
    assert invariants.audit_engine(eng) == []
    while eng.scheduler.has_work():
        eng.step()
        assert invariants.audit_engine(eng) == []


# ----------------------------------------------------------------------
# memory planner


PLAN_NAMES = ["qwen3-8b", "llama3-8b", "qwen2.5-3b", "olmo-1b",
              "nemotron-4-15b", "deepseek-v2-lite-16b", "dbrx-132b",
              "tiny-lm"]


@pytest.mark.parametrize("name", PLAN_NAMES)
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_memory_plan_equals_jax(name, dtype_bytes):
    tcfg, jcfg = get_config(name), jget_config(name)
    for kw in (dict(block_size=16, window=4), dict(block_size=8, window=16,
                                                  with_global=False)):
        want = jmp.plan_memory(jcfg, 40 * 2**30, 4, dtype_bytes=dtype_bytes,
                               **kw)
        got = tmp.plan_memory(tcfg, 40 * 2**30, 4, dtype_bytes=dtype_bytes,
                              **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tmp.bytes_q_per_request(tcfg, 4, dtype_bytes=dtype_bytes) == \
        jmp.bytes_q_per_request(jcfg, 4, dtype_bytes=dtype_bytes)


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_block_bytes_are_the_port_pools(name):
    """At the default fp32, one block's bytes are those of the port's K, V
    and F pools (sink page aside), and one request's window those of its
    observation-window row."""
    from repro_torch.core import serve_model
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    spec = serve_model.ServeSpec(n_slots=2, block_size=8, max_blocks=4,
                                 n_total_blocks=6, m_qslots=3, window=4)
    st = serve_model.make_state(cfg, spec, "cpu")
    pool_bytes = sum(p.numel() * p.element_size()
                     for p in st["pools"].values())
    assert tmp.bytes_per_kv_block(cfg, 8) * (6 + 1) == pool_bytes
    qwin = st["qwin"]
    assert tmp.bytes_q_per_request(cfg, 4) * (3 + 1) == \
        qwin.numel() * qwin.element_size()
    eng = ZipageEngine(cfg, lm.init(cfg, torch.Generator().manual_seed(0),
                                    "cpu"),
                       EngineOptions(block_size=8, n_total_blocks=6,
                                     max_batch=2, max_model_len=32,
                                     prefill_rows=1, prefill_len=16),
                       device="cpu")
    assert eng._kv_block_bytes() == tmp.bytes_per_kv_block(cfg, 8)


# ----------------------------------------------------------------------
# scheduler parity


JAX_MODS = (jsched, jbm, jreq, jsampling)
PORT_MODS = (tsched, tbm, treq, tsampling)

#: scheduler settings of the parity cases (SchedulerParams fields)
PARITY = {
    "hybrid-fcfs": {},
    "constrained": dict(scheduling="constrained"),
    "priority": dict(policy="priority"),
    "srpt": dict(policy="srpt"),
    "cache-aware": dict(policy="cache_aware"),
    "budget-chunked": dict(token_budget=24, max_prefill_chunk=16),
    "tight-pool": dict(n_total_blocks=18, admission_margin=0.5),
    "no-compression": dict(n_max=None),
    "quality-aware": dict(quality_aware=True),
}


def op_stream(seed, n_steps=70, vocab=50):
    """Per step, a list of ops: ("add", rid, prompt, max_new, priority,
    sampling kw) or ("abort", rid). Prompts share prefixes now and then,
    so the prefix cache hits; some requests stop on an eos id."""
    rng = np.random.default_rng(seed)
    stream, rid, prefixes = [], 0, []
    for step in range(n_steps):
        ops = []
        if step < 40:
            for _ in range(int(rng.integers(0, 3))):
                n = int(rng.integers(3, 60))
                if prefixes and rng.random() < 0.3:
                    p = prefixes[int(rng.integers(len(prefixes)))]
                    prompt = p + [int(x) for x in rng.integers(0, vocab, n)]
                else:
                    prompt = [int(x) for x in rng.integers(0, vocab, n)]
                    prefixes.append(prompt[:int(rng.integers(1, n + 1))])
                kw = dict(compression_policy=str(rng.choice(
                    ["default", "protect", "aggressive"])))
                if rng.random() < 0.3:
                    kw["eos_ids"] = (int(rng.integers(0, 20)),)
                ops.append(("add", rid, prompt, int(rng.integers(4, 48)),
                            int(rng.integers(0, 3)), kw))
                rid += 1
        if rid and rng.random() < 0.08:
            ops.append(("abort", int(rng.integers(rid))))
        stream.append(ops)
    return stream


def _token(r):
    return (r.rid * 7919 + len(r.output) * 104729) % 23


def _plan(outs):
    ids = lambda rs: [r.rid for r in rs]   # noqa: E731
    return dict(step=outs.step, admitted=ids(outs.admitted),
                prefill=[(c.request.rid, c.start, c.n_tokens, c.is_final)
                         for c in outs.prefill_chunks],
                compress=[(c.request.rid, list(c.dest), c.reserved,
                           list(c.release)) for c in outs.compress],
                decode=ids(outs.decode), preempted=ids(outs.preempted),
                swapped_out=ids(outs.swapped_out),
                swapped_in=ids(outs.swapped_in), finished=ids(outs.finished),
                n_blocked=outs.n_blocked, token_budget=outs.token_budget)


def _requests(sched):
    return sorted((r.rid, r.state.value, r.slot, r.qslot, list(r.blocks),
                   r.seq_len, r.position, r.n_prefilled, r.win_count,
                   r.compressed, list(r.output), r.finish_reason)
                  for q in (sched.waiting, sched.running,
                            list(sched.finished.values())) for r in q)


def drive(mods, stream, latencies, knobs, window=4, prefill_len=32,
          prefill_rows=2):
    """Run one package's Scheduler over ``stream`` with the engine's host
    bookkeeping (prefill rounds of ``prefill_len``, one token a decoded
    request, aborts as the engine records them) and no model: tokens are
    a function of (rid, tokens so far). Returns the per-step records."""
    sched_mod, bm_mod, req_mod, samp_mod = mods
    knobs = dict(knobs)
    n_total = knobs.pop("n_total_blocks", 48)
    b = 8
    n_max = knobs.pop("n_max", 3)
    params = sched_mod.SchedulerParams(
        block_size=b, max_batch=4, m_qslots=3, n_max=n_max, window=window,
        prefill_rows=prefill_rows, block_bytes=1024,
        compression_enabled=n_max is not None,
        budget_blocks=(n_max - 1) if n_max is not None else 0,
        prefix_ok=True, **knobs)
    sched = sched_mod.Scheduler(params, bm_mod.BlockManager(
        n_total, b, enable_prefix_cache=True))
    records = []
    for step, ops in enumerate(stream, start=1):
        for op in ops:
            if op[0] == "add":
                _, rid, prompt, n, prio, kw = op
                sched.add_request(req_mod.Request(
                    rid=rid, prompt=list(prompt), max_new_tokens=n,
                    arrival=float(step), priority=prio,
                    sampling=samp_mod.SamplingParams(max_new_tokens=n,
                                                     **kw)))
            else:
                r = sched.abort(op[1])
                if r is not None:
                    r.state = req_mod.State.FINISHED
                    r.finish_reason = req_mod.FinishReason.ABORT
                    sched.finished[r.rid] = r
        outs = sched.schedule(step)
        for c in outs.prefill_chunks:       # the engine's prefill rounds
            r = c.request
            r.n_prefilled = c.start + c.n_tokens
            if c.is_final:
                r.output.append(_token(r))
                if r.qslot >= 0:
                    last = c.n_tokens - prefill_len * ((c.n_tokens - 1)
                                                       // prefill_len)
                    r.win_count = min(window, last)
        sched.plan_compression(outs)
        for c in outs.compress:             # what the kernels would report
            c.request.redundancy = (c.request.rid % 5) / 5.0
            c.request.attn_entropy = (c.request.rid % 3) / 3.0
        sched.commit_compression(outs)
        active = sched.schedule_decode(outs)
        if active:
            _, caps = sched.quiescent_horizon(active, outs)
            assert list(caps) == [1] * len(active)
        for r in active:
            r.output.append(_token(r))
            if r.qslot >= 0:
                r.win_count = min(window, r.win_count + 1)
            r.seq_len += 1
            r.position += 1
        sched.end_step(outs)
        sched.observe_latency(latencies[step - 1])
        stats = sched.stats(outs, n_decoded=len(active))
        records.append((_plan(outs), stats, _requests(sched),
                        sched.bm.num_free, list(sched.free_slots),
                        list(sched.free_qslots)))
    return records


@pytest.mark.parametrize("case", list(PARITY))
def test_scheduler_copy_plans_as_the_jax_scheduler(case):
    seed = list(PARITY).index(case)
    stream = op_stream(seed)
    rng = np.random.default_rng(100 + seed)
    # fixed step latencies with stragglers: a step 5x the EWMA halves the
    # admission limit in both schedulers
    latencies = [float(x) for x in rng.uniform(0.01, 0.012, len(stream))]
    for i in (6, 7, 30):
        latencies[i] = 0.2
    want = drive(JAX_MODS, stream, latencies, PARITY[case])
    got = drive(PORT_MODS, stream, latencies, PARITY[case])
    for step, (g, w) in enumerate(zip(got, want), start=1):
        assert g == w, f"step {step}"
    plans = [rec[0] for rec in want]
    assert sum(len(p["admitted"]) for p in plans) > 10
    assert any(p["finished"] for p in plans)
    assert min(rec[1]["admission_scale"] for rec in want) < 1.0
    if PARITY[case].get("n_max", 3) is not None:
        assert any(p["compress"] for p in plans)
    if case == "tight-pool":
        assert any(p["preempted"] for p in plans)
