"""Whole-engine runtime sanitizer (``ZIPAGE_SANITIZE=1``), the port's
copy of ``repro.core.invariants``.

Generalizes ``BlockManager.check_invariants()`` into an audit of the
entire serving engine: scheduler queues, slot/qslot pools, block
refcounts, the host swap tier, token-budget accounting and the
compression invariants of the paper (block cap, observation-window
ownership). The engine runs :func:`check_engine` after every ``step()``
when the env var is set; tests call :func:`audit_engine` directly to
inspect the messages.

Every violation message is actionable: it names the object (rid, slot,
block id), the numbers that disagree, and the class of bug it implies
(leak vs double-free vs orphan).

What differs from the JAX package's sanitizer:

  * device state is read with ``.cpu()`` (a CUDA tensor has no
    ``__array__``); only the rows an audit needs are copied to the host;
  * the port's pools end with a sink page and its observation-window
    pool with a sink query slot, where writes that must be dropped land
    (``repro_torch.core.paged.sink_page``). Nothing owns them and they
    change on every step, so no audit reads them: the block audits run
    over the scheduler's ``num_blocks`` real blocks, and the window audit
    over the ``m_qslots`` real query slots;
  * the window audit exempts every query slot that a table push of the
    audited step mapped (``engine._step_qslots``), not only those of the
    last push: under a tight pool a request can be admitted, prefilled
    (writing its window row) and preempted within one step, and the JAX
    package's audit reports that legitimate write as a violation.

Pure host: this module imports no device code. Reading device state makes
each audit a sync point, which is why it is opt-in.
"""
from __future__ import annotations

import math
import os
from collections import Counter
from typing import TYPE_CHECKING, Dict, List

import numpy as np
import torch

if TYPE_CHECKING:                                   # pragma: no cover
    from repro_torch.core.block_manager import BlockManager
    from repro_torch.core.scheduler import Scheduler

#: truthy spellings accepted for ZIPAGE_SANITIZE
_TRUTHY = ("1", "true", "yes", "on")


class InvariantViolation(AssertionError):
    """Raised by :func:`check_engine`; one line per violated invariant."""


def enabled() -> bool:
    """Whether the per-step engine audit is switched on via env."""
    return os.environ.get("ZIPAGE_SANITIZE", "").lower() in _TRUTHY


# ----------------------------------------------------------------------
# audit groups — each appends human-readable violation strings


def _queue_states(sched: "Scheduler", out: List[str]) -> None:
    """Queue disjointness + per-queue request-state consistency."""
    from repro_torch.core.request import State

    queues = {
        "waiting": list(sched.waiting),
        "running": list(sched.running),
        "swapped": list(sched.swapped),
        "finished": list(sched.finished.values()),
    }
    seen: Dict[int, str] = {}
    for qname, reqs in queues.items():
        for r in reqs:
            if r.rid in seen:
                out.append(
                    f"rid {r.rid} appears in both the {seen[r.rid]!r} and "
                    f"{qname!r} queues — queues must be disjoint (a "
                    "preempt/finish path forgot to remove it)")
            seen[r.rid] = qname
    allowed = {
        "waiting": {State.WAITING},
        "running": {State.RUNNING, State.BLOCKED, State.COMPRESSING},
        "swapped": {State.SWAPPED},
        "finished": {State.FINISHED},
    }
    for qname, reqs in queues.items():
        for r in reqs:
            if r.state not in allowed[qname]:
                out.append(
                    f"rid {r.rid} sits in the {qname!r} queue with state "
                    f"{r.state.value!r} — allowed: "
                    f"{sorted(s.value for s in allowed[qname])}")
            if qname != "running":
                if r.slot != -1 or r.qslot != -1:
                    out.append(
                        f"rid {r.rid} ({qname}) still holds slot={r.slot} "
                        f"qslot={r.qslot} — only running requests may own "
                        "slots (orphaned slot leak)")
                if r.blocks:
                    out.append(
                        f"rid {r.rid} ({qname}) still lists "
                        f"{len(r.blocks)} block(s) — only running "
                        "requests hold device blocks (block leak)")


def _slot_pools(sched: "Scheduler", out: List[str]) -> None:
    """free_slots/free_qslots + per-request assignments partition the
    slot and qslot id spaces exactly."""
    p = sched.p
    for kind, size, free, held in (
            ("slot", p.max_batch, sched.free_slots,
             [r.slot for r in sched.running if r.slot >= 0]),
            ("qslot", p.m_qslots, sched.free_qslots,
             [r.qslot for r in sched.running if r.qslot >= 0])):
        dup = [s for s, c in Counter(held).items() if c > 1]
        if dup:
            out.append(
                f"{kind}(s) {sorted(dup)} owned by more than one running "
                "request — assignment/release mismatch")
        bad = [s for s in held + list(free) if not 0 <= s < size]
        if bad:
            out.append(
                f"{kind} id(s) {sorted(set(bad))} out of range "
                f"[0, {size}) — corrupted pool")
        overlap = set(held) & set(free)
        if overlap:
            out.append(
                f"{kind}(s) {sorted(overlap)} both free and held — a "
                "request was freed without clearing its handle (or the "
                "pool was double-pushed)")
        n = len(set(held)) + len(set(free))
        if n != size and not dup and not bad and not overlap:
            out.append(
                f"{kind} pool accounts for {n} of {size} ids "
                f"({len(free)} free + {len(set(held))} held) — "
                f"{'leaked' if n < size else 'duplicated'} "
                f"{kind}(s): {sorted(set(range(size)) - set(held) - set(free))}")


def _block_refcounts(sched: "Scheduler", out: List[str]) -> None:
    """bm.ref must equal, per block, the number of running requests
    listing that block (prefix-shared blocks count once per holder)."""
    bm = sched.bm
    holders: Counter = Counter()
    for r in sched.running:
        dup = [b for b, c in Counter(r.blocks).items() if c > 1]
        if dup:
            out.append(
                f"rid {r.rid} lists block(s) {sorted(dup)} more than once "
                "in its block table — self-aliased table (compression "
                "commit or swap-in wrote overlapping ids)")
        holders.update(set(r.blocks))
    for b in range(bm.num_blocks):
        ref, held = bm.ref[b], holders.get(b, 0)
        if ref == held:
            continue
        if ref > held:
            out.append(
                f"block {b}: refcount {ref} > {held} holder(s) — leaked "
                "reference (a release path was skipped; the block can "
                "never be reclaimed)")
        else:
            out.append(
                f"block {b}: refcount {ref} < {held} holder(s) — "
                "double-free (the block can be handed to another request "
                "while still referenced: silent KV corruption)")
    live = {b for b in range(bm.num_blocks) if bm.ref[b] > 0}
    free_set = set(bm.free) | set(bm.cached_free)
    if len(free_set) != len(bm.free) + len(bm.cached_free):
        out.append(
            "block(s) "
            f"{sorted(set(bm.free) & set(bm.cached_free))} are in both "
            "the free list and the prefix-cached free list")
    clash = free_set & live
    if clash:
        out.append(
            f"block(s) {sorted(clash)} are simultaneously free and "
            "referenced — double-free into the pool")
    missing = set(range(bm.num_blocks)) - free_set - live
    if missing:
        out.append(
            f"block(s) {sorted(missing)} are neither free nor referenced "
            "— leaked out of the pool entirely")
    for h, b in bm.hash_to_block.items():
        if bm.block_hash.get(b) != h:
            out.append(
                f"prefix-cache hash map out of sync: hash {h} -> block "
                f"{b} but block_hash[{b}] == {bm.block_hash.get(b)}")


def _prefix_tree(sched: "Scheduler", out: List[str]) -> None:
    """Radix prefix-cache structure: node<->hash<->block bijection, tree
    linkage, path closure (a referenced node's ancestors stay referenced)
    and the free-list exclusion of cached payload. Flat policy keeps no
    tree, so there is nothing to audit."""
    bm = sched.bm
    if bm.prefix_cache_policy != "radix":
        if bm.nodes or bm.segments:
            out.append(
                f"flat-policy BlockManager holds {len(bm.nodes)} radix "
                f"node(s) / {len(bm.segments)} segment(s) — tree state "
                "leaked across a policy boundary")
        return
    raw_free = set(bm.free)
    if set(bm.nodes) != set(bm.hash_to_block):
        only_n = sorted(set(bm.nodes) - set(bm.hash_to_block))[:4]
        only_h = sorted(set(bm.hash_to_block) - set(bm.nodes))[:4]
        out.append(
            f"radix node set diverged from hash_to_block (nodes-only "
            f"{only_n}, hashes-only {only_h}) — register/deregister "
            "updated one map but not the other")
    for h, node in bm.nodes.items():
        b = node.block
        if bm.hash_to_block.get(h) != b:
            out.append(
                f"radix node {h} points at block {b} but hash_to_block "
                f"maps it to {bm.hash_to_block.get(h)} — node/block "
                "bijection broken")
        if bm.node_of_block.get(b) is not node:
            out.append(
                f"block {b} of radix node {h} is not node_of_block's "
                "entry for that block — reverse map stale")
        if b in raw_free:
            out.append(
                f"block {b} backs cached radix node {h} but sits in the "
                "raw free list — it can be reallocated while the cache "
                "still advertises its content")
        parent = node.parent
        if parent is not None:
            if parent.children.get(h) is not node:
                out.append(
                    f"radix node {h} names a parent that does not list "
                    "it as a child — tree linkage corrupt")
            if bm.ref[b] > 0 and bm.ref[parent.block] == 0 \
                    and parent.block not in bm.cached_free:
                out.append(
                    f"radix node {h} (block {b}) is referenced but its "
                    f"parent block {parent.block} is neither referenced "
                    "nor cached — path closure broken (eviction can "
                    "orphan a live suffix)")
    for b in bm.seg_of_block:
        if b in raw_free:
            out.append(
                f"block {b} is compressed-segment payload "
                f"({bm.seg_of_block[b]}) but sits in the raw free list — "
                "segment-vs-pool accounting out of sync")


def _swap_pool(sched: "Scheduler", out: List[str]) -> None:
    """Host swap tier: per-rid reservations match the swapped queue and
    partition the host block space with swap_free."""
    bm = sched.bm
    q_rids = {r.rid for r in sched.swapped}
    bm_rids = set(bm.swapped)
    for rid in sorted(bm_rids - q_rids):
        out.append(
            f"rid {rid} holds {len(bm.swapped[rid])} host swap block(s) "
            "but is not in the swapped queue — swap-pool leak (swap-in "
            "or abort forgot release_swapped)")
    for rid in sorted(q_rids - bm_rids):
        out.append(
            f"rid {rid} is in the swapped queue but owns no host swap "
            "blocks — its KV copy is gone and swap-in will corrupt")
    held = [b for blocks in bm.swapped.values() for b in blocks]
    dup = [b for b, c in Counter(held + list(bm.swap_free)).items()
           if c > 1]
    if dup:
        out.append(
            f"host swap block(s) {sorted(dup)} double-booked across "
            "swap_free / per-rid reservations")
    n = len(set(held) | set(bm.swap_free))
    if n != bm.swap_space_blocks and not dup:
        out.append(
            f"host swap pool accounts for {n} of "
            f"{bm.swap_space_blocks} blocks — leaked host blocks")


def _token_budget(engine, out: List[str]) -> None:
    """The step's scheduled tokens must fit the configured budget."""
    if not engine.metrics:
        return
    m = engine.metrics[-1]
    if m.get("step") != engine.step_count:
        return
    budget = m.get("token_budget")
    scheduled = m.get("n_scheduled_tokens")
    if budget is not None and scheduled is not None and scheduled > budget:
        out.append(
            f"step {m['step']} scheduled {scheduled} tokens against a "
            f"token_budget of {budget} — the budget accounting "
            "over-admitted (continuous-batching overdraw)")


def _request_counters(engine, out: List[str]) -> None:
    """Per-request progress counters stay inside their envelopes."""
    sched = engine.scheduler
    p = sched.p
    b = p.block_size
    paged = ("pools" in engine.state and not p.attention_free
             and not p.ring_blocks)
    for r in sched.running:
        if not 0 <= r.win_count <= p.window:
            out.append(
                f"rid {r.rid}: win_count {r.win_count} outside "
                f"[0, window={p.window}] — observation-window cursor "
                "corrupt")
        if p.compression_enabled and r.win_count > 0 and r.qslot < 0:
            out.append(
                f"rid {r.rid}: win_count {r.win_count} > 0 without a "
                "qslot — window rows were recorded into a slot it does "
                "not own (qwin ownership violation)")
        if not 0 <= r.n_prefilled <= r.prefill_target <= len(r.full_prompt):
            out.append(
                f"rid {r.rid}: prefill cursor n_prefilled="
                f"{r.n_prefilled} target={r.prefill_target} vs prompt "
                f"len {len(r.full_prompt)} — chunked-prefill bookkeeping "
                "out of order")
        if len(r.output) > r.max_new_tokens:
            out.append(
                f"rid {r.rid}: emitted {len(r.output)} tokens past "
                f"max_new_tokens={r.max_new_tokens} — finish check "
                "missed the length cap")
        if not paged:
            continue
        if r.seq_len > r.n_blocks * b:
            out.append(
                f"rid {r.rid}: seq_len {r.seq_len} exceeds its "
                f"{r.n_blocks} block(s) x {b} capacity — decode is "
                "writing past the block table")
        if r.compressed:
            # the quality-aware planner legitimately lets a request run
            # past n_max before compressing (compression_deferral /
            # "protect" policy — docs/EVAL.md), so audit against the
            # scheduler's worst-case per-request cap, not the global n_max
            n_cap = (sched._n_max_cap(r, worst_case=True)
                     if p.n_max is not None else 0)
            cap = n_cap + max(1, math.ceil(p.window / b))
            if r.pos_gap:
                # segment adoption (docs/CACHING.md) marks the request
                # compressed at admission, but its block table tracks
                # seq_len like an uncompressed request until its own
                # first compression fires — allow the seq_len envelope
                cap = max(cap, -(-(r.seq_len + max(1, p.decode_steps))
                                 // b))
            if r.n_blocks > cap:
                out.append(
                    f"rid {r.rid}: compressed but holds {r.n_blocks} "
                    f"blocks > per-request cap {n_cap} + in-flight "
                    f"allowance {cap - n_cap} — compression failed to "
                    "release its sources (paper block cap violated)")
        else:
            cap = -(-(r.seq_len + max(1, p.decode_steps)) // b)
            if r.n_blocks > cap:
                out.append(
                    f"rid {r.rid}: uncompressed with {r.n_blocks} blocks "
                    f"for seq_len {r.seq_len} (cap {cap}) — "
                    "over-allocation / stale table entries")


def _device_mirrors(engine, out: List[str]) -> None:
    """Host seq/pos mirrors vs the device tables. Only meaningful when
    the last push is still current (nothing structural moved since) and
    on paged archs whose host counters advance in lockstep."""
    sched = engine.scheduler
    p = sched.p
    if ("pools" not in engine.state or p.attention_free or p.ring_blocks
            or engine._pushed_version != sched.version):
        return
    seq = engine.state["seq_lens"].cpu().numpy()
    pos = engine.state["positions"].cpu().numpy()
    for r in sched.running:
        if r.slot < 0:
            continue
        if int(seq[r.slot]) != r.seq_len:
            out.append(
                f"rid {r.rid} slot {r.slot}: device seq_len "
                f"{int(seq[r.slot])} != host {r.seq_len} — the mirrors "
                "diverged (missed push or double advance)")
        if int(pos[r.slot]) != r.position:
            out.append(
                f"rid {r.rid} slot {r.slot}: device position "
                f"{int(pos[r.slot])} != host {r.position} — the mirrors "
                "diverged (missed push or double advance)")


def _qwin_ownership(engine, out: List[str]) -> None:
    """Observation-window rows of FREE qslots must never change between
    audits — a change means some decode/compress dispatch wrote a row no
    active slot owns (the qwin masking bug class). Shadows are host
    copies keyed by qslot; reassignment retires the shadow. The sink
    query slot (index ``m_qslots``, the last) takes the dropped writes
    and is never free, so it is never audited."""
    if "qwin" not in engine.state or not engine.compression_enabled:
        return
    sched = engine.scheduler
    free = set(sched.free_qslots)
    shadow = engine._qwin_shadow
    # rows legitimately writable under the step's table pushes: a qslot
    # can be assigned AND freed within one step (tenant finishes, or is
    # admitted, prefilled and preempted), so current freeness alone is not
    # enough to declare a row quiescent
    dispatched = {int(q) for q in engine.host_qslot if q >= 0} \
        | engine._step_qslots
    for q in list(shadow):
        if q not in free or q in dispatched:
            del shadow[q]
    quiet = sorted(q for q in free - dispatched if 0 <= q < sched.p.m_qslots)
    if not quiet:
        return
    qwin = engine.state["qwin"][:, quiet].cpu()  # (L, len(quiet), w, h, d)
    if qwin.dtype.itemsize == 2:   # bits: numpy has no bf16, and fp16 by
        qwin = qwin.view(torch.int16)  # value has -0.0 == 0.0, NaN != NaN
    rows = qwin.numpy()
    for i, q in enumerate(quiet):
        row = rows[:, i]
        prev = shadow.get(q)
        if prev is None:
            shadow[q] = row.copy()
        elif not np.array_equal(prev, row):
            out.append(
                f"free qslot {q}: observation-window row changed while "
                "unassigned — a dispatch wrote into a window it does not "
                "own (masking bug: check the qslot gather/scatter masks)")
            shadow[q] = row.copy()            # don't re-report every step


# ----------------------------------------------------------------------


def audit_engine(engine) -> List[str]:
    """Run every audit group; returns violation messages (empty = clean)."""
    out: List[str] = []
    sched = engine.scheduler
    _queue_states(sched, out)
    _slot_pools(sched, out)
    _block_refcounts(sched, out)
    _prefix_tree(sched, out)
    _swap_pool(sched, out)
    _token_budget(engine, out)
    _request_counters(engine, out)
    _device_mirrors(engine, out)
    _qwin_ownership(engine, out)
    return out


def check_engine(engine) -> None:
    """Raise :class:`InvariantViolation` listing every violation found."""
    violations = audit_engine(engine)
    if violations:
        raise InvariantViolation(
            f"ZIPAGE_SANITIZE: {len(violations)} engine invariant "
            "violation(s) after step "
            f"{engine.step_count}:\n  - " + "\n  - ".join(violations))
