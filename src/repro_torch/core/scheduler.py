"""The compression-aware Scheduler: the paper's "comprehensive scheduling
strategy" (§4.3–§4.5) as a standalone, pluggable subsystem.

Pure host-side logic — no JAX imports. The scheduler owns the request
queues (waiting / running / finished), the decode- and query-slot pools,
and every admission / preemption / compression-planning decision; the
engine (``repro_torch.core.engine.ZipageEngine``) owns the device state and
merely *executes* the :class:`SchedulerOutputs` plan each step produces.

Per-step protocol (driven by ``ZipageEngine.step()``):

    plan = scheduler.schedule()            # qslots, admission, prefill chunks
    engine runs prefill from plan.prefill_chunks
    scheduler.plan_compression(plan)       # detect + pick dest blocks (§4.4)
    engine launches the compression kernel from plan.compress
    scheduler.commit_compression(plan)     # release blocks, swap tables
    active = scheduler.schedule_decode(plan)   # growth, blocking, preemption
    engine decodes `active`
    scheduler.end_step(plan)               # async rejoin + finish detection
    scheduler.observe_latency(dt)          # straggler-aware admission scale

The plan is refined in phases rather than produced whole because the
observation-window counters that gate compression only land with the final
prefill chunk, and finish detection depends on the tokens the device
sampled — see docs/SCHEDULER.md for the full queue lifecycle.

Pluggable policies (``SchedulerConfig.policy`` on the ``repro_torch.api``
facade): ``fcfs`` (default — byte-for-byte the pre-extraction engine
behavior), ``priority`` (``Request.priority`` descending), ``srpt``
(shortest remaining work first) and ``cache_aware`` (most reusable
prefix first, scored by a side-effect-free radix-tree probe —
docs/CACHING.md). Preemption victim order is a policy too
(``SchedulerConfig.preemption``; defaults to the admission policy's
reverse).
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.core.block_manager import BlockManager
from repro_torch.core.request import Request, State

# ----------------------------------------------------------------------
# configuration


@dataclasses.dataclass(frozen=True)
class SchedulerParams:
    """Everything the scheduler needs to decide, nothing the device needs.

    Built by the engine from ``EngineOptions`` + model-derived flags; built
    directly in tests (the point of the extraction: policy logic is unit-
    testable without a model or JAX).
    """
    block_size: int = 16
    max_batch: int = 16              # decode slots
    m_qslots: int = 8                # paper's M (query-slot pool)
    n_max: Optional[int] = 4         # block cap; None => full-KV baseline
    window: int = 4                  # observation window w
    scheduling: str = "hybrid"       # hybrid | constrained (§4.3)
    async_compression: bool = True
    prefill_rows: int = 4            # admission batch ceiling per step
    # --- policy knobs (SchedulerConfig on the repro_torch.api facade) ---
    policy: str = "fcfs"             # fcfs | priority | srpt | cache_aware
    preemption: Optional[str] = None  # victim-order policy; None => policy
    # what preemption *does* (docs/SCHEDULER.md "Preemption modes"):
    # "recompute" frees the victim's blocks and re-prefills on
    # re-admission; "swap" parks its KV in the host swap tier and restores
    # it block-for-block; "auto" picks per victim by the cost model below
    preemption_mode: str = "recompute"   # recompute | swap | auto
    # auto cost model: host-copy cost of one KV token-slot (one direction)
    # in re-prefill-token equivalents. swap iff
    #   2 * n_blocks * block_size * swap_cost_per_token < len(full_prompt)
    # — a compressed victim (small n, long history) swaps, a short
    # uncompressed one recomputes.
    swap_cost_per_token: float = 0.5
    block_bytes: int = 0             # KV bytes per block (swap telemetry)
    token_budget: Optional[int] = None   # prefill+decode tokens per step
    max_prefill_chunk: Optional[int] = None  # per-request chunk cap per step
    admission_margin: float = 0.0    # fraction of projected growth reserved
    # cache *compressed* prefixes too (docs/CACHING.md): at a request's
    # first prompt-pure compression, keep the condensed payload registered
    # as a radix segment later prompts can adopt wholesale. Requires the
    # radix prefix-cache policy; off by default because an adopted
    # continuation is not bit-identical to a cold run (the compression is
    # lossy).
    cache_compressed_prefixes: bool = False
    # multi-step decode ceiling (docs/PERF.md): max fused decode+sample
    # iterations per engine step; quiescent_horizon() trims it per request
    decode_steps: int = 1
    # --- quality-aware compression (docs/EVAL.md) ---
    # feed the per-request scoring telemetry (Request.redundancy /
    # Request.attn_entropy, written back by the engine after each
    # compression launch) back into planning: candidates compress
    # lowest-redundancy-first, "default"-policy requests defer compression
    # by `compression_deferral` blocks past n_max while the pool keeps
    # `quality_defer_min_free` blocks free, and requests whose window
    # attention entropy is >= `quality_entropy_threshold` are shielded
    # from preemption while an unshielded victim exists. Off by default:
    # the planner is then byte-identical to the pre-quality scheduler.
    quality_aware: bool = False
    compression_deferral: int = 2    # extra blocks past n_max before a
    #                                  deferring request must compress
    quality_defer_min_free: int = 16  # free-pool floor for deferral
    quality_entropy_threshold: float = 0.85  # normalized entropy in [0,1]
    # --- model/engine-derived flags ---
    compression_enabled: bool = True
    budget_blocks: int = 3           # n_max - 1 (compression destination)
    prefix_ok: bool = True
    attention_free: bool = False
    ring_blocks: int = 0             # local-window ring size (0 = paged)


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    """One request's prefill work this step: ``full_prompt[start:start+n]``.
    ``is_final`` marks the chunk that completes the prompt — only then is a
    first token sampled and the observation window considered primed."""
    request: Request
    start: int
    n_tokens: int
    is_final: bool


@dataclasses.dataclass(frozen=True)
class CompressionLaunch:
    """A planned compression (§4.4): write the compressed KV into ``dest``,
    keep ``reserved`` as the in-progress block, return ``release`` to the
    pool once the kernel has consumed the sources."""
    request: Request
    dest: List[int]
    reserved: int
    release: List[int]


@dataclasses.dataclass
class SchedulerOutputs:
    """The explicit per-step plan ``ZipageEngine.step()`` executes."""
    step: int = 0
    admitted: List[Request] = dataclasses.field(default_factory=list)
    prefill_chunks: List[PrefillChunk] = dataclasses.field(
        default_factory=list)
    compress: List[CompressionLaunch] = dataclasses.field(
        default_factory=list)
    decode: List[Request] = dataclasses.field(default_factory=list)
    preempted: List[Request] = dataclasses.field(default_factory=list)
    swapped_out: List[Request] = dataclasses.field(default_factory=list)
    swapped_in: List[Request] = dataclasses.field(default_factory=list)
    finished: List[Request] = dataclasses.field(default_factory=list)
    n_blocked: int = 0
    token_budget: Optional[int] = None

    @property
    def n_prefill_tokens(self) -> int:
        return sum(c.n_tokens for c in self.prefill_chunks)

    @property
    def n_scheduled_tokens(self) -> int:
        return self.n_prefill_tokens + len(self.decode)


# ----------------------------------------------------------------------
# policies


class SchedulingPolicy:
    """Ordering hooks. ``admission_order`` ranks the waiting queue (admission
    is strict head-of-line within that order: the first request that does
    not fit stops the pass, preserving the paper's FCFS fairness argument);
    ``victim_order`` ranks running requests most-preemptible first."""
    name = "base"

    def admission_order(self, waiting: Sequence[Request]) -> List[Request]:
        raise NotImplementedError

    def victim_order(self, running: Sequence[Request]) -> List[Request]:
        raise NotImplementedError


class FcfsPolicy(SchedulingPolicy):
    """Arrival order in, LIFO out — exactly the pre-extraction engine."""
    name = "fcfs"

    def admission_order(self, waiting):
        return list(waiting)

    def victim_order(self, running):
        return list(reversed(running))


class PriorityPolicy(SchedulingPolicy):
    """``Request.priority`` descending (ties: arrival order); victims are
    the lowest-priority, most-recently-admitted requests."""
    name = "priority"

    def admission_order(self, waiting):
        return sorted(waiting, key=lambda r: (-r.priority, r.arrival, r.rid))

    def victim_order(self, running):
        order = list(enumerate(running))
        order.sort(key=lambda ir: (ir[1].priority, -ir[0]))
        return [r for _i, r in order]


class SrptPolicy(SchedulingPolicy):
    """Shortest remaining work first (prefill remainder + decode remainder);
    victims are the longest-remaining requests. Minimises mean latency on
    reasoning workloads with known generation caps."""
    name = "srpt"

    def admission_order(self, waiting):
        return sorted(waiting,
                      key=lambda r: (r.remaining_work(), r.arrival, r.rid))

    def victim_order(self, running):
        order = list(enumerate(running))
        order.sort(key=lambda ir: (-ir[1].remaining_work(), -ir[0]))
        return [r for _i, r in order]


class CacheAwarePolicy(SchedulingPolicy):
    """Most-reusable-prefix-first admission (docs/CACHING.md): waiting
    requests are scored by the prompt tokens a side-effect-free prefix-cache
    probe (``BlockManager.probe_prefix``) says the pool already holds,
    highest first, ties broken by arrival — so head-of-line blocking never
    strands a cheap cache hit behind an expensive miss, and cached blocks
    become admitted requests before pool pressure evicts them. Victims are
    FCFS-like (most recently admitted first): the newest request has
    accumulated the least reusable state. Bound to the engine's block
    manager at scheduler construction (``bind``); unbound it degrades to
    plain FCFS ordering."""
    name = "cache_aware"

    def __init__(self):
        self.bm: Optional[BlockManager] = None
        self.allow_compressed = False

    def bind(self, bm: BlockManager, allow_compressed: bool = False) -> None:
        self.bm = bm
        self.allow_compressed = allow_compressed

    def _score(self, r: Request) -> int:
        if self.bm is None:
            return 0
        return self.bm.probe_prefix(r.full_prompt,
                                    allow_compressed=self.allow_compressed)

    def admission_order(self, waiting):
        return sorted(waiting,
                      key=lambda r: (-self._score(r), r.arrival, r.rid))

    def victim_order(self, running):
        return list(reversed(running))


POLICIES = {p.name: p for p in (FcfsPolicy(), PriorityPolicy(),
                                SrptPolicy(), CacheAwarePolicy())}


def make_policy(name: str) -> SchedulingPolicy:
    try:
        proto = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown scheduler policy {name!r}; expected one "
                         f"of {tuple(POLICIES)}") from None
    # a fresh instance per scheduler: stateful policies (cache_aware binds
    # its engine's block manager) must not leak state across engines
    return type(proto)()


# ----------------------------------------------------------------------


class Scheduler:
    """Owns the queues and every scheduling decision; see module docstring
    for the per-step protocol."""

    def __init__(self, params: SchedulerParams, bm: BlockManager):
        if params.token_budget is not None \
                and params.token_budget < params.max_batch:
            raise ValueError(
                f"token_budget ({params.token_budget}) must be >= max_batch "
                f"({params.max_batch}) so every running request can decode "
                "each step")
        if params.admission_margin < 0:
            raise ValueError("admission_margin must be >= 0")
        if params.decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        if params.compression_deferral < 0:
            raise ValueError("compression_deferral must be >= 0")
        if params.quality_defer_min_free < 0:
            raise ValueError("quality_defer_min_free must be >= 0")
        if params.preemption_mode not in ("recompute", "swap", "auto"):
            raise ValueError(
                f"unknown preemption_mode {params.preemption_mode!r}; "
                "expected one of ('recompute', 'swap', 'auto')")
        if params.preemption_mode == "swap" and bm.swap_space_blocks <= 0:
            raise ValueError(
                "preemption_mode='swap' requires swap_space_blocks > 0 "
                "(the host swap tier is sized by CacheConfig."
                "swap_space_blocks)")
        if params.preemption_mode == "auto" and bm.swap_space_blocks <= 0:
            warnings.warn(
                "preemption_mode='auto' with swap_space_blocks=0: the "
                "swap tier is unarmed, every preemption will recompute",
                stacklevel=2)
        if params.cache_compressed_prefixes \
                and bm.prefix_cache_policy != "radix":
            raise ValueError(
                "cache_compressed_prefixes=True requires "
                "prefix_cache_policy='radix' — the flat prefix cache "
                "cannot index compressed segments")
        self.p = params
        self.bm = bm
        self.policy = make_policy(params.policy)
        self.preempt_policy = make_policy(params.preemption
                                          or params.policy)
        for pol in (self.policy, self.preempt_policy):
            if hasattr(pol, "bind"):
                pol.bind(bm, params.cache_compressed_prefixes)
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []      # admission order
        self.swapped: Deque[Request] = deque()   # host swap tier, FIFO
        self.finished: Dict[int, Request] = {}
        # swap execution is device work: the engine registers these two
        # callbacks (swap_executor(r, device_blocks, host_blocks) and
        # swap_in_executor(r, host_blocks, device_blocks)) when the host
        # swap tier is enabled and the arch supports it (paged attention,
        # no per-slot recurrent state). They run synchronously at plan
        # time so a victim's KV is parked before its blocks are reused.
        # None => swap unavailable, every preemption recomputes.
        self.swap_executor = None
        self.swap_in_executor = None
        # cumulative swap telemetry (surfaced via stats())
        self.n_swapped_out = 0
        self.n_swapped_in = 0
        self.swap_bytes = 0
        # cumulative quality telemetry (stats(); docs/EVAL.md): compression
        # events by SamplingParams.compression_policy, plus (request, step)
        # instances where the quality planner deferred a base-rule-due
        # compression
        self.n_comp_by_policy = {"default": 0, "protect": 0,
                                 "aggressive": 0}
        self.n_comp_deferred = 0
        self.free_slots = list(range(params.max_batch - 1, -1, -1))
        self.free_qslots = list(range(params.m_qslots - 1, -1, -1))
        # straggler-aware admission: EWMA of step latency vs baseline
        self.ewma: Optional[float] = None
        self.admission_scale = 1.0
        # monotonically increasing whenever scheduler-owned state that the
        # device tables mirror (slots, qslots, block lists, seq lens)
        # changes; the engine compares it against the last pushed version
        # to skip redundant host->device table uploads (docs/PERF.md)
        self.version = 0

    # ------------------------------------------------------------------
    # queue entry points

    def add_request(self, r: Request) -> None:
        self.waiting.append(r)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.swapped)

    def abort(self, rid: int) -> Optional[Request]:
        """Remove a waiting/running/swapped request, return its blocks to
        the pool and hand it back for finish bookkeeping (None if
        unknown)."""
        for r in list(self.waiting):
            if r.rid == rid:
                self.waiting.remove(r)
                return r
        for r in self.running:
            if r.rid == rid:
                self._release_slots(r)
                self.running.remove(r)
                return r
        for r in list(self.swapped):
            if r.rid == rid:
                self.bm.release_swapped(rid)
                self.swapped.remove(r)
                return r
        return None

    # ------------------------------------------------------------------
    # shared helpers

    def _needed_blocks(self, n_tokens: int) -> int:
        if self.p.attention_free:
            return 0
        if self.p.ring_blocks:
            return self.p.ring_blocks
        return -(-n_tokens // self.p.block_size)

    def _projected_blocks(self, n_tokens: int,
                          r: Optional[Request] = None) -> int:
        """Steady-state footprint of ``n_tokens``: with compression on, the
        block cap bounds it — the paper's lever for admission (§4.3). With
        a request in hand the cap is its *effective* one (``_n_max_cap``),
        so a deferring ``protect`` request projects the extra blocks it
        will actually hold."""
        raw = self._needed_blocks(n_tokens)
        if self.p.compression_enabled and self.p.n_max is not None:
            cap = self.p.n_max if r is None else self._n_max_cap(r)
            return min(raw, cap)
        return raw

    def projected_growth(self) -> int:
        """Blocks the running batch may still demand, under *post-
        compression* projections: each request's final footprint is capped
        at ``n_max`` once it compresses, so with compression on this stays
        small no matter how long the generations run."""
        total = 0
        for r in self.running:
            final_len = len(r.prompt) + len(r.output) \
                + max(0, r.max_new_tokens - len(r.output))
            total += max(0,
                         self._projected_blocks(final_len, r) - r.n_blocks)
        return total

    def _release_slots(self, r: Request) -> None:
        """Return r's blocks, decode slot and query slot to their pools
        (shared by preempt/finish/abort)."""
        self.version += 1
        self.bm.release(r.blocks)
        r.blocks = []
        if r.slot >= 0:
            self.free_slots.append(r.slot)
        if r.qslot >= 0:
            self.free_qslots.append(r.qslot)
        r.slot = r.qslot = -1

    # ------------------------------------------------------------------
    # quality-aware compression planning (docs/EVAL.md)

    @staticmethod
    def _comp_policy(r: Request) -> str:
        """The request's ``SamplingParams.compression_policy``."""
        return r.sampling.compression_policy

    def _n_max_cap(self, r: Request, worst_case: bool = False) -> int:
        """Effective block cap at which ``r``'s compression comes due.

        ``aggressive`` compresses at the paper's base cap ``n_max``;
        ``protect`` always defers by ``2 * compression_deferral`` extra
        blocks (per-request intent needs no global knob); ``default``
        defers by ``compression_deferral`` only when the planner is
        ``quality_aware`` *and* the pool has headroom
        (``quality_defer_min_free`` free blocks) — so the default path is
        bit-identical to the base rule unless opted in. Callers guarantee
        ``compression_enabled`` (n_max is not None).

        ``worst_case`` ignores the instantaneous pool headroom and
        returns the static envelope — what the sanitizer audits against,
        since a request deferred while the pool had headroom legitimately
        holds its extra blocks for a step or two after the pool fills."""
        n_max = self.p.n_max
        pol = self._comp_policy(r)
        if pol == "aggressive":
            return n_max
        if pol == "protect":
            return n_max + 2 * self.p.compression_deferral
        if self.p.quality_aware \
                and (worst_case
                     or self.bm.num_free >= self.p.quality_defer_min_free):
            return n_max + self.p.compression_deferral
        return n_max

    def _compression_due(self, r: Request) -> bool:
        """The single compression-trigger predicate shared by
        ``plan_compression`` (ready filter) and ``schedule_decode`` (the
        "compression will handle it" block gate) — keeping the two phases
        consistent by construction."""
        return (self.p.compression_enabled and r.qslot >= 0
                and r.seq_len == r.n_blocks * self.p.block_size
                and r.win_count >= self.p.window
                and r.n_blocks >= self._n_max_cap(r))

    def _victim_shielded(self, r: Request) -> bool:
        """Whether eviction should pass over ``r`` while an unshielded
        victim exists: explicit per-request intent (``protect``), or —
        under the quality-aware planner — measured high attention entropy
        (eviction of spread-attention requests is what degrades reasoning
        traces; docs/EVAL.md). ``aggressive`` requests volunteered, so
        telemetry never shields them."""
        pol = self._comp_policy(r)
        if pol == "protect":
            return True
        return (self.p.quality_aware and pol != "aggressive"
                and r.attn_entropy is not None
                and r.attn_entropy >= self.p.quality_entropy_threshold)

    def _preempt_mode(self, r: Request) -> str:
        """Resolve what preemption does to this victim (docs/SCHEDULER.md).
        Falls back to recompute whenever swap is unavailable: no engine
        executor (unsupported arch), no blocks to park, or a full swap
        pool."""
        mode = self.p.preemption_mode
        if mode == "recompute":
            return "recompute"
        if (self.swap_executor is None or not r.blocks
                or not self.bm.can_swap_out(r.n_blocks)):
            return "recompute"
        if mode == "swap":
            return "swap"
        # auto: bytes moved (out now + back in later) vs re-prefilling the
        # full accumulated prompt. A compressed victim holds n_max-ish
        # blocks against a far longer history — swap wins; a short
        # uncompressed one is cheaper to recompute.
        swap_cost = (2 * r.n_blocks * self.p.block_size
                     * self.p.swap_cost_per_token)
        recompute_cost = len(r.prompt) + len(r.output)
        return "swap" if swap_cost < recompute_cost else "recompute"

    def _reset_for_recompute(self, r: Request) -> None:
        """Recompute-mode bookkeeping: all progress is discarded; the
        generated tokens survive as prompt suffix (``full_prompt``) and
        the request re-enters the front of the waiting queue."""
        r.compressed = False
        r.seq_len = r.position = 0
        r.n_cached = 0
        r.pos_gap = 0
        r.win_count = 0
        r.n_prefilled = r.prefill_target = 0
        r.state = State.WAITING
        self.waiting.appendleft(r)       # front of waiting queue (§3)

    def _preempt(self, r: Request, outs: Optional[SchedulerOutputs]) -> None:
        if self._preempt_mode(r) == "swap":
            self._swap_out(r, outs)
            return
        self._release_slots(r)
        r.preempt_count += 1
        self.running.remove(r)
        self._reset_for_recompute(r)
        if outs is not None:
            outs.preempted.append(r)

    def _swap_out(self, r: Request, outs: Optional[SchedulerOutputs]) -> None:
        """Swap-mode preemption: park the victim's KV in the host swap
        pool, then free its device resources. Unlike recompute, all
        progress state (seq_len/position/compressed/prefill cursor, and —
        via the executor — the observation window and its win_count)
        survives the round trip. Shared prefix blocks are copy-on-swap:
        the host copy makes the restore self-contained while the device
        ref merely drops."""
        self.version += 1
        host_blocks = self.bm.swap_out(r.rid, r.n_blocks)
        # the executor also parks the observation-window rows while the
        # victim still owns its qslot, so win_count survives the swap
        self.swap_executor(r, list(r.blocks), host_blocks)
        self.bm.release(r.blocks)        # prefix-safe: shared blocks decref
        r.blocks = []
        if r.slot >= 0:
            self.free_slots.append(r.slot)
        if r.qslot >= 0:
            self.free_qslots.append(r.qslot)
        r.slot = r.qslot = -1
        r.n_shared = 0
        r.preempt_count += 1
        r.n_swaps += 1
        r.state = State.SWAPPED
        self.running.remove(r)
        self.swapped.append(r)
        self.n_swapped_out += 1
        self.swap_bytes += len(host_blocks) * self.p.block_bytes
        if outs is not None:
            outs.preempted.append(r)
            outs.swapped_out.append(r)

    def _find_victim(self, requester: Request,
                     exclude: frozenset = frozenset()) -> Optional[Request]:
        """§4.3/§4.4 victim tiers, in two passes: the first skips quality-
        shielded requests (``_victim_shielded``), the second admits them —
        shielding redirects pressure, it never deadlocks it. With no
        shielded or ``aggressive`` request present both passes reduce to
        the pre-quality search exactly."""
        victim = self._find_victim_pass(requester, exclude, shielded=True)
        if victim is None:
            victim = self._find_victim_pass(requester, exclude,
                                            shielded=False)
        return victim

    def _find_victim_pass(self, requester: Request, exclude: frozenset,
                          shielded: bool) -> Optional[Request]:
        """§4.3/§4.4 victim tiers — slotless first under hybrid scheduling,
        then uncompressed under prefix caching — ordered within each tier
        by the preemption policy (``aggressive``-policy volunteers
        stable-partitioned first). ``exclude`` holds requests that must not
        be preempted (e.g. peers already planned into this step's
        compression set, whose block lists a launch still references);
        ``shielded=True`` additionally passes over quality-shielded
        requests."""
        order = self.preempt_policy.victim_order(self.running)
        if any(self._comp_policy(r) == "aggressive" for r in order):
            order = ([r for r in order
                      if self._comp_policy(r) == "aggressive"]
                     + [r for r in order
                        if self._comp_policy(r) != "aggressive"])
        if shielded:
            order = [r for r in order if not self._victim_shielded(r)]
        if self.p.scheduling == "hybrid":
            for r in order:
                if r is requester or r.rid in exclude \
                        or r.state == State.FINISHED:
                    continue
                if r.qslot < 0:
                    # a compressed request can be slotless here only after
                    # a qslot-starved swap-in; recompute-preempting it
                    # would discard its condensed KV, so it stays
                    # swap-only even in this tier
                    if r.compressed and self._preempt_mode(r) != "swap":
                        continue
                    return r
        if self.p.prefix_ok:
            for r in order:
                if r is requester or r.rid in exclude \
                        or r.state == State.FINISHED:
                    continue
                if not r.compressed:
                    return r
        # swap-only tier: compressed victims are never recompute-preempted
        # (re-prefilling would both waste the compression and rebuild raw
        # KV, changing their downstream tokens), but the host swap tier
        # preserves their compressed KV exactly — and moves n_max-fewer
        # blocks doing it, so eviction-then-swap beats either alone.
        if self.p.preemption_mode != "recompute":
            for r in order:
                if r is requester or r.rid in exclude \
                        or r.state == State.FINISHED:
                    continue
                if r.compressed and self._preempt_mode(r) == "swap":
                    return r
        return None

    def _preempt_for_blocks(self, n_needed: int, requester: Request,
                            outs: Optional[SchedulerOutputs],
                            exclude: frozenset = frozenset()) -> bool:
        """Free blocks via preemption per §4.3/§4.4 rules. Returns success."""
        while not self.bm.can_allocate(n_needed):
            victim = self._find_victim(requester, exclude)
            if victim is None:
                return False
            self._preempt(victim, outs)
        return True

    def _can_decode_slotless(self, r: Request) -> bool:
        """Hybrid rule: decode without a qslot while < N_max blocks or
        < b - w tokens in the last block."""
        b, w = self.p.block_size, self.p.window
        return (r.n_blocks < self.p.n_max
                or r.tokens_in_last_block(b) < b - w)

    def _assign_qslots(self) -> None:
        """Paper §4.3 rule 3: free query slots go to the foremost running
        requests lacking one (only first M are eligible)."""
        if not self.p.compression_enabled:
            return
        for i, r in enumerate(self.running):
            if not self.free_qslots:
                break
            if i >= self.p.m_qslots:
                break
            if r.qslot < 0 and r.state != State.FINISHED:
                r.qslot = self.free_qslots.pop()
                self.version += 1
                if r.state == State.BLOCKED:
                    r.state = State.RUNNING

    # ------------------------------------------------------------------
    # phase 1: admission + prefill-chunk planning

    def schedule(self, step: int = 0) -> SchedulerOutputs:
        outs = SchedulerOutputs(step=step,
                                token_budget=self.p.token_budget)
        self._swap_in_ready(outs)
        self._assign_qslots()
        # token budget shared across prefill + decode (continuous batching):
        # every decodable running request is reserved one token up front,
        # prefill chunks split what remains.
        if self.p.token_budget is None:
            prefill_avail = math.inf
        else:
            n_decode_est = sum(1 for r in self.running
                               if r.state != State.FINISHED
                               and not r.prefill_pending and not r.done())
            prefill_avail = max(0, self.p.token_budget - n_decode_est)
        max_chunk = self.p.max_prefill_chunk or math.inf
        # carried-over partial prefills (token-budget mode) come first, in
        # admission order — they already hold slots and blocks.
        for r in self.running:
            if not r.prefill_pending:
                continue
            prefill_avail = self._plan_chunk(outs, r, prefill_avail,
                                             max_chunk)
        self._admit(outs, prefill_avail, max_chunk)
        return outs

    def _plan_chunk(self, outs: SchedulerOutputs, r: Request,
                    prefill_avail, max_chunk):
        """Plan one request's prefill chunk for this step. A final chunk
        reserves one extra budget token: the request decodes in the same
        step once its prompt completes, and that decode shares the
        budget."""
        rem = r.prefill_target - r.n_prefilled
        cap = min(rem, max_chunk)
        if cap >= rem and prefill_avail >= rem + 1:
            outs.prefill_chunks.append(PrefillChunk(r, r.n_prefilled, rem,
                                                    is_final=True))
            return prefill_avail - (rem + 1)
        # a non-final chunk must leave >=1 prompt token for the final one —
        # only final chunks sample the first token
        take = int(min(cap, max(0, prefill_avail), rem - 1))
        if take > 0:
            outs.prefill_chunks.append(PrefillChunk(r, r.n_prefilled, take,
                                                    is_final=False))
            return prefill_avail - take
        return prefill_avail

    def _swap_in_ready(self, outs: SchedulerOutputs) -> None:
        """Re-admit swapped requests (FIFO — they already spent their
        prefill compute) while a decode slot and device blocks are
        available under the same admission margin waiting requests face.
        The engine's swap-in executor restores the KV synchronously, so
        the request decodes this very step."""
        # a swapped queue with no executor (e.g. a swap-mode snapshot
        # restored into an engine without a swap tier) can never swap in:
        # demote those requests to recompute re-admission — their parked
        # KV is unreachable, but full_prompt rebuilds it
        while self.swapped and self.swap_in_executor is None:
            r = self.swapped.popleft()
            self.bm.release_swapped(r.rid)
            self._reset_for_recompute(r)
        while self.swapped:
            r = self.swapped[0]
            n = self.bm.n_swapped_blocks(r.rid)
            if not self.free_slots:
                break
            margin = 0
            if self.p.admission_margin > 0:
                final_len = len(r.prompt) + r.max_new_tokens
                own = max(0, self._projected_blocks(final_len) - n)
                margin = math.ceil(self.p.admission_margin
                                   * (self.projected_growth() + own))
            if not self.bm.can_allocate(n, margin=margin):
                break
            self.version += 1
            host_blocks = self.bm.swapped_blocks(r.rid)
            r.blocks = self.bm.allocate(n)
            r.slot = self.free_slots.pop()
            if self.p.compression_enabled and self.free_qslots \
                    and len(self.running) < self.p.m_qslots:
                r.qslot = self.free_qslots.pop()
            r.state = State.RUNNING
            # slot/qslot + blocks are assigned before the copy: the
            # executor re-arms tokens_next for the new slot and, given a
            # qslot, restores the parked observation window (returns
            # truthy); without that restore the window must re-prime
            if not self.swap_in_executor(r, host_blocks, r.blocks):
                r.win_count = 0
            self.bm.release_swapped(r.rid)
            self.swapped.popleft()
            self.running.append(r)
            self.n_swapped_in += 1
            self.swap_bytes += n * self.p.block_bytes
            outs.swapped_in.append(r)

    def _admit(self, outs: SchedulerOutputs, prefill_avail, max_chunk):
        if self.swapped:
            # anti-thrash: while a swapped request cannot come back (the
            # head of the queue lacks a slot or blocks), admitting fresh
            # prompts would grab exactly the resources it is waiting for
            return prefill_avail
        limit = max(1, int(self.p.prefill_rows * self.admission_scale))
        for r in self.policy.admission_order(self.waiting):
            if len(outs.admitted) >= limit or not self.free_slots:
                break
            if self.p.scheduling == "constrained" \
                    and self.p.compression_enabled and not self.free_qslots:
                break
            prompt = r.full_prompt
            if prefill_avail < 1:
                break                    # no token budget left this step
            if self.p.prefix_ok:
                m = self.bm.lookup_prefix_ex(
                    prompt,
                    allow_compressed=self.p.cache_compressed_prefixes)
                shared, n_cached, chain = m.blocks, m.n_tokens, m.chain
                # a compressed-segment hit covers more tokens than the KV
                # entries it occupies; the gap shifts every cache index
                # below the token position for the rest of the request's
                # life (Request.pos_gap)
                pos_gap = m.n_tokens - m.n_entries
            else:
                shared, n_cached, chain = [], 0, []
                pos_gap = 0
            n_new = self._needed_blocks(len(prompt) - pos_gap) - len(shared)
            # compression-aware admission: beyond the prompt's own blocks,
            # require `admission_margin` of the batch's projected *post-
            # compression* growth to stay free. margin 0.0 (default) is the
            # paper's greedy admit-then-preempt behavior.
            margin = 0
            if self.p.admission_margin > 0:
                # final length counts max_new_tokens from the *original*
                # prompt — full_prompt already contains any tokens a
                # preempted request generated, and max_new_tokens caps the
                # total output
                final_len = len(r.prompt) + r.max_new_tokens
                own_growth = max(
                    0,
                    self._projected_blocks(final_len)
                    - self._needed_blocks(len(prompt)))
                margin = math.ceil(self.p.admission_margin
                                   * (self.projected_growth() + own_growth))
                # cache-aware refinement: matched blocks are KV the pool
                # already holds — admitting this request does not compete
                # with the batch's projected growth for them, so the
                # reserve shrinks by the hit size
                margin = max(0, margin - len(shared))
            if not self.bm.can_allocate(n_new, margin=margin):
                # roll back the prefix refs and stop admitting (strict
                # head-of-line within the policy order)
                if shared:
                    self.bm.release(shared)
                break
            self.version += 1
            new_blocks = self.bm.allocate(n_new) if n_new else []
            r.blocks = shared + new_blocks
            r.n_cached, r.chain, r.n_shared = n_cached, chain, len(shared)
            r.pos_gap = pos_gap
            # an adopted segment's blocks sit below token positions the
            # chain hashes describe — registering them would serve
            # compressed KV as raw; only gap-free admissions register
            if self.p.prefix_ok and chain and pos_gap == 0:
                self.bm.register_prefix(r.blocks, chain, len(shared))
            r.slot = self.free_slots.pop()
            if self.p.compression_enabled and self.free_qslots \
                    and len(self.running) < self.p.m_qslots:
                r.qslot = self.free_qslots.pop()
            # a ring holds the window's tokens (the JAX package clamps at
            # the ring's block count here, a unit slip nothing reads)
            ring = self.p.ring_blocks * self.p.block_size
            r.seq_len = (min(len(prompt), ring) if ring
                         else (0 if self.p.attention_free
                               else len(prompt) - pos_gap))
            r.position = len(prompt)
            if pos_gap:
                r.compressed = True      # lives under compressed accounting
            r.state = State.RUNNING
            r.n_prefilled = r.n_cached
            r.prefill_target = len(prompt)
            self.waiting.remove(r)
            self.running.append(r)
            outs.admitted.append(r)
            # a zero-token final chunk still flows through prefill so the
            # first token is sampled (full prefix-cache hit)
            prefill_avail = self._plan_chunk(outs, r, prefill_avail,
                                             max_chunk)
        return prefill_avail

    # ------------------------------------------------------------------
    # phase 2: compression planning (after prefill — window counters land
    # with the final chunk)

    def plan_compression(self, outs: SchedulerOutputs) -> None:
        if not self.p.compression_enabled:
            return
        b = self.p.block_size
        eligible = [r for r in self.running
                    if r.state in (State.RUNNING, State.BLOCKED)
                    and not r.prefill_pending
                    and r.qslot >= 0
                    and r.seq_len == r.n_blocks * b
                    and r.win_count >= self.p.window]
        ready = [r for r in eligible if self._compression_due(r)]
        # quality telemetry: base-rule-due candidates the effective cap
        # (_n_max_cap) let keep their full KV another step
        self.n_comp_deferred += sum(
            1 for r in eligible
            if r.n_blocks >= self.p.n_max and not self._compression_due(r))
        if self.p.quality_aware and len(ready) > 1:
            # lowest-redundancy-first within each policy class (ROADMAP
            # item 5 / docs/EVAL.md): aggressive volunteers lead, protect
            # trails; un-measured requests (no telemetry yet) keep their
            # running-order position at the back of their class
            rank = {"aggressive": 0, "default": 1, "protect": 2}
            ready = [r for _i, r in sorted(
                enumerate(ready),
                key=lambda ir: (rank[self._comp_policy(ir[1])],
                                ir[1].redundancy is None,
                                ir[1].redundancy or 0.0, ir[0]))]
        nb = self.p.budget_blocks
        # compression-ready peers are off-limits for preemption here: an
        # earlier launch in this set still references their block lists,
        # and preempting a later one would empty the blocks this very loop
        # is about to slice
        no_preempt = frozenset(r.rid for r in ready)
        def cow_need(r):
            # copy-on-write: a block another reader depends on — shared
            # prefix (ref > 1), cached compressed-segment payload, or a
            # radix cache registration — must not be overwritten in
            # place; compression copies into fresh dest blocks instead
            n_prefix = sum(1 for blk in r.blocks
                           if self.bm.is_cow_protected(blk))
            need = 0
            if n_prefix:
                need = min(n_prefix, nb)
                if self.bm.is_cow_protected(
                        r.blocks[min(nb, r.n_blocks - 1)]):
                    need += 1                      # reserved must be fresh too
            return n_prefix, need

        for r in ready:
            n_prefix, need = cow_need(r)
            if need and not self.bm.can_allocate(need) \
                    and not self._preempt_for_blocks(need, r, outs,
                                                     exclude=no_preempt):
                # out of road: no free or evictable block and no
                # preemptible victim (a whole batch can be compression-
                # ready at once, and ready peers shield each other). A
                # protection that exists only for the cache's benefit — a
                # sole-referenced radix registration, not a segment
                # payload — is best-effort: drop those registrations and
                # condense in place (the legacy behavior, minus its stale
                # entries) rather than deadlock the batch on fresh blocks
                # that can never materialise.
                soft = [blk for blk in r.blocks
                        if self.bm.ref[blk] == 1
                        and blk in self.bm.block_hash
                        and blk not in self.bm.seg_of_block]
                if soft:
                    self.bm.invalidate_blocks(soft)
                    n_prefix, need = cow_need(r)
                if need and not self.bm.can_allocate(need):
                    r.state = State.BLOCKED        # retry next step
                    continue
            if n_prefix == 0:
                dest = r.blocks[:nb]
                reserved = r.blocks[nb]
                release = r.blocks[nb + 1:]
            else:
                fresh = self.bm.allocate(min(n_prefix, nb))
                dest = fresh + r.blocks[n_prefix:][:nb - len(fresh)]
                if self.bm.is_cow_protected(
                        r.blocks[min(nb, r.n_blocks - 1)]):
                    reserved = self.bm.allocate(1)[0]
                    keep = set(dest) | {reserved}
                    release = [blk for blk in r.blocks if blk not in keep]
                else:
                    reserved = r.blocks[nb] if len(r.blocks) > nb else \
                        self.bm.allocate(1)[0]
                    keep = set(dest) | {reserved}
                    release = [blk for blk in r.blocks if blk not in keep]
            outs.compress.append(CompressionLaunch(r, dest, reserved,
                                                   release))

    def commit_compression(self, outs: SchedulerOutputs) -> None:
        """Deterministic host bookkeeping once the kernel is launched:
        release the source blocks, swap in the compressed table, and (in
        async mode) park the request for this step's decode (§4.5)."""
        k = self.p.budget_blocks * self.p.block_size
        if outs.compress:
            self.version += 1
        for c in outs.compress:
            r = c.request
            span = r.seq_len                 # tokens this launch condenses
            first = not r.compressed
            shared_released = [blk for blk in c.release
                               if self.bm.ref[blk] > 1]
            self.bm.release(c.release)
            r.n_compressions += 1
            r.comp_blocks_freed += len(c.release) - len(shared_released)
            self.n_comp_by_policy[self._comp_policy(r)] += 1
            r.blocks = list(c.dest) + [c.reserved]
            r.seq_len = k
            r.compressed = True
            r.n_shared = 0
            if self.bm.prefix_cache_policy == "radix":
                # the kernel overwrites dest/reserved in place: any cache
                # registration naming them would serve condensed KV under a
                # raw-KV hash — drop it, subtree and all (flat keeps the
                # legacy behavior for parity with the frozen engine)
                self.bm.invalidate_blocks(r.blocks)
                if (self.p.cache_compressed_prefixes and first
                        and span <= r.prefill_target
                        and 0 < span // self.p.block_size <= len(r.chain)):
                    # prompt-pure first compression (no decoded token in
                    # the span, so the condensed payload and the selection
                    # that produced it depend only on the prompt): cache it
                    # as a segment keyed by the span-ending chain hash
                    self.bm.register_segment(
                        r.chain[span // self.p.block_size - 1],
                        list(c.dest), span)
            if self.p.async_compression:
                r.state = State.COMPRESSING     # sits out this decode step

    # ------------------------------------------------------------------
    # phase 3: decode planning

    def schedule_decode(self, outs: SchedulerOutputs) -> List[Request]:
        """Ensure every decodable request has room for one token; apply
        blocking/preemption rules. Fills ``outs.decode``."""
        b = self.p.block_size
        active = []
        for r in list(self.running):
            if r.state == State.COMPRESSING:
                continue
            if r.prefill_pending:
                continue                 # chunked prefill still in flight
            if r.done():
                # already terminated (eos/stop on the prefill-sampled
                # token); decoding again would bury the match under a
                # second token before end_step sees it
                continue
            if r.state == State.BLOCKED:
                r.state = State.RUNNING          # retry below
            if r not in self.running:            # got preempted this step
                continue
            if self.p.attention_free:
                active.append(r)
                continue
            if self.p.ring_blocks:
                active.append(r)
                continue
            # hybrid slotless boundary rule
            if (self.p.compression_enabled and r.qslot < 0
                    and not self._can_decode_slotless(r)):
                r.state = State.BLOCKED
                continue
            if r.seq_len == r.n_blocks * b:      # last block full
                if self._compression_due(r):
                    # compression will handle it (was detected this step or
                    # will be next step); skip decode if it somehow races
                    r.state = State.BLOCKED
                    continue
                ok = self.bm.can_allocate(1) or \
                    self._preempt_for_blocks(1, r, outs)
                if not ok or r not in self.running:
                    if r in self.running:
                        r.state = State.BLOCKED
                    continue
                blk = self.bm.allocate(1)[0]
                r.blocks.append(blk)
                self.version += 1
            active.append(r)
        outs.decode = [r for r in active if r in self.running]
        return outs.decode

    # ------------------------------------------------------------------
    # multi-step decode horizon (docs/PERF.md)

    def quiescent_horizon(self, active: Sequence[Request],
                          outs: Optional[SchedulerOutputs] = None):
        """Per-request *host-free* decode budgets for this step, and the
        fused scan length ``K = max(caps)`` (capped by ``decode_steps``).

        ``caps[i]`` is how many consecutive tokens ``active[i]`` can decode
        before a decision only the host can make comes due: a block
        allocation or compression launch (last allocated block fills), the
        hybrid slotless ``b - w`` boundary (§4.3), finish-by-length, or
        per-token stop-sequence matching. A row whose cap is below K simply
        sits out the scan's remaining iterations (the decode batch is
        dense, so the masked rows cost nothing) and resumes next step —
        its (seed, position)-keyed token stream is unaffected.

        Under a ``token_budget`` each row's cap is additionally bounded by
        its even share of what this step's prefill chunks (``outs``) left
        over, preserving the per-step invariant
        ``n_prefill_tokens + n_decode <= token_budget``.

        Returns ``(K, caps)`` with ``caps`` aligned to ``active``;
        ``K == 1`` reproduces single-step scheduling exactly.
        """
        limit = self.p.decode_steps
        if self.p.token_budget is not None and active:
            avail = self.p.token_budget \
                - (outs.n_prefill_tokens if outs else 0)
            # schedule() reserved one token per decodable row up front,
            # so every active row's share is at least 1
            limit = min(limit, max(1, avail // len(active)))
        caps = []
        for r in active:
            if limit <= 1 or r.sampling.stop:
                caps.append(1)        # host matches stop sequences per token
                continue
            c = min(limit, r.max_new_tokens - len(r.output))
            caps.append(max(1, self._host_free_steps(r, c)))
        return max(caps, default=1), caps

    def _host_free_steps(self, r: Request, cap: int) -> int:
        """Consecutive decode tokens ``r`` can take without host
        intervention, at most ``cap``. The first token was already
        validated (and its block allocated) by ``schedule_decode``."""
        if self.p.attention_free or self.p.ring_blocks:
            return cap               # no paged growth: length-bound only
        b, w = self.p.block_size, self.p.window
        s, n = r.seq_len + 1, r.n_blocks
        k = 1
        while k < cap:
            if s >= n * b:
                break                # needs a block (or compression) next
            if self.p.compression_enabled and r.qslot < 0:
                til = b if (s % b == 0 and s > 0) else s % b
                if not (n < self.p.n_max or til < b - w):
                    break            # hybrid slotless boundary (§4.3)
            s += 1
            k += 1
        return k

    # ------------------------------------------------------------------
    # phase 4: step epilogue

    def end_step(self, outs: SchedulerOutputs) -> List[Request]:
        """Async-compressed requests rejoin; finished requests release their
        resources. Returns (and records) the newly finished."""
        for r in self.running:
            if r.state == State.COMPRESSING:
                r.state = State.RUNNING
        for r in list(self.running):
            if r.state == State.COMPRESSING or r.prefill_pending:
                continue
            reason = r.check_finish()
            if reason is None:
                continue
            r.finish_reason = reason
            r.truncate_stop()
            self._register_finished_prefix(r)
            self._release_slots(r)
            r.state = State.FINISHED
            r.t_finish = time.monotonic()
            self.running.remove(r)
            self.finished[r.rid] = r
            outs.finished.append(r)
        outs.n_blocked = sum(1 for r in self.running
                             if r.state == State.BLOCKED)
        return outs.finished

    def _register_finished_prefix(self, r: Request) -> None:
        """Radix multi-turn reuse (docs/CACHING.md): before a finished
        request's blocks return to the pool, register its *generated*
        tokens' full blocks under the extended hash chain. The next turn of
        the conversation — prompt + this output + a new user message —
        then longest-prefix matches straight through the generation instead
        of stopping at the old prompt boundary. Only raw (uncompressed,
        gap-free) KV is registerable; compressed requests contribute via
        ``cache_compressed_prefixes`` segments instead."""
        if (self.bm.prefix_cache_policy != "radix" or not self.p.prefix_ok
                or r.compressed or r.pos_gap or not r.blocks
                or self.p.ring_blocks or self.p.attention_free):
            return
        b = self.p.block_size
        stream = r.full_prompt
        # seq_len counts KV entries actually written; truncate_stop may
        # have trimmed the stream below it, and the final sampled token's
        # KV was never written — min() keeps hashes honest
        n_full = min(min(r.seq_len, len(stream)) // b, r.n_blocks)
        if n_full <= 0:
            return
        h, chain = 0, []
        for i in range(n_full):
            h = self.bm.chain_hash(h, tuple(stream[i * b:(i + 1) * b]))
            chain.append(h)
        self.bm.register_prefix(r.blocks, chain, 0)

    def observe_latency(self, dt: float) -> None:
        """Straggler-aware admission: back off when step latency inflates."""
        self.ewma = dt if self.ewma is None else 0.9 * self.ewma + 0.1 * dt
        if self.ewma > 0 and dt > 3.0 * self.ewma:
            self.admission_scale = max(0.25, self.admission_scale * 0.5)
        else:
            self.admission_scale = min(1.0, self.admission_scale * 1.1)

    # ------------------------------------------------------------------
    def stats(self, outs: SchedulerOutputs,
              n_decoded: Optional[int] = None) -> dict:
        """Per-step telemetry merged into the engine's metrics entries and
        surfaced as ``Zipage.scheduler_stats`` (docs/SCHEDULER.md).
        ``n_decoded`` is the number of decode tokens actually emitted —
        under a multi-step horizon that exceeds ``len(outs.decode)``, and
        ``budget_util`` must reflect it."""
        scheduled = outs.n_prefill_tokens + (
            n_decoded if n_decoded is not None else len(outs.decode))
        return {
            "policy": self.policy.name,
            "preemption_mode": self.p.preemption_mode,
            "n_admitted": len(outs.admitted),
            "n_preempted": len(outs.preempted),
            "n_swapped_out": len(outs.swapped_out),
            "n_swapped_in": len(outs.swapped_in),
            "n_swapped": len(self.swapped),
            "swap_bytes": self.swap_bytes,
            "swap_util": self.bm.swap_util,
            "n_blocked": outs.n_blocked,
            "n_finished": len(outs.finished),
            "n_prefill_tokens": outs.n_prefill_tokens,
            "n_scheduled_tokens": scheduled,
            "token_budget": outs.token_budget,
            "budget_util": (scheduled / outs.token_budget
                            if outs.token_budget else None),
            "free_blocks": self.bm.num_free,
            "admission_scale": self.admission_scale,
            # quality-aware compression telemetry (cumulative;
            # docs/EVAL.md): events by SamplingParams.compression_policy
            # plus quality-planner deferrals
            "quality_aware": self.p.quality_aware,
            "n_comp_default": self.n_comp_by_policy["default"],
            "n_comp_protect": self.n_comp_by_policy["protect"],
            "n_comp_aggressive": self.n_comp_by_policy["aggressive"],
            "n_comp_deferred": self.n_comp_deferred,
            # prefix-cache telemetry (cumulative; docs/CACHING.md)
            **self.bm.cache_stats(),
        }
