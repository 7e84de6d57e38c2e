"""Orthogonal serving configs composed into the internal ``EngineOptions``
(the port's copy of ``repro.api.config``: same classes, fields and
defaults; settings the port has not ported raise when the engine is
built).

The engine-internal ``EngineOptions`` mixes cache sizing, scheduler policy
and runner shapes in one bag. The public API splits them along ownership
lines (mirroring vLLM's CacheConfig/SchedulerConfig split):

  * ``CacheConfig``       — KV pool: paging, budget, compression, prefix cache
  * ``SchedulerConfig``   — batching policy: slots, query slots, async comp.
  * ``ModelRunnerConfig`` — device step shapes: prefill buckets, dtype

``build_engine_options`` composes the three back into ``EngineOptions`` for
the internal layer; ``route_overrides`` lets call sites pass flat kwargs
(``Zipage.from_config("tiny-lm", block_size=8, max_batch=4)``) that are
routed to the config owning each field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.compression import CompressOptions
from repro_torch.core.engine import EngineOptions
from repro_torch.core.serve_model import DECODE_KERNELS


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """KV-cache pool layout and the Compressed-PagedAttention budget."""
    block_size: int = 16
    n_total_blocks: int = 256
    n_max: Optional[int] = 4         # block cap; None => full-KV baseline
    window: int = 4                  # observation window w
    prefix_caching: bool = True
    # prefix-cache index structure (docs/CACHING.md): "radix" (default)
    # keeps cached blocks in a radix tree over chain hashes — partial-
    # prefix reuse at block granularity, leaf-first LRU eviction, and
    # compressed-segment caching; "flat" is the legacy exact-map
    # behavior kept for byte-for-byte parity with the frozen engine
    prefix_cache_policy: str = "radix"
    # LRU high-watermark: cap unreferenced-but-cached blocks at this
    # fraction of the pool (excess is evicted leaf-first on release);
    # 1.0 disables the cap — cached blocks are then reclaimed only on
    # allocation pressure
    prefix_cache_watermark: float = 1.0
    # also cache *compressed* prefixes (docs/CACHING.md "Compressed
    # segments"): a prompt-pure compression's condensed payload is kept
    # as a cache segment, so a later request with the same long prompt
    # adopts n_tokens of history for k cache entries. Requires the radix
    # policy and compression enabled; hits are semantically (not
    # bit-wise) equivalent to recompute — see the docs caveat.
    cache_compressed_prefixes: bool = False
    compress: Optional[CompressOptions] = None   # None => window defaults
    max_model_len: int = 512
    # host swap tier: CPU-side block slots backing swap-mode preemption
    # (SchedulerConfig.preemption_mode). 0 disables the tier; preempted
    # requests are then always re-prefilled (recompute mode).
    swap_space_blocks: int = 0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """The compression-aware scheduling strategy (paper §4.3/§4.5),
    executed by ``repro_torch.core.scheduler.Scheduler`` — see docs/SCHEDULER.md
    for the full queue lifecycle and what each knob trades off."""
    max_batch: int = 16              # decode slots
    m_qslots: int = 8                # paper's M (query-slot pool)
    scheduling: str = "hybrid"       # hybrid | constrained
    async_compression: bool = True
    # admission/preemption policy (repro_torch.core.scheduler.POLICIES):
    # fcfs | priority (Request.priority desc) | srpt (shortest remaining)
    # | cache_aware (most projected prefix-cache-reusable blocks first,
    # FCFS tie-break; victims are least-reusable first — docs/CACHING.md
    # "Cache-aware admission")
    policy: str = "fcfs"
    # victim-order policy for preemption; None => same as `policy`
    preemption: Optional[str] = None
    # what preemption *does* (docs/SCHEDULER.md "Preemption modes"):
    # "recompute" frees the victim's blocks and re-prefills on
    # re-admission; "swap" parks its KV in the host swap tier
    # (CacheConfig.swap_space_blocks) and restores it block-for-block;
    # "auto" picks per victim by the swap-bytes-vs-re-prefill cost model
    preemption_mode: str = "recompute"
    # auto's exchange rate: host-copy cost of one KV token-slot (one
    # direction), in re-prefill-token equivalents — swap a victim iff
    # 2 * n_blocks * block_size * swap_cost_per_token < tokens to
    # re-prefill. Lower it on fast interconnects to swap more eagerly.
    swap_cost_per_token: float = 0.5
    # shared prefill+decode token budget per step (continuous batching with
    # chunked prefill); None => unbounded (prefill completes in-step)
    token_budget: Optional[int] = None
    # per-request prefill chunk cap per step; None => budget-limited only
    max_prefill_chunk: Optional[int] = None
    # compression-aware admission: fraction of the running batch's
    # projected *post-compression* block growth that must stay free when
    # admitting. 0.0 => the paper's greedy admit-then-preempt behavior.
    admission_margin: float = 0.0
    # quality-aware compression planning (docs/EVAL.md): feed the
    # per-request scoring telemetry back into the planner — candidates
    # compress lowest-redundancy-first, default-policy requests defer
    # compression by `compression_deferral` blocks past n_max while at
    # least `quality_defer_min_free` pool blocks stay free, and requests
    # whose normalized window-attention entropy is
    # >= `quality_entropy_threshold` are shielded from preemption while
    # an unshielded victim exists. False => the planner is bit-identical
    # to the pre-quality scheduler (per-request
    # SamplingParams.compression_policy "protect"/"aggressive" still
    # apply).
    quality_aware: bool = False
    compression_deferral: int = 2
    quality_defer_min_free: int = 16
    quality_entropy_threshold: float = 0.85


#: kernel backends accepted by ``ModelRunnerConfig.kernel_backend``. The
#: port's kernels follow the tensors' device (a CUDA tensor launches the
#: hand-written kernel, a CPU tensor runs its plain version), so "auto" is
#: the only setting; the JAX package's Pallas backend names do not apply.
KERNEL_BACKENDS = ("auto",)


@dataclasses.dataclass(frozen=True)
class ModelRunnerConfig:
    """Fixed device-step shapes and numerics."""
    prefill_rows: int = 4
    prefill_len: int = 128
    dtype: str = "float32"           # float32 | bfloat16 | float16
    measure_phases: bool = False     # block per phase for timing benches
    # kernel dispatch (repro_torch.kernels.ops): kernels follow the
    # tensors' device; only "auto" is accepted
    kernel_backend: str = "auto"
    # decode kernel family (docs/KERNELS.md "Ragged decode"): "ragged"
    # scales each slot's attention work with its live page count —
    # padded and evicted pages are never fetched; "dense" restores the
    # pool-wide-grid kernel. Token streams are bit-identical either way,
    # so this is a fallback/ablation switch, not a numerics choice.
    decode_kernel: str = "ragged"
    # decode hot path (docs/PERF.md): fuse_sampling runs the per-slot
    # sampler inside the jitted decode step (tokens never leave the
    # device between steps); decode_steps > 1 additionally runs up to
    # that many decode+sample iterations per dispatch, bounded by the
    # scheduler's quiescent horizon. decode_steps > 1 requires
    # fuse_sampling; token streams are identical either way.
    fuse_sampling: bool = True
    decode_steps: int = 1


_CONFIG_TYPES = (CacheConfig, SchedulerConfig, ModelRunnerConfig)
_FIELD_OWNER = {f.name: t for t in _CONFIG_TYPES
                for f in dataclasses.fields(t)}


def route_overrides(cache: Optional[CacheConfig] = None,
                    scheduler: Optional[SchedulerConfig] = None,
                    runner: Optional[ModelRunnerConfig] = None,
                    **overrides
                    ) -> Tuple[CacheConfig, SchedulerConfig,
                               ModelRunnerConfig]:
    """Apply flat field overrides on top of (possibly defaulted) configs."""
    by_type = {CacheConfig: dict(), SchedulerConfig: dict(),
               ModelRunnerConfig: dict()}
    for k, v in overrides.items():
        owner = _FIELD_OWNER.get(k)
        if owner is None:
            if k in ("temperature", "seed", "top_k", "top_p"):
                raise TypeError(
                    f"{k!r} is per-request now — pass it via "
                    "SamplingParams, not the engine config")
            raise TypeError(f"unknown engine config field {k!r}")
        by_type[owner][k] = v
    cache = dataclasses.replace(cache or CacheConfig(),
                                **by_type[CacheConfig])
    scheduler = dataclasses.replace(scheduler or SchedulerConfig(),
                                    **by_type[SchedulerConfig])
    runner = dataclasses.replace(runner or ModelRunnerConfig(),
                                 **by_type[ModelRunnerConfig])
    return cache, scheduler, runner


def build_engine_options(cache: CacheConfig, scheduler: SchedulerConfig,
                         runner: ModelRunnerConfig) -> EngineOptions:
    if runner.kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(
            f"unknown kernel_backend {runner.kernel_backend!r}; expected "
            f"one of {KERNEL_BACKENDS}")
    if runner.decode_kernel not in DECODE_KERNELS:
        raise ValueError(
            f"unknown decode_kernel {runner.decode_kernel!r}; expected "
            f"one of {DECODE_KERNELS}")
    compress = cache.compress
    if compress is None:
        compress = CompressOptions(window=cache.window)
    elif compress.window != cache.window:
        raise ValueError(
            f"CacheConfig.window ({cache.window}) must match "
            f"compress.window ({compress.window}); set both, or pass only "
            "compress and window together")
    # policy names, token_budget >= max_batch and admission_margin bounds
    # are validated by repro_torch.core.scheduler (Scheduler.__init__ /
    # make_policy), which the engine constructs before any device work
    return EngineOptions(
        block_size=cache.block_size,
        n_total_blocks=cache.n_total_blocks,
        max_batch=scheduler.max_batch,
        m_qslots=scheduler.m_qslots,
        n_max=cache.n_max,
        window=cache.window,
        scheduling=scheduler.scheduling,
        prefix_caching=cache.prefix_caching,
        prefix_cache_policy=cache.prefix_cache_policy,
        prefix_cache_watermark=cache.prefix_cache_watermark,
        cache_compressed_prefixes=cache.cache_compressed_prefixes,
        async_compression=scheduler.async_compression,
        policy=scheduler.policy,
        preemption=scheduler.preemption,
        preemption_mode=scheduler.preemption_mode,
        swap_cost_per_token=scheduler.swap_cost_per_token,
        swap_space_blocks=cache.swap_space_blocks,
        token_budget=scheduler.token_budget,
        max_prefill_chunk=scheduler.max_prefill_chunk,
        admission_margin=scheduler.admission_margin,
        quality_aware=scheduler.quality_aware,
        compression_deferral=scheduler.compression_deferral,
        quality_defer_min_free=scheduler.quality_defer_min_free,
        quality_entropy_threshold=scheduler.quality_entropy_threshold,
        compress=compress,
        max_model_len=cache.max_model_len,
        prefill_rows=runner.prefill_rows,
        prefill_len=runner.prefill_len,
        dtype=runner.dtype,
        measure_phases=runner.measure_phases,
        kernel_backend=runner.kernel_backend,
        decode_kernel=runner.decode_kernel,
        fuse_sampling=runner.fuse_sampling,
        decode_steps=runner.decode_steps)
