"""``Zipage`` — the serving facade (the port's ``repro.api.engine``).

The public face of ``repro_torch.core.engine.ZipageEngine``, with the same
names and knobs as the JAX package's facade. It runs on the card unless
``device="cpu"`` is passed. The facade adds the request-scoped contract
production engines expose:

  * per-request :class:`SamplingParams` (temperature/top-k/top-p/seed/stop),
  * incremental ``add_request()`` / ``step()`` streaming over continuous
    batching, emitting :class:`RequestOutput` snapshots with
    :class:`CompletionChunk` deltas as tokens land,
  * blocking batch ``generate(prompts, params)``,
  * mid-flight ``abort(request_id)`` that returns blocks to the pool,
  * ``Zipage.from_config("tiny-lm", block_size=8, ...)`` one-line bring-up
    with the CacheConfig / SchedulerConfig / ModelRunnerConfig split,
  * the async surface, ``generate_async()`` and ``stream()``, over the
    background loop the HTTP tier also uses (``repro_torch.api.aio``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Union

import torch

from repro_torch.api.config import (CacheConfig, ModelRunnerConfig,
                                    SchedulerConfig, build_engine_options,
                                    route_overrides)
from repro_torch.api.outputs import (CompletionChunk, RequestOutput,
                                     UsageInfo, snapshot_request)
from repro_torch.core.engine import ZipageEngine
from repro_torch.core.request import Request
from repro_torch.core.sampling import SamplingParams
from repro_torch.device import resolve_device


class Zipage:
    def __init__(self, cfg, params,
                 cache: Optional[CacheConfig] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 runner: Optional[ModelRunnerConfig] = None,
                 device=None, **overrides):
        """Wrap a model (ArchConfig + params on ``device``) in the serving
        facade.

        ``overrides`` are flat config fields routed to the owning config
        (``block_size`` -> CacheConfig, ``max_batch`` -> SchedulerConfig,
        ...); explicit config objects provide the bases they override.
        ``device`` defaults to ``cuda`` and raises without a card.
        """
        self.cache_config, self.scheduler_config, self.runner_config = \
            route_overrides(cache, scheduler, runner, **overrides)
        self.cfg = cfg
        self.engine = ZipageEngine(cfg, params, build_engine_options(
            self.cache_config, self.scheduler_config, self.runner_config),
            device=device)
        self._requests: Dict[int, Request] = {}
        self._emitted: Dict[int, int] = {}       # tokens already streamed
        self._undrained: Set[int] = set()        # rids _drain still watches
        self._queued: List[RequestOutput] = []   # outputs consumed by an
        #                                          interleaved generate()
        self._listeners: List[Callable[[List[RequestOutput]], None]] = []
        self._aio = None          # lazily-started AsyncEngineLoop

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, arch_name: str, *, device=None, params=None,
                    param_seed: int = 0, reduce: bool = False,
                    cache: Optional[CacheConfig] = None,
                    scheduler: Optional[SchedulerConfig] = None,
                    runner: Optional[ModelRunnerConfig] = None,
                    **overrides) -> "Zipage":
        """One-line bring-up: resolve the architecture by name, initialise
        (or accept) params, and build the engine. Random params are drawn
        on ``device`` from a ``torch.Generator`` seeded with
        ``param_seed``. ``reduce=True`` derives the family-preserving tiny
        config for CPU smoke runs. ``device`` defaults to ``cuda``."""
        from repro_torch.configs import get_config
        from repro_torch.models import lm

        dev = resolve_device(device)
        cache, scheduler, runner = route_overrides(
            cache, scheduler, runner, **overrides)
        cfg = get_config(arch_name)
        if reduce:
            cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, dtype=runner.dtype)
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(param_seed)
            params = lm.init(cfg, gen, dev)
        return cls(cfg, params, cache=cache, scheduler=scheduler,
                   runner=runner, device=dev)

    # ------------------------------------------------------------------
    # request lifecycle

    def add_request(self, prompt: Sequence[int],
                    params: Optional[SamplingParams] = None,
                    priority: int = 0) -> int:
        """Enqueue a request; returns its request id immediately. Tokens
        arrive through subsequent ``step()`` calls. ``priority`` orders
        admission (and inversely, preemption) under the "priority"
        scheduler policy — higher runs first; other policies ignore it."""
        params = params or SamplingParams()
        rid = self.engine.add_request(prompt, params, priority=priority)
        self._requests[rid] = self.engine.waiting[-1]
        self._emitted[rid] = 0
        self._undrained.add(rid)
        return rid

    def step(self) -> List[RequestOutput]:
        """Advance the engine one scheduling step (admit + prefill +
        compress + decode) and return a RequestOutput for every request
        that made progress — its ``chunk`` carries the new tokens, in
        generation order. Finished requests appear exactly once with
        ``finished=True``."""
        if self.has_unfinished():
            self.engine.step()
        queued, self._queued = self._queued, []
        outs = queued + self._drain()
        if outs:
            for fn in list(self._listeners):
                fn(outs)
        return outs

    def add_listener(self,
                     fn: Callable[[List[RequestOutput]], None]) -> None:
        """Register a step listener: called with every non-empty output
        batch ``step()`` produces (including steps driven by an
        interleaved ``generate()``). Listeners must not call back into the
        facade. The async surface (``repro_torch.api.aio``) fans its
        streams out through one; under it ``step()`` runs on the loop's
        worker thread, so a listener runs there too."""
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def generate(self,
                 prompts: Sequence[Sequence[int]],
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None,
                 max_steps: int = 100_000) -> List[RequestOutput]:
        """Blocking batch mode: submit all prompts (each with its own
        SamplingParams — pass a list — or one shared instance) and run the
        continuous-batching loop until they all finish. Returns final
        RequestOutputs in prompt order."""
        if params is None or isinstance(params, SamplingParams):
            params = [params] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError("one SamplingParams per prompt required")
        rids = [self.add_request(p, sp) for p, sp in zip(prompts, params)]
        mine = set(rids)
        pending = set(rids)
        for _ in range(max_steps):
            if not pending:
                break
            # re-queue outputs belonging to interleaved streaming requests
            # so the caller's next step() still sees their chunks
            # (step() replaces self._queued, so it must run before extend
            # resolves the list)
            outs = self.step()
            self._queued.extend(o for o in outs
                                if o.request_id not in mine)
            pending = {rid for rid in pending
                       if self._requests[rid].finish_reason is None}
        if pending:
            # don't leave orphans holding slots/blocks the caller can't
            # reach — abort them before surfacing the failure
            for rid in sorted(pending):
                self.abort(rid)
            raise RuntimeError(
                f"generate() exceeded {max_steps} steps; aborted unfinished "
                f"requests {sorted(pending)}")
        return [self.output(rid) for rid in rids]

    # ------------------------------------------------------------------
    # async surface — same background loop the HTTP tier uses, so sync
    # and async callers share one scheduler

    async def _ensure_aio(self):
        import asyncio

        from repro_torch.api.aio import AsyncEngineLoop
        loop = asyncio.get_running_loop()
        if self._aio is not None and (self._aio._loop is not loop
                                      or not self._aio.started):
            self._aio._teardown()     # stale: bound to a finished loop
            self._aio = None
        if self._aio is None:
            self._aio = await AsyncEngineLoop(self).start()
        return self._aio

    async def generate_async(self, prompt: Sequence[int],
                             params: Optional[SamplingParams] = None,
                             priority: int = 0) -> RequestOutput:
        """Async ``generate`` for one prompt: admit on the background
        continuous-batching loop and await the final RequestOutput.
        Concurrent callers batch together on the same loop."""
        aio = await self._ensure_aio()
        return await aio.generate(prompt, params, priority)

    async def stream(self, prompt: Sequence[int],
                     params: Optional[SamplingParams] = None,
                     priority: int = 0):
        """``async for chunk in zipage.stream(prompt, params)``: yields a
        :class:`CompletionChunk` per engine step that grew the request;
        the terminal chunk carries ``finish_reason`` + ``usage``."""
        aio = await self._ensure_aio()
        rid = await aio.add_request(prompt, params, priority)
        async for out in aio.stream_outputs(rid):
            chunk = out.chunk
            if chunk is None:         # abort-path terminal snapshot
                chunk = CompletionChunk(
                    request_id=out.request_id, index=len(out.token_ids),
                    token_ids=[], logprobs=None,
                    finish_reason=out.finish_reason, usage=out.usage)
            yield chunk

    def abort(self, request_id: int) -> Optional[RequestOutput]:
        """Cancel a waiting or running request mid-flight. Its blocks are
        returned to the BlockManager immediately; the final RequestOutput
        (finish_reason="abort") is returned, or None for unknown/finished
        ids."""
        if not self.engine.abort(request_id):
            return None
        r = self._requests.get(request_id)
        if r is None:                 # submitted directly on the engine
            return snapshot_request(self.engine.finished[request_id],
                                    self.kv_budget_tokens)
        self._emitted[request_id] = len(r.output)
        self._undrained.discard(request_id)
        # drop any chunks a concurrent generate() re-queued: the abort
        # snapshot is this request's terminal (and only further) emission
        self._queued = [o for o in self._queued
                        if o.request_id != request_id]
        return snapshot_request(r, self.kv_budget_tokens)

    def output(self, request_id: int) -> RequestOutput:
        """Current snapshot of any known request (no chunk); also resolves
        ids submitted directly on the wrapped engine once finished."""
        r = self._requests.get(request_id) \
            or self.engine.finished.get(request_id)
        if r is None:
            raise KeyError(f"unknown request id {request_id}")
        return snapshot_request(r, self.kv_budget_tokens)

    def has_unfinished(self) -> bool:
        return bool(self.engine.waiting or self.engine.running)

    # ------------------------------------------------------------------
    # engine passthroughs (read-only views)

    @property
    def kv_budget_tokens(self) -> Optional[int]:
        """Per-request KV budget ((n_max-1)*block_size), None = full KV."""
        if not self.engine.compression_enabled:
            return None
        return self.engine.budget_blocks * self.cache_config.block_size

    @property
    def metrics(self) -> List[dict]:
        return self.engine.metrics

    @property
    def scheduler_stats(self) -> Optional[dict]:
        """Last step's scheduler telemetry (docs/SCHEDULER.md of the JAX package): policy,
        admitted/preempted/blocked/finished counts, prefill and scheduled
        token counts, token-budget utilization, free blocks, the
        straggler-aware admission scale, and the cumulative prefix-cache
        counters (docs/CACHING.md "Telemetry"). None before the first
        step."""
        if not self.engine.metrics:
            return None
        m = self.engine.metrics[-1]
        return {k: m[k] for k in (
            "policy", "preemption_mode", "n_admitted", "n_preempted",
            "n_swapped_out", "n_swapped_in", "n_swapped", "swap_bytes",
            "swap_util", "n_blocked",
            "n_finished", "n_prefill_tokens", "n_scheduled_tokens",
            "token_budget", "budget_util", "free_blocks",
            "admission_scale", "t_host", "t_device",
            "decode_horizon",
            "quality_aware", "n_comp_default", "n_comp_protect",
            "n_comp_aggressive", "n_comp_deferred",
            "prefix_cache_policy", "prefix_lookups", "prefix_hits",
            "prefix_hit_tokens", "prefix_segment_hits",
            "prefix_evictions", "prefix_cached_blocks",
            "prefix_cached_tokens", "cached_tokens_per_block") if k in m}

    @property
    def step_count(self) -> int:
        return self.engine.step_count

    @property
    def bm(self):
        return self.engine.bm

    @property
    def num_free_blocks(self) -> int:
        return self.engine.bm.num_free

    # ------------------------------------------------------------------
    def _drain(self) -> List[RequestOutput]:
        outs = []
        # only unfinalized requests are scanned, so long-running serving
        # loops don't pay per-step cost for completed history
        for rid in sorted(self._undrained):
            r = self._requests[rid]
            n_seen = self._emitted[rid]
            finished = r.finish_reason is not None
            if len(r.output) <= n_seen and not finished:
                continue
            # stop-sequence truncation can shrink the output below what
            # streaming already emitted; the final snapshot is
            # authoritative and the chunk simply comes up empty
            new = list(r.output[n_seen:])
            lps = (list(r.logprobs[n_seen:len(r.output)])
                   if r.sampling.logprobs else None)
            chunk = CompletionChunk(
                request_id=rid, index=n_seen, token_ids=new, logprobs=lps,
                # terminal chunk carries the OpenAI last-chunk markers so
                # streaming layers need no second lookup (docs/SERVING.md)
                finish_reason=r.finish_reason if finished else None,
                usage=(UsageInfo.of(len(r.prompt), len(r.output))
                       if finished else None))
            self._emitted[rid] = len(r.output)
            outs.append(snapshot_request(r, self.kv_budget_tokens, chunk))
            if finished:
                self._undrained.discard(rid)
        return outs
