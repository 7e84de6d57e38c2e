"""Zipage: the Compressed-PagedAttention serving engine (paper §4), ported
from ``repro.core.engine``.

The engine owns the device state and the host mirrors that feed it. Every
scheduling decision lives in the host ``Scheduler``
(``repro_torch.core.scheduler``, a copy of the JAX package's); ``step()``
executes the plan it produces: paged prefill, compression launches
(async: compressing requests sit out one decode step), and the decode of
the running batch: fused decode+sample over the scheduler's quiescent
horizon of up to ``decode_steps`` tokens, in power-of-two chunks, or
(``fuse_sampling=False``) one decode step and the host-driven sampler.

On a CUDA device every fused chunk is a replay of a CUDA graph captured at
init (``core/decode_graphs.py``), the port's counterpart of the JAX
package's one jitted dispatch a chunk; on the CPU the chunk runs eagerly.
The graphs read fixed addresses, so the device state and the decode
inputs are buffers allocated once: every host push, and ``restore()``,
copies into them.

Ported: attention models (GQA, and DeepSeek's MLA on a latent pool) with
dense or MoE FFNs, local-window attention over a ring of pages beside
RG-LRU layers (RecurrentGemma) and the attention-free RWKV6, whose
per-slot recurrent state lives in the device state (``rec``): these two
run without compression and without prefix caching, as in the JAX
package, and preempt by recompute; the encoder-decoder Whisper, which
compresses its decoder's self-attention KV and keeps each slot's
cross-attention KV in the device state (``cross_kv``, written by every
prefill call from zero frame embeddings, as the JAX engine does), without
prefix caching and preempting by recompute; InternVL2's backbone, served
on text as the JAX engine serves it; compression with lightning or flash
redundancy, the ragged and the dense decode kernel, recompute, swap and
auto preemption with the host swap tier (a pinned host pool on the card),
block-level prefix caching of raw KV and of compressed prefixes, fused and
unfused decode at any ``decode_steps``, and ``snapshot()`` /
``restore()``, in float32, bfloat16 or float16 (``EngineOptions.dtype``:
the K/V pools, the observation windows and the model's matrices at that
dtype, the global scores F and the logits in fp32); other dtypes raise
``NotImplementedError``.

Setting ``n_max=None`` disables compression (plain PagedAttention).
``ZIPAGE_SANITIZE=1`` in the environment when an engine is built makes it
audit its whole state after every step (``core/invariants.py``).
"""
from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import invariants, serve_model
from repro_torch.core.block_manager import BlockManager
from repro_torch.core.compression import CompressOptions, build_compress_fn
from repro_torch.core.decode_graphs import DecodeGraphs
from repro_torch.core.request import FinishReason, Request, State
from repro_torch.core.sampling import (SamplingParams, sample_batch,
                                       sampling_noise)
from repro_torch.core.scheduler import (PrefillChunk, Scheduler,
                                        SchedulerOutputs, SchedulerParams)
from repro_torch.device import resolve_device
from repro_torch.kernels import native, ops
from repro_torch.models import lm


def _fused_chunk_sizes(k: int) -> List[int]:
    """Decompose a horizon into power-of-two dispatch lengths
    (largest-first), so only O(log decode_steps) chunk lengths are ever
    captured; a single big chunk is split in half so the token fetch for
    chunk N can overlap chunk N+1's compute (pipelined fetch)."""
    sizes = []
    rem = k
    while rem:
        p = 1 << (rem.bit_length() - 1)
        sizes.append(p)
        rem -= p
    if len(sizes) == 1 and k >= 4:
        sizes = [k // 2, k // 2]
    return sizes


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """The JAX package's ``EngineOptions``, field for field."""
    block_size: int = 16
    n_total_blocks: int = 256
    max_batch: int = 16              # decode slots
    m_qslots: int = 8                # paper's M (query-slot pool)
    n_max: Optional[int] = 4         # block cap; None => full-KV baseline
    window: int = 4                  # observation window w
    scheduling: str = "hybrid"       # hybrid | constrained
    prefix_caching: bool = True
    prefix_cache_policy: str = "radix"
    prefix_cache_watermark: float = 1.0
    cache_compressed_prefixes: bool = False
    async_compression: bool = True
    compress: CompressOptions = dataclasses.field(
        default_factory=lambda: CompressOptions(window=4))
    max_model_len: int = 512
    prefill_rows: int = 4
    prefill_len: int = 128
    policy: str = "fcfs"             # fcfs | priority | srpt | cache_aware
    preemption: Optional[str] = None  # victim-order policy; None => policy
    preemption_mode: str = "recompute"
    swap_space_blocks: int = 0
    swap_cost_per_token: float = 0.5
    token_budget: Optional[int] = None
    max_prefill_chunk: Optional[int] = None
    admission_margin: float = 0.0
    quality_aware: bool = False
    compression_deferral: int = 2
    quality_defer_min_free: int = 16
    quality_entropy_threshold: float = 0.85
    fuse_sampling: bool = True
    decode_steps: int = 1
    temperature: float = 0.0         # used only without SamplingParams
    seed: int = 0
    dtype: str = "float32"
    measure_phases: bool = False     # block per phase for timing benches
    kernel_backend: str = "auto"
    decode_kernel: str = "ragged"    # ragged | dense


def unported_options(opts: EngineOptions) -> List[str]:
    """Engine knobs whose settings the port does not support yet."""
    out = []
    if opts.kernel_backend != "auto":
        out.append(f"kernel_backend={opts.kernel_backend!r} (kernels follow "
                   "the device)")
    if opts.dtype not in lm.DTYPES:
        out.append(f"dtype={opts.dtype!r}")
    if opts.compress.backend != "auto":
        out.append(f"compress.backend={opts.compress.backend!r}")
    return out


class ZipageEngine:
    def __init__(self, cfg: ArchConfig, params, opts: EngineOptions,
                 device=None):
        lm.check_supported(cfg)
        missing = unported_options(opts)
        if missing:
            raise NotImplementedError(
                "not ported to repro_torch yet: " + "; ".join(missing))
        if opts.decode_steps > 1 and not opts.fuse_sampling:
            raise ValueError("decode_steps > 1 requires fuse_sampling")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.cfg = cfg
        self.opts = opts
        # the serve dtype is the engine's, whatever the config's: params
        # at another dtype are cast once here (the JAX engine casts them
        # at each use), the norms left in fp32
        dtype = lm.torch_dtype(opts.dtype)
        if params["embed"].dtype != dtype:
            params = lm.cast_params(params, dtype)
        self.params = params
        b = opts.block_size
        assert opts.window == opts.compress.window
        self.compression_enabled = (
            opts.n_max is not None and not cfg.attention_free
            and not cfg.local_window)
        self.budget_blocks = (opts.n_max - 1) if self.compression_enabled else 0
        self.max_blocks = -(-opts.max_model_len // b)
        self.spec = serve_model.ServeSpec(
            n_slots=opts.max_batch, block_size=b, max_blocks=self.max_blocks,
            n_total_blocks=opts.n_total_blocks, m_qslots=opts.m_qslots,
            window=opts.window, prefill_rows=opts.prefill_rows,
            prefill_len=opts.prefill_len, dtype=opts.dtype,
            decode_kernel=opts.decode_kernel)
        self.prefix_ok = (opts.prefix_caching and not cfg.attention_free
                          and not cfg.local_window and not cfg.is_enc_dec)
        self._ring = (self.spec.ring_blocks(cfg) if cfg.local_window
                      else 0)
        if self._ring > self.max_blocks:
            raise ValueError(
                f"{cfg.name}: the local window takes {self._ring} blocks of "
                f"{b}, the block table {self.max_blocks} (max_model_len "
                f"{opts.max_model_len}); raise max_model_len to at least "
                f"{cfg.local_window}")
        self.state = serve_model.make_state(cfg, self.spec, self.device)
        # host swap tier: only archs whose request state is all in the
        # paged pools can vacate a slot and resume in another; a ring's
        # pages, the recurrent state and the cross-attention KV are per
        # slot, so those archs preempt by recompute, with the JAX engine's
        # warning
        self._swap_ok = (opts.swap_space_blocks > 0
                         and "pools" in self.state and not self._ring
                         and "rec" not in self.state
                         and "cross_kv" not in self.state)
        if opts.swap_space_blocks > 0 and not self._swap_ok:
            warnings.warn(
                f"preemption_mode={opts.preemption_mode!r} cannot swap on "
                "this arch (recurrent/ring/enc-dec state is per-slot, not "
                "paged); falling back to recompute-mode preemption",
                stacklevel=2)
        self.scheduler = Scheduler(
            SchedulerParams(
                block_size=b, max_batch=opts.max_batch,
                m_qslots=opts.m_qslots, n_max=opts.n_max,
                window=opts.window, scheduling=opts.scheduling,
                async_compression=opts.async_compression,
                prefill_rows=opts.prefill_rows,
                policy=opts.policy, preemption=opts.preemption,
                preemption_mode=(opts.preemption_mode
                                 if self._swap_ok
                                 or opts.swap_space_blocks == 0
                                 else "recompute"),
                swap_cost_per_token=opts.swap_cost_per_token,
                block_bytes=self._kv_block_bytes(),
                token_budget=opts.token_budget,
                max_prefill_chunk=opts.max_prefill_chunk,
                admission_margin=opts.admission_margin,
                quality_aware=opts.quality_aware,
                compression_deferral=opts.compression_deferral,
                quality_defer_min_free=opts.quality_defer_min_free,
                quality_entropy_threshold=opts.quality_entropy_threshold,
                # compressed-prefix caching needs segments to register
                # (compression on) and hits to be adoptable (prefix on);
                # outside that it is silently inert, not an error
                cache_compressed_prefixes=(opts.cache_compressed_prefixes
                                           and self.compression_enabled
                                           and self.prefix_ok),
                decode_steps=opts.decode_steps,
                compression_enabled=self.compression_enabled,
                budget_blocks=self.budget_blocks,
                prefix_ok=self.prefix_ok, attention_free=cfg.attention_free,
                ring_blocks=self._ring),
            BlockManager(opts.n_total_blocks, b,
                         enable_prefix_cache=self.prefix_ok,
                         swap_space_blocks=(opts.swap_space_blocks
                                            if self._swap_ok else 0),
                         prefix_cache_policy=opts.prefix_cache_policy,
                         prefix_cache_watermark=opts.prefix_cache_watermark))
        self._prefill = serve_model.build_prefill_step(cfg, self.spec)
        # an encoder-decoder model's frontend is a stub: every prefill
        # call encodes zero frame embeddings, as the JAX engine's does
        self._prefill_kw = {}
        if cfg.is_enc_dec:
            self._prefill_kw["frame_embeds"] = torch.zeros(
                (opts.prefill_rows, cfg.cross_seq_len, cfg.d_model),
                dtype=torch.float32, device=self.device)
        self._decode = serve_model.build_decode_step(cfg, self.spec)
        self._fused_fns: Dict[tuple, callable] = {}
        self._compress_fns: Dict[int, callable] = {}
        # host mirrors of the device tables (rebuilt from scheduler state
        # before each push)
        self.host_bt = np.full((opts.max_batch, self.max_blocks), -1, np.int32)
        self.host_seq = np.zeros((opts.max_batch,), np.int32)
        self.host_pos = np.zeros((opts.max_batch,), np.int32)
        self.host_qslot = np.full((opts.max_batch,), -1, np.int32)
        self.tokens_next = np.zeros((opts.max_batch,), np.int64)
        # dirty tracking: device tables are re-pushed only when the
        # scheduler's state version moved past what was last uploaded;
        # the sampling-state mirrors track what lives on the device
        self._pushed_version = -1
        self._tokens_dirty = True
        self._dev_mask: Optional[np.ndarray] = None
        self._dev_counters: Optional[np.ndarray] = None
        self._samp_version = -1
        self._samp_arrays = None
        self._eos_width = 1
        # the fused chunk's inputs: allocated once, written with copy_
        # (a captured graph reads these addresses on every replay)
        B, dev = opts.max_batch, self.device
        self._dec = {
            "idx0": torch.zeros((), dtype=torch.int32, device=dev),
            "step_caps": torch.zeros(B, dtype=torch.int32, device=dev),
            "seeds": torch.zeros(B, dtype=torch.int64, device=dev),
            "temps": torch.zeros(B, dtype=torch.float32, device=dev),
            "top_k": torch.zeros(B, dtype=torch.int32, device=dev),
            "top_p": torch.ones(B, dtype=torch.float32, device=dev),
            "eos": torch.full((B, self._eos_width), -1, dtype=torch.int64,
                              device=dev),
        }
        # pinned host buffers for the chunks' tokens and logprobs, one
        # pair per chunk of a horizon (on the card)
        self._staging: Dict[int, tuple] = {}
        self._t_blocked = 0.0
        self._step_decoded = 0
        self._last_horizon = 0
        self._step_pages_visited = 0
        self._step_pages_dense = 0
        self._rid = 0
        self._pending_quality = None
        self.metrics: List[dict] = []
        self.step_hooks = []
        self.step_count = 0
        # runtime sanitizer: a whole-engine audit after every step when
        # ZIPAGE_SANITIZE=1 (core/invariants.py); _qwin_shadow holds host
        # copies of free observation-window rows, so a write to a row no
        # active slot owns is caught
        self.sanitize = invariants.enabled()
        self._qwin_shadow: Dict[int, np.ndarray] = {}
        # qslots any table push of the current step mapped: a request can
        # be admitted, prefilled and preempted within one step, and its
        # window row was written while it owned it
        self._step_qslots: set = set()
        self.swap_pool: Optional[Dict[str, torch.Tensor]] = None
        self._swap_qwin: Dict[int, torch.Tensor] = {}   # rid -> parked window
        self._swap_out = serve_model.build_swap_out_step(cfg, self.spec)
        self._swap_in = serve_model.build_swap_in_step(cfg, self.spec)
        if self._swap_ok:
            self._init_swap()
        self._graphs: Optional[DecodeGraphs] = None
        if self.device.type == "cuda":
            native.build_all()       # compile before the first step, not in it
            if opts.fuse_sampling:
                self._capture_graphs()

    def _capture_graphs(self):
        """Capture a graph of every fused chunk that the configured
        ``decode_steps`` can produce, greedy and sampled, before serving
        starts (the JAX package's ``_warm_fused``)."""
        self._graphs = DecodeGraphs(self._run_chunk, self._dec["step_caps"])
        sizes = set()
        for k in range(1, self.opts.decode_steps + 1):
            sizes.update(_fused_chunk_sizes(k))
        for k in sorted(sizes):
            for greedy in (True, False):
                self._graphs.capture(k, greedy, self._eos_width)

    # ------------------------------------------------------------------
    # scheduler views

    @property
    def bm(self) -> BlockManager:
        return self.scheduler.bm

    @property
    def waiting(self):
        return self.scheduler.waiting

    @property
    def running(self) -> List[Request]:
        return self.scheduler.running

    @property
    def finished(self) -> Dict[int, Request]:
        return self.scheduler.finished

    @property
    def free_slots(self) -> List[int]:
        return self.scheduler.free_slots

    @property
    def free_qslots(self) -> List[int]:
        return self.scheduler.free_qslots

    @property
    def admission_scale(self) -> float:
        return self.scheduler.admission_scale

    @property
    def _ewma(self):
        return self.scheduler.ewma

    @_ewma.setter
    def _ewma(self, value):
        self.scheduler.ewma = value

    # ------------------------------------------------------------------
    def add_request(self, prompt, sampling: Optional[SamplingParams] = None,
                    priority: int = 0) -> int:
        if sampling is None:
            sampling = SamplingParams(temperature=self.opts.temperature,
                                      seed=self._default_seed())
        if len(prompt) + sampling.max_new_tokens > self.opts.max_model_len:
            raise ValueError("request exceeds max_model_len")
        rid = self._rid
        self._rid += 1
        self.scheduler.add_request(Request(
            rid=rid, prompt=list(map(int, prompt)),
            max_new_tokens=sampling.max_new_tokens, sampling=sampling,
            priority=priority, arrival=time.monotonic()))
        return rid

    def _default_seed(self) -> int:
        return (self.opts.seed * 1_000_003 + self._rid) & 0xFFFFFFFF

    def abort(self, rid: int) -> bool:
        r = self.scheduler.abort(rid)
        if r is None:
            return False
        self._swap_qwin.pop(rid, None)
        r.state = State.FINISHED
        r.finish_reason = FinishReason.ABORT
        r.t_finish = time.monotonic()
        self.scheduler.finished[rid] = r
        return True

    # ------------------------------------------------------------------
    # device traffic

    def _dev(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    @staticmethod
    def _put(dst: torch.Tensor, a: np.ndarray) -> None:
        """Host array -> an allocated device buffer, in place (a copy on
        the CPU too: the buffer never aliases the host mirror)."""
        dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))

    def _fetch(self, *xs):
        """Device->host read; the wait counts as blocked-on-device time
        (the ``t_device`` share of the per-step metrics)."""
        t = time.monotonic()
        out = tuple(x.cpu().numpy() for x in xs)
        self._t_blocked += time.monotonic() - t
        return out if len(out) > 1 else out[0]

    def _sync(self):
        t = time.monotonic()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._t_blocked += time.monotonic() - t

    def _kv_block_bytes(self) -> int:
        """Bytes one pool block takes over all layers and leaves; 0 for an
        attention-free arch, which has no pools."""
        pools = self.state.get("pools")
        if not pools:
            return 0
        return int(sum(leaf.numel() // leaf.shape[1] * leaf.element_size()
                       for leaf in pools.values()))

    def _push_host_state(self, force: bool = False):
        v = self.scheduler.version
        if not force and v == self._pushed_version:
            return
        self.host_bt.fill(-1)
        self.host_qslot.fill(-1)
        for r in self.scheduler.running:
            if r.slot < 0:
                continue
            self.host_bt[r.slot, :r.n_blocks] = r.blocks
            self.host_seq[r.slot] = r.seq_len
            self.host_pos[r.slot] = r.position
            self.host_qslot[r.slot] = r.qslot
        self._put(self.state["block_tables"], self.host_bt)
        self._put(self.state["seq_lens"], self.host_seq)
        self._put(self.state["positions"], self.host_pos)
        self._put(self.state["qslot"], self.host_qslot)
        self._step_qslots.update(int(q) for q in self.host_qslot if q >= 0)
        self._pushed_version = v

    # ------------------------------------------------------------------
    # plan execution: prefill

    def _run_prefill(self, chunks: Sequence[PrefillChunk]):
        """Execute the planned prefill chunks; a chunk longer than the
        device bucket S is fed in several rounds, and only a request's
        final chunk samples its first token."""
        P, S = self.opts.prefill_rows, self.opts.prefill_len
        remaining: Dict[int, List[int]] = {}
        offset: Dict[int, int] = {}
        final_chunk: Dict[int, bool] = {}
        pending: List[Request] = []
        for c in chunks:
            r = c.request
            remaining[r.rid] = list(r.full_prompt[c.start:c.start
                                                  + c.n_tokens])
            offset[r.rid] = c.start
            final_chunk[r.rid] = c.is_final
            pending.append(r)
        while pending:
            batch = pending[:P]
            toks = np.zeros((P, S), np.int64)
            slot_ids = np.full((P,), -1, np.int32)
            lengths = np.zeros((P,), np.int32)
            start = np.zeros((P,), np.int32)
            rope = np.zeros((P,), np.int32)
            final = []
            for i, r in enumerate(batch):
                chunk = remaining[r.rid][:S]
                toks[i, :len(chunk)] = chunk
                slot_ids[i] = r.slot
                lengths[i] = len(chunk)
                start[i] = offset[r.rid] - r.pos_gap
                rope[i] = offset[r.rid]
                remaining[r.rid] = remaining[r.rid][len(chunk):]
                offset[r.rid] += len(chunk)
                r.n_prefilled = offset[r.rid]
                if not remaining[r.rid] and final_chunk[r.rid]:
                    final.append((i, r, len(chunk)))
            self._push_host_state()
            logits = self._prefill(
                self.params, self.state, self._dev(toks), self._dev(slot_ids),
                self._dev(lengths), self._dev(start),
                rope_start=self._dev(rope), **self._prefill_kw)
            if final:
                row_reqs: List[Optional[Request]] = [None] * P
                for i, r, _n in final:
                    row_reqs[i] = r
                tok, lp = self._sample_rows(logits, row_reqs)
                for i, r, chunk_len in final:
                    self.tokens_next[r.slot] = tok[i]
                    self._tokens_dirty = True
                    self._record_token(r, tok[i],
                                       None if lp is None else lp[i])
                    if r.qslot >= 0:
                        r.win_count = min(self.opts.window, chunk_len)
            still = [r for r in batch if remaining[r.rid]]
            pending = still + pending[P:]

    def _sample_rows(self, logits, reqs: Sequence[Optional[Request]]):
        """One token per row; ``reqs[i]`` occupies row i (None = padding).
        All-greedy batches without logprobs take the argmax alone. Returns
        (tokens, logprobs) as numpy; logprobs is None on that fast path."""
        if not any(r is not None and (not r.sampling.is_greedy
                                      or r.sampling.logprobs)
                   for r in reqs):
            return self._fetch(torch.argmax(logits, -1)), None
        n = logits.shape[0]
        seeds = np.zeros((n,), np.int64)
        counters = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        top_k = np.zeros((n,), np.int32)
        top_p = np.ones((n,), np.float32)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            sp = r.sampling
            seeds[i] = sp.seed & 0xFFFFFFFF
            counters[i] = len(r.output)
            temps[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
        noise = sampling_noise(self._dev(seeds), self._dev(counters),
                               logits.shape[-1])
        tok, lp = sample_batch(logits, noise, self._dev(temps),
                               self._dev(top_k), self._dev(top_p))
        return self._fetch(tok, lp)

    @staticmethod
    def _record_token(r: Request, tok: int, lp) -> None:
        r.output.append(int(tok))
        if r.sampling.logprobs and lp is not None:
            r.logprobs.append(float(lp))
        if r.t_first_token is None:
            r.t_first_token = time.monotonic()

    # ------------------------------------------------------------------
    # plan execution: compression

    def _compress_fn(self, width):
        fn = self._compress_fns.get(width)
        if fn is None:
            fn = build_compress_fn(
                self.cfg, block_size=self.opts.block_size, max_blocks=width,
                budget_blocks=self.budget_blocks, opts=self.opts.compress)
            self._compress_fns[width] = fn
        return fn

    def _launch_compression(self, outs: SchedulerOutputs):
        """Run the compression over the planned launches, then let the
        scheduler commit the (deterministic) host bookkeeping. On a card
        the kernels are queued and the host goes on; the quality stats are
        read at the start of the next step."""
        planned = outs.compress
        if not planned:
            return
        n = 1
        while n < len(planned):
            n *= 2
        width = ops.block_table_width(
            max(c.request.n_blocks for c in planned), self.max_blocks)
        src_bt = np.full((n, width), -1, np.int32)
        dest_bt = np.full((n, self.budget_blocks), -1, np.int32)
        qslots = np.full((n,), -1, np.int32)
        seq_lens = np.zeros((n,), np.int32)
        hist = np.zeros((n,), np.int32)
        for i, c in enumerate(planned):
            r = c.request
            src_bt[i, :r.n_blocks] = r.blocks
            dest_bt[i] = c.dest
            qslots[i] = r.qslot
            seq_lens[i] = r.seq_len
            hist[i] = self.budget_blocks * self.opts.block_size \
                if r.compressed else 0
        req = tuple(self._dev(a) for a in (src_bt, dest_bt, qslots,
                                           seq_lens, hist))
        _, qstats = self._compress_fn(width)(self.state["pools"],
                                             self.state["qwin"], req)
        self._pending_quality = ([c.request.rid for c in planned], qstats)
        self.scheduler.commit_compression(outs)
        if self.opts.measure_phases or not self.opts.async_compression:
            self._sync()

    def _drain_quality_stats(self):
        pq = self._pending_quality
        if pq is None:
            return
        self._pending_quality = None
        rids, dev = pq
        stats = self._fetch(dev)
        live = {r.rid: r for r in self.scheduler.running}
        for sw in self.scheduler.swapped:
            live[sw.rid] = sw
        for i, rid in enumerate(rids):
            r = live.get(rid)
            if r is None:
                continue
            r.redundancy = float(stats[i, 0])
            r.attn_entropy = float(stats[i, 1])

    # ------------------------------------------------------------------
    # plan execution: the host swap tier

    def _init_swap(self):
        """Allocate the host swap pool, once: one mirror a pool leaf,
        ``swap_space_blocks`` wide and block-major (``(S, L, b, ...)``,
        each block's layers contiguous, as ``build_swap_out_step`` gathers
        them), pinned on the card, so that every copy is a direct DMA; a
        failed pinned allocation raises. Then register the two executors
        the scheduler calls at plan time."""
        pin = self.device.type == "cuda"
        S = self.opts.swap_space_blocks
        self.swap_pool = {
            k: torch.zeros((S, leaf.shape[0]) + tuple(leaf.shape[2:]),
                           dtype=leaf.dtype, pin_memory=pin)
            for k, leaf in self.state["pools"].items()}
        self.scheduler.swap_executor = self._swap_out_blocks
        self.scheduler.swap_in_executor = self._swap_in_blocks

    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor to receive ``t`` (pinned on the card)."""
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=self.device.type == "cuda")

    def _swap_out_blocks(self, r: Request, src_blocks, dst_host_blocks):
        """Scheduler swap-out callback: gather the victim's blocks from
        every layer's pools and park them in the host swap pool, with its
        observation-window row keyed by rid, so a swap-in with a fresh
        qslot resumes compression scoring where the swap-out left it. The
        copies are waited for before returning: the scheduler releases
        the device blocks right after."""
        gathered = self._swap_out(self.state["pools"],
                                  self._dev(np.asarray(src_blocks, np.int64)))
        for k, vals in gathered.items():
            host = self.swap_pool[k]
            for i, j, h in _runs(dst_host_blocks):
                host[h:h + j - i].copy_(vals[i:j], non_blocking=True)
        if r.qslot >= 0:
            win = self.state["qwin"][:, r.qslot]
            parked = self._host_copy(win)
            parked.copy_(win, non_blocking=True)
            self._swap_qwin[r.rid] = parked
        self._sync()

    def _swap_in_blocks(self, r: Request, src_host_blocks,
                        dst_dev_blocks) -> bool:
        """Scheduler swap-in callback: copy the parked blocks to the card
        and scatter them into the freshly allocated device blocks, in
        place; re-arm the decode input (the victim's last sampled token
        becomes ``tokens_next`` of its new slot) and restore the parked
        window into the new qslot. Returns True when the window was
        restored (the scheduler keeps ``win_count`` only then).

        The host-to-device copies are queued without waiting. The host
        blocks they read go back to the scheduler on return, but the only
        writer of the host pool is a later swap-out's device-to-host copy,
        which the stream runs after them (``restore()`` waits for the
        device first); a parked window is a block of the caching pinned
        allocator, which holds it until the copies queued from it have
        run."""
        vals = {}
        for k, host in self.swap_pool.items():
            buf = torch.empty((len(dst_dev_blocks),) + tuple(host.shape[1:]),
                              dtype=host.dtype, device=self.device)
            for i, j, h in _runs(src_host_blocks):
                buf[i:j].copy_(host[h:h + j - i], non_blocking=True)
            vals[k] = buf
        self._swap_in(self.state["pools"],
                      self._dev(np.asarray(dst_dev_blocks, np.int64)), vals)
        if r.output and not r.prefill_pending:
            self.tokens_next[r.slot] = r.output[-1]
            self._tokens_dirty = True
        parked = self._swap_qwin.pop(r.rid, None)
        if parked is None or r.qslot < 0:
            return False
        self.state["qwin"][:, r.qslot].copy_(parked, non_blocking=True)
        return True

    # ------------------------------------------------------------------
    # plan execution: fused decode

    def _advance_decoded(self, r: Request) -> None:
        if r.qslot >= 0:
            r.win_count = min(self.opts.window, r.win_count + 1)
        if self._ring:
            r.seq_len = min(r.seq_len + 1, self._ring * self.opts.block_size)
        elif not self.cfg.attention_free:
            r.seq_len += 1
        r.position += 1
        self.host_seq[r.slot] = r.seq_len
        self.host_pos[r.slot] = r.position
        self._step_decoded += 1

    def _track_pages(self, active, caps, k):
        """Page-visit telemetry: the ragged decode kernel reads
        ``ceil(attend_len / b)`` pages per row, while the dense kernel
        (``decode_kernel="dense"``) reads ``max_blocks`` for every slot.
        Host arithmetic only."""
        b = self.opts.block_size
        for r, c in zip(active, caps):
            self._step_pages_visited += sum(
                -(-(r.seq_len + j + 1) // b) for j in range(c))
        self._step_pages_dense += k * self.opts.max_batch * self.max_blocks

    def _run_decode(self, active):
        """Unfused decode: one decode step, then the host-driven sampler
        over the slots (``fuse_sampling=False``)."""
        if not active:
            return
        self._track_pages(active, [1] * len(active), 1)
        mask = np.zeros((self.opts.max_batch,), bool)
        for r in active:
            mask[r.slot] = True
        self._push_host_state()
        logits = self._decode(self.params, self.state,
                              self._dev(self.tokens_next), self._dev(mask))
        slot_reqs: List[Optional[Request]] = [None] * self.opts.max_batch
        for r in active:
            slot_reqs[r.slot] = r
        tok, lp = self._sample_rows(logits, slot_reqs)
        for r in active:
            t = int(tok[r.slot])
            self.tokens_next[r.slot] = t
            self._record_token(r, t, None if lp is None else lp[r.slot])
            self._advance_decoded(r)

    def _sampling_tensors(self) -> bool:
        """Copy the per-slot sampling parameters (seeds, temperatures,
        top-k/top-p, padded eos-id sets) into the chunk's input buffers,
        only when the scheduler's slot assignments changed. The eos pad
        width grows by powers of two and never shrinks; a wider pad takes
        a new buffer, and the graphs that read the old one are captured
        anew. Returns whether every slot is greedy."""
        v = self.scheduler.version
        if self._samp_arrays is not None and self._samp_version == v:
            return not (self._samp_arrays[1] > 0).any()
        B = self.opts.max_batch
        seeds = np.zeros((B,), np.int64)
        temps = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        e = self._eos_width
        for r in self.scheduler.running:
            if r.slot >= 0 and r.sampling.eos_ids:
                e = max(e, len(r.sampling.eos_ids))
        width = 1 << (e - 1).bit_length()
        if width != self._eos_width:
            self._eos_width = width
            self._dec["eos"] = torch.full((B, width), -1, dtype=torch.int64,
                                          device=self.device)
            if self._graphs is not None:
                self._graphs.recapture(width)
        eos = np.full((B, width), -1, np.int64)
        for r in self.scheduler.running:
            if r.slot < 0:
                continue
            sp = r.sampling
            seeds[r.slot] = sp.seed & 0xFFFFFFFF
            temps[r.slot] = sp.temperature
            top_k[r.slot] = sp.top_k
            top_p[r.slot] = sp.top_p
            if sp.eos_ids:
                eos[r.slot, :len(sp.eos_ids)] = sp.eos_ids
        self._samp_arrays = (seeds, temps, top_k, top_p, eos)
        for name, a in zip(("seeds", "temps", "top_k", "top_p", "eos"),
                           self._samp_arrays):
            self._put(self._dec[name], a)
        self._samp_version = v
        return not (temps > 0).any()

    def _push_sampling_state(self, active):
        """Sync the device-carried sampling state (live mask, PRNG
        counters, next input tokens) with the host's view, pushing only
        what diverged. During steady decode the device advances all
        three itself, so nothing is uploaded."""
        B = self.opts.max_batch
        mask = np.zeros((B,), bool)
        counters = np.zeros((B,), np.int32)
        for r in active:
            mask[r.slot] = True
            counters[r.slot] = len(r.output)
        if self._dev_mask is None \
                or not np.array_equal(mask, self._dev_mask):
            self._put(self.state["active_mask"], mask)
        if self._dev_counters is None \
                or not np.array_equal(counters, self._dev_counters):
            self._put(self.state["sample_counters"], counters)
        if self._tokens_dirty:
            self._put(self.state["tokens_next"], self.tokens_next)
            self._tokens_dirty = False
        self._dev_mask = mask
        self._dev_counters = counters

    def _run_chunk(self, k: int, greedy: bool):
        """One fused chunk of ``k`` iterations on the static buffers,
        eagerly: what the CPU runs, and what a graph captures."""
        fn = self._fused_fns.get((k, greedy))
        if fn is None:
            fn = serve_model.build_fused_decode_step(self.cfg, self.spec, k,
                                                     greedy=greedy)
            self._fused_fns[(k, greedy)] = fn
        d = self._dec
        return fn(self.params, self.state, d["idx0"], d["step_caps"],
                  d["seeds"], d["temps"], d["top_k"], d["top_p"], d["eos"])

    def _stage(self, i: int, tok, lp):
        """Chunk ``i``'s (k, B) tokens and logprobs out of the chunk's
        outputs before the next chunk runs: on the card a graph's next
        replay overwrites its output buffers, so they are copied, without
        waiting, into pinned host buffers of chunk ``i``'s own, and an
        event marks when they are there."""
        if self._graphs is None:
            return tok, lp, None
        buf = self._staging.get(i)
        if buf is None:
            shape = (self.opts.decode_steps, self.opts.max_batch)
            buf = (torch.empty(shape, dtype=tok.dtype, pin_memory=True),
                   torch.empty(shape, dtype=lp.dtype, pin_memory=True))
            self._staging[i] = buf
        k = tok.shape[0]
        host_tok, host_lp = buf[0][:k], buf[1][:k]
        host_tok.copy_(tok, non_blocking=True)
        host_lp.copy_(lp, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host_tok, host_lp, done

    def _unstage(self, staged):
        tok, lp, done = staged
        if done is None:
            return self._fetch(tok, lp)
        t = time.monotonic()
        done.synchronize()
        self._t_blocked += time.monotonic() - t
        return tok.numpy(), lp.numpy()

    def _run_decode_fused(self, active, plan=None):
        """Fused decode+sample over the scheduler's quiescent horizon: up
        to K decode steps in O(log K) power-of-two chunks, each a graph
        replay on the card, with each chunk's token block fetched only
        after the next chunk is in flight. The host records chunk N's
        tokens while the device computes chunk N+1 (the carried
        ``active_mask`` keeps in-flight eos exact across chunks)."""
        if not active:
            return
        K, caps = self.scheduler.quiescent_horizon(active, plan)
        self._last_horizon = K
        self._track_pages(active, caps, K)
        self._push_host_state()
        self._push_sampling_state(active)
        greedy = self._sampling_tensors()
        caps_arr = np.zeros((self.opts.max_batch,), np.int32)
        for r, c in zip(active, caps):
            caps_arr[r.slot] = c
        self._put(self._dec["step_caps"], caps_arr)
        chunks = []
        off = 0
        for i, k in enumerate(_fused_chunk_sizes(K)):
            self._dec["idx0"].fill_(off)
            if self._graphs is not None:
                tok, lp = self._graphs.replay(k, greedy, self._eos_width)
            else:
                tok, lp = self._run_chunk(k, greedy)
            chunks.append((off, k, self._stage(i, tok, lp)))
            off += k
        halted: set = set()
        for off, k, staged in chunks:
            tok, lp = self._unstage(staged)
            self._record_decode_block(active, off, k, tok, lp, caps, halted)

    def _record_decode_block(self, active, off, k, tok, lp, caps, halted):
        """Replay a fetched ``(k, B)`` token block into request state,
        mirroring the device's in-chunk gating exactly: each row consumes
        tokens up to its cap, stopping early at its first eos hit."""
        for idx, r in enumerate(active):
            if r.rid in halted:
                continue
            for j in range(min(k, caps[idx] - off)):
                t = int(tok[j, r.slot])
                self.tokens_next[r.slot] = t
                self._dev_counters[r.slot] += 1
                self._record_token(r, t, float(lp[j, r.slot]))
                self._advance_decoded(r)
                sp = r.sampling
                if sp.eos_ids is not None and t in sp.eos_ids:
                    halted.add(r.rid)
                    self._dev_mask[r.slot] = False
                    break

    # ------------------------------------------------------------------
    def step(self):
        """One serving step: ask the scheduler for a plan, execute it."""
        t0 = time.monotonic()
        self._drain_quality_stats()
        self._t_blocked = 0.0
        self._step_decoded = 0
        self._last_horizon = 0
        self._step_pages_visited = 0
        self._step_pages_dense = 0
        self._step_qslots = {int(q) for q in self.host_qslot if q >= 0}
        self.step_count += 1
        plan = self.scheduler.schedule(self.step_count)
        t_admit = time.monotonic()
        if plan.prefill_chunks:
            self._run_prefill(plan.prefill_chunks)
            if self.opts.measure_phases:
                self._sync()
        t_prefill = time.monotonic()
        self.scheduler.plan_compression(plan)
        self._launch_compression(plan)
        t_comp = time.monotonic()
        active = self.scheduler.schedule_decode(plan)
        if self.opts.fuse_sampling:
            self._run_decode_fused(active, plan)
        else:
            self._run_decode(active)
        if self.opts.measure_phases:
            self._sync()
        t_dec = time.monotonic()
        self.scheduler.end_step(plan)
        used = self.opts.n_total_blocks - self.bm.num_free
        entry = {
            "step": self.step_count,
            "t_total": t_dec - t0,
            "t_prefill": t_prefill - t_admit,
            "t_compress": t_comp - t_prefill,
            "t_decode": t_dec - t_comp,
            # host planning/bookkeeping vs blocked-on-device split
            "t_device": self._t_blocked,
            "t_host": max(0.0, (t_dec - t0) - self._t_blocked),
            "n_running": len(self.scheduler.running),
            "n_waiting": len(self.scheduler.waiting),
            "n_active": len(active),
            "n_compressing": len(plan.compress),
            "n_prefilled": len(plan.admitted),
            "block_util": used / self.opts.n_total_blocks,
            "tokens": self._step_decoded + len(plan.admitted),
            "decode_horizon": self._last_horizon,
            "pages_visited": self._step_pages_visited,
            "pages_dense": self._step_pages_dense,
        }
        entry.update(self.scheduler.stats(plan,
                                          n_decoded=self._step_decoded))
        self.metrics.append(entry)
        self.scheduler.observe_latency(
            (t_dec - t0) / max(1, self._last_horizon))
        if self.sanitize:
            invariants.check_engine(self)
        for hook in self.step_hooks:
            hook(entry)

    def run(self, max_steps=10_000):
        while self.scheduler.has_work() and self.step_count < max_steps:
            self.step()
        return {r.rid: r for r in self.scheduler.finished.values()}

    # ------------------------------------------------------------------
    # fault tolerance: full engine snapshot/restore

    def snapshot(self):
        """The whole engine as host data: the device state (sink page and
        sink query slot included), the host mirrors, the scheduler's
        queues, pools and counters, the block manager, and the host swap
        tier: the swapped queue, its counters, the host swap pool and the
        parked observation windows."""
        dev = _tree_map(lambda t: t.to("cpu", copy=True), self.state)
        return {
            "device": dev,
            "host": copy.deepcopy({
                "bt": self.host_bt, "seq": self.host_seq,
                "pos": self.host_pos, "qslot": self.host_qslot,
                "tokens_next": self.tokens_next,
                "free_slots": self.scheduler.free_slots,
                "free_qslots": self.scheduler.free_qslots,
                "rid": self._rid, "step": self.step_count,
                "admission_scale": self.scheduler.admission_scale,
                "ewma": self.scheduler.ewma,
                "n_swapped_out": self.scheduler.n_swapped_out,
                "n_swapped_in": self.scheduler.n_swapped_in,
                "swap_bytes": self.scheduler.swap_bytes,
                "n_comp_by_policy": self.scheduler.n_comp_by_policy,
                "n_comp_deferred": self.scheduler.n_comp_deferred,
            }),
            "requests": copy.deepcopy({
                "waiting": list(self.scheduler.waiting),
                "running": self.scheduler.running,
                "swapped": list(self.scheduler.swapped),
                "finished": self.scheduler.finished,
            }),
            "bm": copy.deepcopy(self.bm),
            "swap_pool": (None if self.swap_pool is None else
                          _tree_map(torch.clone, self.swap_pool)),
            "swap_qwin": {rid: a.clone()
                          for rid, a in self._swap_qwin.items()},
        }

    def restore(self, snap):
        """Resume from ``snapshot()``. The device state is copied into the
        engine's own buffers, which its captured graphs read; then every
        device mirror is invalidated, so the next step pushes tables and
        sampling state wholesale. The swap pool is copied into the engine's
        own host pool. Into an engine without a swap tier, the swapped
        requests re-enter as recompute admissions (the scheduler demotes
        them) and their parked windows are dropped."""
        self._sync()                 # queued swap-ins may read the host pool
        _copy_into(self.state, snap["device"])
        h = copy.deepcopy(snap["host"])
        self.host_bt, self.host_seq = h["bt"], h["seq"]
        self.host_pos, self.host_qslot = h["pos"], h["qslot"]
        self.tokens_next = h["tokens_next"]
        sched = self.scheduler
        sched.free_slots, sched.free_qslots = h["free_slots"], h["free_qslots"]
        sched.admission_scale = h["admission_scale"]
        sched.ewma = h["ewma"]
        sched.n_swapped_out = h["n_swapped_out"]
        sched.n_swapped_in = h["n_swapped_in"]
        sched.swap_bytes = h["swap_bytes"]
        sched.n_comp_by_policy = dict(h["n_comp_by_policy"])
        sched.n_comp_deferred = h["n_comp_deferred"]
        # in-flight quality telemetry references the old device buffers;
        # the requests it describes were deep-copied anyway
        self._pending_quality = None
        self._rid, self.step_count = h["rid"], h["step"]
        r = copy.deepcopy(snap["requests"])
        sched.waiting = deque(r["waiting"])
        sched.running = r["running"]
        sched.swapped = deque(r["swapped"])
        sched.finished = r["finished"]
        sched.bm = copy.deepcopy(snap["bm"])
        self._swap_qwin = {}
        if self.swap_pool is not None:
            if snap["swap_pool"] is not None:
                _copy_into(self.swap_pool, snap["swap_pool"])
            for rid, a in snap["swap_qwin"].items():
                self._swap_qwin[rid] = self._host_copy(a)
                self._swap_qwin[rid].copy_(a)
        self._pushed_version = -1
        self._tokens_dirty = True
        self._qwin_shadow = {}
        self._dev_mask = None
        self._dev_counters = None
        self._samp_version = -1
        self._samp_arrays = None


def _runs(ids):
    """Maximal runs of consecutive ids: ``(i, j, ids[i])`` for each run
    ``ids[i:j]``, so a run of host blocks is one copy."""
    i = 0
    for j in range(1, len(ids) + 1):
        if j == len(ids) or ids[j] != ids[j - 1] + 1:
            yield i, j, ids[i]
            i = j


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_into(dst: dict, src: dict) -> None:
    """Copy a snapshot's host tensors into the device buffers ``dst``,
    key by key, in place; shapes and keys must match exactly."""
    if dst.keys() != src.keys():
        raise ValueError(f"snapshot state keys {sorted(src)} are not the "
                         f"engine's {sorted(dst)}")
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        elif dst[k].shape != v.shape:
            raise ValueError(f"snapshot {k!r} has shape {tuple(v.shape)}, "
                             f"the engine's {tuple(dst[k].shape)}")
        else:
            dst[k].copy_(v)
