"""Serving-time model execution over the paged KV pool
(``repro.core.serve_model`` for the layer kinds the port serves:
attention, GQA or MLA, with dense or MoE FFNs).

State layout (a dict of tensors on one device; the steps update it in
place where the JAX package returned a new state, and never replace a
tensor of it, so a captured CUDA graph of a step reads and writes the same
buffers on every replay):
  pools:  {"k", "v": (L, N + 1, b, h_kv, d) at ``ServeSpec.dtype``,
           "f": (L, N + 1, b, h_kv) fp32}                       [GQA]
          or {"kv": (L, N + 1, b, r + d_rope) at ``ServeSpec.dtype``,
           "f": (L, N + 1, b, 1) fp32}                          [MLA]
  qwin:   (L, M + 1, w, h_q, dq) ring-ordered observation-window queries,
          at ``ServeSpec.dtype``; dq = d (GQA) or r + d_rope (MLA: the
          absorbed query beside its roped part)
The extra last page of the pools and the extra last query slot are sinks:
nothing maps them, and writes that must be dropped land there
(``paged.sink_page``).
  block_tables (B, max_blocks) int32, seq_lens (B,), positions (B,),
  qslot (B,) int32, and the fused-decode carry tokens_next (B,),
  active_mask (B,) bool, sample_counters (B,).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import paged
from repro_torch.core.sampling import sample_batch, sampling_noise
from repro_torch.kernels import ops
from repro_torch.models import layers as ML
from repro_torch.models import lm
from repro_torch.models.common import apply_norm, apply_rope


#: decode kernel families (``ServeSpec.decode_kernel``)
DECODE_KERNELS = ("ragged", "dense")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    n_slots: int                # decode batch slots
    block_size: int
    max_blocks: int             # block-table width per request
    n_total_blocks: int         # pool size
    m_qslots: int               # query-slot pool (paper's M)
    window: int = 16            # observation window w
    prefill_rows: int = 4       # prefill bucket rows
    prefill_len: int = 256      # padded prefill length
    # compute dtype of the residual stream, the K/V pools and the windows:
    # float32 (the port's default and parity baseline; the JAX package
    # defaults to bfloat16) or bfloat16. The params must be at it.
    dtype: str = "float32"
    # decode attention: "ragged" reads each slot's live pages only,
    # "dense" every entry of its table (the baseline); live rows agree
    # bit for bit
    decode_kernel: str = "ragged"

    def __post_init__(self):
        if self.decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"unknown decode_kernel {self.decode_kernel!r}; "
                             f"expected one of {DECODE_KERNELS}")


def qwin_dim(cfg: ArchConfig) -> int:
    """Width of one observation-window query."""
    if cfg.attn_type == "mla":
        return cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return cfg.head_dim


def make_state(cfg: ArchConfig, spec: ServeSpec, device) -> dict:
    lm.check_supported(cfg)
    L, B = cfg.num_layers, spec.n_slots
    N, b = spec.n_total_blocks, spec.block_size
    h, d = cfg.num_kv_heads, cfg.head_dim
    f32, i32 = torch.float32, torch.int32
    dt = lm.torch_dtype(spec.dtype)
    if cfg.attn_type == "mla":
        pools = {"kv": torch.zeros((L, N + 1, b, qwin_dim(cfg)), dtype=dt,
                                   device=device),
                 "f": torch.zeros((L, N + 1, b, 1), dtype=f32,
                                  device=device)}
    else:
        pools = {"k": torch.zeros((L, N + 1, b, h, d), dtype=dt,
                                  device=device),
                 "v": torch.zeros((L, N + 1, b, h, d), dtype=dt,
                                  device=device),
                 "f": torch.zeros((L, N + 1, b, h), dtype=f32,
                                  device=device)}
    return {
        "block_tables": torch.full((B, spec.max_blocks), -1, dtype=i32,
                                   device=device),
        "seq_lens": torch.zeros(B, dtype=i32, device=device),
        "positions": torch.zeros(B, dtype=i32, device=device),
        "qslot": torch.full((B,), -1, dtype=i32, device=device),
        "pools": pools,
        "qwin": torch.zeros((L, spec.m_qslots + 1, spec.window,
                             cfg.num_heads, qwin_dim(cfg)), dtype=dt,
                            device=device),
        "tokens_next": torch.zeros(B, dtype=torch.int64, device=device),
        "active_mask": torch.zeros(B, dtype=torch.bool, device=device),
        "sample_counters": torch.zeros(B, dtype=i32, device=device),
    }


def _write_qwin(qwin_l, rows, qslot, ring_pos, q):
    """Write q into the ring pool at (qslot, ring_pos % w) where ``rows``
    holds; other entries go to the sink slot (the last)."""
    M1, w = qwin_l.shape[:2]
    flat = qwin_l.view((M1 * w,) + tuple(qwin_l.shape[2:]))
    idx = torch.where(rows, qslot.long() * w + ring_pos.long() % w,
                      (M1 - 1) * w)
    flat[idx.reshape(-1)] = q.reshape((-1,) + tuple(q.shape[-2:])).to(
        flat.dtype)


def _absorb(cfg, p, q_nope, dtype):
    """Queries absorbed through W_uk: (..., h_q, dh) -> (..., h_q, r), the
    product in fp32, as the reference."""
    w_uk = p["w_uk"].reshape(cfg.kv_lora_rank, cfg.num_heads, cfg.head_dim)
    return torch.einsum("...hd,rhd->...hr", q_nope.float(),
                        w_uk.float()).to(dtype)


def _expand(cfg, p, o_lat, dtype):
    """Latent attention output through W_uv: (..., h_q, r) ->
    (..., h_q * dv), the product in fp32."""
    w_uv = p["w_uv"].reshape(cfg.kv_lora_rank, cfg.num_heads,
                             cfg.v_head_dim)
    o = torch.einsum("...hr,rhd->...hd", o_lat.float(), w_uv.float())
    return o.reshape(*o.shape[:-2], -1).to(dtype)


def build_decode_step(cfg: ArchConfig, spec: ServeSpec):
    """decode_step(params, state, tokens, active) -> logits (B, V) fp32.

    tokens: (B,) int; active: (B,) bool. Inactive slots produce garbage
    logits and leave all their state untouched: they write no KV and no
    observation-window query (their ring position is frozen, so a write
    would overwrite an entry compression scoring still needs).
    """
    lm.check_supported(cfg)
    dense = spec.decode_kernel == "dense"
    mla = cfg.attn_type == "mla"

    def step(params, state, tokens, active):
        x = params["embed"][tokens]
        positions = state["positions"]
        seq = state["seq_lens"]
        bt = state["block_tables"]
        qslot = state["qslot"]
        write_pos = torch.where(active, seq, torch.full_like(seq, -1))
        attend_len = seq + 1
        live_q = (qslot >= 0) & active
        pools, qwin = state["pools"], state["qwin"]
        B = x.shape[0]
        for li, p in enumerate(params["layers"]):
            h = apply_norm(cfg, p["ln1"], x)
            pa = p["attn"]
            if mla:
                # the latent pool, attended in plain PyTorch as the JAX
                # package decodes MLA in jnp
                q_nope, q_rope = ML.mla_queries(cfg, pa, h[:, None],
                                                positions[:, None])
                c, k_rope = ML.mla_latent(cfg, pa, h[:, None],
                                          positions[:, None])
                kv_l = pools["kv"][li]
                paged.scatter_token(kv_l, bt, write_pos,
                                    torch.cat([c[:, 0], k_rope[:, 0]], -1))
                q_abs = _absorb(cfg, pa, q_nope[:, 0], x.dtype)
                o_lat = paged.paged_decode_attention_mla(
                    q_abs, q_rope[:, 0], kv_l, bt, attend_len,
                    r=cfg.kv_lora_rank, scale=ML.mla_scale(cfg))
                o = _expand(cfg, pa, o_lat, x.dtype)
                q = torch.cat([q_abs, q_rope[:, 0]], -1)   # (B, hq, r+dr)
            else:
                q, k, v = ML.attn_qkv(cfg, pa, h)             # (B, h, d)
                q = apply_rope(q[:, None], positions[:, None],
                               cfg.rope_theta)[:, 0]
                k = apply_rope(k[:, None], positions[:, None],
                               cfg.rope_theta)[:, 0]
                k_l, v_l = pools["k"][li], pools["v"][li]
                paged.scatter_token(k_l, bt, write_pos, k)
                paged.scatter_token(v_l, bt, write_pos, v)
                if dense:
                    o = ops.paged_decode_attention(q, k_l, v_l, bt,
                                                   attend_len)
                else:
                    o = ops.ragged_decode_attention(q, k_l, v_l, bt,
                                                    attend_len)
            _write_qwin(qwin[li], live_q, qslot, seq, q)
            x = x + o.reshape(B, -1) @ pa["wo"]
            h2 = apply_norm(cfg, p["ln2"], x)
            if "moe" in p:
                x = x + ML.moe_forward(cfg, p["moe"], h2[:, None],
                                       valid=active[:, None])[:, 0]
            else:
                x = x + ML.ffn_forward(cfg, p["ffn"], h2)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = (x @ lm.unembed_matrix(cfg, params)).float()
        inc = active.to(seq.dtype)
        seq.add_(inc)
        positions.add_(inc)
        return logits

    return step


def build_fused_decode_step(cfg: ArchConfig, spec: ServeSpec, n_steps: int,
                            greedy: bool = False):
    """``n_steps`` decode+sample iterations on the device-carried sampling
    state (the JAX package's fused step, its ``lax.scan`` written out).

    fused(params, state, idx0, step_caps, seeds, temps, top_k, top_p,
          eos_ids) -> (tokens (n_steps, B), logprobs (n_steps, B))

    Row i decodes in iteration j while its ``active_mask`` bit is set and
    ``idx0 + j < step_caps[i]``; ``idx0`` is a 0-d int tensor on the
    device, so one captured graph of the function serves every chunk
    offset. ``tokens_next``, ``sample_counters`` and ``active_mask``
    advance on the device, in place, so consecutive iterations and calls
    chain without the host writing them; a row that samples one of its
    ``eos_ids`` (padded with -1) clears its own mask bit. Each iteration
    draws the sampled rows' threefry noise from that iteration's
    ``sample_counters`` (``sampling.sampling_noise``), so a request's
    stream depends on its (seed, position) alone.

    ``greedy=True`` builds the variant for batches whose rows are all
    greedy: argmax and its logprob, no noise and no sort; ``seeds``,
    ``temps``, ``top_k`` and ``top_p`` are not read.
    """
    core = build_decode_step(cfg, spec)

    def fused(params, state, idx0, step_caps, seeds, temps, top_k, top_p,
              eos_ids):
        toks, lps = [], []
        nxt, counters = state["tokens_next"], state["sample_counters"]
        mask = state["active_mask"]
        for j in range(n_steps):
            gate = mask & (idx0 + j < step_caps)
            logits = core(params, state, nxt, gate)
            if greedy:
                tok = torch.argmax(logits, -1)
                lp = torch.gather(torch.log_softmax(logits, -1), 1,
                                  tok[:, None])[:, 0]
            else:
                noise = sampling_noise(seeds, counters, logits.shape[-1])
                tok, lp = sample_batch(logits, noise, temps, top_k, top_p)
            tok = torch.where(gate, tok, nxt)
            eos_hit = gate & (tok[:, None] == eos_ids).any(-1)
            nxt.copy_(tok)
            counters.add_(gate.to(counters.dtype))
            mask.logical_and_(~eos_hit)
            toks.append(tok)
            lps.append(lp)
        return torch.stack(toks), torch.stack(lps)

    return fused


def build_swap_out_step(cfg: ArchConfig, spec: ServeSpec):
    """``swap_out(pools, block_ids) -> {leaf: (m, L, b, ...)}``: whole KV
    blocks of every layer and pool leaf, gathered for a swap-out.

    Block-major, where the JAX package returns ``(L, m, b, ...)``: the
    engine's host swap pool holds each block's layers contiguously, so a
    run of consecutive host blocks is one direct copy between the device
    and pinned host memory, without a staging buffer.
    """
    lm.check_supported(cfg)

    def swap_out(pools, block_ids):
        return {k: paged.gather_kv_blocks(v, block_ids).transpose(0, 1)
                .contiguous() for k, v in pools.items()}

    return swap_out


def build_swap_in_step(cfg: ArchConfig, spec: ServeSpec):
    """``swap_in(pools, block_ids, values)``: scatter block-major values
    (``build_swap_out_step``'s layout) back into the device pools, in
    place, so a captured decode graph keeps reading the same buffers;
    swap-in restores the request's KV bit for bit. A -1 id writes to the
    sink page."""
    lm.check_supported(cfg)

    def swap_in(pools, block_ids, values):
        for k, pool in pools.items():
            paged.scatter_kv_blocks(pool, block_ids,
                                    values[k].transpose(0, 1))

    return swap_in


def build_prefill_step(cfg: ArchConfig, spec: ServeSpec):
    """prefill_step(params, state, tokens, slot_ids, lengths, start_pos,
    rope_start=None) -> last-token logits (P, V).

    tokens: (P, S) padded prompts; slot_ids: (P,) destination slots (-1 =
    padding row); lengths: (P,) valid length; start_pos: (P,) KV entries
    already cached (the cache-write index of each row's first token);
    rope_start: (P,) the rotary position of that token, defaulting to
    start_pos. The caller must have installed block tables / seq_lens for
    these slots first. Writes K/V into the pools and seeds the observation
    window with each row's last ``window`` queries.
    """
    lm.check_supported(cfg)
    w_obs = spec.window
    mla = cfg.attn_type == "mla"

    def step(params, state, tokens, slot_ids, lengths, start_pos,
             rope_start=None):
        P, S = tokens.shape
        dev = tokens.device
        x = params["embed"][tokens]
        if rope_start is None:
            rope_start = start_pos
        ar = torch.arange(S, device=dev)[None]
        positions = rope_start[:, None] + ar
        valid = ar < lengths[:, None]
        row_ok = slot_ids >= 0
        slot_c = slot_ids.clamp(min=0).long()
        bt = state["block_tables"][slot_c]
        cache_pos = start_pos[:, None] + ar
        wpos = torch.where(valid & row_ok[:, None], cache_pos,
                           torch.full_like(cache_pos, -1))
        kv_lens = start_pos + lengths
        qslot = state["qslot"][slot_c]
        in_win = valid & (cache_pos >= kv_lens[:, None] - w_obs) \
            & ((qslot >= 0) & row_ok)[:, None]
        qslot_rows = qslot[:, None].expand(P, S)
        pools, qwin = state["pools"], state["qwin"]
        moe_valid = valid & row_ok[:, None]
        for li, p in enumerate(params["layers"]):
            h = apply_norm(cfg, p["ln1"], x)
            pa = p["attn"]
            if mla:
                q_nope, q_rope = ML.mla_queries(cfg, pa, h, positions)
                c, k_rope = ML.mla_latent(cfg, pa, h, positions)
                kv_l = pools["kv"][li]
                paged.scatter_positions(kv_l, bt, wpos,
                                        torch.cat([c, k_rope], -1))
                q = torch.cat([_absorb(cfg, pa, q_nope, x.dtype), q_rope],
                              -1)                         # (P, S, hq, r+dr)
                o_lat = paged.paged_prefill_attention_mla(
                    q, kv_l, bt, start_pos, kv_lens, r=cfg.kv_lora_rank,
                    scale=ML.mla_scale(cfg))
                o = _expand(cfg, pa, o_lat, x.dtype)
            else:
                q, k, v = ML.attn_qkv(cfg, pa, h)          # (P, S, h, d)
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
                k_l, v_l = pools["k"][li], pools["v"][li]
                paged.scatter_positions(k_l, bt, wpos, k)
                paged.scatter_positions(v_l, bt, wpos, v)
                o = paged.paged_prefill_attention(q, k_l, v_l, bt,
                                                  start_pos, kv_lens)
            _write_qwin(qwin[li], in_win, qslot_rows, cache_pos, q)
            x = x + o.reshape(P, S, -1) @ pa["wo"]
            h2 = apply_norm(cfg, p["ln2"], x)
            if "moe" in p:
                x = x + ML.moe_forward(cfg, p["moe"], h2, valid=moe_valid)
            else:
                x = x + ML.ffn_forward(cfg, p["ffn"], h2)
        x = apply_norm(cfg, params["final_norm"], x)
        last = (lengths - 1).clamp(min=0).long()
        x_last = x[torch.arange(P, device=dev), last]
        return (x_last @ lm.unembed_matrix(cfg, params)).float()

    return step
