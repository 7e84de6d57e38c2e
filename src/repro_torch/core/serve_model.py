"""Serving-time model execution over the paged KV pool
(``repro.core.serve_model`` for every layer kind: attention, GQA or MLA,
local-window GQA over a ring of pages, the recurrent mixers RG-LRU and
RWKV6, with dense or MoE FFNs, and an encoder-decoder model's cross
attention).

State layout (a dict of tensors on one device; the steps update it in
place where the JAX package returned a new state, and never replace a
tensor of it, so a captured CUDA graph of a step reads and writes the same
buffers on every replay). L_attn counts the attention layers, L_rec the
recurrent ones; a config with no attention layer has no pools and no qwin.
  pools:  {"k", "v": (L_attn, N + 1, b, h_kv, d) at ``ServeSpec.dtype``,
           "f": (L_attn, N + 1, b, h_kv) fp32}                  [GQA]
          or {"kv": (L_attn, N + 1, b, r + d_rope) at the dtype,
           "f": (L_attn, N + 1, b, 1) fp32}                     [MLA]
  qwin:   (L_attn, M + 1, w, h_q, dq) ring-ordered observation-window
          queries, at ``ServeSpec.dtype``; dq = d (GQA) or r + d_rope
          (MLA: the absorbed query beside its roped part)
  rec:    {"h": (L_rec, B, w) fp32, "conv": (L_rec, B, cw - 1, w) at the
           dtype}                                               [RG-LRU]
          or {"S": (L_rec, B, h, K, K) fp32, "shift": (L_rec, B, d) at
           the dtype}                                           [RWKV6]
  cross_kv: {"k", "v": (L, B, cross_seq_len, h_kv, d) at the dtype}, each
           slot's cross-attention keys and values over the encoder's
           output, which every prefill call writes for its rows and
           every decode layer reads                             [enc-dec]
The extra last page of the pools and the extra last query slot are sinks:
nothing maps them, and writes that must be dropped land there
(``paged.sink_page``).
  block_tables (B, max_blocks) int32, seq_lens (B,), positions (B,),
  qslot (B,) int32, and the fused-decode carry tokens_next (B,),
  active_mask (B,) bool, sample_counters (B,).

Local-window attention (``cfg.local_window``, RecurrentGemma) keeps a
request's keys in a ring of ``ServeSpec.ring_blocks(cfg)`` blocks, the
window's tokens: position p lives at ring entry p % ring, and a decode
attends the ring's min(p + 1, ring) entries; seq_lens stays clamped at the
ring.

Prefill continues a request's state across calls. The JAX package starts
every prefill call's recurrent state from zero and lets a ring's queries
see only the call's own keys, so a prompt fed in several calls loses its
state at each boundary; here a row whose ``start_pos`` is above 0 starts
from the slot's carried state (RG-LRU's h and conv history, RWKV's S and
token shift), and its queries see the ring entries of the window before
the call, read before the call's own writes, beside the call's keys. A row
at ``start_pos`` 0 starts from zero, as the JAX package does.
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
    # defaults to bfloat16), bfloat16 or float16. The params must be at it.
    dtype: str = "float32"
    # decode attention: "ragged" reads each slot's live pages only,
    # "dense" every entry of its table (the baseline); live rows agree
    # bit for bit
    decode_kernel: str = "ragged"

    def __post_init__(self):
        if self.decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"unknown decode_kernel {self.decode_kernel!r}; "
                             f"expected one of {DECODE_KERNELS}")

    def ring_blocks(self, cfg) -> int:
        """Ring capacity for local-window attention, in blocks (the
        window's tokens)."""
        if cfg.local_window % self.block_size:
            raise ValueError(f"local_window {cfg.local_window} is not a "
                             f"multiple of block_size {self.block_size}")
        return cfg.local_window // self.block_size


def ring_tokens(cfg: ArchConfig, spec: ServeSpec) -> int:
    """The ring's entries for a local-window config, else 0."""
    return spec.ring_blocks(cfg) * spec.block_size if cfg.local_window else 0


def mixer_kinds(cfg: ArchConfig):
    """Each layer's mixer and its ordinal among the layers of its state:
    [(kind, index into the pools or into rec)]."""
    out, n_attn, n_rec = [], 0, 0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            out.append((kind, n_attn))
            n_attn += 1
        else:
            out.append((kind, n_rec))
            n_rec += 1
    return out


def qwin_dim(cfg: ArchConfig) -> int:
    """Width of one observation-window query."""
    if cfg.attn_type == "mla":
        return cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return cfg.head_dim


def make_state(cfg: ArchConfig, spec: ServeSpec, device) -> dict:
    lm.check_supported(cfg)
    L, B = cfg.num_attn_layers, spec.n_slots
    L_rec = cfg.num_layers - L
    N, b = spec.n_total_blocks, spec.block_size
    h, d = cfg.num_kv_heads, cfg.head_dim
    f32, i32 = torch.float32, torch.int32
    dt = lm.torch_dtype(spec.dtype)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    st = {
        "block_tables": torch.full((B, spec.max_blocks), -1, dtype=i32,
                                   device=device),
        "seq_lens": zeros(B, i32),
        "positions": zeros(B, i32),
        "qslot": torch.full((B,), -1, dtype=i32, device=device),
    }
    if L:
        if cfg.attn_type == "mla":
            st["pools"] = {"kv": zeros((L, N + 1, b, qwin_dim(cfg)), dt),
                           "f": zeros((L, N + 1, b, 1), f32)}
        else:
            st["pools"] = {"k": zeros((L, N + 1, b, h, d), dt),
                           "v": zeros((L, N + 1, b, h, d), dt),
                           "f": zeros((L, N + 1, b, h), f32)}
        st["qwin"] = zeros((L, spec.m_qslots + 1, spec.window,
                            cfg.num_heads, qwin_dim(cfg)), dt)
    if L_rec:
        if "rglru" in cfg.layer_kinds():
            w = cfg.lru_width or cfg.d_model
            st["rec"] = {"h": zeros((L_rec, B, w), f32),
                         "conv": zeros((L_rec, B, cfg.conv1d_width - 1, w),
                                       dt)}
        else:
            K = cfg.head_dim
            st["rec"] = {"S": zeros((L_rec, B, cfg.num_heads, K, K), f32),
                         "shift": zeros((L_rec, B, cfg.d_model), dt)}
    if cfg.is_enc_dec:
        shape = (cfg.num_layers, B, cfg.cross_seq_len, h, d)
        st["cross_kv"] = {"k": zeros(shape, dt), "v": zeros(shape, dt)}
    st.update(tokens_next=zeros(B, torch.int64),
              active_mask=zeros(B, torch.bool),
              sample_counters=zeros(B, i32))
    return st


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


def _decode_rec(cfg, p, kind, x, rec, r_i, active):
    """One recurrent layer, one token. The state of an inactive slot is
    left as it was: the new state is selected per slot and copied into
    the buffers in place. Returns the mixer's output (B, d)."""
    if kind == "rglru":
        st = {"h": rec["h"][r_i], "conv": rec["conv"][r_i]}
        out, new = ML.rglru_step(cfg, p, x, st)
    else:
        st = {"S": rec["S"][r_i], "shift": rec["shift"][r_i]}
        out, new = ML.rwkv_step(cfg, p, x, st)
    for k, old in st.items():
        keep = active.reshape((-1,) + (1,) * (old.dim() - 1))
        old.copy_(torch.where(keep, new[k].to(old.dtype), old))
    return out


def build_decode_step(cfg: ArchConfig, spec: ServeSpec):
    """decode_step(params, state, tokens, active) -> logits (B, V) fp32.

    tokens: (B,) int; active: (B,) bool. Inactive slots produce garbage
    logits and leave all their state untouched: they write no KV, no
    observation-window query (their ring position is frozen, so a write
    would overwrite an entry compression scoring still needs) and no
    recurrent state. A local-window layer writes position p at ring entry
    p % ring and attends min(p + 1, ring) entries; seq_lens then stays
    clamped at the ring.
    """
    lm.check_supported(cfg)
    dense = spec.decode_kernel == "dense"
    mla = cfg.attn_type == "mla"
    ring = ring_tokens(cfg, spec)
    kinds = mixer_kinds(cfg)

    def step(params, state, tokens, active):
        x = params["embed"][tokens]
        positions = state["positions"]
        seq = state["seq_lens"]
        bt = state["block_tables"]
        qslot = state["qslot"]
        if ring:
            write_pos = torch.where(active, positions % ring,
                                    torch.full_like(positions, -1))
            attend_len = torch.clamp(positions + 1, max=ring)
        else:
            write_pos = torch.where(active, seq, torch.full_like(seq, -1))
            attend_len = seq + 1
        live_q = (qslot >= 0) & active
        pools, qwin = state.get("pools"), state.get("qwin")
        cross = state.get("cross_kv")
        B = x.shape[0]
        for l, (p, (kind, li)) in enumerate(zip(params["layers"], kinds)):
            h = apply_norm(cfg, p["ln1"], x)
            if kind != "attn":
                x = x + _decode_rec(cfg, p[kind], kind, h, state["rec"], li,
                                    active)
            else:
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
                                        torch.cat([c[:, 0], k_rope[:, 0]],
                                                  -1))
                    q_abs = _absorb(cfg, pa, q_nope[:, 0], x.dtype)
                    o_lat = paged.paged_decode_attention_mla(
                        q_abs, q_rope[:, 0], kv_l, bt, attend_len,
                        r=cfg.kv_lora_rank, scale=ML.mla_scale(cfg))
                    o = _expand(cfg, pa, o_lat, x.dtype)
                    q = torch.cat([q_abs, q_rope[:, 0]], -1)  # (B, hq, r+dr)
                else:
                    q, k, v = ML.attn_qkv(cfg, pa, h)          # (B, h, d)
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
            if cross is not None:
                x = x + ML.cross_attend(
                    cfg, p["cross"], apply_norm(cfg, p["ln_x"], x)[:, None],
                    cross["k"][l], cross["v"][l])[:, 0]
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
        if ring:
            seq.clamp_(max=ring)
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


def _carried(rec, r_i, slot_c, carry):
    """The slots' recurrent state of layer ``r_i`` for the rows that carry
    it (start_pos > 0), zeros for the rows that start afresh."""
    out = {}
    for k, t in rec.items():
        st = t[r_i][slot_c]
        keep = carry.reshape((-1,) + (1,) * (st.dim() - 1))
        out[k] = torch.where(keep, st, torch.zeros_like(st))
    return out


def _store_rec(rec, r_i, slot_ids, row_ok, new):
    """Write the rows' final recurrent state into their slots, in place;
    padding rows (slot -1) write nothing."""
    idx = slot_ids[row_ok].long()
    for k, t in rec.items():
        t[r_i].index_copy_(0, idx, new[k][row_ok].to(t.dtype))


def _rwkv_chunk(S: int) -> int:
    """The reference's choice of WKV chunk for a prefill of S positions:
    64, 32, S itself below 32, else the token scan (1)."""
    if S % 64 == 0:
        return 64
    if S % 32 == 0:
        return 32
    return S if S < 32 else 1


def _prefill_ring(cfg, spec, q, k, v, k_l, v_l, bt, positions, valid,
                  row_ok, start_pos, lengths):
    """Local-window attention of a prefill chunk over the ring. The ring
    entries of the window before the chunk are read first: entry j holds
    the latest position below ``start_pos`` that is j modulo the ring
    (none at ``start_pos`` 0). Then the chunk's last ``ring`` keys are
    written at their ring entries, and the queries attend both, under the
    window's mask."""
    ring = ring_tokens(cfg, spec)
    nb = spec.ring_blocks(cfg)
    k_prev = paged.gather_entries(k_l, bt[:, :nb])      # (P, ring, h, d)
    v_prev = paged.gather_entries(v_l, bt[:, :nb])
    j = torch.arange(ring, device=q.device)[None]
    last = start_pos[:, None] - 1
    prev_pos = last - torch.remainder(last - j, ring)    # < 0: empty
    keep = positions >= (start_pos + lengths - ring)[:, None]
    wpos = torch.where(valid & keep & row_ok[:, None], positions % ring,
                       torch.full_like(positions, -1))
    paged.scatter_positions(k_l, bt, wpos, k)
    paged.scatter_positions(v_l, bt, wpos, v)
    kpos = torch.cat([prev_pos, torch.where(
        valid, positions, torch.full_like(positions, -1))], 1)
    return ML.window_attention(q, torch.cat([k_prev, k], 1),
                               torch.cat([v_prev, v], 1), positions, kpos,
                               local_window=cfg.local_window)


def build_prefill_step(cfg: ArchConfig, spec: ServeSpec):
    """prefill_step(params, state, tokens, slot_ids, lengths, start_pos,
    rope_start=None, frame_embeds=None, prefix_embeds=None) -> last-token
    logits (P, V).

    tokens: (P, S) padded prompts; slot_ids: (P,) destination slots (-1 =
    padding row); lengths: (P,) valid length; start_pos: (P,) KV entries
    already cached (the cache-write index of each row's first token);
    rope_start: (P,) the rotary position of that token, defaulting to
    start_pos. The caller must have installed block tables / seq_lens for
    these slots first. Writes K/V into the pools (a local-window layer:
    into the ring) and the rows' final recurrent state into their slots,
    and seeds the observation window with each row's last ``window``
    queries. A row with ``start_pos`` above 0 continues from its slot's
    carried state (module docstring).

    An encoder-decoder config needs ``frame_embeds`` (P, Sm, d): the
    encoder runs over each row's, every decoder layer attends its output
    after the self-attention, and the rows' cross keys and values are
    written into their slots' ``cross_kv``, in place. ``prefix_embeds``
    (P, n, d) go before every row's tokens, whatever its ``start_pos``, as
    the JAX package's code does, and lengthen every row by n: the
    positions, the cache writes and the observation window count them.
    """
    lm.check_supported(cfg)
    w_obs = spec.window
    mla = cfg.attn_type == "mla"
    ring = ring_tokens(cfg, spec)
    kinds = mixer_kinds(cfg)

    def step(params, state, tokens, slot_ids, lengths, start_pos,
             rope_start=None, frame_embeds=None, prefix_embeds=None):
        dev = tokens.device
        x = params["embed"][tokens]
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], 1)
            lengths = lengths + prefix_embeds.shape[1]
        P, S = x.shape[:2]
        memory = None
        if cfg.is_enc_dec:
            if frame_embeds is None:
                raise ValueError("enc-dec arch requires frame_embeds")
            memory = lm.encode(cfg, params, frame_embeds)
            cross = state["cross_kv"]
            store = slot_ids[slot_ids >= 0].long()
        if rope_start is None:
            rope_start = start_pos
        ar = torch.arange(S, device=dev)[None]
        positions = rope_start[:, None] + ar
        valid = ar < lengths[:, None]
        row_ok = slot_ids >= 0
        slot_c = slot_ids.clamp(min=0).long()
        carry = start_pos > 0
        bt = state["block_tables"][slot_c]
        cache_pos = start_pos[:, None] + ar
        wpos = torch.where(valid & row_ok[:, None], cache_pos,
                           torch.full_like(cache_pos, -1))
        kv_lens = start_pos + lengths
        qslot = state["qslot"][slot_c]
        in_win = valid & (cache_pos >= kv_lens[:, None] - w_obs) \
            & ((qslot >= 0) & row_ok)[:, None]
        qslot_rows = qslot[:, None].expand(P, S)
        pools, qwin = state.get("pools"), state.get("qwin")
        moe_valid = valid & row_ok[:, None]
        rows = torch.arange(P, device=dev)
        last = (lengths - 1).clamp(min=0).long()
        for l, (p, (kind, li)) in enumerate(zip(params["layers"], kinds)):
            h = apply_norm(cfg, p["ln1"], x)
            if kind == "rglru":
                out, new = ML.rglru_forward(
                    cfg, p[kind], h, valid=valid,
                    state=_carried(state["rec"], li, slot_c, carry),
                    return_state=True)
                _store_rec(state["rec"], li, slot_ids, row_ok, new)
                x = x + out
            elif kind == "rwkv":
                st = _carried(state["rec"], li, slot_c, carry)
                out, S_fin = ML.rwkv_forward(
                    cfg, p[kind], h, chunk=_rwkv_chunk(S), valid=valid,
                    state=st, return_state=True)
                _store_rec(state["rec"], li, slot_ids, row_ok,
                           {"S": S_fin, "shift": h[rows, last]})
                x = x + out
            else:
                pa = p["attn"]
                if mla:
                    q_nope, q_rope = ML.mla_queries(cfg, pa, h, positions)
                    c, k_rope = ML.mla_latent(cfg, pa, h, positions)
                    kv_l = pools["kv"][li]
                    paged.scatter_positions(kv_l, bt, wpos,
                                            torch.cat([c, k_rope], -1))
                    q = torch.cat([_absorb(cfg, pa, q_nope, x.dtype),
                                   q_rope], -1)           # (P, S, hq, r+dr)
                    o_lat = paged.paged_prefill_attention_mla(
                        q, kv_l, bt, start_pos, kv_lens, r=cfg.kv_lora_rank,
                        scale=ML.mla_scale(cfg))
                    o = _expand(cfg, pa, o_lat, x.dtype)
                else:
                    q, k, v = ML.attn_qkv(cfg, pa, h)      # (P, S, h, d)
                    q = apply_rope(q, positions, cfg.rope_theta)
                    k = apply_rope(k, positions, cfg.rope_theta)
                    k_l, v_l = pools["k"][li], pools["v"][li]
                    if ring:
                        o = _prefill_ring(cfg, spec, q, k, v, k_l, v_l, bt,
                                          positions, valid, row_ok,
                                          start_pos, lengths)
                    else:
                        paged.scatter_positions(k_l, bt, wpos, k)
                        paged.scatter_positions(v_l, bt, wpos, v)
                        o = paged.paged_prefill_attention(
                            q, k_l, v_l, bt, start_pos, kv_lens)
                _write_qwin(qwin[li], in_win, qslot_rows, cache_pos, q)
                x = x + o.reshape(P, S, -1) @ pa["wo"]
            if memory is not None:
                pc = p["cross"]
                ck, cv = ML.cross_kv(cfg, pc, memory)
                x = x + ML.cross_attend(
                    cfg, pc, apply_norm(cfg, p["ln_x"], x), ck, cv)
                cross["k"][l].index_copy_(0, store, ck[row_ok])
                cross["v"][l].index_copy_(0, store, cv[row_ok])
            h2 = apply_norm(cfg, p["ln2"], x)
            if "moe" in p:
                x = x + ML.moe_forward(cfg, p["moe"], h2, valid=moe_valid)
            else:
                x = x + ML.ffn_forward(cfg, p["ffn"], h2)
        x = apply_norm(cfg, params["final_norm"], x)
        return (x[rows, last] @ lm.unembed_matrix(cfg, params)).float()

    return step
