"""Paged KV-pool operations in plain PyTorch (``repro.core.paged``).

Pool layout per attention layer: ``(N_total, b, h_kv, d)`` for K and V.
Block tables are ``(B, max_blocks)`` int32, padded with ``-1``.

The JAX package writes with ``.at[idx].set(..., mode="drop")`` and an
out-of-range sentinel for rows that must not write. PyTorch has no dropping
scatter, and selecting the writing rows with a boolean mask would make the
host wait for the device on every write. So the port's pools carry one
extra page at the end, the *sink*: block tables never map it, and a write
that must be dropped is sent there instead (``sink_page``). Writes update
the pool in place.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# ----------------------------------------------------------------------
# writes (in place)

def scatter_token(pool, block_tables, positions, values):
    """Write one token per request into its page slot.

    pool: (N_total + 1, b, ...) with the sink page last; block_tables:
    (B, max_blocks); positions: (B,) cache position; values: (B, ...).
    Rows with position < 0 write nothing (inactive slots).
    """
    scatter_positions(pool, block_tables, positions[:, None],
                      values[:, None])


def sink_page(pool) -> int:
    """Index of the pool's sink page (the last one), where dropped writes
    go."""
    return pool.shape[0] - 1


def scatter_positions(pool, block_tables, wpos, values):
    """Write (B, S, ...) values at cache positions ``wpos`` (B, S);
    entries with wpos < 0 go to the sink page. block_tables:
    (B, max_blocks)."""
    b = pool.shape[1]
    live = wpos >= 0
    pos = torch.where(live, wpos, torch.zeros_like(wpos)).long()
    blk = torch.gather(block_tables.long(), 1, pos // b)
    idx = torch.where(live, blk * b + pos % b, sink_page(pool) * b)
    flat = pool.view((-1,) + tuple(pool.shape[2:]))
    flat[idx.reshape(-1)] = values.reshape(
        (-1,) + tuple(values.shape[2:])).to(pool.dtype)


def scatter_prefill(pool, block_tables, values, lengths, start=None):
    """Write a whole prefill segment. values: (B, S, ...); lengths: (B,)
    total valid cache length; start: (B,) first cache position."""
    B, S = values.shape[:2]
    ar = torch.arange(S, device=values.device)[None, :]
    st = torch.zeros_like(lengths) if start is None else start
    pos = ar + st[:, None]
    wpos = torch.where(pos < lengths[:, None], pos, torch.full_like(pos, -1))
    scatter_positions(pool, block_tables, wpos, values)


# ----------------------------------------------------------------------
# whole-block copies (the host swap tier)

def gather_kv_blocks(pool, block_ids):
    """Gather whole blocks across every layer of a pool leaf.

    pool: (L, N_total + 1, b, ...) with the sink page last; block_ids:
    (m,) int, padded with -1. Returns (L, m, b, ...); a -1 id reads page
    0, as in the JAX package, and callers slice by the real block count.
    The swap-out half of the host swap tier.
    """
    return pool.index_select(1, block_ids.long().clamp(min=0))


def scatter_kv_blocks(pool, block_ids, values):
    """Inverse of :func:`gather_kv_blocks`, in place: write (L, m, b, ...)
    values into the pool at ``block_ids``; a -1 id writes to the sink page
    (the JAX package drops it). Swap-in restores a request's KV bit for
    bit."""
    ids = block_ids.long()
    ids = torch.where(ids >= 0, ids, torch.full_like(ids, pool.shape[1] - 1))
    pool.index_copy_(1, ids, values.to(pool.dtype))


# ----------------------------------------------------------------------
# reads

def gather_entries(pool, block_tables):
    """Gather each request's pages into cache order.

    pool: (N_total, b, ...); block_tables: (B, max_blocks). Returns
    (B, max_blocks*b, ...). ``-1`` entries read page 0 — callers mask by
    seq_len.
    """
    out = pool[block_tables.long().clamp(min=0)]       # (B, mb, b, ...)
    return out.reshape((out.shape[0], -1) + tuple(out.shape[3:]))


# ----------------------------------------------------------------------
# attention

def paged_decode_attention(q, k_pool, v_pool, block_tables, seq_lens):
    """One-token GQA attention against the paged pool (the dense
    reference). q: (B, h_q, d); pools: (N, b, h_kv, d). Returns
    (B, h_q, d). Masked V lanes are zeroed before ``p·V``: a masked
    position carries zero probability, but the gathered V there is pool
    garbage and 0·NaN = NaN."""
    B, hq, d = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    ks = gather_entries(k_pool, block_tables)          # (B, T, hkv, d)
    vs = gather_entries(v_pool, block_tables)
    T = ks.shape[1]
    qg = q.reshape(B, hkv, g, d).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, ks.float()) / math.sqrt(d)
    mask = torch.arange(T, device=q.device)[None, :] < seq_lens[:, None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, -1)
    vs = torch.where(mask[..., None, None], vs.float(),
                     torch.zeros((), device=q.device))
    o = torch.einsum("bhgt,bthd->bhgd", p, vs)
    return o.reshape(B, hq, d).to(q.dtype)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_start,
                            kv_lens):
    """Prefill chunk attention against pages (no kernel: plain PyTorch, as
    in the JAX package).

    q: (B, S, h_q, d) at cache positions q_start + arange(S); kv_lens: (B,)
    valid cache entries including this chunk, already written. Causal
    within the chunk.
    """
    B, S, hq, d = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    ks = gather_entries(k_pool, block_tables)
    vs = gather_entries(v_pool, block_tables)
    T = ks.shape[1]
    qg = q.reshape(B, S, hkv, g, d).float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, ks.float()) / math.sqrt(d)
    qpos = q_start[:, None] + torch.arange(S, device=q.device)[None]
    kpos = torch.arange(T, device=q.device)[None]
    kv_valid = kpos < kv_lens[:, None]                             # (B, T)
    mask = (kpos[:, None] <= qpos[..., None]) & kv_valid[:, None]  # (B,S,T)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, -1)
    vs = torch.where(kv_valid[..., None, None], vs.float(),
                     torch.zeros((), device=q.device))
    o = torch.einsum("bhgst,bthd->bshgd", p, vs)
    return o.reshape(B, S, hq, d).to(q.dtype)


def paged_decode_attention_mla(q_nope_abs, q_rope, kv_pool, block_tables,
                               seq_lens, *, r, scale):
    """MLA absorbed decode (no kernel: plain PyTorch, as in the JAX
    package): score = q_abs·c + q_rope·k_rope, output in the latent.

    q_nope_abs: (B, h_q, r), the queries already absorbed through W_uk;
    q_rope: (B, h_q, d_rope); kv_pool: (N, b, r + d_rope). The product
    contracts the full (r + d_rope)-wide entries. Returns the latent
    output (B, h_q, r); the caller applies W_uv. Masked entries are zeroed
    before ``p·entries`` (pool garbage, and 0·NaN = NaN)."""
    entries = gather_entries(kv_pool, block_tables)      # (B, T, r+dr)
    T = entries.shape[1]
    q_cat = torch.cat([q_nope_abs, q_rope], -1)          # (B, hq, r+dr)
    s = torch.einsum("bhe,bte->bht", q_cat.float(), entries.float()) * scale
    mask = torch.arange(T, device=q_cat.device)[None, :] < seq_lens[:, None]
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, -1)
    ent = torch.where(mask[..., None], entries.float(),
                      torch.zeros((), device=q_cat.device))
    o = torch.einsum("bht,bte->bhe", p, ent)
    return o[..., :r].to(q_nope_abs.dtype)


def paged_prefill_attention_mla(q_full, kv_pool, block_tables, q_start,
                                kv_lens, *, r, scale):
    """MLA prefill attention in the absorbed space against the pool (the
    JAX package's ``_paged_prefill_mla``). q_full: (B, S, h_q, r + d_rope)
    at cache positions q_start + arange(S); kv_lens: (B,) valid entries,
    this chunk's already written. Causal within the chunk. Returns the
    latent output (B, S, h_q, r)."""
    B, S = q_full.shape[:2]
    entries = gather_entries(kv_pool, block_tables)      # (B, T, r+dr)
    T = entries.shape[1]
    dev = q_full.device
    s = torch.einsum("bshe,bte->bhst", q_full.float(),
                     entries.float()) * scale
    qpos = q_start[:, None] + torch.arange(S, device=dev)[None]
    kpos = torch.arange(T, device=dev)[None]
    kv_valid = kpos < kv_lens[:, None]                             # (B, T)
    mask = (kpos[:, None] <= qpos[..., None]) & kv_valid[:, None]  # (B,S,T)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, -1)
    ent = torch.where(kv_valid[..., None], entries.float(),
                      torch.zeros((), device=dev))
    o = torch.einsum("bhst,bte->bshe", p, ent)
    return o[..., :r].to(q_full.dtype)
