"""Compression scoring in plain PyTorch (``repro.core.scoring``), batched.

Every function takes a leading request dimension n: scores are
(n, T, h) in cache order, ``valid`` is (n, T) (entry < seq_len), and
per-request scalars are (n,). The window attention scores and the raw
redundancy come from the kernels (``repro_torch.kernels.ops``); this module
turns them into the final keep scores and the top-k tag.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.paged import NEG_INF


def _arange(T, like):
    return torch.arange(T, device=like.device)


def mla_attention_scores(q_win_abs, entries, valid, seq_len, *, scale):
    """MLA window scores (the JAX package's ``mla_attention_scores``,
    batched), the plain reference the kernel route is held against:
    q_win_abs (n, w, h_q, r + d_rope) absorbed window queries; entries
    (n, T, r + d_rope) the latent cache. Softmax over T, max over the
    query heads, mean over w. Returns (n, T, 1)."""
    w = q_win_abs.shape[1]
    T = entries.shape[1]
    s = torch.einsum("nwhe,nte->nwht", q_win_abs.float(),
                     entries.float()) * scale
    qpos = seq_len[:, None] - w + _arange(w, s)[None]             # (n, w)
    mask = (_arange(T, s)[None, None] <= qpos[..., None]) \
        & valid[:, None]                                          # (n, w, T)
    s = torch.where(mask[:, :, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, -1)
    p = torch.where(mask[:, :, None], p, torch.zeros_like(p))
    return p.amax(2).mean(1)[..., None]


def global_score_update(scores, f_prev, hist_len, alpha):
    """Paper Alg. 2 (G-KV): decayed max with history; entries with cache
    position < hist_len carry history."""
    has_hist = (_arange(scores.shape[1], scores)[None] < hist_len[:, None])
    return torch.where(has_hist[..., None],
                       torch.maximum(alpha * f_prev, scores), scores)


def redundancy_softmax(r_raw, valid, *, tau=1.0):
    """Distribution over the sequence dim with temperature (paper C.8)."""
    x = torch.where(valid[..., None], r_raw / tau,
                    torch.full_like(r_raw, NEG_INF))
    return torch.softmax(x, dim=1)


def max_pool_scores(scores, valid, *, kernel=7):
    """SnapKV sequence-dim max pooling (paper C.4), same-padded, masked."""
    s = torch.where(valid[..., None], scores,
                    torch.full_like(scores, NEG_INF))
    out = s.clone()
    for off in range(1, kernel // 2 + 1):
        out[:, off:] = torch.maximum(out[:, off:], s[:, :-off])
        out[:, :-off] = torch.maximum(out[:, :-off], s[:, off:])
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def combine_scores(attn_s, red_dist, valid, win_len, seq_len, *, lam):
    """Final score (paper Eq. 4 + window pinning): S - λ·R, the
    observation window (last win_len valid entries) pinned to +inf,
    invalid entries to -inf."""
    s = attn_s - lam * red_dist
    pos = _arange(s.shape[1], s)[None]
    in_win = (pos >= (seq_len - win_len)[:, None]) & (pos < seq_len[:, None])
    s = torch.where(in_win[..., None], torch.full_like(s, math.inf), s)
    return torch.where(valid[..., None], s, torch.full_like(s, -math.inf))


def quality_stats(attn_s, red_raw, valid, seq_len):
    """Per-request quality telemetry (docs/EVAL.md of the JAX package):
    (n, 2) ``[mean raw redundancy over valid entries, normalized attention
    entropy in [0, 1]]``."""
    v = valid[..., None]
    zero = torch.zeros((), device=attn_s.device)
    n_valid = valid.sum(1).clamp(min=1)
    red_mean = torch.where(v, red_raw, zero).sum((1, 2)) / (
        n_valid * red_raw.shape[2])
    p = torch.where(v, attn_s, zero)
    p = p / p.sum(1, keepdim=True).clamp(min=1e-12)
    ent = -torch.where(v & (p > 0), p * torch.log(p.clamp(min=1e-12)),
                       zero).sum(1)                           # (n, h)
    ent_norm = ent.mean(1) / torch.log(seq_len.clamp(min=2).float())
    return torch.stack([red_mean, ent_norm], 1).float()


def topk_tag(scores, k):
    """Boolean keep-tag per head: the top-k entries along the sequence dim.
    (n, T, h) -> (n, T, h). Ties go to the lower cache position, as with
    ``lax.top_k``, hence a stable descending sort and not ``torch.topk``."""
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]
    tag = torch.zeros_like(scores, dtype=torch.bool)
    return tag.scatter_(1, idx, True)
