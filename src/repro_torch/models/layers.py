"""Dense GQA attention and FFN layers (``repro.models.layers`` for the
layer kinds the port serves). Params are plain dicts of tensors."""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import apply_rope, ffn_act_fn, rms_head_norm

NEG_INF = -1e30


def attn_qkv(cfg, p, x):
    """Project x -> (q, k, v) with per-head layout (..., H, D)."""
    lead = x.shape[:-1]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(*lead, hq, dh)
    k = k.reshape(*lead, hkv, dh)
    v = v.reshape(*lead, hkv, dh)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    return q, k, v


def causal_attention(q, k, v):
    """Full causal GQA attention. q: (B, S, Hq, D); k, v: (B, S, Hkv, D).
    Returns (B, S, Hq, D)."""
    B, S, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(B, S, hkv, g, d).float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(d)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]                      # (S, T)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, -1)
    o = torch.einsum("bhgst,bthd->bshgd", a, v.float())
    return o.reshape(B, S, hq, d).to(q.dtype)


def attn_forward(cfg, p, x, positions):
    """Full-sequence causal attention. x: (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = attn_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = causal_attention(q, k, v)
    return o.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"]


def ffn_forward(cfg, p, x):
    act = ffn_act_fn(cfg.ffn_act)
    a = x @ p["w1"]
    b = x @ p["w3"] if "w3" in p else None
    return act(a, b) @ p["w2"]
