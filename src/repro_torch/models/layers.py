"""Attention (GQA and DeepSeek's MLA), FFN and MoE layers
(``repro.models.layers`` for the layer kinds the port serves). Params are
plain dicts of tensors."""
from __future__ import annotations

import math

import torch

from repro_torch.models import moe_ctx
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


# ----------------------------------------------------------------------
# MLA (DeepSeek-V2): latent KV with decoupled RoPE

def mla_scale(cfg) -> float:
    """The softmax scale of MLA's scores, 1/sqrt(head_dim + rope dim):
    the absorbed form's 576-wide products stand for per-head ones of that
    width."""
    return 1.0 / math.sqrt(cfg.head_dim + cfg.qk_rope_head_dim)


def mla_latent(cfg, p, x, positions):
    """Per-token latent cache entry: (c_kv normed, k_rope roped). The
    norm computes in fp32 with its fp32 scale ``kv_norm``."""
    r = cfg.kv_lora_rank
    dkv = x @ p["w_dkv"]
    c, k_rope = dkv[..., :r], dkv[..., r:]
    cf = c.float()
    cf = cf * torch.rsqrt((cf * cf).mean(-1, keepdim=True) + 1e-6)
    c = (cf * p["kv_norm"]).to(x.dtype)
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c, k_rope


def mla_queries(cfg, p, x, positions):
    """(q_nope (..., hq, dh), q_rope (..., hq, dr) roped)."""
    hq, dh, dr = cfg.num_heads, cfg.head_dim, cfg.qk_rope_head_dim
    q = (x @ p["wq"]).reshape(*x.shape[:-1], hq, dh + dr)
    return q[..., :dh], apply_rope(q[..., dh:], positions, cfg.rope_theta)


def mla_forward(cfg, p, x, positions):
    """Full-sequence MLA in the expanded form: per-head keys and values
    from the latent, the roped key shared by the heads, V padded to the
    key width so one causal attention serves both."""
    B, S, _ = x.shape
    hq, dh, dv = cfg.num_heads, cfg.head_dim, cfg.v_head_dim
    dr = cfg.qk_rope_head_dim
    q_nope, q_rope = mla_queries(cfg, p, x, positions)
    c, k_rope = mla_latent(cfg, p, x, positions)
    k_nope = (c @ p["w_uk"]).reshape(B, S, hq, dh)
    v = (c @ p["w_uv"]).reshape(B, S, hq, dv)
    # the reference's scale and its undoing, kept for the same rounding
    q = torch.cat([q_nope, q_rope], -1) / math.sqrt(dh + dr)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, hq, dr)], -1)
    v = torch.nn.functional.pad(v, (0, dh + dr - dv))
    o = causal_attention(q * math.sqrt(dh + dr), k, v)
    return o[..., :dv].reshape(B, S, hq * dv) @ p["wo"]


def ffn_forward(cfg, p, x):
    act = ffn_act_fn(cfg.ffn_act)
    a = x @ p["w1"]
    b = x @ p["w3"] if "w3" in p else None
    return act(a, b) @ p["w2"]


# ----------------------------------------------------------------------
# MoE: capacity-based top-k routing (GShard dispatch)

def moe_forward(cfg, p, x, *, capacity_factor=None, valid=None,
                groups=None):
    """Capacity-based top-k MoE, the reference's semantics exactly.
    x: (B, S, d).

    The router's logits are a product at the compute dtype, softmaxed in
    fp32; the top-k gates are renormalised with ``max(sum, 1e-9)``. Each
    of ``groups`` token groups (``moe_ctx.dispatch_groups`` unless given;
    1 if it does not divide the tokens) routes on its own: an expert keeps
    at most ``C = max(ceil(T_g k / E * capacity_factor), 4)`` token-expert
    pairs of the group, in token-major order, and drops the rest. ``valid``
    (B, S) parks padding tokens on no expert, out of the competition. The
    shapes are static and nothing is read back to the host, so a decode
    step with MoE layers can be captured in a CUDA graph. The expert
    products are batched matmuls; each token's k contributions are summed
    in a fixed order (j = 0 .. k-1, as the reference's scatter-add adds
    them), so two runs give the same bits.
    """
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    dev = x.device
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    G = moe_ctx.dispatch_groups.get() if groups is None else groups
    if G < 1 or T % G != 0:
        G = 1
    Tg = T // G
    xt = x.reshape(T, d)
    probs = torch.softmax((xt @ p["router"]).float(), -1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)       # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    C = max(int(math.ceil(Tg * k / E * capacity_factor)), 4)
    flat_e = expert_ids.reshape(G, Tg * k)                    # token-major
    if valid is not None:
        vt = valid.reshape(-1).repeat_interleave(k).reshape(G, Tg * k)
        flat_e = torch.where(vt, flat_e, E)                   # no expert
    # one-hot by comparison: F.one_hot checks its range on the host
    onehot = (flat_e[..., None]
              == torch.arange(E, device=dev)).to(torch.int32)  # (G, Tg*k, E)
    pos_in_e = ((onehot.cumsum(1) - 1) * onehot).sum(2)       # (G, Tg*k)
    keep = pos_in_e < C
    if valid is not None:
        keep = keep & vt
    slot = torch.where(keep, flat_e * C + pos_in_e, E * C)
    tok_local = torch.arange(Tg, device=dev).repeat_interleave(k) \
        .expand(G, Tg * k)
    # dispatch buffer of local token ids per group; slot E * C takes the
    # dropped pairs and is cut off; token Tg is a zero row
    buf = torch.full((G, E * C + 1), Tg, dtype=torch.int64, device=dev)
    buf.scatter_(1, slot, tok_local)
    xg = torch.cat([xt.reshape(G, Tg, d),
                    torch.zeros((G, 1, d), dtype=x.dtype, device=dev)], 1)
    xe = torch.gather(xg, 1, buf[:, :E * C, None].expand(-1, -1, d)) \
        .reshape(G, E, C, d)
    act = ffn_act_fn(cfg.ffn_act)
    a = torch.einsum("gecd,edf->gecf", xe, p["w1"])
    b = torch.einsum("gecd,edf->gecf", xe, p["w3"]) if "w3" in p else None
    h = torch.einsum("gecf,efd->gecd", act(a, b), p["w2"]).reshape(
        G, E * C, d)
    # combine: each pair's contribution, weighted by its gate
    gflat = (gate_vals.reshape(G, Tg * k) * keep).to(x.dtype)
    contrib = torch.gather(h, 1, torch.where(keep, slot, 0)[..., None]
                           .expand(-1, -1, d))                # (G, Tg*k, d)
    contrib = torch.where(keep[..., None], contrib * gflat[..., None],
                          torch.zeros((), dtype=x.dtype, device=dev))
    contrib = contrib.view(G, Tg, k, d)
    y = torch.zeros((G, Tg, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + contrib[:, :, j]
    y = y.reshape(T, d)
    if "shared" in p:
        y = y + ffn_forward(cfg, p["shared"], xt)
    return y.reshape(B, S, d)
