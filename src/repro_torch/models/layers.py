"""Attention (GQA, local-window GQA and DeepSeek's MLA), encoder-decoder
cross attention, the recurrent mixers RG-LRU (RecurrentGemma) and RWKV6
time mixing, FFN and MoE layers (``repro.models.layers`` for every layer
kind). Params are plain dicts of tensors.

The recurrent mixers come in a full-sequence form (``rglru_forward``,
``rwkv_forward``), which the serve's prefill also runs, and a one-token
step (``rglru_step``, ``rwkv_step``) over a per-request state. The
full-sequence forms take an optional carried state, so a prompt fed in
several prefill calls continues where the previous call ended.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import moe_ctx
from repro_torch.models.common import (apply_rope, ffn_act_fn, gelu_tanh,
                                       rms_head_norm)

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


def causal_attention(q, k, v, *, local_window=0):
    """Full causal GQA attention. q: (B, S, Hq, D); k, v: (B, S, Hkv, D).
    ``local_window`` > 0 limits each query to the last ``local_window``
    positions, its own included (the reference's
    ``chunked_causal_attention`` mask ``kpos > qpos - local_window``).
    Returns (B, S, Hq, D)."""
    pos = torch.arange(q.shape[1], device=q.device)
    return window_attention(q, k, v, pos, pos, local_window=local_window)


def window_attention(q, k, v, qpos, kpos, *, local_window=0):
    """GQA attention of queries at positions ``qpos`` over keys at
    positions ``kpos``: a key is seen when ``kpos <= qpos`` and, with
    ``local_window`` > 0, ``kpos > qpos - local_window``; a negative key
    position is never seen. q: (B, S, Hq, D); k, v: (B, T, Hkv, D); qpos
    (S,) or (B, S), kpos (T,) or (B, T). The scores, the softmax and the
    output are fp32, cast back to q's dtype; a query that sees no key
    gives a mean of the values, as the reference's masked softmax."""
    B, S, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(B, S, hkv, g, d).float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(d)
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    mask = (kp <= qp) & (kp >= 0)
    if local_window:
        mask = mask & (kp > qp - local_window)
    if mask.dim() == 3:                                      # (B, S, T)
        mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, -1)
    o = torch.einsum("bhgst,bthd->bshgd", a, v.float())
    return o.reshape(B, S, hq, d).to(q.dtype)


def attn_forward(cfg, p, x, positions, *, local_window=None):
    """Full-sequence causal attention. x: (B, S, d). ``local_window``
    defaults to the config's (0: full causal)."""
    B, S, _ = x.shape
    q, k, v = attn_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    lw = cfg.local_window if local_window is None else local_window
    o = causal_attention(q, k, v, local_window=lw)
    return o.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"]


# ----------------------------------------------------------------------
# encoder-decoder cross attention (Whisper): unmasked, no RoPE, no bias

def cross_kv(cfg, p, memory):
    """The keys and values of ``memory`` (B, Sm, d): two (B, Sm, h_kv, d)
    tensors, what a slot's cross-attention state holds."""
    B = memory.shape[0]
    k = (memory @ p["wk"]).reshape(B, -1, cfg.num_kv_heads, cfg.head_dim)
    v = (memory @ p["wv"]).reshape(B, -1, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def cross_attend(cfg, p, x, k, v):
    """Queries of ``x`` (B, S, d) over every key of k, v (B, Sm, h_kv, d),
    through the output projection: (B, S, d). The scores, the softmax and
    the product are fp32, cast back to x's dtype."""
    B, S, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = (x @ p["wq"]).reshape(B, S, hkv, hq // hkv, dh).float()
    s = torch.einsum("bshgd,bmhd->bhgsm", qg, k.float()) / math.sqrt(dh)
    o = torch.einsum("bhgsm,bmhd->bshgd", torch.softmax(s, -1), v.float())
    return o.reshape(B, S, hq * dh).to(x.dtype) @ p["wo"]


def cross_attn_forward(cfg, p, x, memory):
    """Encoder-decoder cross attention of x (B, S, d) over memory (B, Sm,
    d); the encoder's bidirectional self-attention is the case memory =
    x."""
    return cross_attend(cfg, p, x, *cross_kv(cfg, p, memory))


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


# ----------------------------------------------------------------------
# RG-LRU block (RecurrentGemma)

_C_RGLRU = 8.0


def _rglru_gates(cfg, p, xw):
    """Per-step gates of the post-conv activations xw (..., w): the decay
    a and the gated input b of h_t = a_t h_{t-1} + b_t, both fp32. The
    gate products are block-diagonal over the config's heads, in fp32."""
    h = cfg.num_heads
    w = xw.shape[-1]
    xh = xw.reshape(*xw.shape[:-1], h, w // h).float()
    i_gate = torch.sigmoid(torch.einsum("...hb,hbc->...hc", xh,
                                        p["w_in_gate"])).reshape(xw.shape)
    r_gate = torch.sigmoid(torch.einsum("...hb,hbc->...hc", xh,
                                        p["w_rec_gate"])).reshape(xw.shape)
    log_a = -_C_RGLRU * r_gate * F.softplus(p["a_param"])
    a = torch.exp(log_a)
    gated_x = xw.float() * i_gate
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                        min=1e-12))
    return a, gated_x * multiplier


def causal_conv1d(p, x, history=None):
    """Depthwise causal conv of width cw over x (B, S, w), summed in fp32
    in tap order and cast back. ``history`` (B, cw - 1, w) holds the
    inputs before x (zeros when None, the reference's zero padding)."""
    cw = p["conv_w"].shape[0]
    B, S, w = x.shape
    if history is None:
        history = torch.zeros((B, cw - 1, w), dtype=x.dtype, device=x.device)
    xs = torch.cat([history.to(x.dtype), x], 1)
    out = torch.zeros((B, S, w), dtype=torch.float32, device=x.device)
    for i in range(cw):
        out = out + xs[:, i:i + S].float() * p["conv_w"][i]
    return (out + p["conv_b"]).to(x.dtype)


def linear_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t along dim 1, from h_{-1} = ``h0`` (zero
    when None), as a log-depth scan: Hillis-Steele doubling, log2 S steps,
    each combining element t with element t - 2^k by the reference's
    associative operator (a_l a_r, b_l a_r + b_r). Returns every h_t."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    S = a.shape[1]
    off = 1
    while off < S:
        a_prev = torch.cat([torch.ones_like(a[:, :off]), a[:, :-off]], 1)
        b_prev = torch.cat([torch.zeros_like(b[:, :off]), b[:, :-off]], 1)
        b = b_prev * a + b
        a = a_prev * a
        off *= 2
    return b


def rglru_forward(cfg, p, x, *, state=None, valid=None, return_state=False):
    """Full-sequence RG-LRU block. x: (B, S, d) -> (B, S, d).

    ``state`` {"h": (B, w) fp32, "conv": (B, cw - 1, w)} is the carried
    recurrence and conv history (zero when None). ``valid`` (B, S) masks
    padding, a prefix of each row: a padded step feeds a zero to the conv
    and leaves h as it is (a = 1, b = 0). With ``return_state``, returns
    (out, new state), the state at each row's last valid step."""
    xw = x @ p["wx"]
    if valid is not None:
        xw = torch.where(valid[..., None], xw, torch.zeros_like(xw))
    hist = None if state is None else state["conv"]
    xc = causal_conv1d(p, xw, hist)
    a, b = _rglru_gates(cfg, p, xc)
    if valid is not None:
        a = torch.where(valid[..., None], a, torch.ones_like(a))
        b = torch.where(valid[..., None], b, torch.zeros_like(b))
    hs = linear_scan(a, b, None if state is None else state["h"])
    gate = gelu_tanh((x @ p["wy_gate"]).float())
    out = (hs * gate).to(x.dtype) @ p["wo"]
    if not return_state:
        return out
    B, S, w = xw.shape
    cw = p["conv_w"].shape[0]
    n = (valid.sum(1) if valid is not None
         else torch.full((B,), S, device=x.device)).long()
    rows = torch.arange(B, device=x.device)
    h_last = hs[rows, (n - 1).clamp(min=0)]
    if state is not None:
        h_last = torch.where((n > 0)[:, None], h_last, state["h"])
    if hist is None:
        hist = torch.zeros((B, cw - 1, w), dtype=xw.dtype, device=x.device)
    # the last cw - 1 conv inputs up to each row's last valid step
    xs = torch.cat([hist.to(xw.dtype), xw], 1)
    idx = n[:, None] + torch.arange(cw - 1, device=x.device)[None]
    conv = xs[rows[:, None], idx]
    return out, {"h": h_last, "conv": conv}


def rglru_step(cfg, p, x, state):
    """Single-token step. x: (B, d); state: {"h": (B, w) fp32, "conv":
    (B, cw - 1, w)}. Returns (out (B, d), new state)."""
    xw = x @ p["wx"]
    xc = causal_conv1d(p, xw[:, None], state["conv"])[:, 0]
    a, b = _rglru_gates(cfg, p, xc)
    h = a * state["h"] + b
    gate = gelu_tanh((x @ p["wy_gate"]).float())
    out = (h * gate).to(x.dtype) @ p["wo"]
    conv = torch.cat([state["conv"].to(xw.dtype), xw[:, None]], 1)[:, 1:]
    return out, {"h": h, "conv": conv}


def rglru_init_state(cfg, B, dtype, device=None):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((B, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.conv1d_width - 1, w), dtype=dtype,
                                device=device)}


# ----------------------------------------------------------------------
# RWKV-6 (Finch) time mixing: data-dependent decay

def _rwkv_proj(cfg, p, x, x_prev):
    """Token-shift lerp and projections. x: (..., d); x_prev the same
    shape. Returns r, k, v, g at x's dtype and logw (the log decay) in
    fp32."""
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = [x + (x_prev - x) * mu[i] for i in range(5)]
    r = xr @ p["w_r"]
    k = xk @ p["w_k"]
    v = xv @ p["w_v"]
    g = xg @ p["w_g"]
    lora = torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(torch.clamp(p["w0"] + lora, -20.0, 2.0))
    return r, k, v, g, logw


def _rwkv_out(cfg, p, y, g):
    """Per-head group norm (eps 64e-5), the SiLU gate and the output
    projection. y: (B, S, h, K) fp32; g: (B, S, d)."""
    B, S = y.shape[:2]
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, S, -1) * p["ln_x_scale"] + p["ln_x_bias"]
    y = y * F.silu(g.float())
    return y.to(g.dtype) @ p["w_o"]


def _rwkv_inputs(cfg, p, x, shift, valid):
    """r, k, v (B, S, h, K) fp32, w-log (B, S, h, K), g, with the token
    shift from ``shift`` (B, d) before the first token (zero when None),
    and padding masked (w = 1, k = 0)."""
    B, S, d = x.shape
    h, K = cfg.num_heads, cfg.head_dim
    first = (torch.zeros_like(x[:, :1]) if shift is None
             else shift[:, None].to(x.dtype))
    x_prev = torch.cat([first, x[:, :-1]], 1)
    r, k, v, g, logw = _rwkv_proj(cfg, p, x, x_prev)
    if valid is not None:
        logw = torch.where(valid[..., None], logw, torch.zeros_like(logw))
        k = torch.where(valid[..., None], k, torch.zeros_like(k))

    def heads(t):
        return t.reshape(B, S, h, K)
    return heads(r), heads(k), heads(v), heads(logw), g


def _rwkv_scan(p, r, k, v, logw, S0):
    """The O(S) token scan: y_t = r_t (S + u k_t v_t^T), S' = w_t S +
    k_t v_t^T. Returns (y (B, S, h, K) fp32, final state)."""
    u = p["u"][None, :, :, None]
    Sst = S0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t].float()[..., None] * v[:, t].float()[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               Sst + u * kv))
        Sst = torch.exp(logw[:, t])[..., None] * Sst + kv
    return torch.stack(ys, 1), Sst


def _rwkv_chunks(p, r, k, v, logw, S0, chunk):
    """The chunked matmul form of the scan, chunk by chunk; within a chunk
    every decay factor is the exp of a non-positive sum."""
    B, S, h, K = r.shape
    u = p["u"]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), -1)
    Sst = S0
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc = (t[:, c0:c0 + chunk].float() for t in (r, k, v))
        lwc = logw[:, c0:c0 + chunk]
        Lc = torch.cumsum(lwc, 1)                 # inclusive log P_t
        Lprev = Lc - lwc                          # log P_{t-1}
        y = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(Lprev), Sst)
        dec = torch.exp(torch.clamp(Lprev[:, :, None] - Lc[:, None, :],
                                    max=0.0))     # (B, t, s, h, K)
        A = (rc[:, :, None] * kc[:, None, :] * dec).sum(-1)   # (B, t, s, h)
        A = A.permute(0, 3, 1, 2) * tri
        y = y + torch.einsum("bhts,bshv->bthv", A, vc)
        y = y + (rc * u[None, None] * kc).sum(-1, keepdim=True) * vc
        Lend = Lc[:, -1:]                         # (B, 1, h, K)
        kdec = kc * torch.exp(Lend - Lc)
        Sst = torch.exp(Lend[:, 0])[..., None] * Sst + \
            torch.einsum("bshk,bshv->bhkv", kdec, vc)
        ys.append(y)
    return torch.cat(ys, 1), Sst


def rwkv_forward_naive(cfg, p, x):
    """The O(S) scan from a zero state: the oracle for the chunked form.
    x: (B, S, d)."""
    r, k, v, logw, g = _rwkv_inputs(cfg, p, x, None, None)
    S0 = torch.zeros(r.shape[:1] + r.shape[2:] + r.shape[-1:],
                     dtype=torch.float32, device=x.device)
    y, _ = _rwkv_scan(p, r, k, v, logw, S0)
    return _rwkv_out(cfg, p, y, g)


def rwkv_forward(cfg, p, x, *, chunk=32, valid=None, state=None,
                 return_state=False):
    """WKV6 over x (B, S, d): the chunked matmul form when ``chunk``
    divides S, else the token scan (the reference falls back the same
    way; ``chunk=1`` asks for the scan). ``valid`` (B, S) masks padding
    (w = 1, k = 0, so the final state is the one at the last valid
    token). ``state`` {"S": (B, h, K, K) fp32, "shift": (B, d)} is the
    carried WKV state and the token before x (zero when None). With
    ``return_state``, returns (out, final S)."""
    B, S, d = x.shape
    h, K = cfg.num_heads, cfg.head_dim
    r, k, v, logw, g = _rwkv_inputs(cfg, p, x,
                                    None if state is None else state["shift"],
                                    valid)
    S0 = (torch.zeros((B, h, K, K), dtype=torch.float32, device=x.device)
          if state is None else state["S"])
    if chunk > 1 and S % chunk == 0:
        y, S_fin = _rwkv_chunks(p, r, k, v, logw, S0, chunk)
    else:
        y, S_fin = _rwkv_scan(p, r, k, v, logw, S0)
    out = _rwkv_out(cfg, p, y, g)
    return (out, S_fin) if return_state else out


def rwkv_step(cfg, p, x, state):
    """Single-token step. x: (B, d); state {"S": (B, h, K, K) fp32,
    "shift": (B, d)}. Returns (out (B, d), new state)."""
    B, d = x.shape
    h, K = cfg.num_heads, cfg.head_dim
    r, k, v, g, logw = _rwkv_proj(cfg, p, x, state["shift"].to(x.dtype))
    rh = r.reshape(B, h, K).float()
    kh = k.reshape(B, h, K).float()
    vh = v.reshape(B, h, K).float()
    wh = torch.exp(logw.reshape(B, h, K))
    kv = kh[..., None] * vh[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rh,
                     state["S"] + p["u"][None, :, :, None] * kv)
    S_new = wh[..., None] * state["S"] + kv
    out = _rwkv_out(cfg, p, y[:, None], g[:, None])[:, 0]
    return out, {"S": S_new, "shift": x}


def rwkv_init_state(cfg, B, dtype, device=None):
    h, K = cfg.num_heads, cfg.head_dim
    return {"S": torch.zeros((B, h, K, K), dtype=torch.float32,
                             device=device),
            "shift": torch.zeros((B, cfg.d_model), dtype=dtype,
                                 device=device)}


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
