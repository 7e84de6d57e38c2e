"""Generic LM built from an ArchConfig (``repro.models.lm``).

The JAX package stacks identical layers into scanned units; the port keeps
a plain list of per-layer dicts, since PyTorch runs the layers eagerly:

    {"embed": (V, d), "final_norm": norm, "unembed": (d, V),
     "layers": [{"ln1": norm, "ln2": norm,
                 "attn": attn or "rglru": rglru or "rwkv": rwkv,
                 "ffn": {"w1", "w2", ["w3"]} or "moe": moe,
                 ["ln_x": norm, "cross": cross]}, ...],
     ["encoder": {"layers": [{"ln1", "ln2", "attn", "ffn"}, ...],
                  "final_norm": norm}]}

where attn is {"wq", "wk", "wv", "wo", ["q_norm", "k_norm"], ["bq", "bk",
"bv"]} (GQA, local-window GQA) or {"wq", "w_dkv", "kv_norm", "w_uk",
"w_uv", "wo"} (MLA), rglru is {"wx", "wy_gate", "conv_w": (cw, w),
"conv_b", "w_in_gate", "w_rec_gate": (h, w/h, w/h), "a_param": (w,),
"wo"} and rwkv is {"mu": (5, d), "w_r", "w_k", "w_v", "w_g", "w_o",
"w0": (d,), "w_lora_a": (d, 64), "w_lora_b": (64, d), "u": (h, K),
"ln_x_scale", "ln_x_bias": (d,)} (the layer kind is the mixer's key),
moe is {"router": (d, E), "w1", "w3": (E, d, f), "w2": (E, f, d),
["shared": ffn]} (the layers at or past ``first_dense_layers`` of a MoE
config), cross is {"wq", "wk", "wv", "wo"} (no bias: an encoder-decoder
config's decoder layers, with the ``encoder`` tree of ``encoder_layers``
attention layers), and a norm is {"scale": (d,)} (rmsnorm), {"scale",
"bias": (d,)} (layernorm) or {} (nonparam_ln), as
``repro.models.common.init_norm``.

``repro_torch.convert.params_from_numpy`` maps the JAX package's stacked
tree onto this layout. Attention layers (GQA, local-window GQA or MLA),
RG-LRU and RWKV6 layers with dense or MoE FFNs, the encoder-decoder
backbone (Whisper: ``encode`` over frame embeddings, cross attention in
every decoder layer) and the prefix embeddings of a vision frontend
(InternVL2) are ported; ``check_supported`` names what is not
(local-window MLA, dtypes other than fp32, bf16 and fp16). The frontends
themselves are stubs in both packages: the forward takes their
embeddings.

Dtypes (``cfg.dtype``, float32, bfloat16 or float16): the JAX package
keeps fp32 parameters and casts the matrices, qkv biases, router, experts and
embeddings to the compute dtype at each use. The port serves from params
stored at the dtype once, which gives the same values (``cast_params``);
training keeps fp32 master params, as the JAX package does, and the
forward casts them at each use, so its gradients and updates are fp32.
Norm scales and biases, the q/k norm scales, MLA's ``kv_norm`` and the
parameters the reference uses uncast (RG-LRU's conv taps and bias, gate
blocks and ``a_param``; RWKV's decay base and LoRA, bonus ``u`` and group
norm) stay fp32 in both (``FP32_KEYS``), and norms compute in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.common import apply_norm, is_gated

#: compute dtypes the port serves (``cfg.dtype``, ``EngineOptions.dtype``)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
#: parameters that stay fp32 whatever the dtype: the norms' scales and
#: biases, and what the reference's recurrent mixers use without a cast
FP32_KEYS = ("ln1", "ln2", "ln_x", "final_norm", "q_norm", "k_norm",
             "kv_norm", "conv_w", "conv_b", "w_in_gate", "w_rec_gate",
             "a_param", "w0", "w_lora_a", "w_lora_b", "u", "ln_x_scale",
             "ln_x_bias")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a compute dtype the port serves."""
    if name not in DTYPES:
        raise NotImplementedError(
            f"dtype={name!r} is not ported to repro_torch yet (it serves "
            f"{', '.join(DTYPES)})")
    return DTYPES[name]


# ----------------------------------------------------------------------
# layer plan

def layer_specs(cfg: ArchConfig):
    """Per-layer (mixer_kind, ffn_kind)."""
    kinds = cfg.layer_kinds()
    specs = []
    for i, kind in enumerate(kinds):
        if cfg.num_experts > 0 and i >= cfg.first_dense_layers:
            specs.append((kind, "moe"))
        else:
            specs.append((kind, "dense"))
    return specs


def build_plan(cfg: ArchConfig):
    """Split layers into head (unrolled), main (stacked units), tail
    (unrolled) — the JAX package's parameter-tree layout."""
    specs = layer_specs(cfg)
    p = len(cfg.block_pattern)
    head = specs[:cfg.first_dense_layers]
    rest = specs[cfg.first_dense_layers:]
    n_units = len(rest) // p
    main_units = [rest[i * p:(i + 1) * p] for i in range(n_units)]
    tail = rest[n_units * p:]
    if main_units and any(u != main_units[0] for u in main_units):
        return {"head": specs, "unit": [], "n_units": 0, "tail": []}
    return {"head": head, "unit": main_units[0] if main_units else [],
            "n_units": n_units, "tail": tail}


def check_supported(cfg: ArchConfig) -> None:
    """Raise for any architecture feature the port has not ported yet."""
    unported = []
    if cfg.num_attn_layers and cfg.attn_type not in ("gqa", "mla"):
        unported.append(f"attn_type={cfg.attn_type!r}")
    kinds = set(cfg.layer_kinds()) - {"attn", "rglru", "rwkv"}
    if kinds:
        unported.append(f"mixers {sorted(kinds)}")
    if cfg.local_window and cfg.attn_type == "mla":
        unported.append("local_window MLA")
    if cfg.dtype not in DTYPES:
        unported.append(f"dtype={cfg.dtype!r}")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: "
            + ", ".join(unported))


# ----------------------------------------------------------------------
# init

def _dense(shape, fan_in, generator, device, dtype=torch.float32):
    """Drawn in fp32 and cast at once, so a bf16 model never holds its
    fp32 tree and equals the fp32 one of the same seed, rounded."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def _init_norm(cfg, d, device):
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device),
                "bias": torch.zeros(d, dtype=torch.float32, device=device)}
    if cfg.norm_type == "nonparam_ln":       # OLMo: no affine parameters
        return {}
    raise ValueError(cfg.norm_type)


def _init_rglru(cfg, dense, dense32, device):
    d, w, h = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.num_heads
    wb, cw = w // h, cfg.conv1d_width
    # constant-time-scale init: a in (0.9, 0.999), a_param = softplus^-1
    # of -log a
    a = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=device)
    return {"wx": dense((d, w), d),
            "wy_gate": dense((d, w), d),              # output gate branch
            "conv_w": dense32((cw, w), cw),
            "conv_b": torch.zeros(w, dtype=torch.float32, device=device),
            "w_in_gate": dense32((h, wb, wb), wb),
            "w_rec_gate": dense32((h, wb, wb), wb),
            "a_param": torch.log(torch.expm1(-torch.log(a))),
            "wo": dense((w, d), w)}


def _init_rwkv(cfg, dense, dense32, device, dt):
    d, h, K = cfg.d_model, cfg.num_heads, cfg.head_dim
    lora = 64                                         # decay LoRA rank

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=device)
    return {"mu": full((5, d), 0.5, dt),    # token-shift mix of r, k, v, g, w
            "w_r": dense((d, d), d), "w_k": dense((d, d), d),
            "w_v": dense((d, d), d), "w_g": dense((d, d), d),
            "w0": full((d,), -6.0),           # base decay, w ~ exp(-exp(w0))
            "w_lora_a": dense32((d, lora), d),
            "w_lora_b": dense32((lora, d), lora).mul_(0.1),
            "u": dense32((h, K), h),          # bonus for the current token
            "ln_x_scale": full((d,), 1.0), "ln_x_bias": full((d,), 0.0),
            "w_o": dense((d, d), d)}


def _init_layer(cfg, kind, generator, device, dt, ffn_kind="dense",
                with_cross=False):
    d, hq, hkv, dh, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    def dense(shape, fan_in):
        return _dense(shape, fan_in, generator, device, dt)

    def dense32(shape, fan_in):
        return _dense(shape, fan_in, generator, device)

    def ffn(width, lead=()):
        e = tuple(lead)
        out = {"w1": dense(e + (d, width), d), "w2": dense(e + (width, d),
                                                           width)}
        if is_gated(cfg.ffn_act):
            out["w3"] = dense(e + (d, width), d)
        return out

    def gqa(cross=False):
        attn = {"wq": dense((d, hq * dh), d),
                "wk": dense((d, hkv * dh), d),
                "wv": dense((d, hkv * dh), d),
                "wo": dense((hq * dh, d), hq * dh)}
        if cfg.qkv_bias and not cross:
            for name, n in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
                attn[name] = torch.zeros(n, dtype=dt, device=device)
        if cfg.qk_norm:
            attn["q_norm"] = ones(dh)
            attn["k_norm"] = ones(dh)
        return attn

    if kind == "rglru":
        mixer = _init_rglru(cfg, dense, dense32, device)
    elif kind == "rwkv":
        mixer = _init_rwkv(cfg, dense, dense32, device, dt)
    elif cfg.attn_type == "mla":
        r, dr, dv = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.v_head_dim
        attn = {"wq": dense((d, hq * (dh + dr)), d),
                "w_dkv": dense((d, r + dr), d),   # down: latent + rope key
                "kv_norm": ones(r),
                "w_uk": dense((r, hq * dh), r),   # latent -> per-head keys
                "w_uv": dense((r, hq * dv), r),
                "wo": dense((hq * dv, d), hq * dv)}
    else:
        attn = gqa()
    if kind == "attn":
        mixer = attn
    layer = {"ln1": _init_norm(cfg, d, device),
             "ln2": _init_norm(cfg, d, device), kind: mixer}
    if ffn_kind == "moe":
        moe = {"router": dense((d, cfg.num_experts), d),
               **ffn(cfg.moe_d_ff, (cfg.num_experts,))}
        if cfg.num_shared_experts:
            moe["shared"] = ffn(cfg.moe_d_ff * cfg.num_shared_experts)
        layer["moe"] = moe
    else:
        layer["ffn"] = ffn(f)
    if with_cross:
        layer["ln_x"] = _init_norm(cfg, d, device)
        layer["cross"] = gqa(cross=True)
    return layer


def init(cfg: ArchConfig, generator: torch.Generator, device, *,
         dtype=None) -> dict:
    """Random parameters in the port's layout, drawn from ``generator``
    directly on ``device`` (the same scales as the JAX package's
    ``dense_init``: std 1/sqrt(fan_in), unit norm scales, zero norm
    biases), at ``dtype`` (by default ``cfg.dtype``; training asks for
    fp32 masters) apart from the fp32 norms: the same draws at any dtype.
    The two packages' generators differ, so tests carry weights across
    with ``convert.params_from_numpy`` instead."""
    check_supported(cfg)
    dt = torch_dtype(cfg.dtype) if dtype is None else dtype
    params = {"embed": _dense((cfg.vocab_size, cfg.d_model), cfg.d_model,
                              generator, device, dt),
              "final_norm": _init_norm(cfg, cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = _dense((cfg.d_model, cfg.vocab_size),
                                   cfg.d_model, generator, device, dt)
    params["layers"] = [_init_layer(cfg, kind, generator, device, dt,
                                    ffn_kind, with_cross=cfg.is_enc_dec)
                        for kind, ffn_kind in layer_specs(cfg)]
    if cfg.is_enc_dec:
        params["encoder"] = {
            "layers": [_init_layer(cfg, "attn", generator, device, dt)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": _init_norm(cfg, cfg.d_model, device)}
    return params


def cast_params(params, dtype) -> dict:
    """A copy of ``params`` with every matrix, qkv bias and embedding at
    ``dtype`` and the ``FP32_KEYS`` left fp32 (the JAX package's casts at
    use, done once). Leaves already at their dtype are shared, not
    copied."""
    def walk(t, key=None):
        if key in FP32_KEYS:
            return t
        if isinstance(t, torch.Tensor):
            return t.to(dtype)
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return [walk(v) for v in t]
    return walk(params)


def check_params_dtype(cfg, params) -> None:
    """Raise unless the matrices of ``params`` are at ``cfg.dtype`` (the
    port serves them at the compute dtype; ``cast_params`` converts) or
    are fp32 masters, which the forward casts at each use (training)."""
    want = torch_dtype(cfg.dtype)
    got = params["embed"].dtype
    if got not in (want, torch.float32):
        raise ValueError(f"{cfg.name}: params are {got}, the model computes "
                         f"in {want}; convert them with lm.cast_params")


def param_count(params) -> int:
    def walk(t):
        if isinstance(t, torch.Tensor):
            return t.numel()
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        return sum(walk(v) for v in t)
    return walk(params)


# ----------------------------------------------------------------------
# forward (full sequence; serving runs through repro_torch.core)

def mixer_kind(p) -> str:
    """The mixer of a layer's params: "attn", "rglru" or "rwkv"."""
    return next(k for k in ("attn", "rglru", "rwkv") if k in p)


def apply_layer(cfg, p, x, positions, memory=None):
    """One decoder layer; ``memory`` is the encoder's output (B, Sm, d),
    which the layer's cross attention reads after its mixer (an
    encoder-decoder config), or None."""
    h = apply_norm(cfg, p["ln1"], x)
    kind = mixer_kind(p)
    if kind == "rglru":
        x = x + L.rglru_forward(cfg, p["rglru"], h)
    elif kind == "rwkv":
        x = x + L.rwkv_forward(cfg, p["rwkv"], h)
    elif cfg.attn_type == "mla":
        x = x + L.mla_forward(cfg, p["attn"], h, positions)
    else:
        x = x + L.attn_forward(cfg, p["attn"], h, positions)
    if memory is not None and "cross" in p:
        x = x + L.cross_attn_forward(cfg, p["cross"],
                                     apply_norm(cfg, p["ln_x"], x), memory)
    h2 = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        return x + L.moe_forward(cfg, p["moe"], h2)
    return x + L.ffn_forward(cfg, p["ffn"], h2)


def _cast_apply_layer(cfg, p, x, positions, memory=None):
    """``apply_layer`` on the layer's params cast to the compute dtype
    (no copy where they are at it already), as the reference's
    ``astype`` at each use: inside a checkpointed layer the cast copy
    lives only while the layer runs."""
    return apply_layer(cfg, cast_params(p, torch_dtype(cfg.dtype)), x,
                       positions, memory)


def _encoder_layer(cfg, p, x):
    p = cast_params(p, torch_dtype(cfg.dtype))
    h = apply_norm(cfg, p["ln1"], x)
    x = x + L.cross_attn_forward(cfg, p["attn"], h, h)   # unmasked self
    return x + L.ffn_forward(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x))


def encode(cfg: ArchConfig, params, frame_embeds, *, remat=False):
    """The Whisper encoder: bidirectional self-attention over frame
    embeddings (B, Sm, d), cast to ``cfg.dtype``, then its final norm.
    ``remat=True`` checkpoints each layer, as ``forward_hidden``."""
    x = frame_embeds.to(torch_dtype(cfg.dtype))
    enc = params["encoder"]
    for p in enc["layers"]:
        if remat:
            x = checkpoint(_encoder_layer, cfg, p, x, use_reentrant=False)
        else:
            x = _encoder_layer(cfg, p, x)
    return apply_norm(cfg, enc["final_norm"], x)


def forward_hidden(cfg: ArchConfig, params, tokens, *, positions=None,
                   prefix_embeds=None, frame_embeds=None, remat=False):
    """Token ids (B, S) -> final hidden states (B, P + S, d) at
    ``cfg.dtype``, as the JAX package's: the residual stream, matrices and
    products at the dtype, norms, RoPE and attention in fp32, cast back.
    ``params`` are at the dtype or fp32 masters, cast at each use.

    ``prefix_embeds`` (B, P, d), a vision frontend's patch embeddings,
    go before the tokens' embeddings (P = 0 without them). An
    encoder-decoder config needs ``frame_embeds`` (B, Sm, d): the encoder
    runs over them, and each decoder layer attends its output.

    ``remat=True`` checkpoints each layer: its activations are recomputed
    in the backward pass instead of kept (the reference's ``remat``, which
    ``lm_loss`` turns on). It changes no value."""
    check_supported(cfg)
    check_params_dtype(cfg, params)
    dt = torch_dtype(cfg.dtype)
    # the gather of params["embed"].astype(dt)[tokens], whose backward
    # sums each row's gradients in a fixed order (indexing's accumulates
    # in any)
    x = F.embedding(tokens, params["embed"].to(dt))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], 1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    memory = None
    if cfg.is_enc_dec:
        if frame_embeds is None:
            raise ValueError("enc-dec arch requires frame_embeds")
        memory = encode(cfg, params, frame_embeds, remat=remat)
    for p in params["layers"]:
        if remat:
            x = checkpoint(_cast_apply_layer, cfg, p, x, positions, memory,
                           use_reentrant=False)
        else:
            x = _cast_apply_layer(cfg, p, x, positions, memory)
    return apply_norm(cfg, params["final_norm"], x)


def unembed_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def forward(cfg, params, tokens, **kw):
    h = forward_hidden(cfg, params, tokens, **kw)
    return h @ unembed_matrix(cfg, params).to(h.dtype)


# ----------------------------------------------------------------------
# chunked-vocab cross-entropy: never materializes (B, S, V) logits.

def _xent_chunk(hc, lc, w, ignore_id):
    logits = (hc @ w.to(hc.dtype)).float()
    lse = torch.logsumexp(logits, -1)
    tgt = torch.gather(logits, -1, torch.clamp(lc, min=0)[..., None])[..., 0]
    valid = lc != ignore_id
    return torch.where(valid, lse - tgt, 0.0).sum(), valid.sum()


def chunked_xent(cfg, params, hidden, labels, *, chunk=256, ignore_id=-100):
    """hidden: (B, S, d); labels: (B, S). Returns (sum_loss, n_tokens), an
    fp32 and an int64 0-d tensor. The sequence goes in chunks of ``chunk``
    positions; each chunk's (B, chunk, V) logits are recomputed in the
    backward pass rather than kept, as the reference's ``jax.checkpoint``
    does."""
    w = unembed_matrix(cfg, params)
    labels = labels.long()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for s in range(0, hidden.shape[1], chunk):
        part, cnt = checkpoint(_xent_chunk, hidden[:, s:s + chunk],
                               labels[:, s:s + chunk], w, ignore_id,
                               use_reentrant=False)
        loss_sum = loss_sum + part
        n = n + cnt
    return loss_sum, n


def lm_loss(cfg, params, batch, *, vocab_chunk=256):
    """batch: {"tokens": (B, S), "labels": (B, S)}, with a frontend's
    ``prefix_embeds`` (B, P, d) or ``frame_embeds`` (B, Sm, d); the mean
    loss over the labels that are not ``-100``, at the text positions
    only."""
    hidden = forward_hidden(cfg, params, batch["tokens"].long(),
                            prefix_embeds=batch.get("prefix_embeds"),
                            frame_embeds=batch.get("frame_embeds"),
                            remat=True)
    if "prefix_embeds" in batch:
        hidden = hidden[:, batch["prefix_embeds"].shape[1]:]
    loss_sum, n = chunked_xent(cfg, params, hidden, batch["labels"],
                               chunk=vocab_chunk)
    return loss_sum / torch.clamp(n, min=1)
