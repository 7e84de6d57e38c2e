"""Generic dense GQA LM built from an ArchConfig (``repro.models.lm``).

The JAX package stacks identical layers into scanned units; the port keeps
a plain list of per-layer dicts, since PyTorch runs the layers eagerly:

    {"embed": (V, d), "final_norm": norm, "unembed": (d, V),
     "layers": [{"ln1": norm, "ln2": norm, "attn": {"wq", "wk", "wv", "wo",
                 ["q_norm", "k_norm"], ["bq", "bk", "bv"]},
                 "ffn": {"w1", "w2", ["w3"]}}, ...]}

where a norm is {"scale": (d,)} (rmsnorm), {"scale", "bias": (d,)}
(layernorm) or {} (nonparam_ln), as ``repro.models.common.init_norm``.

``repro_torch.convert.params_from_numpy`` maps the JAX package's stacked
tree onto this layout. Only the dense GQA family is ported so far;
``check_supported`` names what is not.

Dtypes (``cfg.dtype``, float32 or bfloat16): the JAX package keeps fp32
parameters and casts the matrices, qkv biases and embeddings to the
compute dtype at each use; the port stores those at the dtype once, which
gives the same values (``cast_params``). Norm scales and biases, and the
q/k norm scales, stay fp32 in both, and norms compute in fp32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.common import apply_norm, is_gated

#: compute dtypes the port serves (``cfg.dtype``, ``EngineOptions.dtype``)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: parameters that stay fp32 whatever the dtype: the norms' scales and biases
NORM_KEYS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


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
    if cfg.attn_type != "gqa":
        unported.append(f"attn_type={cfg.attn_type!r}")
    if any(spec != ("attn", "dense") for spec in layer_specs(cfg)):
        unported.append("non-attention mixers or MoE layers")
    if cfg.local_window:
        unported.append("local_window attention")
    if cfg.is_enc_dec:
        unported.append("encoder-decoder")
    if cfg.frontend != "none" or cfg.num_prefix_embeds:
        unported.append(f"frontend={cfg.frontend!r}")
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


def _init_layer(cfg, generator, device):
    d, hq, hkv, dh, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    dt = torch_dtype(cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    def dense(shape, fan_in):
        return _dense(shape, fan_in, generator, device, dt)

    attn = {"wq": dense((d, hq * dh), d),
            "wk": dense((d, hkv * dh), d),
            "wv": dense((d, hkv * dh), d),
            "wo": dense((hq * dh, d), hq * dh)}
    if cfg.qkv_bias:
        for name, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            attn[name] = torch.zeros(n, dtype=dt, device=device)
    if cfg.qk_norm:
        attn["q_norm"] = ones(dh)
        attn["k_norm"] = ones(dh)
    ffn = {"w1": dense((d, f), d), "w2": dense((f, d), f)}
    if is_gated(cfg.ffn_act):
        ffn["w3"] = dense((d, f), d)
    return {"ln1": _init_norm(cfg, d, device),
            "ln2": _init_norm(cfg, d, device), "attn": attn, "ffn": ffn}


def init(cfg: ArchConfig, generator: torch.Generator, device) -> dict:
    """Random parameters in the port's layout, drawn from ``generator``
    directly on ``device`` (the same scales as the JAX package's
    ``dense_init``: std 1/sqrt(fan_in), unit norm scales, zero norm
    biases), at ``cfg.dtype`` apart from the fp32 norms: the same draws at
    any dtype. The two packages' generators differ, so tests carry weights
    across with ``convert.params_from_numpy`` instead."""
    check_supported(cfg)
    dt = torch_dtype(cfg.dtype)
    params = {"embed": _dense((cfg.vocab_size, cfg.d_model), cfg.d_model,
                              generator, device, dt),
              "final_norm": _init_norm(cfg, cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = _dense((cfg.d_model, cfg.vocab_size),
                                   cfg.d_model, generator, device, dt)
    params["layers"] = [_init_layer(cfg, generator, device)
                        for _ in range(cfg.num_layers)]
    return params


def cast_params(params, dtype) -> dict:
    """A copy of ``params`` with every matrix, qkv bias and embedding at
    ``dtype`` and the norms' parameters left fp32 (the JAX package's casts
    at use, done once). Leaves already at their dtype are shared, not
    copied."""
    def walk(t, key=None):
        if key in NORM_KEYS:
            return t
        if isinstance(t, torch.Tensor):
            return t.to(dtype)
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return [walk(v) for v in t]
    return walk(params)


def check_params_dtype(cfg, params) -> None:
    """Raise unless the matrices of ``params`` are at ``cfg.dtype`` (the
    port stores them at the compute dtype; ``cast_params`` converts)."""
    want = torch_dtype(cfg.dtype)
    got = params["embed"].dtype
    if got != want:
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

def apply_layer(cfg, p, x, positions):
    h = apply_norm(cfg, p["ln1"], x)
    x = x + L.attn_forward(cfg, p["attn"], h, positions)
    h2 = apply_norm(cfg, p["ln2"], x)
    return x + L.ffn_forward(cfg, p["ffn"], h2)


def forward_hidden(cfg: ArchConfig, params, tokens, *, positions=None):
    """Token ids (B, S) -> final hidden states (B, S, d) at ``cfg.dtype``,
    as the JAX package's: the residual stream, matrices and products at
    the dtype, norms, RoPE and attention in fp32, cast back."""
    check_supported(cfg)
    check_params_dtype(cfg, params)
    x = params["embed"][tokens]
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    for p in params["layers"]:
        x = apply_layer(cfg, p, x, positions)
    return apply_norm(cfg, params["final_norm"], x)


def unembed_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def forward(cfg, params, tokens, **kw):
    h = forward_hidden(cfg, params, tokens, **kw)
    return h @ unembed_matrix(cfg, params)
