"""Shared model primitives: norms, activations, RoPE.

Plain functions on tensors, with the same math and layouts as the JAX
package's ``repro.models.common``: norms and RoPE compute in fp32 and cast
back to the input dtype, and RoPE rotates the two halves of the head
dimension (the half-split layout, not interleaved pairs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------------
# norms

def apply_norm(cfg, p, x, eps=1e-6):
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        xf = xf * p["scale"]
    else:  # layernorm / nonparam_ln
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if p:
            xf = xf * p["scale"] + p["bias"]
    return xf.to(x.dtype)


def rms_head_norm(scale, x, eps=1e-6):
    """Per-head q/k norm (Qwen3-style); x: (..., d_head)."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


# ----------------------------------------------------------------------
# activations

def gelu_tanh(x):
    """``jax.nn.gelu``: its default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def ffn_act_fn(name):
    if name == "silu_glu":
        return lambda a, b: F.silu(a) * b
    if name == "gelu_glu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda a, b: F.gelu(a, approximate="tanh") * b
    if name == "sq_relu":
        return lambda a, _b: F.relu(a).square()
    if name == "gelu":
        return lambda a, _b: F.gelu(a, approximate="tanh")
    raise ValueError(name)


def is_gated(name):
    return name.endswith("_glu")


# ----------------------------------------------------------------------
# RoPE

def rope_freqs(head_dim, theta, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    # torch.full, not torch.tensor: no host-to-device copy, which a CUDA
    # graph capture of the decode step would refuse
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exponent)


def apply_rope(x, positions, theta):
    """x: (..., S, H, D) or (..., H, D) with positions broadcastable to
    (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    ang = positions[..., None].float() * freqs               # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                       # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)
