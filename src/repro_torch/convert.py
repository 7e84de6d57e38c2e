"""Carry the JAX package's parameters into the port's layout.

``repro.models.lm.init`` returns a pytree whose identical layers are
stacked into scanned units (``head`` / ``main`` / ``tail``, the layout
``repro.core.serve_model`` walks). Given that tree as numpy arrays (any
nesting of dicts and lists), ``params_from_numpy`` returns the port's
per-layer dict (``repro_torch.models.lm``), so both packages compute on
the same weights: at bfloat16 the port's matrices hold the values the
JAX package casts its fp32 ones to at each use. MLA's projections
(``wq``, ``w_dkv``, ``w_uk``, ``w_uv``, ``wo``) and a MoE layer's router,
experts (``w1``/``w2``/``w3``, stacked (E, d, f)) and shared experts are
carried as matrices; MLA's ``kv_norm`` stays fp32, as the norms do, and
so do the recurrent mixers' parameters that the JAX package uses uncast
(``lm.FP32_KEYS``). RecurrentGemma's 26 layers come as 8 stacked
(rglru, rglru, attn) units and a (rglru, rglru) tail, in layer order.
An encoder-decoder config (Whisper) carries its ``encoder`` tree, whose
layers are one stacked unit ``"0"`` with a leading ``encoder_layers``
axis, and each decoder layer's cross attention (``cross``, its norm
``ln_x`` in fp32). A prefix-embedding config (InternVL2) has no
parameters of its frontend: the forward takes its embeddings.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm


def _tensor(a, device, dtype):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, dtype)


def _layer_tree(t, device, dtype, index=None, key=None):
    if key in lm.FP32_KEYS:
        dtype = torch.float32
    if isinstance(t, dict):
        return {k: _layer_tree(v, device, dtype, index, k)
                for k, v in t.items()}
    a = np.asarray(t)
    return _tensor(a if index is None else a[index], device, dtype)


def params_from_numpy(cfg, tree, device="cpu", dtype=torch.float32) -> dict:
    """JAX param tree (numpy leaves) -> port params on ``device``, the
    matrices, qkv biases and embeddings at ``dtype`` (cast one leaf at a
    time) and ``lm.FP32_KEYS`` in fp32."""
    lm.check_supported(cfg)
    plan = lm.build_plan(cfg)
    layers = [_layer_tree(p, device, dtype) for p in tree.get("head", [])]
    for u in range(plan["n_units"]):
        for j in range(len(plan["unit"])):
            layers.append(_layer_tree(tree["main"][str(j)], device, dtype, u))
    layers += [_layer_tree(p, device, dtype) for p in tree.get("tail", [])]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    out = {"embed": _tensor(tree["embed"], device, dtype),
           "final_norm": _layer_tree(tree["final_norm"], device,
                                     torch.float32),
           "layers": layers}
    if not cfg.tie_embeddings:
        out["unembed"] = _tensor(tree["unembed"], device, dtype)
    if cfg.is_enc_dec:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [_layer_tree(enc["layers"]["0"], device, dtype, u)
                       for u in range(cfg.encoder_layers)],
            "final_norm": _layer_tree(enc["final_norm"], device,
                                      torch.float32)}
    return out
