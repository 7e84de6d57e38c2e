"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``cuda`` and raise when no card is present — there is
no silent CPU fallback. On a card, float32 matmuls and convolutions are
pinned to full float32 (no TF32), the precision the port is held to, and
bfloat16 and float16 matmuls reduce in fp32 (no 16-bit split-K
reductions), as the JAX package's accumulate.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul \
            .allow_fp16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
