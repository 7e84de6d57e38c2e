"""Argument checks shared by the CUDA kernel wrappers."""
from __future__ import annotations

import torch


def require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def cuda_tensor(name: str, arg: str, t: torch.Tensor, dtype, device) -> None:
    require(t.is_cuda, name, f"{arg} must be a CUDA tensor, got {t.device}")
    require(t.device == device, name,
            f"{arg} is on {t.device}, expected {device}")
    require(t.dtype == dtype, name, f"{arg} must be {dtype}, got {t.dtype}")
    require(t.is_contiguous(), name, f"{arg} must be contiguous")
