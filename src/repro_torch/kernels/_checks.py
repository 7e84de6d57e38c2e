"""Argument checks shared by the CUDA kernel wrappers."""
from __future__ import annotations

import torch


def require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


#: storage types of the K/V pools, queries and decode outputs that the
#: kernels take (each has its own entry point, ``native.launcher``)
KV_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def cuda_tensor(name: str, arg: str, t: torch.Tensor, dtype, device) -> None:
    require(t.is_cuda, name, f"{arg} must be a CUDA tensor, got {t.device}")
    require(t.device == device, name,
            f"{arg} is on {t.device}, expected {device}")
    require(t.dtype == dtype, name, f"{arg} must be {dtype}, got {t.dtype}")
    require(t.is_contiguous(), name, f"{arg} must be contiguous")


def kv_tensors(name: str, device, **tensors) -> torch.dtype:
    """Check the K/V-typed arguments of a kernel: CUDA, contiguous, one
    dtype among KV_DTYPES across all of them; at a 16-bit dtype (bf16,
    fp16) the rows take 16-byte copies only, so head_dim (the last dim)
    must be a multiple of 8 and every tensor 16-byte aligned. Returns the
    dtype."""
    dtype = next(iter(tensors.values())).dtype
    require(dtype in KV_DTYPES, name,
            f"K/V tensors must be one of {KV_DTYPES}, got {dtype}")
    for arg, t in tensors.items():
        cuda_tensor(name, arg, t, dtype, device)
    if dtype.itemsize == 2:
        d = next(iter(tensors.values())).shape[-1]
        require(d % 8 == 0, name,
                f"head_dim {d}: {dtype} rows need a multiple of 8")
        for arg, t in tensors.items():
            require(t.data_ptr() % 16 == 0, name,
                    f"{arg} must be 16-byte aligned at {dtype}")
    return dtype


#: the decode kernels' limits (csrc/common.cuh: kDecodeMaxG,
#: kDecodeThreads * kDecodeMaxDpt)
DECODE_MAX_G, DECODE_MAX_D = 16, 256


def decode_args(name, q, k_pages, v_pages, block_tables, seq_lens):
    """Check the arguments of a decode kernel (ragged or dense); returns
    (B, h_kv, g, d, b, mb)."""
    dev = q.device
    kv_tensors(name, dev, q=q, k_pages=k_pages, v_pages=v_pages)
    for arg, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        cuda_tensor(name, arg, t, torch.int32, dev)
    B, hq, d = q.shape
    N, b, hkv, dk = k_pages.shape
    require(v_pages.shape == k_pages.shape, name, "k/v pool shapes differ")
    require(dk == d, name, f"head_dim {d} vs pool {dk}")
    require(hq % hkv == 0, name, f"h_q={hq} not a multiple of h_kv={hkv}")
    g = hq // hkv
    require(g <= DECODE_MAX_G and d <= DECODE_MAX_D, name,
            f"g={g} (max {DECODE_MAX_G}), d={d} (max {DECODE_MAX_D})")
    require(block_tables.dim() == 2 and block_tables.shape[0] == B, name,
            f"block_tables {tuple(block_tables.shape)} vs batch {B}")
    require(tuple(seq_lens.shape) == (B,), name, "seq_lens must be (B,)")
    return B, hkv, g, d, b, block_tables.shape[1]
