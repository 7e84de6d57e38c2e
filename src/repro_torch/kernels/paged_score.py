"""Paged observation-window attention logits (paper Alg. 1): the CUDA
kernel's wrapper and its plain version.

Replaces ``src/repro/kernels/paged_score.py`` (``paged_score_logits``).
Contract: q_win (n, w, h_q, d) chronological window queries; pool
(N, b, h_kv, d); block_tables (n, mb) int32; seq_lens (n,) int32. Returns
logits (n, h_kv, g, w, mb*b) float32, Q_win·Kᵀ·scale where
kpos <= seq_len - w + u and kpos < seq_len, and -1e30 elsewhere; ``scale``
is 1/√d unless given (MLA scores its 576-wide entries at
1/√(head_dim + qk_rope_head_dim)). q_win and the pool are float32,
bfloat16 or float16 (one dtype); the logits are fp32 at any of them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.paged import NEG_INF, gather_entries
from repro_torch.kernels import native
from repro_torch.kernels._checks import cuda_tensor, kv_tensors, require

NAME = "paged_score"


def paged_score_logits_plain(q_win, k_pages, block_tables, seq_lens,
                             scale=None):
    n, w, hq, d = q_win.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    ks = gather_entries(k_pages, block_tables)            # (n, T, hkv, d)
    T = ks.shape[1]
    qg = q_win.reshape(n, w, hkv, g, d).float()
    s = torch.einsum("nwhgd,nthd->nhgwt", qg, ks.float())
    s = s / math.sqrt(d) if scale is None else s * scale
    ar = torch.arange(T, device=q_win.device)
    qpos = seq_lens[:, None] - w + torch.arange(w, device=q_win.device)
    mask = (ar[None, None] <= qpos[..., None]) & \
        (ar[None, None] < seq_lens[:, None, None])         # (n, w, T)
    return torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))


def paged_score_logits_cuda(q_win, k_pages, block_tables, seq_lens,
                            scale=None):
    """Launch ``csrc/paged_score.cu`` on the current stream. Needs
    ``d % 4 == 0`` at fp32 and ``d % 8 == 0`` at bf16 and fp16 (16-byte
    copies); any d and window otherwise (the kernel tiles d where whole
    rows would not fit its shared memory)."""
    dev = q_win.device
    dtype = kv_tensors(NAME, dev, q_win=q_win, k_pages=k_pages)
    for arg, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        cuda_tensor(NAME, arg, t, torch.int32, dev)
    n, w, hq, d = q_win.shape
    N, b, hkv, dk = k_pages.shape
    require(dk == d and hq % hkv == 0, NAME,
            f"q_win {tuple(q_win.shape)} vs pool {tuple(k_pages.shape)}")
    require(block_tables.dim() == 2 and block_tables.shape[0] == n, NAME,
            f"block_tables {tuple(block_tables.shape)} vs n={n}")
    require(tuple(seq_lens.shape) == (n,), NAME, "seq_lens must be (n,)")
    require(d % 4 == 0, NAME, f"head_dim {d} is not a multiple of 4")
    g = hq // hkv
    mb = block_tables.shape[1]
    out = torch.empty((n, hkv, g, w, mb * b), dtype=torch.float32,
                      device=dev)
    lib = native.library(NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = native.launcher(lib, "paged_score_launch", dtype)(
            q_win.data_ptr(), k_pages.data_ptr(), block_tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), n, hkv, g, w, d, b, mb,
            1.0 / math.sqrt(d) if scale is None else float(scale), stream)
    native.check(NAME, lib, code)
    return out
