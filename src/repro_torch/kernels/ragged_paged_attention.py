"""Ragged paged decode attention: the CUDA kernel's wrapper and its plain
version.

Replaces ``src/repro/kernels/ragged_paged_attention.py``
(``ragged_paged_attention``). Contract: q (B, h_q, d); pools (N, b, h_kv, d);
block_tables (B, mb) int32 padded with -1; seq_lens (B,) int32. Returns
(B, h_q, d): one-token GQA attention over each slot's first seq_len cache
entries; rows with seq_len == 0 are exact zeros.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import paged
from repro_torch.kernels import native
from repro_torch.kernels._checks import cuda_tensor, require

NAME = "ragged_paged_attention"
MAX_G, MAX_D = 8, 256


def ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 seq_lens):
    """The same function in plain PyTorch: the dense gathered reference,
    with seq_len == 0 rows set to zeros."""
    out = paged.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                       seq_lens)
    return torch.where((seq_lens > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def ragged_paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                seq_lens):
    """Launch ``csrc/ragged_paged_attention.cu`` on the current stream."""
    dev = q.device
    for arg, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        cuda_tensor(NAME, arg, t, torch.float32, dev)
    for arg, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        cuda_tensor(NAME, arg, t, torch.int32, dev)
    B, hq, d = q.shape
    N, b, hkv, dk = k_pages.shape
    require(v_pages.shape == k_pages.shape, NAME, "k/v pool shapes differ")
    require(dk == d, NAME, f"head_dim {d} vs pool {dk}")
    require(hq % hkv == 0, NAME, f"h_q={hq} not a multiple of h_kv={hkv}")
    g = hq // hkv
    require(g <= MAX_G and d <= MAX_D, NAME,
            f"g={g} (max {MAX_G}), d={d} (max {MAX_D})")
    require(block_tables.dim() == 2 and block_tables.shape[0] == B, NAME,
            f"block_tables {tuple(block_tables.shape)} vs batch {B}")
    require(tuple(seq_lens.shape) == (B,), NAME, "seq_lens must be (B,)")
    mb = block_tables.shape[1]
    out = torch.empty_like(q)
    lib = native.library(NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ragged_paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, hkv, g, d, b, mb, 1.0 / math.sqrt(d), stream)
    native.check(NAME, lib, code)
    return out
