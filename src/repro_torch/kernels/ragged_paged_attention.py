"""Ragged paged decode attention: the CUDA kernel's wrapper and its plain
version.

Replaces ``src/repro/kernels/ragged_paged_attention.py``
(``ragged_paged_attention``). Contract: q (B, h_q, d); pools (N, b, h_kv, d);
block_tables (B, mb) int32 padded with -1; seq_lens (B,) int32. Returns
(B, h_q, d): one-token GQA attention over each slot's first seq_len cache
entries, a -1 table entry among them reading page 0 (the TPU kernel's
clamp: a slot that decodes nothing attends seq_len + 1 entries over an
empty table); rows with seq_len == 0 are exact zeros. q and the pools are
float32, bfloat16 or float16 (one dtype); the math is fp32 and the output,
in q's dtype, is rounded once.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import paged
from repro_torch.kernels import native
from repro_torch.kernels._checks import decode_args

NAME = "ragged_paged_attention"


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
    B, hkv, g, d, b, mb = decode_args(NAME, q, k_pages, v_pages,
                                      block_tables, seq_lens)
    lib = native.library(NAME)
    # one buffer: the output in q's dtype, rounded up to 16 bytes, then the
    # chunks' fp32 parts that the merge reads (common.cuh,
    # zp_decode_out_bytes)
    size = q.numel() * q.element_size()
    out_bytes = -(-size // 16) * 16
    extra = lib.ragged_paged_attention_workspace(B, hkv, g, d, b, mb)
    buf = torch.empty(out_bytes + 4 * extra, dtype=torch.uint8,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = native.launcher(lib, "ragged_paged_attention_launch", q.dtype)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), buf.data_ptr(),
            B, hkv, g, d, b, mb, 1.0 / math.sqrt(d), stream)
    native.check(NAME, lib, code)
    return buf[:size].view(q.dtype).view(q.shape)
