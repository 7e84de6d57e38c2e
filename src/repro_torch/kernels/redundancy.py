"""Lightning key redundancy (paper App. C.7): the CUDA kernel's wrapper and
its plain version.

Replaces ``src/repro/kernels/redundancy.py`` (``lightning_redundancy``).
Contract: pool (N, b, h, d); block_tables (n, mb) int32; seq_lens (n,)
int32. Returns (n, mb*b, h) float32: per page, the row sums (divided by b)
of the cosine matrix of L2-normalised keys with the diagonal and invalid
rows/columns zeroed and, per column, the newest entry above ``p_thresh``
zeroed.
"""
from __future__ import annotations

import torch

from repro_torch.core.paged import gather_entries
from repro_torch.kernels import native
from repro_torch.kernels._checks import cuda_tensor, require

NAME = "lightning_redundancy"


def lightning_redundancy_plain(k_pages, block_tables, seq_lens, *,
                               p_thresh=0.8):
    n, mb = block_tables.shape
    b, h = k_pages.shape[1], k_pages.shape[2]
    e = gather_entries(k_pages, block_tables).float()     # (n, T, h, d)
    T = e.shape[1]
    valid = torch.arange(T, device=e.device)[None] < seq_lens[:, None]
    e = torch.where(valid[..., None, None], e, torch.zeros((), device=e.device))
    ehat = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True) \
        .clamp(min=1e-12)
    eb = ehat.reshape(n, mb, b, h, -1)
    vb = valid.reshape(n, mb, b)
    c = torch.einsum("nkthd,nkshd->nkhts", eb, eb)        # (n, mb, h, b, b)
    eye = torch.eye(b, dtype=torch.bool, device=e.device)
    keep = (vb[:, :, :, None] & vb[:, :, None, :])[:, :, None] & ~eye
    c = torch.where(keep, c, torch.zeros((), device=e.device))
    # per column, zero the last (newest-row) entry above the threshold
    above = c > p_thresh
    rows = torch.arange(b, device=e.device)[:, None]
    last = torch.where(above, rows, torch.full_like(rows, -1)).amax(dim=-2)
    hit = (rows == last[..., None, :]) & above.any(dim=-2)[..., None, :]
    c = torch.where(hit, torch.zeros((), device=e.device), c)
    r = c.sum(-1) / b                                     # (n, mb, h, b)
    return r.permute(0, 1, 3, 2).reshape(n, T, h)


def lightning_redundancy_cuda(k_pages, block_tables, seq_lens, *,
                              p_thresh=0.8):
    """Launch ``csrc/redundancy.cu`` on the current stream."""
    dev = k_pages.device
    cuda_tensor(NAME, "k_pages", k_pages, torch.float32, dev)
    for arg, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        cuda_tensor(NAME, arg, t, torch.int32, dev)
    N, b, h, d = k_pages.shape
    require(block_tables.dim() == 2, NAME, "block_tables must be (n, mb)")
    n, mb = block_tables.shape
    require(tuple(seq_lens.shape) == (n,), NAME, "seq_lens must be (n,)")
    out = torch.empty((n, mb * b, h), dtype=torch.float32, device=dev)
    lib = native.library(NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lightning_redundancy_launch(
            k_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), n, h, d, b, mb, float(p_thresh), stream)
    native.check(NAME, lib, code)
    return out
