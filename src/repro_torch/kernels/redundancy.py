"""Key redundancy: the CUDA kernels' wrappers and their plain versions.

Lightning redundancy (paper App. C.7) replaces
``src/repro/kernels/redundancy.py`` (``lightning_redundancy``). Contract:
pool (N, b, h, d); block_tables (n, mb) int32; seq_lens (n,) int32.
Returns (n, mb*b, h) float32: per page, the row sums (divided by b) of the
cosine matrix of L2-normalised keys with the diagonal and invalid
rows/columns zeroed and, per column, the newest entry above ``p_thresh``
zeroed.

Flash redundancy (paper Alg. 3) replaces ``flash_redundancy`` of the same
file: the same over the whole sequence instead of page by page, with row
sums divided by ``max(seq_len, 1)`` (``scoring.redundancy_full`` of the JAX
package, batched over requests).

Both take float32, bfloat16 or float16 keys and return float32.
"""
from __future__ import annotations

import torch

from repro_torch.core.paged import gather_entries
from repro_torch.kernels import native
from repro_torch.kernels._checks import cuda_tensor, kv_tensors, require

NAME = "lightning_redundancy"
FLASH_NAME = "flash_redundancy"
#: three key tiles (of 64 keys, or of 32 where 64 would not fit) of
#: d + pad elements must fit a block's shared memory: d <= 576 takes
#: MLA's latent (512) at either dtype
FLASH_MAX_D = 576


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


def _launch(name, launch, k_pages, block_tables, seq_lens, p_thresh,
            workspace=None):
    """Check the arguments and launch on the current stream. The kernel
    gets one buffer: the (n, mb*b, h) output, then as many floats of
    scratch as the library's ``workspace`` function asks for, if named
    (given n, h, d, b, mb and the keys' element size)."""
    dev = k_pages.device
    dtype = kv_tensors(name, dev, k_pages=k_pages)
    for arg, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        cuda_tensor(name, arg, t, torch.int32, dev)
    N, b, h, d = k_pages.shape
    require(block_tables.dim() == 2, name, "block_tables must be (n, mb)")
    n, mb = block_tables.shape
    require(tuple(seq_lens.shape) == (n,), name, "seq_lens must be (n,)")
    lib = native.library(name)
    size = n * mb * b * h
    extra = getattr(lib, workspace)(n, h, d, b, mb, k_pages.element_size()) \
        if workspace else 0
    buf = torch.empty(size + extra, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = native.launcher(lib, launch, dtype)(
            k_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            buf.data_ptr(), n, h, d, b, mb, float(p_thresh), stream)
    native.check(name, lib, code)
    return buf[:size].view(n, mb * b, h)


def lightning_redundancy_cuda(k_pages, block_tables, seq_lens, *,
                              p_thresh=0.8):
    """Launch ``csrc/redundancy.cu`` on the current stream. Needs
    ``d % 4 == 0`` (16-byte copies; ``d % 8 == 0`` at bf16 and fp16)."""
    d = k_pages.shape[-1]
    require(d % 4 == 0, NAME, f"head_dim {d}: needs a multiple of 4")
    return _launch(NAME, "lightning_redundancy_launch", k_pages,
                   block_tables, seq_lens, p_thresh)


def _cosine_matrix(entries, valid):
    """(n, h, T, T) cosine similarity of L2-normalised keys (eps 1e-12);
    invalid rows and columns zeroed (and their keys zeroed first, so stale
    or NaN pool data cannot reach a valid entry)."""
    zero = torch.zeros((), device=entries.device)
    e = torch.where(valid[..., None, None], entries.float(), zero)
    ehat = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True) \
        .clamp(min=1e-12)
    c = torch.einsum("nthd,nshd->nhts", ehat, ehat)
    vm = valid[:, :, None] & valid[:, None, :]
    return torch.where(vm[:, None], c, zero)


def flash_redundancy_plain(k_pages, block_tables, seq_lens, *,
                           p_thresh=0.8):
    e = gather_entries(k_pages, block_tables)              # (n, T, h, d)
    T = e.shape[1]
    valid = torch.arange(T, device=e.device)[None] < seq_lens[:, None]
    zero = torch.zeros((), device=e.device)
    c = _cosine_matrix(e, valid)
    eye = torch.eye(T, dtype=torch.bool, device=e.device)
    c = torch.where(eye, zero, c)
    # per column, zero the last (newest-row) entry above the threshold
    above = c > p_thresh
    rows = torch.arange(T, device=e.device)[:, None]
    last = torch.where(above, rows, torch.full_like(rows, -1)).amax(dim=-2)
    hit = (rows == last[..., None, :]) & above.any(dim=-2)[..., None, :]
    c = torch.where(hit, zero, c)
    n_valid = valid.sum(1).clamp(min=1).float()
    return (c.sum(-1) / n_valid[:, None, None]).transpose(1, 2)


def flash_redundancy_cuda(k_pages, block_tables, seq_lens, *, p_thresh=0.8):
    """Launch ``csrc/flash_redundancy.cu`` on the current stream. Needs
    ``d % 4 == 0`` (16-byte copies; ``d % 8 == 0`` at bf16 and fp16) and
    ``d <= FLASH_MAX_D`` (shared memory)."""
    d = k_pages.shape[-1]
    require(d % 4 == 0 and d <= FLASH_MAX_D, FLASH_NAME,
            f"head_dim {d}: needs a multiple of 4, at most {FLASH_MAX_D}")
    return _launch(FLASH_NAME, "flash_redundancy_launch", k_pages,
                   block_tables, seq_lens, p_thresh,
                   workspace="flash_redundancy_workspace")
