"""KV-cache compaction (paper Alg. 4): the CUDA kernel's wrapper and its
plain version.

Replaces ``src/repro/kernels/compaction.py`` (``compact_gather``) together
with the scatter around it (the JAX engine's ``_compact_pool`` in
``src/repro/core/compression.py``). One call moves, for every layer,
request and head, the surviving cache entries of K, V and the refreshed
global score F into the request's destination slots, in place.

Contract: pools k, v (L, N + 1, b, h, d) and f (L, N + 1, b, h) with the
sink page last (v may be None: MLA's latent pool, viewed as k with h = 1,
has no V); new_f (L, n, T, h) the post-global scores in cache order;
src_bt (n, mb) int32 source tables (-1 padded); src_cache (L, n, h, k)
survivor cache positions per head, in destination order; dest_flat (n, k)
destination flat slots (sink-page slots where nothing is to be written).
K and V are float32, bfloat16 or float16 (one dtype: their bits are
moved); F and new_f are float32.

Precondition, which the engine's compression planning guarantees
(``core/scheduler.py``, ``plan_compression``: ``dest = r.blocks[:nb]``, or
``fresh + r.blocks[n_prefix:][:nb - len(fresh)]``, which keeps block i at
index i): rank j's destination is a fresh slot or cache position j of its
own table; no request writes a block another request of the call reads
(copy-on-write compacts a shared or cached source into fresh blocks); and
each (layer, request, head) row of src_cache is ascending, so rank j reads
a position >= j. The kernel then writes a chunk of ranks as soon as the
reads of that chunk and of the earlier ones are done, and needs no buffer
the size of the budget.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels._checks import cuda_tensor, kv_tensors, require

NAME = "compaction"


def _compact(pool, src_bt, src_cache, dest_flat):
    """Move one request's surviving entries (per-head streams) in place.
    pool: (N + 1, b, h, ...); src_bt: (mb,) clamped source table;
    src_cache: (h, k) survivor cache positions; dest_flat: (k,) destination
    flat slots. The request's reads all happen before its writes."""
    h = src_cache.shape[0]
    b = pool.shape[1]
    flat = pool.view((-1, h) + tuple(pool.shape[3:]))
    src_slot = src_bt[src_cache // b] * b + src_cache % b       # (h, k)
    heads = torch.arange(h, device=pool.device)[:, None]
    flat[dest_flat[None, :], heads] = flat[src_slot, heads]


def compact_plain(k_pool, v_pool, f_pool, new_f, src_bt, src_cache,
                  dest_flat):
    """The same moves in plain PyTorch, request by request and layer by
    layer, as the JAX package's scan over ``apply_one`` does."""
    src_c = src_bt.long().clamp(min=0)
    src_cache = src_cache.long()
    dest_flat = dest_flat.long()
    h = new_f.shape[-1]
    heads = torch.arange(h, device=new_f.device)[:, None]
    for l in range(k_pool.shape[0]):
        f_flat = f_pool[l].view(-1, h)
        for i in range(src_bt.shape[0]):
            _compact(k_pool[l], src_c[i], src_cache[l, i], dest_flat[i])
            if v_pool is not None:
                _compact(v_pool[l], src_c[i], src_cache[l, i],
                         dest_flat[i])
            f_flat[dest_flat[i][None, :], heads] = \
                new_f[l, i].T[heads, src_cache[l, i]]


def compact_cuda(k_pool, v_pool, f_pool, new_f, src_bt, src_cache,
                 dest_flat):
    """Launch ``csrc/compaction.cu`` on the current stream (one launch for
    all layers). Any budget k is taken; the kernel moves rows by 16-byte
    copies, so head_dim must be a multiple of 4 (8 at bf16 and fp16) and
    the pools 16-byte aligned. ``v_pool=None`` moves K and F only."""
    dev = k_pool.device
    kv = {"k_pool": k_pool} if v_pool is None else \
        {"k_pool": k_pool, "v_pool": v_pool}
    dtype = kv_tensors(NAME, dev, **kv)
    for arg, t in (("f_pool", f_pool), ("new_f", new_f)):
        cuda_tensor(NAME, arg, t, torch.float32, dev)
    cuda_tensor(NAME, "src_bt", src_bt, torch.int32, dev)
    require(src_cache.is_cuda and dest_flat.is_cuda, NAME,
            "src_cache and dest_flat must be CUDA tensors")
    src_cache = src_cache.to(torch.int64).contiguous()
    dest_flat = dest_flat.to(torch.int64).contiguous()
    L, N1, b, h, d = k_pool.shape
    require(v_pool is None or v_pool.shape == k_pool.shape, NAME,
            "k/v pool shapes differ")
    require(d % 4 == 0, NAME, f"head_dim {d} must be a multiple of 4")
    require(all(t.data_ptr() % 16 == 0 for t in kv.values()), NAME,
            "k_pool and v_pool must be 16-byte aligned")
    require(tuple(f_pool.shape) == (L, N1, b, h), NAME,
            f"f_pool {tuple(f_pool.shape)} vs k_pool {tuple(k_pool.shape)}")
    n, mb = src_bt.shape
    T = new_f.shape[2]
    require(tuple(new_f.shape) == (L, n, T, h) and T == mb * b, NAME,
            f"new_f {tuple(new_f.shape)} vs (L, n, mb*b, h)")
    require(src_cache.dim() == 4 and tuple(src_cache.shape[:3]) == (L, n, h),
            NAME, f"src_cache {tuple(src_cache.shape)} vs (L, n, h, k)")
    k = src_cache.shape[3]
    require(tuple(dest_flat.shape) == (n, k), NAME,
            f"dest_flat {tuple(dest_flat.shape)} vs (n, k)")
    lib = native.library(NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = native.launcher(lib, "compaction_launch", dtype)(
            k_pool.data_ptr(), None if v_pool is None else v_pool.data_ptr(),
            f_pool.data_ptr(),
            new_f.data_ptr(), src_bt.data_ptr(), src_cache.data_ptr(),
            dest_flat.data_ptr(), L, n, h, d, b, mb, k, N1 * b, T, stream)
    native.check(NAME, lib, code)
