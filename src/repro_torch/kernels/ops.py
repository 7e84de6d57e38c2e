"""Dispatch for the port's kernels (``repro.kernels.ops``).

The backend follows the tensors: a CUDA tensor launches the hand-written
kernel — or raises, there is no fallback — and a CPU tensor runs the plain
PyTorch version. The JAX package's ``backend=`` switch has no counterpart:
the device of the data decides.

``launch_counts`` (from ``native``) counts each kernel's launches;
``reset_launch_counts()`` zeroes them.
"""
from __future__ import annotations

import torch

from repro_torch.core.paged import NEG_INF
from repro_torch.kernels import compaction as _cmp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_score as _ps
from repro_torch.kernels import ragged_paged_attention as _rpa
from repro_torch.kernels import redundancy as _red
from repro_torch.kernels.native import launch_counts, reset_launch_counts  # noqa: F401

#: every kernel of the port, one per TPU kernel of the JAX package
KERNELS = (_rpa.NAME, _ps.NAME, _red.NAME, _pa.NAME, _red.FLASH_NAME,
           _cmp.NAME)


def ragged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """Length-aware decode attention; seq_len == 0 rows are exact zeros."""
    if q.is_cuda:
        return _rpa.ragged_paged_attention_cuda(q, k_pages, v_pages,
                                                block_tables, seq_lens)
    return _rpa.ragged_paged_attention_plain(q, k_pages, v_pages,
                                             block_tables, seq_lens)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """Dense decode attention over the whole table (the ragged kernel's
    baseline); live rows equal ``ragged_decode_attention``'s."""
    if q.is_cuda:
        return _pa.paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                        seq_lens)
    return _pa.paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     seq_lens)


def score_logits(q_win, k_pages, block_tables, seq_lens, scale=None):
    """Masked window logits (n, h_kv, g, w, mb*b), scaled by ``scale``
    (1/sqrt(d) when None, as the reference's ``attention_scores``)."""
    if q_win.is_cuda:
        return _ps.paged_score_logits_cuda(q_win, k_pages, block_tables,
                                           seq_lens, scale=scale)
    return _ps.paged_score_logits_plain(q_win, k_pages, block_tables,
                                        seq_lens, scale=scale)


def lightning_redundancy(k_pages, block_tables, seq_lens, p_thresh=0.8):
    """Page-local redundancy row sums (n, mb*b, h)."""
    if k_pages.is_cuda:
        return _red.lightning_redundancy_cuda(k_pages, block_tables,
                                              seq_lens, p_thresh=p_thresh)
    return _red.lightning_redundancy_plain(k_pages, block_tables, seq_lens,
                                           p_thresh=p_thresh)


def flash_redundancy(k_pages, block_tables, seq_lens, p_thresh=0.8):
    """Full-sequence redundancy row sums (n, mb*b, h) (paper Alg. 3)."""
    if k_pages.is_cuda:
        return _red.flash_redundancy_cuda(k_pages, block_tables, seq_lens,
                                          p_thresh=p_thresh)
    return _red.flash_redundancy_plain(k_pages, block_tables, seq_lens,
                                       p_thresh=p_thresh)


def compact(k_pool, v_pool, f_pool, new_f, src_bt, src_cache, dest_flat):
    """Move every request's survivors of K, V (None: no V, as MLA's
    latent pool) and F into its destination slots, all layers at once, in
    place (paper Alg. 4)."""
    if k_pool.is_cuda:
        return _cmp.compact_cuda(k_pool, v_pool, f_pool, new_f, src_bt,
                                 src_cache, dest_flat)
    return _cmp.compact_plain(k_pool, v_pool, f_pool, new_f, src_bt,
                              src_cache, dest_flat)


def attention_scores_from_logits(logits, seq_lens, causal=False):
    """Softmax over T, GQA max over g, mean over w (paper App. C.2).
    logits: (n, h, g, w, T) masked with -1e30. Returns (n, T, h).

    The probabilities at positions >= seq_len are zeroed (the JAX
    package's kernel route); ``causal=True`` zeroes them at every masked
    logit, the causal mask's too, as its jnp scoring functions do
    (``scoring.mla_attention_scores``, MLA's reference). The two differ
    only for a window query that sees no key (seq_len < w), whose softmax
    is uniform."""
    p = torch.softmax(logits, dim=-1)
    if causal:
        keep = logits != NEG_INF
    else:
        T = logits.shape[-1]
        keep = (torch.arange(T, device=logits.device)[None]
                < seq_lens[:, None])[:, None, None, None]
    p = torch.where(keep, p, torch.zeros((), device=p.device))
    return p.amax(dim=2).mean(dim=2).transpose(1, 2)


def block_table_width(max_used_blocks, table_width):
    """Host-side table-width policy for the compression launches: the
    batch's max used block count, rounded up to a power of two, capped at
    the table's width."""
    w = 1 << max(0, int(max_used_blocks) - 1).bit_length()
    return min(w, int(table_width))
