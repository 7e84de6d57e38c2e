"""The compression operation of Compressed PagedAttention (paper §4.2),
ported from ``repro.core.compression``.

``build_compress_fn`` returns a function that compresses a padded batch of
requests across all attention layers: window scores (``paged_score``
kernel) and redundancy (page-local ``lightning_redundancy`` or
full-sequence ``flash_redundancy`` kernel) -> final scores -> top-k tag ->
stable keep-first compaction into the destination blocks (``compaction``
kernel). This is the JAX package's kernel route (scores precomputed for
the whole batch, ``compression.py:124-150``). Scoring a layer never reads
what another layer's moves write, so every layer is scored first and one
compaction launch then moves K, V and F of all layers. Pools are updated
in place; padding rows (qslot < 0) write only to the pools' sink page
(``paged.sink_page``).

MLA (``cfg.attn_type == "mla"``) scores one stream, h = 1, on the latent
pool (``{"kv", "f"}``), where the JAX package runs its jnp functions: the
window logits are ``paged_score`` over the (r + d_rope)-wide entries as
h_kv = 1 at the MLA scale 1/sqrt(head_dim + qk_rope_head_dim) (16 query
heads, reduced as ``scoring.mla_attention_scores`` reduces them), the
redundancy is
taken on the latents ``[..., :r]`` of the live pages, gathered into a
contiguous temporary with a table over it, and ``compaction`` moves the
whole entries as h = 1 with no V.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import scoring
from repro_torch.core.paged import gather_entries
from repro_torch.kernels import ops
from repro_torch.models.layers import mla_scale


@dataclasses.dataclass(frozen=True)
class CompressOptions:
    """Paper-recommended defaults (App. C.8)."""
    window: int = 16                 # observation window w
    alpha: float = 0.8               # global-score decay
    use_global: bool = True
    redundancy: str = "lightning"    # lightning | flash | none
    lam: float = 0.2                 # λ in Eq. 4
    tau: float = 0.4                 # redundancy softmax temperature
    p_thresh: float = 0.8            # similarity zero-out threshold
    pooling: str = "first"           # none | first | always
    pool_kernel: int = 7
    # the JAX package's kernel-backend switch; the port dispatches on the
    # tensors' device, so only "auto" is accepted
    backend: str = "auto"


def _window_queries(qwin_l, qslots, seq_lens):
    """Chronological window queries (n, w, h_q, d) from the ring pool."""
    rings = qwin_l[qslots.clamp(min=0).long()]           # (n, w, hq, d)
    w = rings.shape[1]
    order = (seq_lens[:, None] - w
             + torch.arange(w, device=rings.device)[None]) % w
    return torch.gather(rings, 1, order.long()[:, :, None, None]
                        .expand(-1, -1, *rings.shape[2:]))


def _latent_pages(kv_l, src_bt, r):
    """The latents ``[..., :r]`` of the pages each table maps, gathered
    into a contiguous pool (n * mb, b, 1, r) with the table (n, mb) over
    it; a -1 entry stays -1."""
    n, mb = src_bt.shape
    pages = kv_l[src_bt.clamp(min=0).long(), :, :r]         # (n, mb, b, r)
    table = torch.arange(n * mb, dtype=torch.int32,
                         device=src_bt.device).view(n, mb)
    table = torch.where(src_bt >= 0, table, torch.full_like(table, -1))
    return pages.view(n * mb, kv_l.shape[1], 1, r), table


def _select_survivors(cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                      hist_lens, T):
    """Scores -> survivors for every request of one layer. Returns
    (src_cache (n, h, k) survivor cache positions in cache order, new_f
    (n, T, h), stats (n, 2), final (n, T, h) keep scores)."""
    valid = torch.arange(T, device=pre_s.device)[None] < seq_lens[:, None]
    s = pre_s
    if opts.redundancy != "none":
        raw = pre_r
        red = scoring.redundancy_softmax(raw, valid, tau=opts.tau)
    else:
        raw = torch.zeros_like(s)
        red = torch.zeros_like(s)
    stats = scoring.quality_stats(s, raw, valid, seq_lens)
    if opts.use_global and opts.alpha > 0:
        s = scoring.global_score_update(s, fscore, hist_lens, opts.alpha)
    new_f = s
    if opts.pooling == "always":
        s = scoring.max_pool_scores(s, valid, kernel=opts.pool_kernel)
    elif opts.pooling == "first":
        pooled = scoring.max_pool_scores(s, valid, kernel=opts.pool_kernel)
        s = torch.where((hist_lens == 0)[:, None, None], pooled, s)
    final = scoring.combine_scores(s, red, valid, opts.window, seq_lens,
                                   lam=opts.lam)
    tag = scoring.topk_tag(final, k_keep)                 # (n, T, h)
    # stable keep-first sort == survivors in original cache order
    order_keep = torch.sort((~tag).transpose(1, 2).to(torch.uint8), dim=-1,
                            stable=True)[1]
    return order_keep[..., :k_keep], new_f, stats, final


def build_compress_fn(cfg, *, block_size, max_blocks, budget_blocks,
                      opts: CompressOptions):
    """Returns compress(pools, qwin, req) -> (new_seq_lens, stats).

    pools: {"k", "v": (L, N + 1, b, h, d), "f": (L, N + 1, b, h)} (GQA)
    or {"kv": (L, N + 1, b, r + d_rope), "f": (L, N + 1, b, 1)} (MLA),
    with the sink page last, updated in place; qwin: (L, M, w, h_q, dq)
    observation-window query pool (ring order).
    req (tensors on the pools' device, leading dim n):
      src_bt (n, max_blocks) source tables (-1 padded), dest_bt
      (n, budget_blocks) destination blocks, qslots (n,) (-1 = padding
      row), seq_lens (n,) valid entries, hist_lens (n,) entries carrying
      global-score history.
    stats is (n, 2) ``scoring.quality_stats`` averaged over layers.
    """
    if opts.redundancy not in ("lightning", "flash", "none"):
        raise ValueError(f"unknown redundancy {opts.redundancy!r}; "
                         "expected lightning | flash | none")
    if opts.backend != "auto":
        raise ValueError("the port dispatches kernels on the tensors' "
                         f"device; backend={opts.backend!r} is not accepted")
    b = block_size
    T = max_blocks * b
    k_keep = budget_blocks * b
    mla = cfg.attn_type == "mla"
    key = "kv" if mla else "k"
    scale = mla_scale(cfg) if mla else None

    def compress(pools, qwin, req):
        src_bt, dest_bt, qslots, seq_lens, hist_lens = req
        dev = src_bt.device
        n_layers = pools[key].shape[0]
        sink = pools[key].shape[1] - 1
        writes = (dest_bt >= 0) & (qslots >= 0)[:, None]
        dest_blk = torch.where(writes, dest_bt.long(), sink)
        dest_flat = (dest_blk.repeat_interleave(b, dim=1) * b
                     + torch.arange(b, device=dev).repeat(budget_blocks))
        stats_sum = 0.0
        survivors, new_fs = [], []
        for l in range(n_layers):
            k_l = pools[key][l]
            if mla:                          # (N + 1, b, 1, r + d_rope)
                k_l = k_l.unsqueeze(2)
            q_wins = _window_queries(qwin[l], qslots, seq_lens)
            logits = ops.score_logits(q_wins, k_l, src_bt, seq_lens,
                                      scale=scale)
            pre_s = ops.attention_scores_from_logits(logits, seq_lens,
                                                     causal=mla)
            red_pool, red_bt = k_l, src_bt
            if mla and opts.redundancy != "none":
                red_pool, red_bt = _latent_pages(pools["kv"][l], src_bt,
                                                 cfg.kv_lora_rank)
            pre_r = None
            if opts.redundancy == "lightning":
                pre_r = ops.lightning_redundancy(red_pool, red_bt, seq_lens,
                                                 p_thresh=opts.p_thresh)
            elif opts.redundancy == "flash":
                pre_r = ops.flash_redundancy(red_pool, red_bt, seq_lens,
                                             p_thresh=opts.p_thresh)
            fscore = gather_entries(pools["f"][l], src_bt)
            src_cache, new_f, stats, _ = _select_survivors(
                cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                hist_lens, T)
            stats_sum = stats_sum + stats
            survivors.append(src_cache)
            new_fs.append(new_f)
        # F is refreshed (post-global scores) and moved with its entries;
        # MLA's whole entries move as one stream (h = 1) with no V
        k_pool, v_pool = (pools["kv"].unsqueeze(3), None) if mla else \
            (pools["k"], pools["v"])
        ops.compact(k_pool, v_pool, pools["f"], torch.stack(new_fs),
                    src_bt, torch.stack(survivors), dest_flat)
        new_seq = torch.where(qslots >= 0,
                              torch.full_like(seq_lens, k_keep), seq_lens)
        return new_seq, stats_sum / n_layers

    return compress
