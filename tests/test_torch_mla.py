"""MLA (DeepSeek-V2's latent attention) in the port, held against the JAX
package on the CPU at DeepSeek-V2-Lite-16B's ``reduced()`` widths (2
layers, d_model 64, 4 heads of 16, kv_lora_rank 32, rope 8), fp32, on
weights from ``repro.models.lm.init`` carried over by
``convert.params_from_numpy`` and inputs drawn from a numpy seed.

Layer by layer at atol = rtol = 1e-5: ``mla_latent``, ``mla_queries`` and
``mla_forward``; the absorbed decode attention over the latent pool
(``paged.paged_decode_attention_mla``) and its prefill counterpart (the
JAX package's ``_paged_prefill_mla``); the window scores
(``scoring.mla_attention_scores``); and the MLA compaction (whole entries
as one stream, h = 1, no V) against the JAX package's ``_compact_pool``.
The kernels' route to the scores on the card, ``paged_score`` at the MLA
scale reduced by ``ops.attention_scores_from_logits(causal=True)``, is
held against the port's ``mla_attention_scores`` (on the CPU through
their plain versions); and the whole MLA compression of a batch, every
layer, against the JAX package's ``build_compress_fn`` (its jnp route).
The facade-level checks of both MoE configs are in tests/test_torch_moe.py.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compression as jcompression
from repro.core import paged as jpaged
from repro.core import scoring as jscoring
from repro.core import serve_model as jserve_model
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression, paged, scoring
from repro_torch.kernels import compaction, ops
from repro_torch.models import layers

TOL = 1e-5
NAME = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced model's ops are too small to gain
    from more, and beside the suite's other workers threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget_config(NAME).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(NAME).reduced(), dtype="float32")
    params = jlm.init(jcfg, jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params))
    return dict(jcfg=jcfg, tcfg=tcfg, jattn=params["head"][0]["attn"],
                tattn=tparams["layers"][0]["attn"])


def close(got, want, tol=TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


def widths(cfg):
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    return r, dr, 1.0 / math.sqrt(cfg.head_dim + dr)


def latent_case(cfg, lens, seed, b=4, mb=6, n_pages=40):
    """A latent pool (N, b, r + dr) and -1 padded tables whose live pages
    never include page 0; the port's copy has page 0 NaN (the JAX ops get
    it finite, as a table's clamped -1 entry reads it)."""
    r, dr, _ = widths(cfg)
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(n_pages, b, r + dr)).astype(np.float32)
    bt = np.full((len(lens), mb), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
    nan_pool = pool.copy()
    nan_pool[0] = np.nan
    return rng, pool, nan_pool, bt, np.asarray(lens, np.int32)


def test_mla_layer_functions_match_jax(model):
    cfg, jcfg = model["tcfg"], model["jcfg"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 3, (2, 9)).astype(np.int32)
    jx, jpos, tx, tpos = jnp.asarray(x), jnp.asarray(pos), t(x), t(pos)
    for got, want in zip(layers.mla_latent(cfg, model["tattn"], tx, tpos),
                         jlayers.mla_latent(jcfg, model["jattn"], jx, jpos)):
        close(got, want)
    for got, want in zip(layers.mla_queries(cfg, model["tattn"], tx, tpos),
                         jlayers.mla_queries(jcfg, model["jattn"], jx,
                                             jpos)):
        close(got, want)
    close(layers.mla_forward(cfg, model["tattn"], tx, tpos),
          jlayers.mla_forward(jcfg, model["jattn"], jx, jpos))


def test_paged_decode_attention_mla_matches_jax(model):
    cfg = model["tcfg"]
    r, dr, scale = widths(cfg)
    hq = cfg.num_heads
    rng, pool, nan_pool, bt, sl = latent_case(cfg, [0, 5, 24, 13, 16], 3)
    q_abs = rng.normal(size=(len(sl), hq, r)).astype(np.float32)
    q_rope = rng.normal(size=(len(sl), hq, dr)).astype(np.float32)
    got = paged.paged_decode_attention_mla(t(q_abs), t(q_rope), t(nan_pool),
                                           t(bt), t(sl), r=r, scale=scale)
    want = jpaged.paged_decode_attention_mla(q_abs, q_rope, pool, bt, sl,
                                             r=r, scale=scale)
    close(got, want)
    assert bool((got[0] == 0).all())            # seq_len 0: nothing read


def test_paged_prefill_attention_mla_matches_jax(model):
    cfg = model["tcfg"]
    r, dr, scale = widths(cfg)
    starts, chunk = np.array([0, 7, 12], np.int32), 6
    lengths = np.array([6, 3, 6], np.int32)
    kv_lens = starts + lengths
    rng, pool, nan_pool, bt, _ = latent_case(cfg, list(kv_lens), 4)
    q = rng.normal(size=(3, chunk, cfg.num_heads, r + dr)).astype(np.float32)
    got = paged.paged_prefill_attention_mla(t(q), t(nan_pool), t(bt),
                                            t(starts), t(kv_lens), r=r,
                                            scale=scale)
    want = jserve_model._paged_prefill_mla(q, pool, bt, starts, kv_lens, r,
                                           scale)
    close(got, want)


def window_case(cfg, lens, w, seed):
    """Absorbed window queries (n, w, h_q, r + dr) over a latent pool."""
    r, dr, _ = widths(cfg)
    rng, pool, nan_pool, bt, sl = latent_case(cfg, lens, seed)
    q = rng.normal(size=(len(lens), w, cfg.num_heads, r + dr)) \
        .astype(np.float32)
    return q, pool, nan_pool, bt, sl


def test_mla_attention_scores_match_jax(model):
    cfg = model["tcfg"]
    _, _, scale = widths(cfg)
    q, pool, _, bt, sl = window_case(cfg, [24, 13, 16, 3], w=4, seed=5)
    entries = np.asarray(jpaged.gather_entries(pool, np.maximum(bt, 0)))
    T = entries.shape[1]
    valid = np.arange(T)[None] < sl[:, None]
    got = scoring.mla_attention_scores(t(q), t(entries), t(valid), t(sl),
                                       scale=scale)
    want = np.stack([np.asarray(jscoring.mla_attention_scores(
        q[i], entries[i], valid[i], sl[i], r=cfg.kv_lora_rank, scale=scale))
        for i in range(len(sl))])
    close(got, want)


@pytest.mark.parametrize("w", [4, 16])
def test_score_kernel_route_equals_mla_attention_scores(model, w):
    """The card's route: K2 over the latent pool as h_kv = 1 at the MLA
    scale, then softmax, max over the query heads and mean over w with
    every masked logit zeroed; here through K2's plain version. A row
    shorter than the window (no key for its first queries) included."""
    cfg = model["tcfg"]
    _, _, scale = widths(cfg)
    q, _, nan_pool, bt, sl = window_case(cfg, [24, 13, 16, 3, 0], w, seed=6)
    logits = ops.score_logits(t(q), t(nan_pool)[:, :, None], t(bt), t(sl),
                              scale=scale)
    assert tuple(logits.shape[1:3]) == (1, cfg.num_heads)
    got = ops.attention_scores_from_logits(logits, t(sl), causal=True)
    entries = paged.gather_entries(t(nan_pool), t(bt))
    valid = torch.arange(entries.shape[1])[None] < t(sl)[:, None]
    close(got, scoring.mla_attention_scores(t(q), entries, valid, t(sl),
                                            scale=scale).numpy())


def test_mla_compaction_matches_compact_pool(model):
    """The MLA moves of one request, in place (destination = its first
    blocks): the whole (r + dr)-wide entries as h = 1 with no V, and F,
    against the JAX package's ``_compact_pool`` on the entries viewed as
    (N, b, 1, r + dr) and its F scatter."""
    cfg = model["tcfg"]
    rng, pool, _, bt, sl = latent_case(cfg, [22], 7)
    b, budget = pool.shape[1], 3
    kk = budget * b
    T = bt.shape[1] * b
    src_cache = np.sort(rng.permutation(int(sl[0]))[:kk])[None]  # (1, k)
    dest = np.repeat(bt[0, :budget], b) * b + np.tile(np.arange(b), budget)
    f_pool = rng.random((pool.shape[0], b, 1)).astype(np.float32)
    new_f = rng.random((T, 1)).astype(np.float32)
    want = jcompression._compact_pool(jnp.asarray(pool)[:, :, None],
                                      np.maximum(bt[0], 0), src_cache,
                                      dest)[:, :, 0]
    f_flat = jnp.asarray(f_pool).reshape(-1, 1)
    f_want = f_flat.at[dest[None, :], jnp.arange(1)[:, None]].set(
        new_f.T[jnp.arange(1)[:, None], src_cache]).reshape(f_pool.shape)
    sink = np.zeros((1,) + pool.shape[1:], np.float32)
    kv = t(np.concatenate([pool, sink]))[None, :, :, None]   # (1, N+1, b, 1, e)
    f = t(np.concatenate([f_pool, np.zeros((1, b, 1), np.float32)]))[None]
    compaction.compact_plain(kv, None, f, t(new_f)[None, None], t(bt),
                             t(src_cache)[None, None], t(dest)[None])
    close(kv[0, :-1, :, 0], want, tol=0)
    close(f[0, :-1], f_want, tol=0)


def test_mla_compression_matches_jax(model):
    """``build_compress_fn`` on MLA pools ({"kv", "f"}) for a padded batch
    at every layer: the port (K2 at the MLA scale, K3 on the gathered
    latents, B6 with no V, through their plain versions) against the JAX
    package's jnp route. Pools, new seq_lens and quality stats agree; the
    sink page and the padding row write nothing the JAX package keeps."""
    cfg = model["tcfg"]
    r, dr, _ = widths(cfg)
    L, b, N, mb, w = cfg.num_layers, 4, 30, 6, 4
    budget = 3
    rng = np.random.default_rng(8)
    kv = rng.normal(size=(L, N, b, r + dr)).astype(np.float32)
    fp = rng.random((L, N, b, 1)).astype(np.float32)
    qwin = rng.normal(size=(L, 3, w, cfg.num_heads, r + dr)) \
        .astype(np.float32)
    pages = list(rng.permutation(np.arange(N)))
    src = np.full((3, mb), -1, np.int32)
    src[0, :5] = pages[:5]
    src[1, :4] = pages[5:9]
    dest = np.full((3, budget), -1, np.int32)
    dest[0], dest[1] = src[0, :budget], src[1, :budget]
    qslots = np.array([0, 2, -1], np.int32)
    seq = np.array([20, 16, 0], np.int32)
    hist = np.array([0, 12, 0], np.int32)
    req = (src, dest, qslots, seq, hist)
    opts = jcompression.CompressOptions(window=w, backend="jnp")
    jfn = jcompression.build_compress_fn(cfg, block_size=b, max_blocks=mb,
                                         budget_blocks=budget, opts=opts)
    jpools, jseq, jstats = jfn({"kv": jnp.asarray(kv), "f": jnp.asarray(fp)},
                               jnp.asarray(qwin), tuple(map(jnp.asarray,
                                                            req)))
    pad = np.zeros((L, 1) + kv.shape[2:], np.float32)
    tpools = {"kv": t(np.concatenate([kv, pad], 1)),
              "f": t(np.concatenate([fp, np.zeros((L, 1, b, 1),
                                                  np.float32)], 1))}
    qpad = np.zeros((L, 1) + qwin.shape[2:], np.float32)
    fn = compression.build_compress_fn(
        cfg, block_size=b, max_blocks=mb, budget_blocks=budget,
        opts=compression.CompressOptions(window=w))
    tseq, tstats = fn(tpools, t(np.concatenate([qwin, qpad], 1)),
                      tuple(t(a) for a in req))
    close(tseq, jseq, tol=0)
    close(tstats[:2], np.asarray(jstats)[:2])
    close(tpools["kv"][:, :-1], jpools["kv"])
    close(tpools["f"][:, :-1], jpools["f"])
