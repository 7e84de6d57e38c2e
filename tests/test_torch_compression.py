"""The port's compression, held against the JAX package's
``build_compress_fn`` on its kernel route (``backend="pallas-interpret"``).

Same pools, observation windows and requests on both sides: a first
compression (no history), a re-compression (global-score history in the
F pool), a copy-on-write launch into fresh destination blocks, and a
padding row. Survivor sets are compared only for the (layer, request,
head) streams whose k-th vs (k+1)-th final-score margin is above 1e-4: a
near-tie flips under a ~1e-7 rounding change (the JAX engine's
``_compress_fn`` docstring records margins of ~1e-5), so equality there
would test rounding, not the algorithm. Tolerance elsewhere: atol = rtol =
1e-5 (fp32). The same holds at bfloat16 pools and windows (F in fp32),
with the compacted K and V compared as bf16 bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.core.compression import CompressOptions as JOpts
from repro.core.compression import build_compress_fn as jbuild
from repro_torch.configs import get_config
from repro_torch.core import compression as tc
from repro_torch.core.paged import gather_entries
from repro_torch.kernels import ops

ATOL = RTOL = 1e-5
MARGIN = 1e-4
L, N, B_SZ, HKV, HQ, D, W = 2, 40, 4, 2, 8, 16, 4
BUDGET, WIDTH = 3, 8


def cfgs():
    kw = dict(num_layers=L, num_heads=HQ, num_kv_heads=HKV, head_dim=D,
              dtype="float32")
    return (dataclasses.replace(jget_config("tiny-lm"), **kw),
            dataclasses.replace(get_config("tiny-lm"), **kw))


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(L, N, B_SZ, HKV, D)).astype(np.float32)
    # near-duplicate keys inside some pages, so redundancy matters
    k[:, ::3] = 0.3 * k[:, ::3] + rng.normal(
        size=(L, len(range(0, N, 3)), 1, HKV, D)).astype(np.float32)
    pools = {"k": k,
             "v": rng.normal(size=(L, N, B_SZ, HKV, D)).astype(np.float32),
             "f": rng.uniform(0, 0.1, size=(L, N, B_SZ, HKV)).astype(
                 np.float32)}
    qwin = rng.normal(size=(L, 4, W, HQ, D)).astype(np.float32)
    src = np.full((4, WIDTH), -1, np.int32)
    src[0, :6] = [5, 9, 2, 30, 14, 7]
    src[1, :5] = [1, 3, 22, 18, 25]
    src[2, :8] = [10, 11, 12, 13, 26, 27, 28, 29]
    dest = np.full((4, BUDGET), -1, np.int32)
    dest[0] = src[0, :3]
    dest[1] = src[1, :3]
    dest[2] = [33, 34, 35]                 # copy-on-write: fresh blocks
    qslots = np.array([2, 0, 3, -1], np.int32)
    seq = np.array([24, 20, 32, 0], np.int32)
    hist = np.array([0, BUDGET * B_SZ, 0, 0], np.int32)
    return pools, qwin, (src, dest, qslots, seq, hist)


def port_pools(pools):
    """The port's pools carry one extra sink page at the end."""
    return {k: torch.from_numpy(np.concatenate(
        [v, np.zeros_like(v[:, :1])], axis=1)) for k, v in pools.items()}


def port_final_scores(tcfg, opts, pools, qwin, req):
    """The port's final keep scores (L, n, T, h) on the untouched pools."""
    src, _, qslots, seq, hist = req
    out = []
    for l in range(L):
        q_wins = tc._window_queries(qwin[l], qslots, seq)
        logits = ops.score_logits(q_wins, pools["k"][l], src, seq)
        pre_s = ops.attention_scores_from_logits(logits, seq)
        pre_r = ops.lightning_redundancy(pools["k"][l], src, seq,
                                         p_thresh=opts.p_thresh)
        fscore = gather_entries(pools["f"][l], src)
        *_, final = tc._select_survivors(tcfg, opts, BUDGET * B_SZ, pre_s,
                                         pre_r, fscore, seq, hist,
                                         WIDTH * B_SZ)
        out.append(final)
    return torch.stack(out)


def test_compress_matches_jax():
    jcfg, tcfg = cfgs()
    pools, qwin, req = make_inputs()
    jfn = jax.jit(jbuild(jcfg, block_size=B_SZ, max_blocks=WIDTH,
                         budget_blocks=BUDGET,
                         opts=JOpts(window=W, backend="pallas-interpret")))
    jpools, jseq, jstats = jfn({k: jnp.asarray(v) for k, v in pools.items()},
                               jnp.asarray(qwin),
                               tuple(jnp.asarray(a) for a in req))
    jpools = {k: np.asarray(v) for k, v in jpools.items()}

    topts = tc.CompressOptions(window=W)
    treq = tuple(torch.from_numpy(a.copy()) for a in req)
    tpools = port_pools(pools)
    tqwin = torch.from_numpy(qwin)
    final = port_final_scores(tcfg, topts, tpools, tqwin, treq)
    fn = tc.build_compress_fn(tcfg, block_size=B_SZ, max_blocks=WIDTH,
                              budget_blocks=BUDGET, opts=topts)
    tseq, tstats = fn(tpools, tqwin, treq)

    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    live = req[2] >= 0
    np.testing.assert_allclose(tstats.numpy()[live], np.asarray(jstats)[live],
                               rtol=RTOL, atol=ATOL)

    # blocks no live launch writes stay untouched on both sides
    written = sorted(set(req[1][live].ravel()))
    untouched = np.setdiff1d(np.arange(N), written)
    for key in ("k", "v", "f"):
        np.testing.assert_array_equal(tpools[key].numpy()[:, untouched],
                                      pools[key][:, untouched])
        np.testing.assert_array_equal(jpools[key][:, untouched],
                                      pools[key][:, untouched])

    k_keep = BUDGET * B_SZ
    compared = total = 0
    for l in range(L):
        for i in np.flatnonzero(live):
            dest = req[1][i]
            for h in range(HKV):
                total += 1
                s = torch.sort(final[l, i, :, h], descending=True)[0]
                if not float(s[k_keep - 1] - s[k_keep]) > MARGIN:
                    continue
                compared += 1
                for key in ("k", "v"):
                    got = tpools[key].numpy()[l, dest, :, h]
                    want = jpools[key][l, dest, :, h]
                    np.testing.assert_array_equal(got, want)
                np.testing.assert_allclose(
                    tpools["f"].numpy()[l, dest, :, h],
                    jpools["f"][l, dest, :, h], rtol=RTOL, atol=ATOL)
    assert compared >= 0.75 * total, (compared, total)


def test_padding_rows_write_nothing():
    _, tcfg = cfgs()
    pools, qwin, req = make_inputs(seed=1)
    src, dest, qslots, seq, hist = req
    qslots = np.full_like(qslots, -1)
    tpools = port_pools(pools)
    fn = tc.build_compress_fn(tcfg, block_size=B_SZ, max_blocks=WIDTH,
                              budget_blocks=BUDGET,
                              opts=tc.CompressOptions(window=W))
    new_seq, _ = fn(tpools, torch.from_numpy(qwin), tuple(
        torch.from_numpy(a) for a in (src, dest, qslots, seq, hist)))
    np.testing.assert_array_equal(new_seq.numpy(), seq)
    for key in pools:
        np.testing.assert_array_equal(tpools[key].numpy()[:, :N], pools[key])


def test_topk_tag_breaks_ties_to_lower_index():
    """``lax.top_k`` keeps the lower cache position among equal scores."""
    from repro.core import scoring as js
    from repro_torch.core import scoring as ts
    s = np.array([[1.0, 2.0], [3.0, 2.0], [1.0, 2.0], [3.0, 0.5],
                  [1.0, 2.0]], np.float32)
    want = np.asarray(js.topk_tag(jnp.asarray(s), 3))
    got = ts.topk_tag(torch.from_numpy(s)[None], 3)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_compress_matches_jax_at_bf16():
    """Compression on identical bf16 pools and windows (the JAX package's
    values carried into the port), F in fp32: both score in fp32 from the
    same bf16 keys and queries, so the statistics agree to 1e-5, and
    wherever the k-th vs (k+1)-th margin is above 1e-4 the compacted K and
    V are the same bf16 bits and F within 1e-5."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in cfgs())
    pools, qwin, req = make_inputs(seed=2)
    jpools = {k: jnp.asarray(v, jnp.bfloat16 if k != "f" else jnp.float32)
              for k, v in pools.items()}
    jqwin = jnp.asarray(qwin, jnp.bfloat16)
    bf16 = {k: np.asarray(v, np.float32) for k, v in jpools.items()}
    jfn = jax.jit(jbuild(jcfg, block_size=B_SZ, max_blocks=WIDTH,
                         budget_blocks=BUDGET,
                         opts=JOpts(window=W, backend="pallas-interpret")))
    jout, jseq, jstats = jfn(jpools, jqwin,
                             tuple(jnp.asarray(a) for a in req))
    assert jout["k"].dtype == jnp.bfloat16
    jout = {k: np.asarray(v, np.float32) for k, v in jout.items()}

    topts = tc.CompressOptions(window=W)
    treq = tuple(torch.from_numpy(a.copy()) for a in req)
    tpools = port_pools(bf16)
    for key in ("k", "v"):
        tpools[key] = tpools[key].to(torch.bfloat16)
    tqwin = torch.from_numpy(np.asarray(jqwin, np.float32)).to(
        torch.bfloat16)
    final = port_final_scores(tcfg, topts, tpools, tqwin, treq)
    fn = tc.build_compress_fn(tcfg, block_size=B_SZ, max_blocks=WIDTH,
                              budget_blocks=BUDGET, opts=topts)
    tseq, tstats = fn(tpools, tqwin, treq)
    assert tpools["k"].dtype == torch.bfloat16
    assert tpools["f"].dtype == torch.float32

    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    live = req[2] >= 0
    np.testing.assert_allclose(tstats.numpy()[live], np.asarray(jstats)[live],
                               rtol=RTOL, atol=ATOL)
    k_keep = BUDGET * B_SZ
    compared = total = 0
    for l in range(L):
        for i in np.flatnonzero(live):
            dest = req[1][i]
            for h in range(HKV):
                total += 1
                s = torch.sort(final[l, i, :, h], descending=True)[0]
                if not float(s[k_keep - 1] - s[k_keep]) > MARGIN:
                    continue
                compared += 1
                for key in ("k", "v"):
                    got = tpools[key][l, dest, :, h].float().numpy()
                    np.testing.assert_array_equal(got,
                                                  jout[key][l, dest, :, h])
                np.testing.assert_allclose(
                    tpools["f"].numpy()[l, dest, :, h],
                    jout["f"][l, dest, :, h], rtol=RTOL, atol=ATOL)
    assert compared >= 0.75 * total, (compared, total)
