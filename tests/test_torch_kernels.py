"""The port's kernels, held against the JAX package's Pallas kernels.

On the CPU each kernel of ``repro_torch.kernels`` runs its plain PyTorch
version; here those are compared with ``repro.kernels.ops`` run through the
Pallas interpreter (``backend="pallas-interpret"``) on the same numpy
inputs, at GQA shapes (8, 2) and (32, 8) and at the head layouts of the
other dense configs, g = 1 (OLMo-1B's MHA), 6 (Nemotron-4-15B) and 8
(Qwen2.5-3B) (the dense decode at (8, 2), (4, 4) and those layouts), over
length mixes with inactive (seq_len == 0), sub-block,
block-aligned and full-table rows, and with a NaN-poisoned page 0 that no
live row maps. The kernels of the second slice (dense decode, flash
redundancy, compaction) run at the interpreter's small sizes: n <= 2 or
so requests, mb <= 4 pages. The CUDA wrappers themselves
run only on a card (tests/test_torch_gpu.py); here they must refuse CPU
tensors rather than fall back.

Tolerance: atol = rtol = 1e-5 (fp32; the two frameworks sum the dot
products in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import _compact_pool
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import compaction as cmp
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_score as ps
from repro_torch.kernels import ragged_paged_attention as rpa
from repro_torch.kernels import redundancy as red

ATOL = RTOL = 1e-5
#: (h_q, h_kv): g = 4 (Qwen3-8B, Llama-3-8B), then g = 1, 6 and 8
LAYOUTS = [(4, 4), (12, 2), (16, 2)]
GQA_SHAPES = [(8, 2), (32, 8)] + LAYOUTS
LENGTH_MIXES = [
    [0, 1, 7, 24, 13],
    [24, 24, 24, 24, 24],
    [0, 0, 0, 0, 0],
    [3, 8, 9, 16, 0],
]


def make_case(hq, hkv, seq_lens, seed, d=16, b=4, mb=6, n_pages=64,
              poison=False, similar=False):
    """Random q / pools / -1 padded tables; live pages never include page
    0. ``poison`` makes page 0 and each row's stale tail NaN; ``similar``
    makes a page's keys near-duplicates (redundancy threshold hits)."""
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    q = rng.normal(size=(B, hq, d)).astype(np.float32)
    kp = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    if similar:
        kp = 0.3 * kp + rng.normal(size=(n_pages, 1, hkv, d)).astype(
            np.float32)
    vp = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    sl = np.asarray(seq_lens, np.int32)
    bt = np.full((B, mb), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i in range(B):
        for j in range(-(-int(sl[i]) // b)):
            bt[i, j] = free.pop()
    if poison:
        kp[0] = np.nan
        vp[0] = np.nan
        for i, s in enumerate(sl):
            if s % b:
                kp[bt[i, s // b], s % b:] = np.nan
                vp[bt[i, s // b], s % b:] = np.nan
    return q, kp, vp, bt, sl


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("hq,hkv", GQA_SHAPES)
@pytest.mark.parametrize("mix", range(len(LENGTH_MIXES)))
@pytest.mark.parametrize("poison", [False, True])
def test_ragged_decode_matches_pallas(hq, hkv, mix, poison):
    q, kp, vp, bt, sl = make_case(hq, hkv, LENGTH_MIXES[mix], seed=mix,
                                  poison=poison)
    # the reference runs on the clean pool: poisoning must change nothing
    _, kc, vc, _, _ = make_case(hq, hkv, LENGTH_MIXES[mix], seed=mix)
    want = np.asarray(jops.ragged_decode_attention(
        q, kc, vc, bt, sl, backend="pallas-interpret"))
    got = ops.ragged_decode_attention(t(q), t(kp), t(vp), t(bt), t(sl))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy()[sl == 0] == 0)


@pytest.mark.parametrize("hq,hkv", GQA_SHAPES)
@pytest.mark.parametrize("mix", range(len(LENGTH_MIXES)))
@pytest.mark.parametrize("poison", [False, True])
def test_score_logits_match_pallas(hq, hkv, mix, poison):
    w = 4
    q, kp, _, bt, sl = make_case(hq, hkv, LENGTH_MIXES[mix], seed=10 + mix,
                                 poison=poison)
    _, kc, _, _, _ = make_case(hq, hkv, LENGTH_MIXES[mix], seed=10 + mix)
    rng = np.random.default_rng(mix)
    q_win = rng.normal(size=(len(sl), w, hq, q.shape[-1])).astype(np.float32)
    # the JAX wrapper is handed clamped tables, as its compression does;
    # the port's kernel takes the -1 padded table and never reads it
    want = np.asarray(jops.score_logits(q_win, kc, np.maximum(bt, 0), sl,
                                        backend="pallas-interpret"))
    got = ops.score_logits(t(q_win), t(kp), t(bt), t(sl))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    scores = ops.attention_scores_from_logits(got, t(sl))
    want_s = np.asarray(jops.attention_scores_from_logits(want, sl))
    np.testing.assert_allclose(scores.numpy(), want_s, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hq,hkv", GQA_SHAPES)
@pytest.mark.parametrize("mix", range(len(LENGTH_MIXES)))
@pytest.mark.parametrize("similar", [False, True])
def test_lightning_redundancy_matches_pallas(hq, hkv, mix, similar):
    _, kp, _, bt, sl = make_case(hq, hkv, LENGTH_MIXES[mix], seed=20 + mix,
                                 poison=True, similar=similar)
    _, kc, _, _, _ = make_case(hq, hkv, LENGTH_MIXES[mix], seed=20 + mix,
                               similar=similar)
    want = np.asarray(jops.lightning_redundancy(
        kc, np.maximum(bt, 0), sl, p_thresh=0.8, backend="pallas-interpret"))
    got = ops.lightning_redundancy(t(kp), t(bt), t(sl), p_thresh=0.8)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_redundancy_threshold_is_exercised():
    """The near-duplicate pool must trip the per-column zero-out, or the
    parity above says nothing about it."""
    _, kp, _, bt, sl = make_case(8, 2, [24, 13, 16, 9, 0], seed=3,
                                 similar=True)
    on = ops.lightning_redundancy(t(kp), t(bt), t(sl), p_thresh=0.8)
    off = ops.lightning_redundancy(t(kp), t(bt), t(sl), p_thresh=2.0)
    assert (on != off).any()


def test_cpu_dispatch_counts_no_launch():
    """CPU tensors take the plain versions, which are not launches."""
    before = dict(ops.launch_counts)
    q, kp, vp, bt, sl = make_case(8, 2, [5, 0, 9], seed=1)
    ops.ragged_decode_attention(t(q), t(kp), t(vp), t(bt), t(sl))
    ops.lightning_redundancy(t(kp), t(bt), t(sl))
    assert ops.launch_counts == before
    assert set(ops.KERNELS) == set(ops.launch_counts)


@pytest.mark.parametrize("wrapper,args", [
    (rpa.ragged_paged_attention_cuda, "q kp vp bt sl"),
    (ps.paged_score_logits_cuda, "qw kp bt sl"),
    (red.lightning_redundancy_cuda, "kp bt sl"),
    (pa.paged_attention_cuda, "q kp vp bt sl"),
    (red.flash_redundancy_cuda, "kp bt sl"),
])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, args):
    """No fallback: a wrapper handed CPU tensors raises before any launch
    instead of running the plain version."""
    q, kp, vp, bt, sl = make_case(8, 2, [5, 0, 9], seed=1)
    qw = np.zeros((3, 4, 8, 16), np.float32)
    env = {"q": q, "kp": kp, "vp": vp, "bt": bt, "sl": sl, "qw": qw}
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(*[t(env[a]) for a in args.split()])


# ----------------------------------------------------------------------
# second slice: dense decode (B4), flash redundancy (B5), compaction (B6)

SMALL_MIXES = [[0, 13], [16, 5], [9, 0], [1, 16]]


@pytest.mark.parametrize("hq,hkv", [(8, 2)] + LAYOUTS)
@pytest.mark.parametrize("mix", range(len(SMALL_MIXES)))
@pytest.mark.parametrize("poison", [False, True])
def test_dense_decode_matches_pallas(hq, hkv, mix, poison):
    lens = SMALL_MIXES[mix]
    q, kp, vp, bt, sl = make_case(hq, hkv, lens, seed=30 + mix, mb=4,
                                  n_pages=16, poison=poison)
    _, kc, vc, _, _ = make_case(hq, hkv, lens, seed=30 + mix, mb=4,
                                n_pages=16)
    want = np.asarray(jops.paged_decode_attention(
        q, kc, vc, bt, sl, backend="pallas-interpret"))
    got = ops.paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(sl))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # seq_len == 0 rows: what the JAX package's dense reference gives
    np.testing.assert_array_equal(got.numpy()[sl == 0], 0.0)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (32, 8)] + LAYOUTS)
@pytest.mark.parametrize("mix", range(len(LENGTH_MIXES)))
def test_dense_equals_ragged_on_live_rows(hq, hkv, mix):
    """The plain dense and ragged versions agree bit for bit on live rows
    (the port's counterpart of the JAX package's ragged == dense), NaN
    page 0 and stale tails included."""
    q, kp, vp, bt, sl = make_case(hq, hkv, LENGTH_MIXES[mix], seed=40 + mix,
                                  poison=True)
    args = [t(a) for a in (q, kp, vp, bt, sl)]
    dense = ops.paged_decode_attention(*args)
    ragged = ops.ragged_decode_attention(*args)
    live = sl > 0
    assert torch.equal(dense[live], ragged[live])
    assert (dense[~live] == 0).all() and (ragged[~live] == 0).all()


FLASH_MIXES = [[16, 7], [0, 11], [13, 16]]


@pytest.mark.parametrize("mix", range(len(FLASH_MIXES)))
@pytest.mark.parametrize("similar", [False, True])
def test_flash_redundancy_matches_pallas_and_ref(mix, similar):
    lens = FLASH_MIXES[mix]
    _, kp, _, bt, sl = make_case(4, 2, lens, seed=50 + mix, mb=4,
                                 n_pages=16, poison=True, similar=similar)
    _, kc, _, _, _ = make_case(4, 2, lens, seed=50 + mix, mb=4, n_pages=16,
                               similar=similar)
    want = np.asarray(jops.flash_redundancy(
        kc, np.maximum(bt, 0), sl, p_thresh=0.8, backend="pallas-interpret"))
    want_ref = np.asarray(jref.flash_redundancy_ref(kc, bt, sl, p_thresh=0.8))
    got = ops.flash_redundancy(t(kp), t(bt), t(sl), p_thresh=0.8)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)


def test_flash_threshold_is_exercised():
    """The near-duplicate keys trip the cross-block zero-out."""
    _, kp, _, bt, sl = make_case(4, 2, [16, 13], seed=51, mb=4, n_pages=16,
                                 similar=True)
    on = ops.flash_redundancy(t(kp), t(bt), t(sl), p_thresh=0.8)
    off = ops.flash_redundancy(t(kp), t(bt), t(sl), p_thresh=2.0)
    assert (on != off).any()
    # a full-sequence score: it differs from the page-local one
    light = ops.lightning_redundancy(t(kp), t(bt), t(sl), p_thresh=0.8)
    assert not torch.allclose(on, light)


def flash_by_strips(kp, bt, sl, strip, p_thresh=0.8):
    """Flash redundancy decomposed as csrc/flash_redundancy.cu computes
    it: per column strip of ``strip`` keys, row tiles of ``strip`` keys
    walked newest to oldest with a per-column "already zeroed" tag; each
    tile's row sums over the strip are that strip's partial, and the
    partials are summed in ascending strip order (p_thresh >= 0)."""
    n, mb = bt.shape
    _, b, h, d = kp.shape
    T = mb * b
    out = np.zeros((n, T, h), np.float32)
    for i in range(n):
        L = min(max(int(sl[i]), 0), T)
        e = kp[np.maximum(bt[i], 0)].reshape(T, h, d)[:L].astype(np.float64)
        e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
        tiles = [np.arange(s, min(s + strip, L)) for s in range(0, L, strip)]
        for hh in range(h):
            part = np.zeros((len(tiles), L))
            for j, cols in enumerate(tiles):
                done = np.zeros(len(cols), bool)
                for rows in reversed(tiles):
                    c = e[rows, hh] @ e[cols, hh].T
                    c[rows[:, None] == cols[None, :]] = 0.0
                    above = c > p_thresh
                    newest = len(rows) - 1 - np.argmax(above[::-1], axis=0)
                    hit = np.flatnonzero(above.any(0) & ~done)
                    c[newest[hit], hit] = 0.0
                    done |= above.any(0)
                    part[j, rows] = c.sum(1)
            total = np.zeros(L)
            for j in range(len(tiles)):
                total += part[j]
            out[i, :L, hh] = total / max(L, 1)
    return out


STRIP_CASES = [(4, 16, [64, 37]), (33, 4, [132, 77, 0]),
               (32, 16, [512, 300])]


@pytest.mark.parametrize("strip", [16, 64])
@pytest.mark.parametrize("case", range(len(STRIP_CASES)))
def test_flash_redundancy_by_column_strips(strip, case):
    """The strip decomposition of the CUDA kernel equals the JAX
    reference and the port's plain version, with near-duplicate pages
    whose zero-outs cross strip boundaries."""
    mb, b, lens = STRIP_CASES[case]
    _, kc, _, bt, sl = make_case(4, 2, lens, seed=60 + case, b=b, mb=mb,
                                 n_pages=160, similar=True)
    rng = np.random.default_rng(case)
    for i, s in enumerate(sl):          # newest page ~ oldest page
        if s > b:
            kc[bt[i, (s - 1) // b]] = kc[bt[i, 0]] + 0.05 * rng.normal(
                size=kc.shape[1:])
    kp = kc.copy()
    kp[0] = np.nan
    for i, s in enumerate(sl):
        if s % b:
            kp[bt[i, s // b], s % b:] = np.nan
    got = flash_by_strips(kp, bt, sl, strip)
    want_ref = np.asarray(jref.flash_redundancy_ref(kc, bt, sl,
                                                    p_thresh=0.8))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    port = ops.flash_redundancy(t(kp), t(bt), t(sl), p_thresh=0.8)
    np.testing.assert_allclose(got, port.numpy(), rtol=RTOL, atol=ATOL)
    no_zero_out = flash_by_strips(kp, bt, sl, strip, p_thresh=2.0)
    assert (np.abs(no_zero_out - got) > 1e-3).any()


def compaction_case(seed=0, L=2, b=4, h=2, d=8, budget=3):
    """Four requests, as the block manager plans them, on tables of
    ``budget + 1`` blocks: 0 and 1 share their first source block (a
    prefix), so each copies it to a fresh block and compacts the rest in
    place (copy-on-write); 2 compacts wholly in place (its destination
    blocks are its first source blocks, so ranks overlap their sources); 3
    is a padding row (destination: the sink page)."""
    rng = np.random.default_rng(seed)
    mb = budget + 1
    N = 3 * mb + 4
    k = rng.normal(size=(L, N, b, h, d)).astype(np.float32)
    v = rng.normal(size=(L, N, b, h, d)).astype(np.float32)
    f = rng.uniform(size=(L, N, b, h)).astype(np.float32)
    free = [int(x) for x in rng.permutation(np.arange(1, N))]
    shared = free.pop()
    src = np.full((4, mb), -1, np.int32)
    src[0] = [shared] + [free.pop() for _ in range(mb - 1)]
    src[1] = [shared] + [free.pop() for _ in range(mb - 1)]
    src[2] = [free.pop() for _ in range(mb)]
    dest = np.full((4, budget), -1, np.int32)
    dest[0] = [free.pop()] + list(src[0, 1:budget])
    dest[1] = [free.pop()] + list(src[1, 1:budget])
    dest[2] = src[2, :budget]
    T, kk = mb * b, budget * b
    # survivors per (layer, request, head): kk sorted positions of T
    src_cache = np.stack([np.stack([np.stack([
        np.sort(rng.choice(T, kk, replace=False)) for _ in range(h)])
        for _ in range(4)]) for _ in range(L)]).astype(np.int64)
    new_f = rng.uniform(size=(L, 4, T, h)).astype(np.float32)
    return k, v, f, new_f, src, dest, src_cache


@pytest.mark.parametrize("b,budget", [(4, 3), (16, 30)])
def test_compaction_matches_jax_compact_pool(b, budget):
    """At the engine's default budget and at one of 30 blocks (k = 480),
    above what a kernel staging a whole stripe in shared memory takes."""
    k, v, f, new_f, src, dest, src_cache = compaction_case(b=b,
                                                           budget=budget)
    L, N, b, h, d = k.shape
    # the port: pools with a sink page; padding/dropped slots go there
    sink = N
    dslots = np.where(dest >= 0, dest, sink)
    dslots[3] = sink
    dest_flat = (np.repeat(dslots, b, axis=1) * b
                 + np.tile(np.arange(b), dest.shape[1]))
    pools = {n: torch.from_numpy(np.concatenate(
        [a, np.zeros_like(a[:, :1])], axis=1)) for n, a in
        (("k", k), ("v", v), ("f", f))}
    ops.compact(pools["k"], pools["v"], pools["f"], t(new_f), t(src),
                t(src_cache), t(dest_flat))
    # the JAX package: the engine's _compact_pool per request, in order,
    # with out-of-range destinations dropped
    jdest = np.where(dslots == sink, 2**30 // b, dslots)
    jflat = (np.repeat(jdest, b, axis=1) * b
             + np.tile(np.arange(b), dest.shape[1]))
    heads = np.arange(h)[:, None]
    for l in range(L):
        kl, vl, fl = k[l], v[l], f[l].reshape(-1, h)
        for i in range(4):
            bt = np.maximum(src[i], 0)
            kl = _compact_pool(jnp.asarray(kl), bt, src_cache[l, i], jflat[i])
            vl = _compact_pool(jnp.asarray(vl), bt, src_cache[l, i], jflat[i])
            fl = jnp.asarray(fl).at[jflat[i][None, :], heads].set(
                new_f[l, i].T[heads, src_cache[l, i]], mode="drop")
        np.testing.assert_array_equal(pools["k"][l, :N].numpy(),
                                      np.asarray(kl))
        np.testing.assert_array_equal(pools["v"][l, :N].numpy(),
                                      np.asarray(vl))
        np.testing.assert_array_equal(pools["f"][l, :N].numpy(),
                                      np.asarray(fl).reshape(N, b, h))
        # what lands at a live request's destination is the gather of its
        # survivors from the pool before any move (compact_gather), through
        # the reference and the interpreted Pallas kernel alike
        flat0 = k[l].reshape(N * b, h, d)
        for i in range(3):
            slots = (np.maximum(src[i], 0)[src_cache[l, i] // b] * b
                     + src_cache[l, i] % b).astype(np.int32)
            rows = np.asarray(jref.compact_gather_ref(flat0, slots))
            np.testing.assert_array_equal(
                np.asarray(jops.compact_gather(flat0, slots,
                                               backend="pallas-interpret")),
                rows)
            got = pools["k"][l].reshape(-1, h, d)[t(dest_flat[i])].numpy()
            np.testing.assert_array_equal(got, rows)


def test_compaction_cuda_refuses_cpu_tensors():
    k, v, f, new_f, src, dest, src_cache = compaction_case()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cmp.compact_cuda(t(k), t(v), t(f), t(new_f), t(src), t(src_cache),
                         t(dest))


# ----------------------------------------------------------------------
# chunked decode (csrc/common.cuh): the decomposition the dense (B4) and
# ragged (K1) kernels share

NEG = np.float32(-1e30)


def merge_states(states):
    """Merge online-softmax states (m, l, acc) in order, skipping those
    with m == -1e30 (no valid position): the merge of csrc/common.cuh."""
    f32 = np.float32
    M = np.full_like(states[0][0], NEG)
    for m, _, _ in states:
        M = np.maximum(M, m)
    L = np.zeros_like(states[0][1])
    A = np.zeros_like(states[0][2])
    for m, l, acc in states:
        keep = m != NEG
        w = np.where(keep, np.exp(m - M), f32(0))
        L = np.where(keep, L + l * w, L)
        A = np.where(keep[:, None], A + acc * w[:, None], A)
    return M, L, A


def decode_by_chunks(q, kp, vp, bt, sl, chunk_pages, dense, rows=16,
                     warps=4):
    """Decode attention decomposed as csrc/common.cuh computes it, in
    float32: each slot's table cut into chunks of ``chunk_pages`` entries,
    a chunk walked in tiles of ``rows`` positions, each of ``warps`` warps
    taking rows // warps rows of a tile with its own online-softmax state;
    a chunk's warp states merged in warp order into the chunk's part, and
    the parts merged in chunk order. A position is valid iff it is below
    seq_len; a -1 table entry reads page 0 (the TPU kernels' clamp).
    ``dense`` walks every tile of every chunk; the ragged walk stops at
    seq_len, reads no table entry past ceil(seq_len / b) and merges the
    live chunks only."""
    f32 = np.float32
    B, hq, d = q.shape
    _, b, hkv, _ = kp.shape
    g = hq // hkv
    mb = bt.shape[1]
    wr = rows // warps
    n_chunks = max(1, -(-mb // chunk_pages))
    scale = f32(1.0 / np.sqrt(d))
    out = np.zeros((B, hq, d), f32)
    for i in range(B):
        L = max(int(sl[i]), 0)
        for h in range(hkv):
            qh = q[i, h * g:(h + 1) * g].astype(f32)
            parts = []
            for c in range(n_chunks):
                e0, e1 = c * chunk_pages, min((c + 1) * chunk_pages, mb)
                pos0, n_pos = e0 * b, max(e1 - e0, 0) * b
                if not dense:
                    if pos0 >= L:
                        break                 # a dead chunk: not walked
                    n_pos = min(n_pos, L - pos0)
                n_read = e1 - e0 if dense else min(e1, -(-L // b)) - e0
                st = [[np.full(g, NEG, f32), np.zeros(g, f32),
                       np.zeros((g, d), f32)] for _ in range(warps)]
                for t0 in range(0, n_pos, rows):
                    for w in range(warps):
                        K = np.zeros((wr, d), f32)
                        V = np.zeros((wr, d), f32)
                        valid = np.zeros(wr, bool)
                        for r in range(wr):
                            rel = t0 + w * wr + r
                            if rel >= n_pos:
                                continue
                            j = rel // b
                            e = int(bt[i, e0 + j]) if j < n_read else -1
                            valid[r] = pos0 + rel < L
                            if dense or valid[r]:
                                K[r] = kp[max(e, 0), rel % b, h]
                                V[r] = vp[max(e, 0), rel % b, h]
                        m, l, acc = st[w]
                        with np.errstate(invalid="ignore"):
                            s = (qh @ K.T) * scale                  # (g, wr)
                        s = np.where(valid[None], s, NEG)
                        m_new = np.maximum(m, s.max(1))
                        corr = np.exp(m - m_new)
                        p = np.where(valid[None], np.exp(s - m_new[:, None]),
                                     f32(0))
                        vz = np.where(valid[:, None], V, f32(0))
                        st[w] = [m_new, l * corr + p.sum(1),
                                 acc * corr[:, None] + p @ vz]
                parts.append(merge_states(st))
            if parts:                         # else seq_len == 0: zeros
                _, tot_l, tot = merge_states(parts)
                out[i, h * g:(h + 1) * g] = \
                    tot / np.maximum(tot_l, f32(1e-30))[:, None]
    return out


@pytest.mark.parametrize("chunk_pages", [1, 2, 4, 6])
@pytest.mark.parametrize("mix", range(len(LENGTH_MIXES)))
def test_decode_by_chunks_matches_pallas_and_walks_agree(chunk_pages, mix):
    """The chunked decode of the CUDA kernels equals the JAX package's
    dense decode, and its dense and ragged walks give the same bits on
    live rows (NaN page 0, NaN stale tails, seq_len == 0 rows), for chunks
    of 1, 2 and 4 table entries and one chunk over the whole table."""
    lens = LENGTH_MIXES[mix]
    q, kp, vp, bt, sl = make_case(8, 2, lens, seed=70 + mix, poison=True)
    _, kc, vc, _, _ = make_case(8, 2, lens, seed=70 + mix)
    want = np.asarray(jops.paged_decode_attention(
        q, kc, vc, bt, sl, backend="pallas-interpret"))
    dense = decode_by_chunks(q, kp, vp, bt, sl, chunk_pages, dense=True)
    ragged = decode_by_chunks(q, kp, vp, bt, sl, chunk_pages, dense=False)
    assert np.isfinite(dense).all() and np.isfinite(ragged).all()
    live = sl > 0
    np.testing.assert_allclose(dense[live], want[live], rtol=RTOL, atol=ATOL)
    assert np.array_equal(dense[live], ragged[live])
    assert np.all(dense[~live] == 0) and np.all(ragged[~live] == 0)
    np.testing.assert_allclose(
        ragged, ops.ragged_decode_attention(t(q), t(kp), t(vp), t(bt),
                                            t(sl)).numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_idle_slots_read_page_zero(hq, hkv):
    """A slot that decodes nothing still attends seq_len + 1 entries over
    an empty (all -1) table, as the serve passes it every step; a -1 entry
    below seq_len is page 0 in the JAX package's ragged and dense kernels
    (their clamp) and in the port's plain versions and chunked walks. The
    first rows are such idle slots, the last a live row with a -1 entry in
    the middle of its table."""
    lens = [1, 9, 17, 13]
    q, kp, vp, bt, sl = make_case(hq, hkv, lens, seed=80)
    bt[:3] = -1
    bt[3, 1] = -1
    ragged = ops.ragged_decode_attention(t(q), t(kp), t(vp), t(bt), t(sl))
    dense = ops.paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(sl))
    assert torch.equal(dense, ragged)
    for fn in (jops.ragged_decode_attention, jops.paged_decode_attention):
        want = np.asarray(fn(q, kp, vp, bt, sl, backend="pallas-interpret"))
        np.testing.assert_allclose(ragged.numpy(), want, rtol=RTOL,
                                   atol=ATOL)
    # row 0 attends the first entry of page 0 alone: its V there, per head
    np.testing.assert_allclose(
        ragged[0].numpy(), np.repeat(vp[0, 0], hq // hkv, axis=0),
        rtol=RTOL, atol=ATOL)
    for chunk_pages in (1, 6):
        for walk in (True, False):
            got = decode_by_chunks(q, kp, vp, bt, sl, chunk_pages, dense=walk)
            np.testing.assert_allclose(got, ragged.numpy(), rtol=RTOL,
                                       atol=ATOL)
