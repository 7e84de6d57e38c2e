"""The port's kernels, held against the JAX package's Pallas kernels.

On the CPU each kernel of ``repro_torch.kernels`` runs its plain PyTorch
version; here those are compared with ``repro.kernels.ops`` run through the
Pallas interpreter (``backend="pallas-interpret"``) on the same numpy
inputs, at GQA shapes (8, 2) and (32, 8), over length mixes with inactive
(seq_len == 0), sub-block, block-aligned and full-table rows, and with a
NaN-poisoned page 0 that no live row maps. The CUDA wrappers themselves
run only on a card (tests/test_torch_gpu.py); here they must refuse CPU
tensors rather than fall back.

Tolerance: atol = rtol = 1e-5 (fp32; the two frameworks sum the dot
products in different orders).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels import paged_score as ps
from repro_torch.kernels import ragged_paged_attention as rpa
from repro_torch.kernels import redundancy as red

ATOL = RTOL = 1e-5
GQA_SHAPES = [(8, 2), (32, 8)]
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
])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, args):
    """No fallback: a wrapper handed CPU tensors raises before any launch
    instead of running the plain version."""
    q, kp, vp, bt, sl = make_case(8, 2, [5, 0, 9], seed=1)
    qw = np.zeros((3, 4, 8, 16), np.float32)
    env = {"q": q, "kp": kp, "vp": vp, "bt": bt, "sl": sl, "qw": qw}
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(*[t(env[a]) for a in args.split()])
