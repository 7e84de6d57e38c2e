"""Tests of the port that need the card: each CUDA kernel against its plain
version on the same CUDA tensors, and the engine on the card against the
same engine on the CPU. They skip without a card and nvcc (decided in the
``cuda`` fixture, never at import). On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: atol = rtol = 1e-4 (fp32; the kernels sum in another order
than PyTorch's reductions). Card-vs-CPU logits: 1e-3. At bf16 inputs
(chip_smoke.kernel_tols): fp32 outputs 1e-5, bf16 outputs one ulp
(2**-7); card-vs-CPU bf16 logits a relative L2 of 2e-2. At fp16 inputs:
fp32 outputs 1e-5, fp16 outputs one fp16 ulp (2**-10); card-vs-CPU fp16
logits a relative L2 of 3e-3.

The head layouts of the other dense configs (g = 1 at h_kv 16, g = 6 at
h_kv 8, g = 8 at h_kv 2, d = 128) have kernel checks of their own, and each
of those configs runs at 2 layers of its full widths on the card and on the
CPU with equal greedy and seeded streams.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import compaction as cmp
from repro_torch.kernels import native, ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_score as ps
from repro_torch.kernels import ragged_paged_attention as rpa
from repro_torch.kernels import redundancy as red
from repro_torch.models import lm

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        native.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc to build the kernels")
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no nvidia-smi")
    native.build_all()
    return torch.device("cuda")


def _case(seed, seq_lens, hq=32, hkv=8, d=128, b=16, mb=8, n_pages=80):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    k[::2] = 0.3 * k[::2] + rng.normal(size=(n_pages // 2, 1, hkv, d))
    v = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    k[0] = v[0] = np.nan
    bt = np.full((len(seq_lens), mb), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(seq_lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
    q = rng.normal(size=(len(seq_lens), hq, d)).astype(np.float32)
    qw = rng.normal(size=(len(seq_lens), 4, hq, d)).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, qw, k, v, bt)] + [
        torch.tensor(seq_lens, dtype=torch.int32)]


def _close(got, want):
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lens", [[0, 1, 15, 16, 17, 100, 128, 0],
                                  [128] * 4, [0] * 4])
def test_kernels_match_plain_versions(cuda, lens):
    q, qw, k, v, bt, sl = [x.to(cuda) for x in _case(len(lens), lens)]
    before = dict(ops.launch_counts)
    got = ops.ragged_decode_attention(q, k, v, bt, sl)
    _close(got, rpa.ragged_paged_attention_plain(q, k, v, bt, sl))
    assert (got[sl == 0] == 0).all()
    _close(ops.score_logits(qw, k, bt, sl),
           ps.paged_score_logits_plain(qw, k, bt, sl))
    _close(ops.lightning_redundancy(k, bt, sl),
           red.lightning_redundancy_plain(k, bt, sl))
    torch.cuda.synchronize()
    for name in (rpa.NAME, ps.NAME, red.NAME):
        assert ops.launch_counts[name] == before[name] + 1


@pytest.mark.parametrize("lens", [[0, 1, 15, 16, 17, 100, 128, 0],
                                  [128] * 4, [0] * 4])
def test_dense_decode_matches_plain_and_ragged(cuda, lens):
    q, _, k, v, bt, sl = [x.to(cuda) for x in _case(len(lens), lens)]
    before = ops.launch_counts[pa.NAME]
    dense = ops.paged_decode_attention(q, k, v, bt, sl)
    _close(dense, pa.paged_attention_plain(q, k, v, bt, sl))
    ragged = ops.ragged_decode_attention(q, k, v, bt, sl)
    live = sl > 0
    assert torch.equal(dense[live], ragged[live])   # bit for bit
    assert (dense[~live] == 0).all()
    assert ops.launch_counts[pa.NAME] == before + 1


@pytest.mark.parametrize("lens", [[64, 17, 0, 128], [16, 128, 5, 33]])
def test_flash_redundancy_matches_plain(cuda, lens):
    _, _, k, _, bt, sl = [x.to(cuda) for x in _case(len(lens), lens)]
    got = ops.flash_redundancy(k, bt, sl, p_thresh=0.8)
    want = red.flash_redundancy_plain(k, bt, sl, p_thresh=0.8)
    _close(got, want)
    off = red.flash_redundancy_plain(k, bt, sl, p_thresh=2.0)
    assert (off != want).any()          # the zero-out fired
    again = ops.flash_redundancy(k, bt, sl, p_thresh=0.8)
    assert torch.equal(got, again)      # no atomics: the same every run


def _wide_case(seed, lens, mb, b=16, hkv=8, hq=32, d=128, w=4):
    """Pool with a NaN page 0 and NaN stale tails past each row's
    seq_len; each row's newest page is a near-duplicate of its oldest, so
    flash redundancy's zero-out crosses strips of 64 columns."""
    rng = np.random.default_rng(seed)
    n_pages = sum(-(-s // b) for s in lens) + 2
    k = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    bt = np.full((len(lens), mb), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
        if s > b:
            last = bt[i, (s - 1) // b]
            k[last] = k[bt[i, 0]] + 0.05 * rng.normal(size=(b, hkv, d))
        if s % b:
            k[bt[i, s // b], s % b:] = np.nan
    k[0] = np.nan
    qw = rng.normal(size=(len(lens), w, hq, d)).astype(np.float32)
    return [torch.from_numpy(a) for a in (qw, k, bt)] + [
        torch.tensor(lens, dtype=torch.int32)]


@pytest.mark.parametrize("mb,lens,shape", [
    (4, [64, 64], {}),                   # the serve's compressions
    (4, [64, 0, 17], {}),
    (5, [80, 37, 0], {}),                # tables of no power-of-two width
    (33, [528, 300, 0, 17], {}),
    (128, [2048, 1999], {}),             # the long input of chip_smoke.py
    (256, [4096, 4000, 1234, 0], {}),    # a table twice the long one
    (5, [40, 13, 0], dict(b=8, hkv=2, hq=4, d=32)),   # tiny-lm's heads
    (7, [112, 50], dict(d=96, w=3)),     # head_dim not a power of two
])
def test_flash_and_score_match_plain_on_wide_tables(cuda, mb, lens, shape):
    qw, k, bt, sl = [x.to(cuda) for x in _wide_case(mb, lens, mb, **shape)]
    before = dict(ops.launch_counts)
    got = ops.flash_redundancy(k, bt, sl, p_thresh=0.8)
    assert ops.launch_counts[red.FLASH_NAME] == before[red.FLASH_NAME] + 1
    want = red.flash_redundancy_plain(k, bt, sl, p_thresh=0.8)
    _close(got, want)
    assert (got[sl == 0] == 0).all()
    if max(lens) > 16:                  # the near-duplicate pages fire it
        assert (red.flash_redundancy_plain(k, bt, sl, p_thresh=2.0)
                != want).any()
    assert torch.equal(got, ops.flash_redundancy(k, bt, sl, p_thresh=0.8))
    del want
    before = dict(ops.launch_counts)
    logits = ops.score_logits(qw, k, bt, sl)
    assert ops.launch_counts[ps.NAME] == before[ps.NAME] + 1
    _close(logits, ps.paged_score_logits_plain(qw, k, bt, sl))


def _compaction_layout(rng, N, mb, budget):
    """Source tables and destination blocks of four requests, as the
    scheduler plans them: 0 and 1 share their first source block, so each
    compacts it into a fresh block and the rest in place (copy-on-write);
    2 compacts wholly in place, so ranks overlap their sources; 3 is a
    padding row (destination: the sink page N)."""
    free = [int(x) for x in rng.permutation(np.arange(1, N))]
    shared = free.pop()
    src = np.full((4, mb), -1, np.int32)
    src[0] = [shared] + [free.pop() for _ in range(mb - 1)]
    src[1] = [shared] + [free.pop() for _ in range(mb - 1)]
    src[2] = [free.pop() for _ in range(mb)]
    dest = np.full((4, budget), N)
    dest[0] = [free.pop()] + list(src[0, 1:budget])
    dest[1] = [free.pop()] + list(src[1, 1:budget])
    dest[2] = src[2, :budget]
    return src, dest


@pytest.mark.parametrize("budget,d", [(3, 128), (64, 128), (3, 32)])
def test_compaction_matches_sequential_plain(cuda, budget, d):
    """In place with overlapping ranks, a prefix-shared pair compacting
    copy-on-write, and a padding row, at Qwen3-8B head widths (k = 48 and
    k = 1024) and tiny-lm's head_dim, bit for bit on every page but the
    sink."""
    rng = np.random.default_rng(3)
    L, b, h = 3, 16, 8
    mb = budget + 1
    N = 3 * mb + 4
    T, kk = mb * b, budget * b
    pools = {n: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             for n, shape in (("k", (L, N + 1, b, h, d)),
                              ("v", (L, N + 1, b, h, d)),
                              ("f", (L, N + 1, b, h)))}
    src, dest = _compaction_layout(rng, N, mb, budget)
    src = torch.from_numpy(src)
    dest_flat = torch.from_numpy(np.repeat(dest, b, axis=1) * b
                                 + np.tile(np.arange(b), budget))
    src_cache = torch.from_numpy(np.sort(np.argsort(
        rng.random((L, 4, h, T)), axis=-1)[..., :kk], axis=-1))
    new_f = torch.from_numpy(rng.uniform(size=(L, 4, T, h)).astype(
        np.float32))
    want = {n: x.clone() for n, x in pools.items()}
    cmp.compact_plain(want["k"], want["v"], want["f"], new_f, src,
                      src_cache, dest_flat)
    got = {n: x.to(cuda) for n, x in pools.items()}
    before = ops.launch_counts[cmp.NAME]
    ops.compact(got["k"], got["v"], got["f"], new_f.to(cuda), src.to(cuda),
                src_cache.to(cuda), dest_flat.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts[cmp.NAME] == before + 1
    for n in pools:       # the sink page N is garbage on both sides
        assert torch.equal(got[n][:, :N].cpu(), want[n][:, :N]), n


def test_compaction_refuses_head_dim_not_a_multiple_of_4(cuda):
    L, N, b, h, d, mb, budget = 1, 8, 4, 2, 6, 2, 1
    pools = [torch.zeros(L, N + 1, b, h, d, device=cuda) for _ in range(2)]
    f = torch.zeros(L, N + 1, b, h, device=cuda)
    new_f = torch.zeros(L, 1, mb * b, h, device=cuda)
    src = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    sc = torch.arange(budget * b, device=cuda).expand(L, 1, h, -1)
    dest = torch.arange(b, 2 * b, device=cuda)[None]
    before = ops.launch_counts[cmp.NAME]
    with pytest.raises(ValueError, match="multiple of 4"):
        cmp.compact_cuda(*pools, f, new_f, src, sc, dest)
    assert ops.launch_counts[cmp.NAME] == before


def test_wrappers_refuse_bad_inputs(cuda):
    q, qw, k, v, bt, sl = [x.to(cuda) for x in _case(0, [5, 9])]
    with pytest.raises(ValueError, match="int32"):
        rpa.ragged_paged_attention_cuda(q, k, v, bt.long(), sl)
    with pytest.raises(ValueError, match="contiguous"):
        ps.paged_score_logits_cuda(qw.transpose(1, 2), k, bt, sl)


def test_engine_on_card_matches_cpu(cuda):
    from repro_torch.api import SamplingParams, Zipage
    cfg = get_config("tiny-lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = dict(block_size=8, n_total_blocks=64, max_batch=4,
                  max_model_len=128, prefill_rows=2, prefill_len=64)
    prompts = [[1, 2, 3, 4, 5] * 6, list(range(10, 50))]
    sp = SamplingParams(max_new_tokens=24)
    on_cpu = Zipage(cfg, params, device="cpu", **shapes).generate(prompts, sp)
    on_card = Zipage(cfg, _to(params, cuda), **shapes).generate(prompts, sp)
    assert [o.token_ids for o in on_card] == [o.token_ids for o in on_cpu]
    assert min(o.metrics.compression.n_compressions for o in on_card) > 0


def test_engine_on_card_matches_cpu_at_a_budget_of_32_blocks(cuda):
    """n_max = 33 at Qwen3-8B widths (2 layers): each compaction moves
    k = 512 rows a (layer, request, head), more than a kernel staging a
    whole stripe in shared memory could take. Greedy streams on the card
    equal the CPU's, and every request compresses."""
    import dataclasses

    from repro_torch.api import SamplingParams, Zipage
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="float32")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(6)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
               for n in (560, 601)]
    sp = SamplingParams(max_new_tokens=24)
    knobs = dict(n_max=33, max_model_len=1024, max_batch=2)
    on_cpu = Zipage(cfg, params, device="cpu", **knobs).generate(prompts, sp)
    before = ops.launch_counts[cmp.NAME]
    on_card = Zipage(cfg, _to(params, cuda), **knobs).generate(prompts, sp)
    assert [o.token_ids for o in on_card] == [o.token_ids for o in on_cpu]
    assert min(o.metrics.compression.n_compressions for o in on_card) > 0
    assert ops.launch_counts[cmp.NAME] > before


def test_second_path_and_seeded_streams_on_card_match_cpu(cuda):
    """Dense decode + flash redundancy, greedy and seeded: the threefry
    noise is the same on both devices, so the streams are too."""
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.core.compression import CompressOptions
    cfg = get_config("tiny-lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = dict(block_size=8, n_total_blocks=64, max_batch=4,
                  max_model_len=128, prefill_rows=2, prefill_len=64,
                  decode_kernel="dense",
                  compress=CompressOptions(window=4, redundancy="flash"))
    prompts = [[1, 2, 3, 4, 5] * 6, list(range(10, 50))]
    sp = [SamplingParams(max_new_tokens=24),
          SamplingParams(max_new_tokens=24, temperature=0.6, top_p=0.95,
                         top_k=20, seed=7)]
    on_cpu = Zipage(cfg, params, device="cpu", **shapes).generate(prompts, sp)
    ops.reset_launch_counts()
    on_card = Zipage(cfg, _to(params, cuda), **shapes).generate(prompts, sp)
    assert [o.token_ids for o in on_card] == [o.token_ids for o in on_cpu]
    for name in (pa.NAME, red.FLASH_NAME, cmp.NAME, ps.NAME):
        assert ops.launch_counts[name] > 0, name


def _to(t, dev):
    if isinstance(t, dict):
        return {k: _to(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_to(v, dev) for v in t]
    return t.to(dev)


def _decode_case(seed, lens, mb, hq=32, hkv=8, d=128, b=16):
    """A decode input at Qwen3-8B heads: -1 padded tables, a NaN page 0
    and NaN stale tails past each slot's seq_len."""
    rng = np.random.default_rng(seed)
    n_pages = sum(-(-s // b) for s in lens) + 2
    k = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    bt = np.full((len(lens), mb), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
        if s % b:
            k[bt[i, s // b], s % b:] = v[bt[i, s // b], s % b:] = np.nan
    k[0] = v[0] = np.nan
    q = rng.normal(size=(len(lens), hq, d)).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k, v, bt)] + [
        torch.tensor(lens, dtype=torch.int32)]


LONG_DECODE_LENS = [2048, 1999, 1536, 1024, 777, 512, 300, 64] + [0] * 8


@pytest.mark.parametrize("mb,lens", [
    (8, [128, 1, 77, 0, 16, 100, 0, 5] * 16),  # 128 slots: one chunk a table
    (128, LONG_DECODE_LENS),                  # chip_smoke.py's long input
])
def test_chunked_decode_matches_plain_and_ragged(cuda, mb, lens):
    q, k, v, bt, sl = [x.to(cuda) for x in _decode_case(mb, lens, mb)]
    before = dict(ops.launch_counts)
    dense = ops.paged_decode_attention(q, k, v, bt, sl)
    ragged = ops.ragged_decode_attention(q, k, v, bt, sl)
    torch.cuda.synchronize()
    for name in (pa.NAME, rpa.NAME):
        assert ops.launch_counts[name] == before[name] + 1
    live = sl > 0
    _close(dense[live], pa.paged_attention_plain(q, k, v, bt, sl)[live])
    _close(ragged, rpa.ragged_paged_attention_plain(q, k, v, bt, sl))
    assert torch.equal(dense[live], ragged[live])   # bit for bit
    assert (dense[~live] == 0).all() and (ragged[~live] == 0).all()
    assert torch.equal(dense, ops.paged_decode_attention(q, k, v, bt, sl))


def _light_case(seed, lens, mb, b, hkv=8, d=128):
    """Keys whose pages hold near-duplicates (the zero-out fires), a NaN
    page 0 and NaN stale tails."""
    rng = np.random.default_rng(seed)
    n_pages = sum(-(-s // b) for s in lens) + 2
    k = (0.35 * rng.normal(size=(n_pages, b, hkv, d))
         + rng.normal(size=(n_pages, 1, hkv, d))).astype(np.float32)
    bt = np.full((len(lens), mb), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
        if s % b:
            k[bt[i, s // b], s % b:] = np.nan
    k[0] = np.nan
    return [torch.from_numpy(a) for a in (k, bt)] + [
        torch.tensor(lens, dtype=torch.int32)]


@pytest.mark.parametrize("b,mb,lens", [
    (8, 8, [64, 13, 0]),
    (16, 4, [64, 64]),                   # the serve's compressions
    (32, 3, [96, 40, 0, 7]),
    (64, 2, [128, 70]),
    (16, 128, [2048, 1999]),             # the long input of chip_smoke.py
])
def test_lightning_redundancy_matches_plain(cuda, b, mb, lens):
    k, bt, sl = [x.to(cuda) for x in _light_case(b, lens, mb, b)]
    before = ops.launch_counts[red.NAME]
    got = ops.lightning_redundancy(k, bt, sl, p_thresh=0.8)
    assert ops.launch_counts[red.NAME] == before + 1
    want = red.lightning_redundancy_plain(k, bt, sl, p_thresh=0.8)
    _close(got, want)
    assert (red.lightning_redundancy_plain(k, bt, sl, p_thresh=2.0)
            != want).any()                 # the zero-out fired
    assert torch.equal(got, ops.lightning_redundancy(k, bt, sl,
                                                     p_thresh=0.8))


#: (h_q, h_kv) of OLMo-1B (g = 1), Nemotron-4-15B (g = 6), Qwen2.5-3B (g = 8)
HEAD_LAYOUTS = [(16, 16), (48, 8), (16, 2)]


@pytest.mark.parametrize("hq,hkv", HEAD_LAYOUTS)
def test_kernels_match_plain_at_head_layouts(cuda, hq, hkv):
    """All six kernels against their plain versions at a config's head
    layout (d = 128, b = 16): a NaN page 0, NaN stale tails and seq_len ==
    0 rows; dense == ragged bit for bit on live rows; B6 bit for bit."""
    lens = [0, 1, 15, 16, 17, 100, 128, 0, 64, 33]
    q, qw, k, v, bt, sl = [x.to(cuda) for x in _case(5, lens, hq=hq,
                                                     hkv=hkv)]
    ragged = ops.ragged_decode_attention(q, k, v, bt, sl)
    _close(ragged, rpa.ragged_paged_attention_plain(q, k, v, bt, sl))
    dense = ops.paged_decode_attention(q, k, v, bt, sl)
    live = sl > 0
    _close(dense[live], pa.paged_attention_plain(q, k, v, bt, sl)[live])
    assert torch.equal(dense[live], ragged[live])
    assert (ragged[~live] == 0).all() and (dense[~live] == 0).all()
    _close(ops.score_logits(qw, k, bt, sl),
           ps.paged_score_logits_plain(qw, k, bt, sl))
    for fn, plain in ((ops.lightning_redundancy,
                       red.lightning_redundancy_plain),
                      (ops.flash_redundancy, red.flash_redundancy_plain)):
        got = fn(k, bt, sl, p_thresh=0.8)
        _close(got, plain(k, bt, sl, p_thresh=0.8))
        assert torch.equal(got, fn(k, bt, sl, p_thresh=0.8))
    rng = np.random.default_rng(hkv)
    L, b, d, budget = 2, 16, 128, 3
    mb = budget + 1
    N = 3 * mb + 4
    T, kk = mb * b, budget * b
    pools = {n: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             for n, shape in (("k", (L, N + 1, b, hkv, d)),
                              ("v", (L, N + 1, b, hkv, d)),
                              ("f", (L, N + 1, b, hkv)))}
    src, dest = _compaction_layout(rng, N, mb, budget)
    src = torch.from_numpy(src)
    dest_flat = torch.from_numpy(np.repeat(dest, b, axis=1) * b
                                 + np.tile(np.arange(b), budget))
    src_cache = torch.from_numpy(np.sort(np.argsort(
        rng.random((L, 4, hkv, T)), axis=-1)[..., :kk], axis=-1))
    new_f = torch.rand(L, 4, T, hkv, generator=torch.Generator().manual_seed(
        hkv))
    want = {n: x.clone() for n, x in pools.items()}
    cmp.compact_plain(want["k"], want["v"], want["f"], new_f, src,
                      src_cache, dest_flat)
    got = {n: x.to(cuda) for n, x in pools.items()}
    ops.compact(got["k"], got["v"], got["f"], new_f.to(cuda), src.to(cuda),
                src_cache.to(cuda), dest_flat.to(cuda))
    for n in pools:
        assert torch.equal(got[n][:, :N].cpu(), want[n][:, :N]), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_recurrentgemma_layout(cuda, dtype):
    """K1 and B4 at RecurrentGemma-2B's layout (g = 10, h_kv = 1, d = 256,
    the G = 16 instantiations masking heads 10 .. 15) over a 128-block
    ring: full and partly filled rings and seq_len 0 rows against the
    plain versions; dense == ragged bit for bit on live rows."""
    lens = [2048, 2048, 1999, 777, 17, 1, 0]
    q, _, k, v, bt, sl = _case(14, lens, hq=10, hkv=1, d=256, mb=128,
                               n_pages=700)
    q, k, v = (x.to(cuda, dtype) for x in (q, k, v))
    bt, sl = bt.to(cuda), sl.to(cuda)
    ragged = ops.ragged_decode_attention(q, k, v, bt, sl)
    dense = ops.paged_decode_attention(q, k, v, bt, sl)
    tol = TOL if dtype == torch.float32 else 2.0 ** -7
    for got, plain in ((ragged, rpa.ragged_paged_attention_plain),
                       (dense, pa.paged_attention_plain)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float().cpu(),
                                   plain(q, k, v, bt, sl).float().cpu(),
                                   rtol=tol, atol=tol)
    live = sl > 0
    assert torch.equal(dense[live], ragged[live])
    assert (ragged[~live] == 0).all() and (dense[~live] == 0).all()


@pytest.mark.parametrize("hq,hkv", [(16, 16), (32, 8)])
def test_idle_slots_match_plain(cuda, hq, hkv):
    """What the serve passes for slots that decode nothing: seq_len 1 (a
    never-used slot) or a stale seq_len over an empty table, and a -1
    entry below seq_len in a live table. A -1 entry below seq_len is page
    0, as the TPU kernels clamp it; page 0 holds finite data, as in a
    serve. K1 once returned zeros for such rows where its plain version
    read page 0 (16384 entries off by up to 4.3 at OLMo-1B's serve input,
    g = 1); here both decode kernels equal the plain versions and each
    other."""
    lens = [1, 1, 57, 130, 16, 40, 0, 9]
    q, _, k, v, bt, sl = _case(9, lens, hq=hq, hkv=hkv, mb=16, n_pages=80)
    k[0] = torch.randn_like(k[0])
    v[0] = torch.randn_like(v[0])
    bt[:4] = -1
    bt[4, 0] = -1
    q, k, v, bt, sl = [x.to(cuda) for x in (q, k, v, bt, sl)]
    ragged = ops.ragged_decode_attention(q, k, v, bt, sl)
    dense = ops.paged_decode_attention(q, k, v, bt, sl)
    want = rpa.ragged_paged_attention_plain(q, k, v, bt, sl)
    _close(ragged, want)
    _close(dense, pa.paged_attention_plain(q, k, v, bt, sl))
    assert torch.equal(dense, ragged)
    assert (ragged[:4].abs().amax(dim=(1, 2)) > 0).all()


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2.5-3b", "llama3-8b",
                                  "nemotron-4-15b"])
def test_config_on_card_matches_cpu_at_2_layers(cuda, name):
    """2 layers of the config at its full widths and head layout (the
    vocabulary capped at 65536 for the CPU side's memory): two greedy and
    one seeded stream equal on the card and the CPU, compression firing."""
    import dataclasses

    from repro_torch.api import SamplingParams, Zipage
    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                              vocab_size=min(cfg.vocab_size, 65536))
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
               for n in (70, 96, 81)]
    sps = [SamplingParams(max_new_tokens=24)] * 2 + [SamplingParams(
        max_new_tokens=24, temperature=0.6, top_p=0.95, top_k=20, seed=7)]
    on_cpu = Zipage(cfg, params, device="cpu", max_batch=4).generate(
        prompts, sps)
    on_card = Zipage(cfg, _to(params, cuda), max_batch=4).generate(prompts,
                                                                   sps)
    assert [o.token_ids for o in on_card] == [o.token_ids for o in on_cpu]
    assert min(o.metrics.compression.n_compressions for o in on_card) > 0


# ----------------------------------------------------------------------
# CUDA graphs of the fused decode chunk (core/decode_graphs.py)


@pytest.mark.parametrize("greedy", [True, False])
def test_graph_replay_equals_eager_bit_for_bit(cuda, greedy):
    """chip_smoke.py's check at 2 layers of Qwen3-8B widths: a fused chunk
    of 4 replayed from its CUDA graph and run eagerly, on clones of one
    state, at offsets 0 and 4, with an eos mid-chunk and idle slots.
    Tokens, logprobs and the state (but the sink page and sink query
    slot) are the same bits, the rows decode their caps, and the replays'
    K1 launches are counted while the warm-up's and capture's are not."""
    import dataclasses
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="float32")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    chip_smoke.check_graph_vs_eager(torch, cuda, cfg, params, greedy)


def test_engine_at_decode_steps_8_on_card_matches_cpu_unfused(cuda):
    """tiny-lm, greedy and seeded (top-k, top-p) requests with compression
    firing: the card's K = 8 engine, every chunk a graph replay, and the
    card's unfused engine give the CPU unfused engine's tokens, finish
    reasons and logprobs (1e-4)."""
    from repro_torch.api import SamplingParams, Zipage
    cfg = get_config("tiny-lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = dict(block_size=8, n_total_blocks=64, max_batch=4, m_qslots=4,
                  n_max=3, max_model_len=256, prefill_rows=2,
                  prefill_len=64)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [10, 11, 12, 13, 14, 15, 16],
               [20, 21]]
    sps = [SamplingParams(max_new_tokens=28),
           SamplingParams(max_new_tokens=28, temperature=0.8, top_k=5,
                          seed=7, logprobs=True),
           SamplingParams(max_new_tokens=28, temperature=1.1, top_p=0.9,
                          seed=3),
           SamplingParams(max_new_tokens=28, logprobs=True)]
    want = Zipage(cfg, params, device="cpu", fuse_sampling=False,
                  **shapes).generate(prompts, sps)
    ops.reset_launch_counts()
    z = Zipage(cfg, _to(params, cuda), decode_steps=8, **shapes)
    got = z.generate(prompts, sps)
    unfused = Zipage(cfg, _to(params, cuda), fuse_sampling=False,
                     **shapes).generate(prompts, sps)
    for run in (got, unfused):
        assert [o.token_ids for o in run] == [o.token_ids for o in want]
        assert [o.finish_reason for o in run] == [o.finish_reason
                                                  for o in want]
        for a, b in zip(run, want):
            if a.logprobs is not None:
                np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=TOL,
                                           atol=TOL)
    assert max(m["decode_horizon"] for m in z.metrics) > 1
    assert z.engine._graphs.replays > 0
    assert ops.launch_counts[rpa.NAME] > 0
    assert min(o.metrics.compression.n_compressions for o in got) > 0


def test_snapshot_on_card_restores_into_a_captured_engine(cuda):
    """A snapshot taken mid-horizon on the card restores into a fresh card
    engine whose graphs were captured before the restore: its buffers stay
    where they were, and the streams continue as the uninterrupted run."""
    from repro_torch.core.engine import EngineOptions, ZipageEngine
    from repro_torch.core.sampling import SamplingParams
    cfg = get_config("tiny-lm")
    params = _to(lm.init(cfg, torch.Generator().manual_seed(0), "cpu"), cuda)
    opts = EngineOptions(block_size=8, n_total_blocks=64, max_batch=4,
                         m_qslots=4, n_max=3, max_model_len=256,
                         prefill_rows=2, prefill_len=64, decode_steps=8)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [10, 11, 12]]
    sps = [SamplingParams(max_new_tokens=28),
           SamplingParams(max_new_tokens=28, temperature=0.6, top_p=0.95,
                          top_k=20, seed=5, eos_ids=(3, 4, 5)),
           SamplingParams(max_new_tokens=28, logprobs=True)]
    eng = ZipageEngine(cfg, params, opts)
    rids = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
    for _ in range(3):
        eng.step()
    assert any(m["decode_horizon"] > 1 for m in eng.metrics)
    snap = eng.snapshot()
    done_a = eng.run(max_steps=500)
    fresh = ZipageEngine(cfg, params, opts)
    assert fresh._graphs.graphs            # captured at init
    ptrs = {k: v.data_ptr() for k, v in fresh.state.items()
            if isinstance(v, torch.Tensor)}
    fresh.restore(snap)
    assert ptrs == {k: v.data_ptr() for k, v in fresh.state.items()
                    if isinstance(v, torch.Tensor)}
    done_b = fresh.run(max_steps=500)
    assert [(done_b[r].output, done_b[r].logprobs) for r in rids] == \
        [(done_a[r].output, done_a[r].logprobs) for r in rids]
    assert fresh._graphs.replays > 0


# ----------------------------------------------------------------------
# the host swap tier and compressed-prefix caching (chip_smoke.py phase 4)


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def tiny(cuda):
    cfg = get_config("tiny-lm")
    p_cpu = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, p_cpu, _to(p_cpu, cuda)


@pytest.mark.parametrize("check", ["block_round_trip", "swap_streams",
                                   "swap_snapshot", "adoption"])
def test_memory_checks_on_card(cuda, tiny, check):
    """chip_smoke.py's phase 4 checks of the host swap tier and of
    compressed-prefix adoption, at tiny-lm: a block round trip through the
    pinned host pool bit for bit; a swap-mode serve on the card equal to
    the CPU's; a snapshot with a swapped request restored into a captured
    card engine; segment adoption on the card equal to the CPU's."""
    cs = _chip_smoke()
    cfg, p_cpu, p_dev = tiny
    args = {"block_round_trip": (cfg, p_dev),
            "swap_streams": (cfg, p_cpu, p_dev),
            "swap_snapshot": (cfg, p_dev),
            "adoption": (cfg, p_cpu, p_dev)}[check]
    getattr(cs, f"check_{check}")(torch, cuda, *args)


# ----------------------------------------------------------------------
# Whisper-tiny's layout (g = 1, h_kv = 6, d = 64) and its cross-attention
# state under CUDA graphs (chip_smoke.py phase 15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_at_whisper_layout(cuda, dtype):
    """chip_smoke.py's 15a: all six kernels against their plain versions
    at Whisper-tiny's layout (g = 1, h_kv = 6, d = 64) over the phase 3
    length mixes, B4 == K1 bit for bit on live rows and on idle slots, B6
    bit for bit at k = 48 and 1024."""
    import dataclasses

    from repro_torch.core.engine import EngineOptions
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("whisper-tiny"), dtype="float32")
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.num_kv_heads,
            cfg.head_dim) == (1, 6, 64)
    before = dict(ops.launch_counts)
    cs.phase_kernels(torch, cuda, cfg, EngineOptions(),
                     phase=f"whisper {dtype}", dtype=dtype)
    assert all(ops.launch_counts[k] > before[k] for k in ops.KERNELS)


def test_whisper_graph_replay_across_a_cross_kv_rewrite(cuda):
    """chip_smoke.py's 15b graph check at Whisper-tiny's full width and
    depth, fp32: a fused chunk of 4 captured, the cross-attention KV of
    two live slots rewritten in place by a prefill over new frames, then
    replay == eager bit for bit (tokens, logprobs, pools, cross_kv), and
    those slots' logprobs moved: the replay read the new cross KV."""
    import dataclasses
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("whisper-tiny"), dtype="float32")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    cs.check_cross_graph(torch, cuda, cfg, params)


# ----------------------------------------------------------------------
# bfloat16: the kernels' bf16 variants and the bf16 serve


@pytest.mark.parametrize("name", ["qwen3-8b", "olmo-1b", "nemotron-4-15b",
                                  "qwen2.5-3b"])
def test_kernels_match_plain_at_bf16(cuda, name):
    """chip_smoke.py's phase 3 at bf16 inputs, at the config's head layout
    (g = 4, 1, 6, 8): all six kernels against their plain versions (fp32
    outputs to 1e-5, bf16 outputs to one ulp, B6 bit for bit), B4 == K1 bit
    for bit on live rows, the idle-slot case, B6 at k = 48 and 1024."""
    import dataclasses

    from repro_torch.core.engine import EngineOptions
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    before = dict(ops.launch_counts)
    cs.phase_kernels(torch, cuda, cfg, EngineOptions(), phase=f"bf16 {name}",
                     dtype=torch.bfloat16)
    assert all(ops.launch_counts[k] > before[k] for k in ops.KERNELS)


@pytest.mark.parametrize("greedy", [True, False])
def test_graph_replay_equals_eager_at_bf16(cuda, greedy):
    """The fused chunk's graph replay against the eager chunk, bit for bit,
    at 2 layers of Qwen3-8B widths with bf16 weights, pools and windows."""
    import dataclasses
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="bfloat16")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    assert params["layers"][0]["ffn"]["w1"].dtype == torch.bfloat16
    cs.check_graph_vs_eager(torch, cuda, cfg, params, greedy)


def test_card_matches_cpu_at_bf16(cuda):
    """2 layers of Qwen3-8B widths at bf16 (vocabulary capped at 65536 for
    the CPU side): logits card against CPU within a relative L2 of 2e-2;
    the card's K = 8 streams equal its K = 1 streams bit for bit."""
    import dataclasses
    cs = _chip_smoke()
    cfg = get_config("qwen3-8b")
    small = dataclasses.replace(cfg, num_layers=2, dtype="bfloat16",
                                vocab_size=min(cfg.vocab_size, 65536))
    p_cpu = lm.init(small, torch.Generator().manual_seed(0), "cpu")
    p_dev = _to(p_cpu, cuda)
    worst = cs.check_logits(torch, cuda, small, p_cpu, p_dev, "bf16",
                            "qwen3-8b widths")
    assert worst <= cs.BF16_REL_L2
    cs.check_streams_bf16(torch, cuda, small, p_cpu, p_dev)


def test_ties_go_to_the_lowest_id_on_card(cuda):
    """On tied bf16 logits the card's greedy argmax, its stable descending
    sort and a top-k = 1 draw give the CPU's answers: the lowest id
    first."""
    from repro_torch.core.sampling import sample_batch
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 4096)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    for i in range(4):
        x[i, torch.from_numpy(rng.choice(4096, 3 + i, replace=False))] = 5.0
    want = torch.argmax(x, -1)
    assert torch.equal(torch.argmax(x.to(cuda), -1).cpu(), want)
    order = torch.sort(x, dim=-1, descending=True, stable=True)[1]
    got = torch.sort(x.to(cuda), dim=-1, descending=True, stable=True)[1]
    assert torch.equal(got.cpu(), order)
    ones = torch.ones(4, device=cuda)
    uniforms = torch.full((4, 4096), 0.5, device=cuda)
    tok, _ = sample_batch(x.to(cuda), uniforms, ones,
                          torch.ones(4, dtype=torch.int32, device=cuda), ones)
    assert torch.equal(tok.cpu(), want)


# ----------------------------------------------------------------------
# float16: the kernels' fp16 entries and the fp16 serve (chip_smoke.py
# phase 16)


def test_kernels_match_plain_at_fp16(cuda):
    """chip_smoke.py's 16a: the six kernels' ``_f16`` entries against their
    plain versions at the shapes of phases 3, 13b, 14a and 15a (g = 1, 4,
    6, 8 and 10; d = 64, 128 and 256; MLA's 512- and 576-wide entries):
    fp32 outputs to 1e-5, fp16 outputs to one fp16 ulp (2**-10), B6 and
    B4 == K1 bit for bit; every launch resolves an ``_f16`` entry."""
    import dataclasses

    from repro_torch.core.engine import EngineOptions
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("qwen3-8b"), dtype="float32")
    before = dict(ops.launch_counts)
    with cs.EntrySpy() as spy:
        errs = cs.phase_fp16_kernels(torch, cuda, cfg, EngineOptions())
    assert all(ops.launch_counts[k] > before[k] for k in ops.KERNELS)
    assert set(spy.entries) == {k + "_launch_f16" for k in ops.KERNELS}
    assert set(errs) == set(ops.KERNELS)


@pytest.mark.parametrize("greedy", [True, False])
def test_graph_replay_equals_eager_at_fp16(cuda, greedy):
    """The fused chunk's graph replay against the eager chunk, bit for bit,
    at 2 layers of Qwen3-8B widths with fp16 weights, pools and windows."""
    import dataclasses
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="float16")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    assert params["layers"][0]["ffn"]["w1"].dtype == torch.float16
    assert params["final_norm"]["scale"].dtype == torch.float32
    cs.check_graph_vs_eager(torch, cuda, cfg, params, greedy)


def test_card_matches_cpu_at_fp16(cuda):
    """2 layers of Qwen3-8B widths at fp16 (vocabulary capped at 65536 for
    the CPU side): logits card against CPU within a relative L2 of 3e-3;
    the card's K = 8 streams equal its K = 1 streams bit for bit. The
    CPU's fp16 products go through ``chip_smoke.cpu_fp16_gemm``."""
    import dataclasses
    cs = _chip_smoke()
    cfg = get_config("qwen3-8b")
    small = dataclasses.replace(cfg, num_layers=2, dtype="float16",
                                vocab_size=min(cfg.vocab_size, 65536))
    p_cpu = lm.init(small, torch.Generator().manual_seed(0), "cpu")
    assert p_cpu["layers"][0]["attn"]["wq"].dtype == torch.float16
    p_dev = _to(p_cpu, cuda)
    worst = cs.check_logits(torch, cuda, small, p_cpu, p_dev, "fp16",
                            "qwen3-8b widths")
    assert worst <= cs.FP16_REL_L2
    cs.check_streams_bf16(torch, cuda, small, p_cpu, p_dev, phase="fp16")


# ----------------------------------------------------------------------
# the async surface and the HTTP tier on the card (chip_smoke.py phase 11)


@pytest.fixture(scope="module")
def qwen_2l(cuda):
    """A 2-layer Qwen3-8B-width engine at the engine defaults, its phase 5
    prompts, and their generate() outputs (256 greedy tokens, compression
    firing)."""
    import dataclasses

    from repro_torch.api import SamplingParams, Zipage
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="float32")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    z = Zipage(cfg, params)
    prompts = cs.make_prompts(cfg)
    sps = [SamplingParams(max_new_tokens=256)] * len(prompts)
    refs = z.generate(prompts, sps)
    assert min(o.metrics.compression.n_compressions for o in refs) > 0
    return cs, z, prompts, sps, refs


def test_async_burst_equals_generate_on_card(qwen_2l):
    """Every request through generate_async at once: the decode graphs
    replay on the loop's worker thread, and tokens, finish reasons and
    usage equal generate()'s bit for bit."""
    import asyncio
    cs, z, prompts, sps, refs = qwen_2l
    replays = z.engine._graphs.replays

    async def main():
        await cs.async_burst(z, prompts, sps, refs)
        await z._aio.drain()

    asyncio.run(main())
    assert z.engine._graphs.replays > replays
    assert z.num_free_blocks == z.engine.opts.n_total_blocks


def test_recapture_on_the_worker_thread_mid_serve(qwen_2l):
    """While four requests stream, a fifth whose eos ids widen the pad from
    1 to 4 makes the step on the loop's worker thread capture every decode
    graph anew; all five streams equal generate()'s."""
    import asyncio
    cs, z, prompts, _sps, refs = qwen_2l

    async def main():
        got = await cs.stream_with_recapture(z, prompts, refs, 4, 256)
        await z._aio.drain()
        return got

    captured, keys = asyncio.run(main())
    assert {name for name, *_ in captured} == {"zipage-step_0"}
    assert keys == [(1, False, 4), (1, True, 4)]


def test_http_streams_equal_generate_on_card(qwen_2l):
    """The port's app on its stdlib server at a loopback port: eight SSE
    streams equal generate()'s, a unary request its SSE twin, a hang-up
    aborts and reclaims, a drain finishes in-flight requests and leaves
    the pool full and the sanitizer clean."""
    import asyncio
    cs, z, prompts, _sps, refs = qwen_2l
    served = asyncio.run(cs.http_serve(torch, z, prompts, refs, 256))
    assert served["tokens"] == 256 * len(prompts)


# ----------------------------------------------------------------------
# training and the eval on the card (chip_smoke.py phase 12)


def _train_cfg():
    import dataclasses
    return dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2,
                               dtype="float32", vocab_size=4096)


def test_train_steps_on_card_match_cpu(cuda):
    """Three steps at ``accum_steps=2`` from one init at Qwen2.5-3B's
    widths, 2 layers, a 4096-token vocabulary, fp32: losses and gradient
    norms within 1e-3 relative, the params within 1e-3."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.train_loop import build_train_step

    cs = _chip_smoke()
    cfg = _train_cfg()
    step = build_train_step(cfg, opt.AdamWConfig(lr=3e-4, warmup_steps=2),
                            accum_steps=2, vocab_chunk=64)
    dc = DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)
    p_cpu = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    p_dev = cs._tree_to(cs._tree_clone(p_cpu), cuda)
    s_cpu, s_dev = opt.init_opt_state(p_cpu), opt.init_opt_state(p_dev)
    for i in range(3):
        p_dev, s_dev, _, m_dev = step(p_dev, s_dev, None, batch_at(dc, i))
        p_cpu, s_cpu, _, m_cpu = step(p_cpu, s_cpu, None, batch_at(dc, i))
        assert m_dev["loss"].device.type == "cuda"
        for key in ("loss", "grad_norm"):
            assert float(m_dev[key]) == pytest.approx(float(m_cpu[key]),
                                                      rel=1e-3)
    for a, b in zip(opt.tree_leaves(p_dev), opt.tree_leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)


def test_restore_on_card_is_bit_for_bit(cuda, tmp_path):
    """A bf16 model's fp32 master params and optimizer state saved from
    the card after a step and restored into a fresh tree on the card:
    equal bits and digests; and a bf16 leaf, stored as its 16-bit
    pattern, restored bit for bit."""
    import dataclasses

    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.train_loop import build_train_step

    cfg = dataclasses.replace(_train_cfg(), dtype="bfloat16")
    p = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                dtype=torch.float32)
    st = opt.init_opt_state(p)
    step = build_train_step(cfg, opt.AdamWConfig(lr=3e-4, warmup_steps=2),
                            vocab_chunk=64)
    dc = DataConfig(seq_len=32, global_batch=2, vocab_size=cfg.vocab_size)
    p, st, _, _ = step(p, st, None, batch_at(dc, 0))
    tree = {"params": p, "opt": st,
            "bf16": lm.cast_params(p, torch.bfloat16)["embed"]}
    ckpt.save(str(tmp_path), 1, tree, extra={"data_step": 1})
    fresh = lm.init(cfg, torch.Generator(device=cuda).manual_seed(1), cuda,
                    dtype=torch.float32)
    like = {"params": fresh, "opt": opt.init_opt_state(fresh),
            "bf16": torch.zeros_like(tree["bf16"])}
    out, extra = ckpt.restore(str(tmp_path), 1, like)
    assert extra == {"data_step": 1}
    assert ckpt.digest(out) == ckpt.digest(tree)
    for a, b in zip(opt.tree_leaves(out), opt.tree_leaves(tree)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_eval_rows_on_card_match_cpu(cuda):
    """tiny-lm trained 30 steps on the card; the eval's five rows at 6
    requests on the card launch the decode, scoring, redundancy and
    compaction kernels and no plain version; two card runs give the same
    bytes; the card's weights on the CPU give the same rows unless a
    stream parts at a near-tie the CPU serve recorded."""
    import copy

    from repro_torch.eval import runner, tasks

    cs = _chip_smoke()
    params = runner.trained_params(30, 0, "cuda")
    examples = tasks.eval_set(6, 0)
    ops.reset_launch_counts()
    with cs.PlainGuard():
        card = runner.serve_rows(params, examples, runner.BUDGETS_SMOKE,
                                 "cuda")
        again = runner.run_eval(n_requests=6, train_steps=30, device="cuda")
    for name in cs.EVAL_PATH:
        assert ops.launch_counts[name] > 0, name
    report = runner.make_report(runner.score_rows(copy.deepcopy(card)),
                                seed=0, n_requests=6, train_steps=30,
                                smoke=True)
    assert runner.render_report(report) == runner.render_report(again)
    rec = cs.TieRecorder()
    with rec:
        cpu = runner.serve_rows(cs._tree_to(params, "cpu"), examples,
                                runner.BUDGETS_SMOKE, "cpu")
    unexplained, _ = cs.compare_rows(card, cpu, rec)
    assert unexplained == []
