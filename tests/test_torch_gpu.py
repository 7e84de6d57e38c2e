"""Tests of the port that need the card: each CUDA kernel against its plain
version on the same CUDA tensors, and the engine on the card against the
same engine on the CPU. They skip without a card and nvcc (decided in the
``cuda`` fixture, never at import). On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: atol = rtol = 1e-4 (fp32; the kernels sum in another order
than PyTorch's reductions).
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import native, ops
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
    for name in ops.KERNELS:
        assert ops.launch_counts[name] == before[name] + 1


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


def _to(t, dev):
    if isinstance(t, dict):
        return {k: _to(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_to(v, dev) for v in t]
    return t.to(dev)
