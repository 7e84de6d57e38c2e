"""Greedy token streams of the port's engine and facade, held against the
JAX package on the same tiny-lm weights, with the JAX kernels run through
the Pallas interpreter (``kernel_backend="pallas-interpret"``).

Covered: compression firing at the engine defaults' n_max=4 (with a
prompt longer than the prefill bucket, so prefill runs in rounds), the
plain PagedAttention baseline (``n_max=None``), a prefix-cache hit, and
the engine's host telemetry. Greedy streams are compared exactly; the
compression survivors behind them are the margin-checked ones of
tests/test_torch_compression.py (these prompts and weights carry no
near-tie that flips).

Every flow runs under the port's sanitizer (``core/invariants.py``, as
``ZIPAGE_SANITIZE=1`` would arm it): each port engine audits its whole
state after every step, and a violation fails the flow. The JAX engines
are left as they are: the environment variable is not set.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import SamplingParams as JSP
from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import ZipageEngine as JEngine
from repro.models import lm as jlm
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariants
from repro_torch.core.engine import EngineOptions, ZipageEngine

SHAPES = dict(block_size=8, n_total_blocks=64, max_batch=4,
              max_model_len=128, prefill_rows=2, prefill_len=64)
PROMPTS = [[1, 2, 3, 4, 5] * 6, list(range(10, 80)), list(range(100, 121))]


@pytest.fixture(autouse=True)
def sanitized(monkeypatch):
    """Arm the port's sanitizer for every engine a flow builds, and count
    its audits."""
    audits = []
    check = invariants.check_engine
    monkeypatch.setattr(invariants, "enabled", lambda: True)
    monkeypatch.setattr(invariants, "check_engine",
                        lambda eng: audits.append(eng.step_count) or check(eng))
    yield
    assert audits, "no port engine stepped under the sanitizer"


@pytest.fixture(scope="module")
def weights():
    params = jlm.init(jget_config("tiny-lm"), jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = get_config("tiny-lm")
    return params, params_from_numpy(cfg, tree)


def facades(weights, **knobs):
    jparams, tparams = weights
    jz = JZipage(jget_config("tiny-lm"), jparams,
                 kernel_backend="pallas-interpret", **SHAPES, **knobs)
    tz = Zipage(get_config("tiny-lm"), tparams, device="cpu", **SHAPES,
                **knobs)
    return jz, tz


def test_facade_streams_match_with_compression(weights):
    jz, tz = facades(weights)
    jo = jz.generate(PROMPTS, JSP(max_new_tokens=40))
    to = tz.generate(PROMPTS, SamplingParams(max_new_tokens=40))
    assert [o.token_ids for o in to] == [o.token_ids for o in jo]
    n_comp = [o.metrics.compression.n_compressions for o in to]
    assert n_comp == [o.metrics.compression.n_compressions for o in jo]
    assert min(n_comp) > 0
    assert [o.finish_reason for o in to] == ["length"] * 3
    # a second round reuses the first round's cached prefix blocks
    again = [PROMPTS[1][:40] + [7, 8, 9]]
    jo2 = jz.generate(again, JSP(max_new_tokens=12))
    to2 = tz.generate(again, SamplingParams(max_new_tokens=12))
    assert to2[0].token_ids == jo2[0].token_ids
    assert tz.scheduler_stats["prefix_hits"] > 0
    assert tz.scheduler_stats["prefix_hits"] == \
        jz.scheduler_stats["prefix_hits"]
    assert tz.num_free_blocks == SHAPES["n_total_blocks"]
    tz.bm.check_invariants()


def test_facade_streams_match_without_compression(weights):
    jz, tz = facades(weights, n_max=None)
    jo = jz.generate(PROMPTS[:2], JSP(max_new_tokens=24))
    to = tz.generate(PROMPTS[:2], SamplingParams(max_new_tokens=24))
    assert [o.token_ids for o in to] == [o.token_ids for o in jo]
    assert all(o.metrics.compression.n_compressions == 0 for o in to)
    assert tz.kv_budget_tokens is None


def test_engine_streams_and_telemetry_match(weights):
    jparams, tparams = weights
    kw = dict(SHAPES, kernel_backend="pallas-interpret")
    jeng = JEngine(jget_config("tiny-lm"), jparams, JOptions(**kw))
    teng = ZipageEngine(get_config("tiny-lm"), tparams,
                        EngineOptions(**SHAPES), device="cpu")
    for p in PROMPTS:
        jeng.add_request(p, JSP(max_new_tokens=30, eos_ids=(999,)))
        teng.add_request(p, SamplingParams(max_new_tokens=30,
                                           eos_ids=(999,)))
    jdone, tdone = jeng.run(), teng.run()
    assert {r: q.output for r, q in tdone.items()} == \
        {r: q.output for r, q in jdone.items()}
    for key in ("pages_visited", "pages_dense", "n_compressing", "tokens",
                "n_active"):
        assert [m[key] for m in teng.metrics] == \
            [m[key] for m in jeng.metrics], key
    for m in teng.metrics:
        assert m["t_host"] >= 0 and m["t_device"] >= 0
        assert m["t_host"] + m["t_device"] == pytest.approx(m["t_total"])


def test_abort_and_stream(weights):
    _, tparams = weights
    z = Zipage(get_config("tiny-lm"), tparams, device="cpu", **SHAPES)
    keep = z.add_request(PROMPTS[0], SamplingParams(max_new_tokens=6))
    gone = z.add_request(PROMPTS[2], SamplingParams(max_new_tokens=50))
    chunks = [o.chunk for o in z.step() if o.request_id == keep]
    out = z.abort(gone)
    assert out.finish_reason == "abort"
    while z.has_unfinished():
        chunks += [o.chunk for o in z.step() if o.request_id == keep]
    final = z.output(keep)
    assert sum((c.token_ids for c in chunks), []) == final.token_ids
    assert chunks[-1].finish_reason == "length"
    assert z.num_free_blocks == SHAPES["n_total_blocks"]


def test_sampled_requests_are_reproducible(weights):
    """Seeded streams are a function of (seed, position) only, so the
    same request gives the same tokens in another batch."""
    _, tparams = weights
    sp = SamplingParams(max_new_tokens=10, temperature=0.8, top_k=20,
                        seed=11, logprobs=True)
    a = Zipage(get_config("tiny-lm"), tparams, device="cpu", **SHAPES) \
        .generate([PROMPTS[0]], sp)[0]
    b = Zipage(get_config("tiny-lm"), tparams, device="cpu", **SHAPES) \
        .generate([PROMPTS[2], PROMPTS[0]], [SamplingParams(
            max_new_tokens=10), sp])[1]
    assert a.token_ids == b.token_ids
    np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(torch.tensor(a.logprobs)).all()
