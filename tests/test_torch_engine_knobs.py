"""The scheduler knobs at the engine level: the port's facade against the
JAX facade (``kernel_backend="jnp"``) on the same tiny-lm fp32 weights
(``repro.models.lm.init``, key 0, carried across as numpy copies).

Shapes: block 8, 64 blocks, 4 slots, ``max_model_len`` 160, prefill
2 x 64, ``n_max`` 4, window 4; six greedy requests of 12-60 prompt
tokens and 40-56 new ones, so compression fires. Settings:
``srpt`` under ``scheduling="constrained"``; ``token_budget=24`` with
``max_prefill_chunk=16`` at ``decode_steps=8``; ``quality_aware`` under
each ``compression_policy``; ``admission_margin``; and
``async_compression=False``. Each must give equal token streams, finish
reasons and per-request compression counts.

The prompts are random draws without repeated runs of one token, which
make survivor near-ties (ROADMAP §C). A request that parted from the
reference would be excused only at a near-tie the port's serve recorded
(``chip_smoke.TieRecorder``: a top-2 logit gap or a k-th against (k+1)-th
survivor margin under 1e-4, at or before the token where it parts); with
these prompts none parts, and the streams are asserted equal.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.api import SamplingParams as JSP
from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.core.scheduler import Scheduler as JScheduler
from repro.models import lm as jlm
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.scheduler import Scheduler

JCFG = dataclasses.replace(jget_config("tiny-lm"), dtype="float32")
CFG = dataclasses.replace(get_config("tiny-lm"), dtype="float32")
SHAPES = dict(block_size=8, n_total_blocks=64, max_batch=4, m_qslots=4,
              n_max=4, window=4, max_model_len=160, prefill_rows=2,
              prefill_len=64)
PROMPT_SEED = 3


def _chip_smoke():
    """chip_smoke.py at the repo's root, which holds the near-tie
    recorder; loaded by path, once."""
    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored after: the
    suite runs six workers on a few cores, where torch's default of one
    spinning thread a core makes these small ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_admission_backoff(monkeypatch):
    """Both schedulers halve their admission rate after a step slower than
    3x their latency average: a wall-clock reading that a busy host can
    trip in one package and not the other, changing the schedule. The
    knobs are compared with it held at its start (no backoff)."""
    monkeypatch.setattr(JScheduler, "observe_latency", lambda s, dt: None)
    monkeypatch.setattr(Scheduler, "observe_latency", lambda s, dt: None)


@pytest.fixture(scope="module")
def weights():
    jparams = jlm.init(JCFG, jax.random.key(0))
    return jparams, params_from_numpy(
        CFG, jax.tree.map(lambda a: np.array(a), jparams))


def _requests():
    rng = np.random.default_rng(PROMPT_SEED)
    lens = rng.integers(12, 61, 6)
    new = rng.integers(40, 57, 6)
    prompts = [[int(t) for t in rng.integers(0, CFG.vocab_size, n)]
               for n in lens]
    return prompts, [int(n) for n in new]


SETTINGS = {
    "srpt-constrained": (dict(policy="srpt", scheduling="constrained",
                              decode_steps=4), None),
    "token-budget": (dict(token_budget=24, max_prefill_chunk=16,
                          decode_steps=8), None),
    "quality-default": (dict(quality_aware=True, quality_defer_min_free=8,
                             decode_steps=4), "default"),
    "quality-protect": (dict(quality_aware=True, quality_defer_min_free=8,
                             decode_steps=4), "protect"),
    "quality-aggressive": (dict(quality_aware=True,
                                quality_defer_min_free=8,
                                decode_steps=4), "aggressive"),
    "admission-margin": (dict(admission_margin=0.5), None),
    "sync-compression": (dict(async_compression=False, decode_steps=4),
                         None),
}


def _serve(z, sp_cls, prompts, new, policy):
    kw = {} if policy is None else dict(compression_policy=policy)
    outs = z.generate(prompts, [sp_cls(max_new_tokens=n, **kw)
                                for n in new])
    fin = z.engine.scheduler.finished
    return ([list(o.token_ids) for o in outs],
            [o.finish_reason for o in outs],
            [fin[o.request_id].n_compressions for o in outs])


@pytest.mark.parametrize("name", list(SETTINGS))
def test_knob_streams_equal_the_jax_facade(weights, name):
    knobs, policy = SETTINGS[name]
    jparams, params = weights
    prompts, new = _requests()
    ref = _serve(JZipage(JCFG, jparams, kernel_backend="jnp", **SHAPES,
                         **knobs), JSP, prompts, new, policy)
    ties = _chip_smoke()
    rec = ties.TieRecorder()
    with rec:
        z = Zipage(CFG, params, device="cpu", **SHAPES, **knobs)
        got = _serve(z, SamplingParams, prompts, new, policy)
    for key, value in knobs.items():
        opts = z.engine.opts
        assert getattr(opts, key, getattr(opts.compress, key, value)) \
            == value
    tokens, reasons, comps = got
    # a request may part from the reference only at a near-tie that the
    # port's serve recorded; with these prompts none does
    parted = [(rid, ties.first_difference(a, b))
              for rid, (a, b) in enumerate(zip(ref[0], tokens)) if a != b]
    assert [(rid, pos, rec.explain(0, rid, pos))
            for rid, pos in parted] == []
    assert tokens == ref[0]
    assert reasons == ref[1]
    assert comps == ref[2]
    assert sum(comps) > 0                      # compression fires
    assert z.num_free_blocks == SHAPES["n_total_blocks"]
