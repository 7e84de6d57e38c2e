"""The second slice of the port as a whole: tiny-lm through
``repro_torch.api.Zipage`` against ``repro.api.Zipage`` (``kernel_backend=
"jnp"``) on the same weights, with compression firing.

  * the paper's Alg. 3 / Alg. 4 path: ``decode_kernel="dense"`` and
    ``CompressOptions(redundancy="flash")``, greedy streams equal;
  * seeded sampling on the default path (ragged decode, lightning
    redundancy): the port's threefry noise is JAX's, so top-k / top-p /
    temperature streams equal, logprobs within atol = rtol = 1e-5 (fp32);
  * seeded sampling on the new path too.

Shapes as in tests/test_torch_engine.py.
"""
import jax
import numpy as np
import pytest

from repro.api import SamplingParams as JSP
from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.core.compression import CompressOptions as JCompress
from repro.models import lm as jlm
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.compression import CompressOptions
from repro_torch.kernels import ops

SHAPES = dict(block_size=8, n_total_blocks=64, max_batch=4,
              max_model_len=128, prefill_rows=2, prefill_len=64)
PROMPTS = [[1, 2, 3, 4, 5] * 6, list(range(10, 80)), list(range(100, 121))]
TOL = 1e-5
#: Qwen3's published thinking-mode sampling, and two other mixes
SAMPLED = [dict(temperature=0.6, top_p=0.95, top_k=20, seed=2**31 + 7),
           dict(temperature=0.8, top_k=5, seed=11),
           dict(temperature=1.0, top_p=0.9, seed=0)]


@pytest.fixture(scope="module")
def weights():
    params = jlm.init(jget_config("tiny-lm"), jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_numpy(get_config("tiny-lm"), tree)


def facades(weights, *, flash=False, **knobs):
    jparams, tparams = weights
    jk, tk = dict(knobs), dict(knobs)
    if flash:
        jk["compress"] = JCompress(window=4, redundancy="flash")
        tk["compress"] = CompressOptions(window=4, redundancy="flash")
    jz = JZipage(jget_config("tiny-lm"), jparams, kernel_backend="jnp",
                 **SHAPES, **jk)
    tz = Zipage(get_config("tiny-lm"), tparams, device="cpu", **SHAPES, **tk)
    return jz, tz


def _same(jo, to):
    assert [o.token_ids for o in to] == [o.token_ids for o in jo]
    n_comp = [o.metrics.compression.n_compressions for o in to]
    assert n_comp == [o.metrics.compression.n_compressions for o in jo]
    assert min(n_comp) > 0


def test_dense_decode_and_flash_greedy_streams_match(weights):
    jz, tz = facades(weights, flash=True, decode_kernel="dense")
    assert tz.engine.spec.decode_kernel == "dense"
    jo = jz.generate(PROMPTS, JSP(max_new_tokens=40))
    to = tz.generate(PROMPTS, SamplingParams(max_new_tokens=40))
    _same(jo, to)
    dense = [m["pages_dense"] for m in tz.engine.metrics]
    assert dense == [m["pages_dense"] for m in jz.engine.metrics]
    assert sum(dense) > sum(m["pages_visited"] for m in tz.engine.metrics)
    assert tz.num_free_blocks == SHAPES["n_total_blocks"]
    tz.bm.check_invariants()


def test_seeded_streams_match_on_the_default_path(weights):
    jz, tz = facades(weights)
    jo = jz.generate(PROMPTS, [JSP(max_new_tokens=40, logprobs=True, **k)
                               for k in SAMPLED])
    to = tz.generate(PROMPTS, [SamplingParams(max_new_tokens=40,
                                              logprobs=True, **k)
                               for k in SAMPLED])
    _same(jo, to)
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=TOL,
                                   atol=TOL)


def test_seeded_and_greedy_mix_on_the_new_path(weights):
    """Greedy and seeded requests in one batch through dense decode and
    flash redundancy, as chip_smoke.py's second serve sends them."""
    jz, tz = facades(weights, flash=True, decode_kernel="dense")
    jsp = [JSP(max_new_tokens=32), JSP(max_new_tokens=32, **SAMPLED[0]),
           JSP(max_new_tokens=32, **SAMPLED[1])]
    tsp = [SamplingParams(max_new_tokens=32),
           SamplingParams(max_new_tokens=32, **SAMPLED[0]),
           SamplingParams(max_new_tokens=32, **SAMPLED[1])]
    _same(jz.generate(PROMPTS, jsp), tz.generate(PROMPTS, tsp))


def test_cpu_serve_launches_no_kernel(weights):
    """On the CPU every kernel runs its plain version: no launch counted."""
    _, tz = facades(weights, flash=True, decode_kernel="dense")
    ops.reset_launch_counts()
    tz.generate(PROMPTS[:1], SamplingParams(max_new_tokens=20))
    assert all(n == 0 for n in ops.launch_counts.values())
    assert len(ops.launch_counts) == len(ops.KERNELS) == 6
