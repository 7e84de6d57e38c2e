"""The port's sampler, held against ``repro.core.sampling.sample_batch``.

JAX draws its Gumbel noise from ``fold_in(key(seed), counter)`` inside the
sampler; the port takes the uniform noise as an argument. Feeding the port
the very uniforms JAX's ``categorical`` draws (``jax.random.uniform`` on
the same key, over [tiny, 1)) must give the same tokens, and logprobs
within atol = rtol = 1e-5 (fp32 log-softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampling import SamplingParams as JSP
from repro.core.sampling import sample_batch as jsample
from repro_torch.core.sampling import SamplingParams, matched_stop
from repro_torch.core.sampling import TINY, sample_batch, sampling_noise

ATOL = RTOL = 1e-5


def jax_uniforms(seeds, counters, V):
    rows = []
    for s, c in zip(seeds, counters):
        key = jax.random.fold_in(jax.random.key(int(s)), int(c))
        rows.append(np.asarray(jax.random.uniform(
            key, (V,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))
    return np.stack(rows)


@pytest.mark.parametrize("seed", range(3))
def test_sample_batch_matches_jax_given_the_same_noise(seed):
    rng = np.random.default_rng(seed)
    B, V = 8, 97
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    logits[1, :5] = logits[1, 5]          # ties: lower token id first
    seeds = rng.integers(0, 2**32, B, dtype=np.uint32)
    counters = rng.integers(0, 50, B).astype(np.int32)
    temps = np.array([0, 0.7, 1.0, 1.3, 0.5, 0, 2.0, 0.9], np.float32)
    top_k = np.array([0, 5, 0, 3, 0, 2, 10, 1], np.int32)
    top_p = np.array([1, 1, 0.9, 0.8, 0.5, 1, 1, 0.95], np.float32)
    want_tok, want_lp = jsample(jnp.asarray(logits), jnp.asarray(seeds),
                                jnp.asarray(counters), jnp.asarray(temps),
                                jnp.asarray(top_k), jnp.asarray(top_p))
    noise = torch.from_numpy(jax_uniforms(seeds, counters, V))
    tok, lp = sample_batch(torch.from_numpy(logits), noise,
                           torch.from_numpy(temps), torch.from_numpy(top_k),
                           torch.from_numpy(top_p))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=RTOL,
                               atol=ATOL)


def test_sampling_noise_is_keyed_by_seed_and_counter():
    a = sampling_noise([7, 7, 8], [0, 1, 0], [True, True, True], 50, "cpu")
    b = sampling_noise([7, 9, 8], [0, 1, 0], [True, False, True], 50, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert float(a.min()) >= TINY and float(a.max()) < 1.0
    assert torch.all(b[1] == 0.5)          # unsampled rows draw nothing


def test_sampling_params_copy_matches():
    """``SamplingParams`` is the JAX package's contract, copied."""
    kw = dict(temperature=0.7, top_k=4, top_p=0.9, max_tokens=12,
              stop=[[1, 2]], eos_ids=[3], seed=5, logprobs=True,
              compression_policy="protect")
    import dataclasses
    assert dataclasses.asdict(SamplingParams(**kw)) == \
        dataclasses.asdict(JSP(**kw))
    with pytest.raises(TypeError, match="did you mean 'top_k'"):
        SamplingParams(topk=3)
    assert matched_stop([5, 1, 2], SamplingParams(stop=[[1, 2]])) == (1, 2)
