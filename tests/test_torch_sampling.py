"""The port's sampler, held against ``repro.core.sampling.sample_batch``.

JAX draws its Gumbel noise from ``fold_in(key(seed), counter)`` inside the
sampler; the port takes the uniform noise as an argument and makes it with
its copy of JAX's threefry generator (``repro_torch.core.prng``). The bits
and uniforms must equal ``jax.random``'s exactly, and the sampler fed
them must give JAX's tokens, with logprobs within atol = rtol = 1e-5 (fp32
log-softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampling import SamplingParams as JSP
from repro.core.sampling import sample_batch as jsample
from repro_torch.core import prng
from repro_torch.core.sampling import SamplingParams, matched_stop
from repro_torch.core.prng import TINY
from repro_torch.core.sampling import sample_batch, sampling_noise

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
    a = sampling_noise(torch.tensor([7, 7, 8]), torch.tensor([0, 1, 0]), 50)
    b = sampling_noise(torch.tensor([7, 9, 8]), torch.tensor([0, 1, 0]), 50)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert not torch.equal(a[1], b[1])
    assert float(a.min()) >= TINY and float(a.max()) < 1.0
    assert a.dtype == torch.float32 and a.shape == (3, 50)


SEEDS = np.array([0, 1, 7, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1],
                 np.uint32)
COUNTERS = np.array([0, 3, 1, 127, 0, 2**31 - 1, 4096], np.int32)


def test_threefry_bits_and_uniforms_equal_jax():
    """Bit for bit, for seeds on both sides of 2**31 and large counters;
    the vocabulary is odd, so threefry's pairing of counts is exercised."""
    V = 257
    want_bits, want_u = [], []
    for s_, c in zip(SEEDS, COUNTERS):
        key = jax.random.fold_in(jax.random.key(s_), c)
        want_bits.append(np.asarray(jax.random.bits(key, (V,))))
        want_u.append(np.asarray(jax.random.uniform(
            key, (V,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))
    k = prng.fold_in(prng.key(torch.from_numpy(SEEDS.astype(np.int64))),
                     torch.from_numpy(COUNTERS))
    bits = prng.random_bits(k, V).numpy().astype(np.uint32)
    np.testing.assert_array_equal(bits, np.stack(want_bits))
    u = sampling_noise(torch.from_numpy(SEEDS.astype(np.int64)),
                       torch.from_numpy(COUNTERS), V).numpy()
    np.testing.assert_array_equal(u.view(np.uint32),
                                  np.stack(want_u).view(np.uint32))
    np.testing.assert_array_equal(u, jax_uniforms(SEEDS, COUNTERS, V))


def test_threefry_hash_equals_jax():
    from jax._src import prng as jprng
    rng = np.random.default_rng(0)
    k0, k1, x0, x1 = (rng.integers(0, 2**32, 64, dtype=np.uint32)
                      for _ in range(4))
    want = jprng.threefry_2x32(jnp.asarray([k0[0], k1[0]]),
                               jnp.asarray(np.concatenate([x0, x1])))
    got = prng.threefry2x32(*(torch.tensor(int(v)) for v in (k0[0], k1[0])),
                            torch.from_numpy(x0.astype(np.int64)),
                            torch.from_numpy(x1.astype(np.int64)))
    np.testing.assert_array_equal(
        torch.cat(got).numpy().astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_sample_batch_with_own_noise_matches_jax(seed):
    """The serving path's noise, not JAX's: the sampler alone must now
    reproduce ``repro.core.sampling.sample_batch`` end to end."""
    rng = np.random.default_rng(100 + seed)
    B, V = 8, 151
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    seeds = np.append(SEEDS, 2**31 + seed).astype(np.uint32)[
        rng.permutation(B)]
    counters = rng.integers(0, 200, B).astype(np.int32)
    temps = np.array([0.6, 0.6, 1.0, 0.8, 0.5, 0, 1.5, 0.6], np.float32)
    top_k = np.array([20, 0, 5, 20, 0, 0, 3, 1], np.int32)
    top_p = np.array([0.95, 0.9, 1, 0.95, 0.5, 1, 1, 1], np.float32)
    want_tok, want_lp = jsample(jnp.asarray(logits), jnp.asarray(seeds),
                                jnp.asarray(counters), jnp.asarray(temps),
                                jnp.asarray(top_k), jnp.asarray(top_p))
    noise = sampling_noise(torch.from_numpy(seeds.astype(np.int64)),
                           torch.from_numpy(counters), V)
    tok, lp = sample_batch(torch.from_numpy(logits), noise,
                           torch.from_numpy(temps), torch.from_numpy(top_k),
                           torch.from_numpy(top_p))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=RTOL,
                               atol=ATOL)


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
