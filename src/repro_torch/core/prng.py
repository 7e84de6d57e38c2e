"""The port's copy of ``jax.random``'s threefry2x32 generator, as plain
tensor ops.

The JAX package keys each sampled row with
``jax.random.fold_in(jax.random.key(seed), counter)`` and draws the Gumbel
noise of ``jax.random.categorical`` from it (``repro.core.sampling``). This
module reproduces those bits exactly, for all rows at once and on any
device, so seeded token streams are the same in both packages and on the
card and the CPU:

  * ``key(seed)`` of a 32-bit seed is the pair ``(0, seed)``;
  * ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``;
  * ``random_bits(key, n)`` is ``x0 ^ x1`` of ``threefry2x32(key, (0, j))``
    for j in 0..n-1 (the layout under ``jax_threefry_partitionable=True``,
    the default of JAX 0.5 and later);
  * ``uniform`` puts the top 23 bits into the mantissa of a float in
    [1, 2), subtracts 1 and lifts the result to at least ``tiny``, as
    ``jax.random.uniform(key, shape, minval=tiny, maxval=1)`` does for
    float32.

Integer arithmetic only: uint32 values are carried in int64 tensors and
masked to 32 bits after every add, because CUDA's support for
``torch.uint32`` shifts and multiplies is incomplete. Every operation is
exact, so the noise is bit-identical on every device.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: smallest normal float32, the lower end of the uniform noise
TINY = float(torch.finfo(torch.float32).tiny)


def _u32(x):
    return torch.as_tensor(x).to(torch.int64) & M32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (``jax._src.prng``'s hash) on int64
    tensors holding uint32 values; arguments broadcast together. Returns
    the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seeds):
    """``jax.random.key`` of 32-bit seeds: (0, seed) per element."""
    s = _u32(seeds)
    return torch.zeros_like(s), s


def fold_in(k, data):
    """``jax.random.fold_in`` elementwise: keys ``k`` (a pair of tensors)
    folded with 32-bit ``data`` of the same shape."""
    d = _u32(data).to(k[0].device)
    return threefry2x32(k[0], k[1], torch.zeros_like(d), d)


def random_bits(k, n):
    """32-bit words (..., n) of each key in ``k``, as
    ``jax.random.bits(key, (n,))`` draws them."""
    j = torch.arange(n, dtype=torch.int64, device=k[0].device)
    y0, y1 = threefry2x32(k[0][..., None], k[1][..., None],
                          torch.zeros_like(j), j)
    return y0 ^ y1


def uniform(k, n):
    """float32 uniforms (..., n) in [TINY, 1) of each key in ``k``, as
    ``jax.random.uniform(key, (n,), minval=TINY, maxval=1.0)``."""
    bits = random_bits(k, n)
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp((one - 1.0) + TINY, min=TINY)


def row_uniforms(seeds, counters, n):
    """(B, n) uniforms of ``fold_in(key(seeds[i]), counters[i])`` for every
    row: the noise ``jax.random.categorical`` draws for row i of the JAX
    package's ``sample_batch``. ``seeds`` and ``counters`` are (B,) integer
    tensors on the device that is to hold the noise."""
    return uniform(fold_in(key(seeds), counters), n)
