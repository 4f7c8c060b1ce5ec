"""The counter-based random numbers of the JAX package, reproduced bit for
bit: JAX's default ``threefry2x32`` PRNG with ``jax_threefry_partitionable``
on (the default since jax 0.5).

- ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``: the pair (seed >> 32,
  seed mod 2^32) of uint32 words.
- ``fold_in(key, d)`` is ``jax.random.fold_in``: ``threefry2x32(key, (0,
  d))``.
- ``random_bits(key, shape)``: element i of the flattened shape has the bits
  ``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i mod 2^32))``.
- ``uniform(key, shape, minval, maxval)`` is ``jax.random.uniform``
  (``_uniform``): the bits' top 23 as a mantissa of [1, 2), less 1, scaled
  and shifted, then at least ``minval``.
- ``gumbel(key, shape)`` is ``jax.random.gumbel``: ``-log(-log(u))`` of a
  uniform on [tiny, 1), with XLA's float32 log (``ops/objectives.log_f32``).

Keys are (k0, k1) tuples of Python ints and are derived on the host (a
fold-in is a few dozen integer operations). The bit streams are torch int64
tensors masked to 32 bits (torch's uint32 arithmetic is thin); they run on
any device and are what the tests and the plain versions of the sampling
kernels use. On the card the kernels generate their own bits from the key
(``xrt_threefry2x32`` in ``csrc/common.cuh``).
"""

from typing import Sequence, Tuple, Union

import torch

from xgboost_ray_tpu_torch.ops.objectives import log_f32

Key = Tuple[int, int]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: the smallest normal float32 (``jnp.finfo(jnp.float32).tiny``)
F32_TINY = 2.0 ** -126


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC 2011) as JAX computes
    it, on Python ints or int64 tensors holding uint32 words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return ((seed >> 32) & MASK32, seed & MASK32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, int(data) & MASK32)


Shape = Union[int, Sequence[int]]


def _numel(shape: Shape) -> Tuple[Tuple[int, ...], int]:
    shape = (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    return shape, n


def random_bits(key: Key, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor."""
    shape, n = _numel(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, i >> 32, i & MASK32)
    return (y0 ^ y1).reshape(shape)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from uint32 bits: ``bitcast((bits >> 9) |
    0x3F800000) - 1``, exactly the multiple ``(bits >> 9) * 2^-23``."""
    word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return word.view(torch.float32) - 1.0


def uniform(key: Key, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` (float32)."""
    f = bits_to_unit(random_bits(key, shape, device))
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.maximum(lo.to(f.device), f * span.item() + lo.item())


def gumbel(key: Key, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (float32): ``-log(-log(u))``, u
    uniform on [tiny, 1), each log XLA's."""
    u = uniform(key, shape, F32_TINY, 1.0, device)
    return -log_f32(-log_f32(u))
