"""The port's copy of what ``jax.random`` draws under its defaults
(``jax_default_prng_impl = threefry2x32``, ``jax_threefry_partitionable
= True``, 32-bit mode), so that one seed gives the reference's numbers:
the temperature draw of ``serve/sampling.py`` and the synthetic token
stream of ``train/data.py`` both build on it.

A key is a pair of ints, the two uint32 words that
``jax.random.key_data`` shows. Keys are split and folded on the host, in
Python ints (a few hundred integer operations); the random bits of a
draw are hashed on the caller's device in int64 tensors masked to 32
bits (torch has no general uint32 arithmetic).

* :func:`key` — ``jax.random.key(seed)``; in 32-bit mode the seed is cut
  to its low 32 bits, which become the second word (the first is 0);
* :func:`split` — ``jax.random.split(key)``: key ``i`` of the two is the
  hash of the counter pair ``(0, i)``;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``: the hash of ``(0,
  data)``;
* :func:`bits` — ``jax.random.bits(key, shape)``: the hash of ``(0, i)``
  for flat index ``i``, its two words xor-ed;
* :func:`randint` — ``jax.random.randint(key, shape, lo, hi, int32)``:
  32 bits from each half of the split key, folded modulo the span in
  uint32 arithmetic that wraps as the reference's does;
* :func:`normal` — ``jax.random.normal(key, shape, float32)``:
  ``sqrt(2) * erfinv(u)`` with ``u`` uniform in ``(-1, 1)``; torch's
  ``erfinv`` and XLA's may differ in the last places.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.mesh import DeviceLike

__all__ = ["Key", "key", "split", "fold_in", "bits", "randint", "normal"]

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    key ``k``: ints, or int64 tensors, in ``[0, 2**32)``, as the result
    is."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s words: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & _MASK


def split(k: Key) -> tuple[Key, Key]:
    """``jax.random.split(k)``: two new keys, so ``k, sub = split(k)``
    reads as the reference's line."""
    return threefry2x32(k, 0, 0), threefry2x32(k, 0, 1)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` for ``data`` in ``[0, 2**32)``."""
    return threefry2x32(k, 0, int(data) & _MASK)


def bits(k: Key, shape, device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.bits(k, shape)`` on ``device``: uint32 words as int64
    in ``[0, 2**32)``. Past ``2**32`` elements the counter's high word
    would be needed; a draw here never gets there."""
    n = 1
    for s in shape:
        n *= s
    if n >= 2 ** 32:
        raise ValueError(f"bits(): {n} words need a 64-bit counter")
    lo = torch.arange(n, device=device)
    y0, y1 = threefry2x32(k, torch.zeros_like(lo), lo)
    return (y0 ^ y1).reshape(tuple(shape))


def randint(k: Key, shape, minval: int, maxval: int,
            device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval, jnp.int32)`` as an
    int32 tensor (``jax/_src/random.py:_randint``): the split key's two
    halves draw the higher and the lower 32 bits of each value, and
    ``(hi % span) * m + lo % span`` with ``m = (2**16 % span)**2 % span``
    folds them modulo ``span = maxval - minval``, every product and sum
    wrapping at 2**32 as the reference's uint32 arithmetic wraps."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError(f"randint(): [{minval}, {maxval}) is not an int32 "
                         f"range")
    k1, k2 = split(k)
    higher, lower = bits(k1, shape, device), bits(k2, shape, device)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    offset = (((higher % span) * mult) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return (minval + offset).to(torch.int32)


def normal(k: Key, shape, device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape, jnp.float32)``: ``u`` uniform in
    ``[nextafter(-1, 0), 1)`` from the bits' 23 high bits as the mantissa
    of a float in ``[1, 2)``, scaled in f32 as the reference scales it,
    then ``sqrt(2) * erfinv(u)``."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).to(device)
    hi = torch.tensor(1.0, device=device)
    mant = (bits(k, shape, device) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    return torch.tensor(2.0 ** 0.5, dtype=torch.float32) * torch.erfinv(u)
