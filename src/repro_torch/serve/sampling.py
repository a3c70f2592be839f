"""Temperature sampling drawn as the reference draws it: a copy of what
``jax.random`` does under its defaults (``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``, 32-bit mode,
gumbel mode ``"low"``), so that one seed gives the reference's tokens.

A key is a pair of ints, the two uint32 words that
``jax.random.key_data`` shows. One Threefry-2x32 hash serves both
sides: keys are split and folded on the host, in Python ints (a few
hundred integer operations), and the random bits of a draw are hashed
on the logits' device in int64 tensors masked to 32 bits (torch has no
general uint32 arithmetic), so no logits leave the card.

* :func:`key` — ``jax.random.key(seed)``; in 32-bit mode the seed is cut
  to its low 32 bits, which become the second word (the first is 0);
* :func:`split` — ``jax.random.split(key)``: key ``i`` of the two is the
  hash of the counter pair ``(0, i)``;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``: the hash of ``(0,
  data)``;
* :func:`bits` — ``jax.random.bits(key, shape)``: the hash of ``(0, i)``
  for flat index ``i``, its two words xor-ed;
* :func:`categorical` — ``jax.random.categorical(key, logits)``: the
  argmax over the last axis of ``logits`` plus Gumbel noise ``-log(-log
  u)``, ``u`` uniform in ``[tiny, 1)`` from the bits' 23 high bits
  (:func:`gumbel_uniform`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.mesh import DeviceLike

__all__ = ["Key", "key", "split", "fold_in", "bits", "gumbel_uniform",
           "categorical"]

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _threefry2x32(k: Key, x0, x1):
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
    return _threefry2x32(k, 0, 0), _threefry2x32(k, 0, 1)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` for ``data`` in ``[0, 2**32)``."""
    return _threefry2x32(k, 0, int(data) & _MASK)


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
    y0, y1 = _threefry2x32(k, torch.zeros_like(lo), lo)
    return (y0 ^ y1).reshape(tuple(shape))


def gumbel_uniform(k: Key, shape, device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval=tiny, maxval=1)``,
    the Gumbel sampler's draw: the 23 high bits as the mantissa of a
    float in ``[1, 2)``, less 1. The reference's ``floats * (1 - tiny) +
    tiny`` is ``floats`` in f32 but for the zero draw, which becomes
    ``tiny``."""
    mant = (bits(k, shape, device) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, _TINY)


def categorical(k: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` over the last axis of f32
    ``logits``: ``argmax(logits + gumbel)``, ties to the lower index as
    ``jnp.argmax``. The Gumbel noise's two logs are torch's, which may
    differ from XLA's in the last place."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical() takes f32 logits, got {logits.dtype}")
    u = gumbel_uniform(k, logits.shape, logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
