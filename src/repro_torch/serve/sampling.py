"""Temperature sampling drawn as the reference draws it: a copy of what
``jax.random`` does under its defaults (``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``, 32-bit mode,
gumbel mode ``"low"``), so that one seed gives the reference's tokens.

Keys and bits come from :mod:`repro_torch.prng` (Threefry-2x32 keys
split and folded on the host, bits hashed on the logits' device, so no
logits leave the card); ``key``, ``split``, ``fold_in`` and ``bits`` are
its functions, named here too for the engine and the scheduler.

* :func:`categorical` — ``jax.random.categorical(key, logits)``: the
  argmax over the last axis of ``logits`` plus Gumbel noise ``-log(-log
  u)``, ``u`` uniform in ``[tiny, 1)`` from the bits' 23 high bits
  (:func:`gumbel_uniform`);
* :func:`categorical_rows` — :func:`categorical` of every row of a
  ``(b, vocab)`` batch under its own key, in one draw (the scheduler's
  per-request keys): the same hash and noise as the row-by-row draw, so
  the same tokens.
"""
from __future__ import annotations

import torch

from repro_torch.mesh import DeviceLike
from repro_torch.prng import Key, bits, fold_in, key, split, threefry2x32

__all__ = ["Key", "key", "split", "fold_in", "bits", "gumbel_uniform",
           "categorical", "categorical_rows", "perturbed_rows"]

_TINY = torch.finfo(torch.float32).tiny


def gumbel_uniform(k: Key, shape, device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval=tiny, maxval=1)``,
    the Gumbel sampler's draw: the 23 high bits as the mantissa of a
    float in ``[1, 2)``, less 1. The reference's ``floats * (1 - tiny) +
    tiny`` is ``floats`` in f32 but for the zero draw, which becomes
    ``tiny``."""
    return _uniform(bits(k, shape, device))


def _uniform(words: torch.Tensor) -> torch.Tensor:
    mant = (words >> 9) | 0x3F800000
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


def perturbed_rows(keys, logits: torch.Tensor) -> torch.Tensor:
    """Every row of f32 ``(b, vocab)`` logits plus its Gumbel noise under
    its own key: the values :func:`categorical_rows` takes the argmax of
    (their top-two gap says how near a draw is to a tie). The keys'
    words go to the device as a ``(b, 2)`` tensor and one hash of ``(b,
    vocab)`` counters draws every row's bits — each row's are those of
    ``bits(keys[i], (vocab,))``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical_rows() takes f32 logits, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or len(keys) != logits.shape[0]:
        raise ValueError(f"categorical_rows(): {len(keys)} keys for logits "
                         f"of shape {tuple(logits.shape)}")
    words = torch.tensor([tuple(k) for k in keys], dtype=torch.int64,
                         device=logits.device)
    lo = torch.arange(logits.shape[1], device=logits.device)[None]
    y0, y1 = threefry2x32((words[:, :1], words[:, 1:]),
                           torch.zeros_like(lo), lo)
    return logits - torch.log(-torch.log(_uniform(y0 ^ y1)))


def categorical_rows(keys, logits: torch.Tensor) -> torch.Tensor:
    """``categorical(keys[i], logits[i])`` for every row ``i`` of f32
    ``(b, vocab)`` logits at once (:func:`perturbed_rows`' argmax), so
    the tokens are the row-by-row draw's."""
    return torch.argmax(perturbed_rows(keys, logits), dim=-1)
