"""Rank axis on one device — the port's stand-in for ``shard_map``.

NCCL does not put two ranks on one device, so a tensor-parallel rank of
the port is a slice of a *rank-stacked* tensor: the leading axis is the
rank, ``x[r]`` is rank ``r``'s local buffer (the ``x[d]`` convention of
``repro/kernels/ref.py``). Code that the reference writes once per
device inside ``shard_map`` is written once here with an explicit rank
axis, and ``RankAxis.index()`` plays ``jax.lax.axis_index``.

Device resolution is shared by every entry point: ``device=None`` means
the CUDA card, and raises where there is none — the port never carries
on on the CPU unless the caller asked for it.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

__all__ = ["RankAxis", "resolve_device"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the current CUDA
    card and raises when there is no CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class RankAxis:
    """One named mesh axis of ``n`` ranks, all stacked on ``device``."""

    name: str
    n: int
    device: torch.device

    def __init__(self, name: str, n: int, device: DeviceLike = None):
        if n < 1:
            raise ValueError(f"axis size must be >= 1, got {n}")
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "device", resolve_device(device))

    def index(self) -> torch.Tensor:
        """(n,) rank ids — ``jax.lax.axis_index`` for every rank at once."""
        return torch.arange(self.n, device=self.device)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Split ``x`` into ``n`` equal blocks along ``dim`` and stack
        them on a new leading rank axis (a contiguous copy)."""
        if x.shape[dim] % self.n:
            raise ValueError(
                f"dim {dim} of size {x.shape[dim]} does not divide over "
                f"{self.n} ranks of axis {self.name!r}")
        return torch.stack(x.to(self.device).chunk(self.n, dim=dim)).contiguous()

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's own copy of ``x`` (a replicated leaf)."""
        x = x.to(self.device)
        return x.unsqueeze(0).expand((self.n,) + tuple(x.shape)).contiguous()
