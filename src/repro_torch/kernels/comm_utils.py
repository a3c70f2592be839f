"""Shared plumbing of the collective kernels: shape checks, ring
neighbours, backend selection, and the state each CUDA kernel keeps —
its workspaces and its launch count.

Port of ``repro/kernels/comm_utils.py``. The reference's
``interpret_mode``/``on_tpu`` have no counterpart: the tensor's device
decides, the kernel for a CUDA tensor and the plain version for a CPU
one. Ranks are stacked on the leading axis (``x[r]`` is rank ``r``'s
buffer, :mod:`repro_torch.mesh`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["check_2d", "ring_neighbors", "resolve_backend",
           "check_kernel_input", "blocks_per_rank", "Workspace", "workspace",
           "check_launch", "LAUNCHES", "MAX_RANKS", "THREADS"]

MAX_RANKS = 8            # kMaxRanks: one launch holds at most 8 rank blocks
THREADS = 512            # threads per block of every collective kernel
# blocks per rank: one per TILE_BYTES of a rank's input (1PA LL: one per
# THREADS packet words), at most MAX_BLOCKS over all ranks, so every block
# is resident at once on an H100 (132 SMs) and the cooperative launch is
# accepted
TILE_BYTES = 8192
MAX_BLOCKS = 128
EPOCH_MAX = 0x7FFFFFFF   # flags are int32 in the plain model (pack_ll)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int32: 3}

#: kernel launches per kernel name, counted by each wrapper where it
#: launches its kernel (and nowhere else)
LAUNCHES: Dict[str, int] = collections.Counter()


def check_2d(x: torch.Tensor, name: str = "x") -> None:
    """Each rank's buffer must be 2D: ``x`` is ``(n, rows, cols)``."""
    if x.dim() != 3:
        raise ValueError(f"{name} must be 2D (rows, cols) per rank, "
                         f"stacked as (n, rows, cols); got "
                         f"{tuple(x.shape)}")


def ring_neighbors(n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prev, next) logical ring neighbours of every rank, as ``(n,)``
    index tensors over the rank axis."""
    me = torch.arange(n, device=device)
    return (me - 1 + n) % n, (me + 1) % n


def resolve_backend(x: torch.Tensor, backend: Optional[str]) -> str:
    """``None`` -> the kernel (``"cuda"``) for a CUDA tensor and the plain
    version (``"torch"``) for a CPU one. A CPU tensor never reaches a
    kernel: asking for one raises."""
    backend = backend or ("cuda" if x.is_cuda else "torch")
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"the CUDA kernel runs CUDA tensors only, got a "
                         f"tensor on {x.device}; use backend='torch' for "
                         f"the plain version")
    return backend


def check_kernel_input(x: torch.Tensor) -> int:
    """Raise unless the kernels take ``x``'s element type and rank count;
    returns the element-type code."""
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"the collective kernels take {list(DTYPE_CODES)}, "
                         f"got {x.dtype}")
    if not 1 <= x.shape[0] <= MAX_RANKS:
        raise ValueError(f"the collective kernels take 1 to {MAX_RANKS} "
                         f"ranks, got {x.shape[0]}")
    return code


def blocks_per_rank(nbytes: int, n: int,
                    tile_bytes: int = TILE_BYTES) -> int:
    """Blocks per rank for a rank input of ``nbytes``: each owns a
    contiguous tile of about ``tile_bytes``, and n * blocks <=
    MAX_BLOCKS."""
    return max(1, min(MAX_BLOCKS // n, -(-nbytes // tile_bytes)))


@dataclasses.dataclass
class Workspace:
    """A kernel's device scratch for one shape: slots, LL packets and
    flags, allocated once; ``epoch`` tags this launch's flags."""

    blocks: int
    tensors: Tuple[torch.Tensor, ...]
    epoch: int = 0

    def next_epoch(self) -> int:
        """The next launch's flag value: it grows by one per launch, never
        0 (the flags' initial value), so no flag of an earlier launch
        matches it and nothing is reset between launches."""
        self.epoch = self.epoch % EPOCH_MAX + 1
        return self.epoch


_WORKSPACES: Dict[tuple, Workspace] = {}


def workspace(kernel: str, x: torch.Tensor,
              make: Optional[Callable[[], Workspace]] = None
              ) -> Optional[Workspace]:
    """The workspace of ``kernel`` for ``x``'s (n, rows, cols, dtype,
    device), made by ``make()`` at the first call (without ``make``:
    the cached one, or None)."""
    key = (kernel, tuple(x.shape), x.dtype, x.device)
    ws = _WORKSPACES.get(key)
    if ws is None and make is not None:
        ws = _WORKSPACES[key] = make()
    return ws


def check_launch(rc: int, error_string: Callable[[int], bytes],
                 kernel: str, x: torch.Tensor) -> None:
    """Raise with the runtime's message (``error_string(rc)``) if the
    launch failed; count it otherwise."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed for {tuple(x.shape)} "
                           f"{x.dtype}: {error_string(rc).decode()}")
    LAUNCHES[kernel] += 1
