"""All-pairs AllToAll — the MoE dispatch/combine collective.

Port of ``repro/kernels/alltoall.py`` (paper §2.1: MoE expert-parallel
dispatch is AllToAll's dominant user): block ``c`` of rank ``d``'s
buffer lands as block ``d`` of rank ``c``'s, by one-sided puts into the
peers' row slots and receiver-side waits — no rendezvous. The CUDA
kernel is ``csrc/alltoall.cu``; a pure copy, so the kernel and
:func:`all_to_all_plain` agree bit for bit in every dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channels import MemoryChannel
from repro_torch.kernels import comm_utils

__all__ = ["all_to_all", "all_to_all_plain"]

KERNEL = "all_to_all"


def _block_rows(x: torch.Tensor) -> int:
    n, total = x.shape[0], x.shape[1]
    if total % n:
        raise ValueError(f"{total} rows per rank do not split into {n} "
                         f"blocks")
    return total // n


def all_to_all(x: torch.Tensor, *,
               backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, n*rows, cols)`` -> the same shape, the row-block
    transpose across ranks: ``out[c][d] = x[d][c]`` (block ``d`` of rank
    ``c``'s output is block ``c`` of rank ``d``'s input)."""
    comm_utils.check_2d(x)
    _block_rows(x)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return all_to_all_plain(x)
    return _launch(x.contiguous())


def all_to_all_plain(x: torch.Tensor) -> torch.Tensor:
    """The reference's order on the channel model: my own block into my
    slot ``[me]``, then block ``peer`` into slot ``[me]`` of each peer,
    rotated from ``me + 1``."""
    n, _, cols = x.shape
    rows = _block_rows(x)
    xs = x.reshape(n, n, rows, cols)
    me = torch.arange(n, device=x.device)
    out = torch.zeros((n, n, rows, cols), dtype=x.dtype, device=x.device)
    out[me, me] = xs[me, me]
    for i in range(1, n):
        peer = (me + i) % n
        MemoryChannel(peer).put(xs[me, peer], out, me)
    return out.reshape(n, n * rows, cols)


def _launch(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    n, total, cols = x.shape
    count = _block_rows(x) * cols

    def make():
        blocks = comm_utils.blocks_per_rank(n * count * x.element_size(), n)
        flags = torch.zeros(n * n * blocks, dtype=torch.int32,
                            device=x.device)
        return comm_utils.Workspace(blocks, (flags,))

    ws = comm_utils.workspace(KERNEL, x, make)
    (flags,) = ws.tensors
    out = torch.empty((n, total, cols), dtype=x.dtype, device=x.device)
    lib = build.alltoall_library()
    rc = lib.all_to_all_launch(
        x.data_ptr(), out.data_ptr(), flags.data_ptr(), code, n, count,
        ws.blocks, ws.next_epoch(), comm_utils.THREADS,
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.alltoall_error_string, KERNEL, x)
    return out
