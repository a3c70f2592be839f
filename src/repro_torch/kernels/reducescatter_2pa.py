"""All-pairs ReduceScatter / AllGather — the two phases of 2PA AllReduce.

Port of ``repro/kernels/reducescatter_2pa.py`` (paper §4.4-2PA, Fig. 5):
one-sided puts with receiver-side waits, and one block of each rank
reading every peer's chunk in one fold. The CUDA kernels are
``csrc/allpairs_2pa.cu``; ``all_reduce_2pa`` is RS then AG, two
launches, as the reference makes two ``pallas_call``s.

Rank ``c`` folds chunk ``c`` rotated from itself, ``x[c][c] + x[c+1][c]
+ ... + x[c-1][c]``, rounding after each add like the reference; the
kernel and :func:`reduce_scatter_2pa_plain` keep that order.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channels import MemoryChannel
from repro_torch.kernels import comm_utils

__all__ = ["reduce_scatter_2pa", "all_gather_2pa", "all_reduce_2pa",
           "reduce_scatter_2pa_plain", "all_gather_2pa_plain"]

RS_KERNEL = "reduce_scatter_2pa"
AG_KERNEL = "all_gather_2pa"


def _chunk_rows(x: torch.Tensor) -> int:
    n, total = x.shape[0], x.shape[1]
    if total % n:
        raise ValueError(f"{total} rows per rank do not split into {n} "
                         f"chunks")
    return total // n


def reduce_scatter_2pa(x: torch.Tensor, *,
                       backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, n*rows, cols)``, rank ``d``'s contribution to every chunk
    -> ``(n, rows, cols)``, rank ``c`` holding reduced chunk ``c``."""
    comm_utils.check_2d(x)
    _chunk_rows(x)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return reduce_scatter_2pa_plain(x)
    return _launch_rs(x.contiguous())


def all_gather_2pa(x: torch.Tensor, *,
                   backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, rows, cols)`` per-rank chunks -> ``(n, n*rows, cols)``,
    every rank holding all chunks in rank order."""
    comm_utils.check_2d(x)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return all_gather_2pa_plain(x)
    return _launch_ag(x.contiguous())


def all_reduce_2pa(x: torch.Tensor, *,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Two-phase all-pairs AllReduce (paper §4.4-2PA): ``(n, n*rows,
    cols)`` -> the same shape, fully reduced on every rank."""
    shard = reduce_scatter_2pa(x, backend=backend)
    return all_gather_2pa(shard, backend=backend)


def reduce_scatter_2pa_plain(x: torch.Tensor) -> torch.Tensor:
    """The reference's order on the channel model: put chunk ``peer``
    into the peer's slot ``[me]``, then fold chunk ``me`` rotated."""
    n, cols = x.shape[0], x.shape[2]
    rows = _chunk_rows(x)
    xs = x.reshape(n, n, rows, cols)
    me = torch.arange(n, device=x.device)
    slots = torch.zeros((n, n, rows, cols), dtype=x.dtype, device=x.device)
    for i in range(1, n):
        peer = (me + i) % n
        MemoryChannel(peer).put(xs[me, peer], slots, me)
    acc = xs[me, me]
    for i in range(1, n):
        acc = acc + slots[me, (me + i) % n]
    return acc


def all_gather_2pa_plain(x: torch.Tensor) -> torch.Tensor:
    """The reference's order on the channel model: my chunk into my own
    row block, then from there into row block ``[me]`` of every peer."""
    n, rows, cols = x.shape
    me = torch.arange(n, device=x.device)
    out = torch.zeros((n, n, rows, cols), dtype=x.dtype, device=x.device)
    out[me, me] = x
    for i in range(1, n):
        MemoryChannel((me + i) % n).put(out[me, me], out, me)
    return out.reshape(n, n * rows, cols)


def _launch_rs(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    n, cols = x.shape[0], x.shape[2]
    rows = _chunk_rows(x)
    count = rows * cols

    def make():
        blocks = comm_utils.blocks_per_rank(n * count * x.element_size(), n)
        scratch = torch.empty((n, n, count), dtype=x.dtype, device=x.device)
        flags = torch.zeros(n * n * blocks, dtype=torch.int32,
                            device=x.device)
        return comm_utils.Workspace(blocks, (scratch, flags))

    ws = comm_utils.workspace(RS_KERNEL, x, make)
    scratch, flags = ws.tensors
    out = torch.empty((n, rows, cols), dtype=x.dtype, device=x.device)
    lib = build.allpairs_2pa_library()
    rc = lib.reduce_scatter_2pa_launch(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
        code, n, count, ws.blocks, ws.next_epoch(), comm_utils.THREADS,
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.allpairs_2pa_error_string, RS_KERNEL, x)
    return out


def _launch_ag(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    n, rows, cols = x.shape

    def make():
        blocks = comm_utils.blocks_per_rank(x[0].numel() * x.element_size(),
                                            n)
        flags = torch.zeros(n * n * blocks, dtype=torch.int32,
                            device=x.device)
        return comm_utils.Workspace(blocks, (flags,))

    ws = comm_utils.workspace(AG_KERNEL, x, make)
    (flags,) = ws.tensors
    out = torch.empty((n, n * rows, cols), dtype=x.dtype, device=x.device)
    lib = build.allpairs_2pa_library()
    rc = lib.all_gather_2pa_launch(
        x.data_ptr(), out.data_ptr(), flags.data_ptr(), code, n,
        rows * cols, ws.blocks, ws.next_epoch(), comm_utils.THREADS,
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.allpairs_2pa_error_string, AG_KERNEL, x)
    return out
