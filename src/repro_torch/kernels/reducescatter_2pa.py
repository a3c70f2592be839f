"""All-pairs ReduceScatter / AllGather — the two phases of 2PA AllReduce.

Port of ``repro/kernels/reducescatter_2pa.py`` (paper §4.4-2PA, Fig. 5):
one-sided puts with receiver-side waits, and one block of each rank
reading every peer's chunk in one fold. The CUDA kernels are
``csrc/allpairs_2pa.cu``; ``all_reduce_2pa`` is RS then AG, two
launches, as the reference makes two ``pallas_call``s.

Rank ``c`` folds chunk ``c`` rotated from itself, ``x[c][c] + x[c+1][c]
+ ... + x[c-1][c]``, rounding after each add like the reference; the
kernel and :func:`reduce_scatter_2pa_plain` keep that order.

The ReduceScatter kernel has two protocols with that one fold, so both
are bit-equal to the plain version: LL packets (paper §4.2.2; 4 data
bytes and the launch's epoch in one 8-byte store, the receiver spinning
on each packet) for a rank's input of at most :data:`LL_MAX_BYTES`, and
HB (vector puts, then one flag round trip) above it. The AllGather
kernel has the same two protocols, LL for a rank's input of at most
:data:`AG_LL_MAX_BYTES`: every packet carries a word of the chunk straight
into the peer's output row block, with no fold. The reference has no
protocol argument, so neither do :func:`reduce_scatter_2pa` and
:func:`all_gather_2pa`: the bytes decide (:func:`rs_protocol`,
:func:`ag_protocol`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channels import MemoryChannel
from repro_torch.kernels import comm_utils

__all__ = ["reduce_scatter_2pa", "all_gather_2pa", "all_reduce_2pa",
           "reduce_scatter_2pa_plain", "all_gather_2pa_plain",
           "rs_protocol", "ag_protocol", "ll_words", "LL_MAX_BYTES",
           "AG_LL_MAX_BYTES"]

RS_KERNEL = "reduce_scatter_2pa"
AG_KERNEL = "all_gather_2pa"
#: the largest input a rank (its n chunks, in bytes) whose ReduceScatter
#: goes by LL packets; HB above. Where the two protocols' times cross in
#: chip_smoke.py phase 8's sweep (n = 4, bf16, NVIDIA H100 80GB HBM3 at
#: 700 W): LL is faster up to 512 KiB a rank, HB from 1 MiB (see
#: PERF.md §6, row 3, for the times).
LL_MAX_BYTES = 512 << 10
#: the largest input a rank (its one chunk, in bytes) whose AllGather goes
#: by LL packets; HB above. Where the two protocols' times cross in
#: chip_smoke.py phase 8's sweep (n = 4, bf16, NVIDIA H100 80GB HBM3 at
#: 700 W): LL is faster up to 128 KiB a rank, HB from 256 KiB, where the
#: packets' 8 bytes on the wire for 4 of data cost more than HB's flag
#: round trip (see PERF.md §6, row 4, for the times)
AG_LL_MAX_BYTES = 128 << 10


def rs_protocol(nbytes: int) -> str:
    """The ReduceScatter kernel's protocol for a rank input of ``nbytes``:
    ``"ll"`` up to :data:`LL_MAX_BYTES`, else ``"hb"``."""
    return "ll" if nbytes <= LL_MAX_BYTES else "hb"


def ag_protocol(nbytes: int) -> str:
    """The AllGather kernel's protocol for a rank input of ``nbytes``:
    ``"ll"`` up to :data:`AG_LL_MAX_BYTES`, else ``"hb"``."""
    return "ll" if nbytes <= AG_LL_MAX_BYTES else "hb"


def ll_words(count: int, element_size: int) -> int:
    """LL packet words of a chunk of ``count`` elements: 4 data bytes a
    packet, so an odd count of 2-byte elements ends in a word whose top
    half is zero."""
    return -(-count * element_size // 4)


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


def _launch_rs(x: torch.Tensor,
               protocol: Optional[str] = None) -> torch.Tensor:
    """One launch of the ReduceScatter kernel; ``protocol`` (``"ll"`` or
    ``"hb"``) overrides :func:`rs_protocol` for measuring the two side by
    side."""
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    n, cols = x.shape[0], x.shape[2]
    rows = _chunk_rows(x)
    count = rows * cols
    protocol = protocol or rs_protocol(x[0].numel() * x.element_size())
    use_ll = protocol == "ll"

    def make():
        if use_ll:      # one packet word per thread: the folds overlap
            words = ll_words(count, x.element_size())
            blocks = comm_utils.blocks_per_rank(words, n, comm_utils.THREADS)
            slots = torch.zeros((n, n, words, 2), dtype=torch.int32,
                                device=x.device)
        else:
            blocks = comm_utils.blocks_per_rank(n * count * x.element_size(),
                                                n)
            slots = torch.empty((n, n, count), dtype=x.dtype, device=x.device)
        flags = torch.zeros(n * n * blocks, dtype=torch.int32,
                            device=x.device)
        return comm_utils.Workspace(blocks, (slots, flags))

    ws = comm_utils.workspace(f"{RS_KERNEL}/{protocol}", x, make)
    slots, flags = ws.tensors
    out = torch.empty((n, rows, cols), dtype=x.dtype, device=x.device)
    lib = build.allpairs_2pa_library()
    rc = lib.reduce_scatter_2pa_launch(
        x.data_ptr(), out.data_ptr(), slots.data_ptr(), flags.data_ptr(),
        code, n, count, ws.blocks, int(use_ll), ws.next_epoch(),
        comm_utils.THREADS, torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.allpairs_2pa_error_string, RS_KERNEL, x)
    return out


def _launch_ag(x: torch.Tensor,
               protocol: Optional[str] = None) -> torch.Tensor:
    """One launch of the AllGather kernel; ``protocol`` (``"ll"`` or
    ``"hb"``) overrides :func:`ag_protocol` for measuring the two side by
    side. Each protocol keeps its own workspace, so their epochs never
    mix."""
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    n, rows, cols = x.shape
    count = rows * cols
    protocol = protocol or ag_protocol(count * x.element_size())
    use_ll = protocol == "ll"

    def make():
        if use_ll:      # a block per THREADS packet words, up to the cap
            words = ll_words(count, x.element_size())
            blocks = comm_utils.blocks_per_rank(words, n, comm_utils.THREADS)
            sync = torch.zeros((n, n, words, 2), dtype=torch.int32,
                               device=x.device)
        else:
            blocks = comm_utils.blocks_per_rank(count * x.element_size(), n)
            sync = torch.zeros(n * n * blocks, dtype=torch.int32,
                               device=x.device)
        return comm_utils.Workspace(blocks, (sync,))

    ws = comm_utils.workspace(f"{AG_KERNEL}/{protocol}", x, make)
    (sync,) = ws.tensors
    out = torch.empty((n, n * rows, cols), dtype=x.dtype, device=x.device)
    lib = build.allpairs_2pa_library()
    rc = lib.all_gather_2pa_launch(
        x.data_ptr(), out.data_ptr(), sync.data_ptr(), code, n, count,
        ws.blocks, int(use_ll), ws.next_epoch(), comm_utils.THREADS,
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.allpairs_2pa_error_string, AG_KERNEL, x)
    return out
