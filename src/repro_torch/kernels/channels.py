"""Check kernels of the channel layer's device side: a ``PortChannel`` put
and a ``FusedReduceChannel`` all-reduce (``csrc/channels.cu`` over
``csrc/channels.cuh``).

The reference's ``PortChannel`` and ``FusedReduceChannel``
(``repro/core/channels.py:134``, ``:145``) have no caller, and no
algorithm, selector entry or path of the port calls these entry points
either: they exist so that the channels' device side is built, launched
and held against the plain models of :mod:`repro_torch.core.channels` on
the card (``chip_smoke.py`` phase 19). On a CPU tensor each wrapper runs
its plain version; on a CUDA tensor it launches its kernel or raises
(:class:`~repro_torch.kernels.build.KernelBuildError`,
:class:`~repro_torch.kernels.build.KernelLaunchError`), never falling
back.

* :func:`port_put`: ``out[(r + 1) % n] = x[r]`` — every rank puts its
  buffer into the next rank's slot through a ``PortChannel`` (TMA bulk
  copies; ``tma=False`` puts with the block's threads instead, for
  comparison), flushes and signals, and the peer waits and copies the
  slot out.
* :func:`fused_reduce`: ``FusedReduceChannel.broadcast`` then ``reduce``,
  an all-reduce folded in the reference's order on every rank.

The epoch lives on the card (one word a block, bumped by the kernel), so
a CUDA graph may capture a launch once its workspace exists.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channels import FusedReduceChannel, PortChannel
from repro_torch.kernels import comm_utils

__all__ = ["port_put", "port_put_plain", "fused_reduce",
           "fused_reduce_plain", "slot_stride"]

EPOCH = 1   # the plain models' epoch: one launch, flags from zero


def slot_stride(count: int, esize: int) -> int:
    """Bytes a slot: the payload rounded up to 16, and 16 more, since the
    sender's data starts at its source's address modulo 16 (the bulk copy
    needs both of its ends 16-byte aligned)."""
    return -(-count * esize // 16) * 16 + 16


def port_put(x: torch.Tensor, *, tma: bool = True,
             backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, rows, cols)`` -> ``out`` with ``out[(r + 1) % n] = x[r]``:
    rank ``r``'s put through its ``PortChannel`` to rank ``(r + 1) %
    n`` (launch count ``port_put``; ``port_put_sm`` with ``tma=False``)."""
    comm_utils.check_2d(x)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return port_put_plain(x)
    return _launch_put(x.contiguous(), tma)


def port_put_plain(x: torch.Tensor) -> torch.Tensor:
    """The channel model: put into the next rank's one slot, flush,
    signal; every rank waits for its flag and reads its slot."""
    n = x.shape[0]
    me = torch.arange(n, device=x.device)
    chan = PortChannel((me + 1) % n)
    slots = torch.zeros((n, 1) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    flags = torch.zeros(n, dtype=torch.int32, device=x.device)
    chan.put_with_signal(x, slots, torch.zeros_like(me))
    chan.flush()
    chan.signal(flags, EPOCH)
    chan.wait(flags, EPOCH)
    return slots[:, 0].clone()


def fused_reduce(x: torch.Tensor, *,
                 backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, rows, cols)`` -> every rank's ``x[r] + x[r+1] + ... +
    x[r-1]`` (indices mod n, rounded after every add): the
    ``FusedReduceChannel`` all-reduce."""
    comm_utils.check_2d(x)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return fused_reduce_plain(x)
    return _launch_reduce(x.contiguous())


def fused_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """The channel model: broadcast into every peer's per-sender slot,
    then reduce on arrival."""
    n = x.shape[0]
    chan = FusedReduceChannel(n, x.device)
    slots = torch.zeros((n, n) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    flags = torch.zeros((n, n), dtype=torch.int32, device=x.device)
    chan.broadcast(x, slots, flags, EPOCH)
    return chan.reduce(x, slots, flags, EPOCH)


def _workspace(kernel: str, x: torch.Tensor, slots_per_rank: int,
               flags_per_block: int) -> comm_utils.Workspace:
    """Slots, flags and the epoch words of ``kernel`` for ``x``'s shape,
    made at the first call (outside a capture: a graph replays kernels,
    it allocates nothing)."""
    n = x.shape[0]
    count = x[0].numel()

    def make():
        if torch.cuda.is_initialized() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{kernel}: the first call of a shape allocates its "
                f"workspace; make it before a CUDA-graph capture")
        blocks = comm_utils.blocks_per_rank(count * x.element_size(), n)
        stride = slot_stride(count, x.element_size())
        slots = torch.empty(n * slots_per_rank * stride, dtype=torch.uint8,
                            device=x.device)
        flags = torch.zeros(n * flags_per_block * blocks, dtype=torch.int32,
                            device=x.device)
        epochs = torch.zeros(n * blocks, dtype=torch.int32, device=x.device)
        return comm_utils.Workspace(blocks, (slots, flags, epochs))

    return comm_utils.workspace(kernel, x, make)


def _launch_put(x: torch.Tensor, tma: bool) -> torch.Tensor:
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    kernel = "port_put" if tma else "port_put_sm"
    n = x.shape[0]
    ws = _workspace(kernel, x, 1, 1)
    slots, flags, epochs = ws.tensors
    out = torch.empty_like(x)
    lib = build.channels_library()
    rc = lib.port_put_launch(
        x.data_ptr(), out.data_ptr(), slots.data_ptr(),
        slot_stride(x[0].numel(), x.element_size()), flags.data_ptr(),
        epochs.data_ptr(), code, n, x[0].numel(), ws.blocks,
        int(tma), comm_utils.THREADS,
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.channels_error_string, kernel, x)
    return out


def _launch_reduce(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    kernel = "fused_reduce"
    n = x.shape[0]
    ws = _workspace(kernel, x, n, n)
    slots, flags, epochs = ws.tensors
    out = torch.empty_like(x)
    lib = build.channels_library()
    rc = lib.fused_reduce_launch(
        x.data_ptr(), out.data_ptr(), slots.data_ptr(),
        slot_stride(x[0].numel(), x.element_size()), flags.data_ptr(),
        epochs.data_ptr(), code, n, x[0].numel(), ws.blocks,
        comm_utils.THREADS, torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.channels_error_string, kernel, x)
    return out
