"""One-phase all-pairs AllReduce (1PA), LL or HB protocol.

Port of ``repro/kernels/allreduce_1pa.py``. Paper §4.4-1PA: for small
messages every rank puts its whole buffer into every peer's slot and
reduces all n buffers locally — n-fold traffic, but one synchronisation
step. LL (paper §4.2.2) folds the flag into the data: the CUDA kernel
(``csrc/allreduce_1pa.cu``) writes 8-byte {data, flag} packets and the
receiver spins on each one.

Rank ``r`` folds rotated from itself, ``x[r] + x[r+1] + ... + x[r-1]``,
rounding after each add like the reference, so ranks may differ in the
last bit; the kernel and :func:`all_reduce_1pa_plain` both keep that
order and are bit-equal to the reference, ``torch.sum`` is not.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channels import MemoryChannel, Protocol
from repro_torch.kernels import comm_utils

__all__ = ["all_reduce_1pa", "all_reduce_1pa_plain"]

KERNEL = "all_reduce_1pa"


def ll_flag_value(step: int) -> int:
    """The reference's distinct, never-zero LL flag of a step."""
    return (int(step) % 2 ** 30) * 2 + 0x5A5A5


def all_reduce_1pa(x: torch.Tensor, *, use_ll: bool = True, step: int = 0,
                   backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, rows, cols)``, rank ``r``'s buffer at ``x[r]`` -> the
    same shape, every rank holding the sum.

    ``step`` is kept for the reference's signature: the plain version
    derives its LL flag from it as the reference does, while the kernel
    takes a fresh epoch per launch, so a repeated ``step`` is safe.
    ``backend``: ``None`` (kernel for a CUDA tensor, plain for a CPU
    one), ``"cuda"`` or ``"torch"``."""
    comm_utils.check_2d(x)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return all_reduce_1pa_plain(x, use_ll=use_ll, step=step)
    return _launch(x.contiguous(), use_ll)


def all_reduce_1pa_plain(x: torch.Tensor, *, use_ll: bool = True,
                         step: int = 0) -> torch.Tensor:
    """The reference's order of operations on the channel model: fan-out
    into every peer's slot ``[me]``, then the rotated fold."""
    n = x.shape[0]
    me = torch.arange(n, device=x.device)
    flag = ll_flag_value(step)
    protocol = Protocol.LL if use_ll else Protocol.HB
    if use_ll:
        words = -(-x[0].numel() * x.element_size() // 4)
        slots = torch.zeros((n, n, words, 2), dtype=torch.int32,
                            device=x.device)
    else:
        slots = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
    for i in range(1, n):
        chan = MemoryChannel((me + i) % n, protocol)
        if use_ll:
            chan.put_ll(x, slots, me, flag)
        else:
            chan.put(x, slots, me)
    acc = x.clone()
    for i in range(1, n):
        peer = (me + i) % n
        if use_ll:
            got = MemoryChannel(peer, protocol).read_ll(
                slots, peer, flag, dtype=x.dtype, shape=x.shape[1:])
        else:
            got = slots[me, peer]
        acc = acc + got
    return acc


def _launch(x: torch.Tensor, use_ll: bool) -> torch.Tensor:
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    n, count = x.shape[0], x[0].numel()
    name = f"{KERNEL}/{'ll' if use_ll else 'hb'}"

    def make():
        words = -(-count * x.element_size() // 4)
        if use_ll:      # one packet word per thread: the folds overlap
            blocks = comm_utils.blocks_per_rank(words, n, comm_utils.THREADS)
            slots = torch.zeros((n, n, words, 2), dtype=torch.int32,
                                device=x.device)
        else:
            blocks = comm_utils.blocks_per_rank(count * x.element_size(), n)
            slots = torch.empty((n, n, count), dtype=x.dtype, device=x.device)
        flags = torch.zeros(n * n * blocks, dtype=torch.int32,
                            device=x.device)
        return comm_utils.Workspace(blocks, (slots, flags))

    ws = comm_utils.workspace(name, x, make)
    slots, flags = ws.tensors
    out = torch.empty_like(x)
    lib = build.allreduce_1pa_library()
    rc = lib.allreduce_1pa_launch(
        x.data_ptr(), out.data_ptr(), slots.data_ptr(), flags.data_ptr(),
        code, n, count, ws.blocks, int(use_ll), ws.next_epoch(),
        comm_utils.THREADS, torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.allreduce_1pa_error_string, KERNEL, x)
    return out
