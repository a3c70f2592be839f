"""Ring AllGather.

Port of ``repro/kernels/allgather_ring.py``: the bandwidth-optimal
algorithm across links (paper §5.1). At each of ``n - 1`` steps rank
``me`` forwards the row block it received last step to ``next``; the
CUDA kernel is ``csrc/allgather_ring.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.channels import MemoryChannel
from repro_torch.kernels import comm_utils

__all__ = ["all_gather_ring", "all_gather_ring_plain"]

KERNEL = "all_gather_ring"


def all_gather_ring(x: torch.Tensor, *,
                    backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, rows, cols)`` per-rank chunks -> ``(n, n*rows, cols)``,
    every rank holding all chunks in rank order."""
    comm_utils.check_2d(x)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return all_gather_ring_plain(x)
    return _launch(x.contiguous())


def all_gather_ring_plain(x: torch.Tensor) -> torch.Tensor:
    """The reference's steps on the channel model: my chunk into my own
    row block, then at step ``i`` row block ``(me - i) mod n`` into the
    same row block of ``next``."""
    n, rows, cols = x.shape
    me = torch.arange(n, device=x.device)
    _, nxt = comm_utils.ring_neighbors(n, x.device)
    chan = MemoryChannel(nxt)
    out = torch.zeros((n, n, rows, cols), dtype=x.dtype, device=x.device)
    out[me, me] = x
    for i in range(n - 1):
        slot = (me - i + n) % n
        chan.put(out[me, slot], out, slot)
    return out.reshape(n, n * rows, cols)


def _launch(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    n, rows, cols = x.shape

    def make():
        blocks = comm_utils.blocks_per_rank(x[0].numel() * x.element_size(),
                                            n)
        flags = torch.zeros(max(1, n * (n - 1) * blocks), dtype=torch.int32,
                            device=x.device)
        return comm_utils.Workspace(blocks, (flags,))

    ws = comm_utils.workspace(KERNEL, x, make)
    (flags,) = ws.tensors
    out = torch.empty((n, n * rows, cols), dtype=x.dtype, device=x.device)
    lib = build.allgather_ring_library()
    rc = lib.allgather_ring_launch(
        x.data_ptr(), out.data_ptr(), flags.data_ptr(), code, n,
        rows * cols, ws.blocks, ws.next_epoch(), comm_utils.THREADS,
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.allgather_ring_error_string, KERNEL, x)
    return out
