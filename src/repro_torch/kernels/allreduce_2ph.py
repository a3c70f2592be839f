"""Two-phase hierarchical AllReduce (2PH) over a node × local rank grid.

Port of ``repro/kernels/allreduce_2ph.py`` (paper §4.4-2PH): reduce
inside each node first, cross the node boundary with 1/L of the data,
then gather inside the node again:

    phase 1: all-pairs ReduceScatter along `local` (full data)
    phase 2: all-pairs AllReduce     along `node`  (1/L of the data)
    phase 3: all-pairs AllGather     along `local` (full data)

Ranks are stacked node-major (:mod:`repro_torch.mesh`): ``x`` is
``(nn*L, L*rows, cols)``, rank ``node*L + l`` at ``x[node*L + l]``, each
rank's buffer L chunks of ``rows`` rows. The CUDA kernel is
``csrc/allreduce_2ph.cu``, one cooperative launch for every rank.

The fold order is the reference kernel's, rounding after each add:
rank ``(node, l)`` sums its own chunk ``l`` first, then the slots of
local peers ``l+1, ..., l-1``; in phase 2 it starts from its own node's
partial and adds nodes ``node+1, ..., node-1``. The kernel and
:func:`all_reduce_2ph_plain` keep that order, so they are bit-equal to
each other and to the reference in f32 and bf16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.channels import MemoryChannel
from repro_torch.kernels import comm_utils

__all__ = ["all_reduce_2ph", "all_reduce_2ph_plain", "MAX_RANKS"]

KERNEL = "all_reduce_2ph"
MAX_RANKS = 16        # kMaxRanks2ph in csrc/allreduce_2ph.cu: up to 4 x 4


def _geometry(x: torch.Tensor, node_size: Optional[int]
              ) -> Tuple[int, int, int]:
    """(nn, L, rows per chunk) of a node-major ``(nn*L, L*rows, cols)``
    payload; raises on what does not divide."""
    if node_size is None:
        raise ValueError("all_reduce algo '2ph' needs node_size, the "
                         "number of nodes the ranks are grouped into")
    total = x.shape[0]
    if node_size < 1 or total % node_size:
        raise ValueError(f"node_size={node_size} does not divide the "
                         f"{total} ranks of x")
    lnum = total // node_size
    if x.shape[1] % lnum:
        raise ValueError(f"{x.shape[1]} rows per rank do not split into "
                         f"{lnum} chunks, one per local rank")
    return node_size, lnum, x.shape[1] // lnum


def all_reduce_2ph(x: torch.Tensor, *, node_size: Optional[int],
                   backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(nn*L, L*rows, cols)``, ranks node-major, ``nn = node_size``
    -> the same shape, every rank holding the sum over all nn*L ranks.
    ``backend``: ``None`` (kernel for a CUDA tensor, plain for a CPU
    one), ``"cuda"`` or ``"torch"``."""
    comm_utils.check_2d(x)
    nn, _, _ = _geometry(x, node_size)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return all_reduce_2ph_plain(x, node_size=nn)
    return _launch(x.contiguous(), nn)


def all_reduce_2ph_plain(x: torch.Tensor, *, node_size: int) -> torch.Tensor:
    """The reference's order of operations on the channel model."""
    nn, lnum, rows = _geometry(x, node_size)
    total, cols = x.shape[0], x.shape[2]
    xs = x.reshape(total, lnum, rows, cols)
    me = torch.arange(total, device=x.device)
    node, lme = me // lnum, me % lnum

    # phase 1: ReduceScatter along `local` — chunk p to local peer p's
    # slot [lme], then the fold of my chunk
    slots = torch.zeros((total, lnum, rows, cols), dtype=x.dtype,
                        device=x.device)
    for i in range(1, lnum):
        p = (lme + i) % lnum
        MemoryChannel(node * lnum + p).put(xs[me, p], slots, lme)
    acc = xs[me, lme]
    for i in range(1, lnum):
        acc = acc + slots[me, (lme + i) % lnum]

    # phase 2: AllReduce along `node` on my chunk, staged in out[lme]
    out = torch.zeros((total, lnum, rows, cols), dtype=x.dtype,
                      device=x.device)
    out[me, lme] = acc
    node_slots = torch.zeros((total, nn, rows, cols), dtype=x.dtype,
                             device=x.device)
    for i in range(1, nn):
        peer = ((node + i) % nn) * lnum + lme
        MemoryChannel(peer).put(out[me, lme], node_slots, node)
    for i in range(1, nn):
        acc = acc + node_slots[me, (node + i) % nn]
    out[me, lme] = acc

    # phase 3: AllGather along `local` — my chunk into every local
    # peer's out[lme]
    for i in range(1, lnum):
        MemoryChannel(node * lnum + (lme + i) % lnum).put(out[me, lme], out,
                                                         lme)
    return out.reshape(total, lnum * rows, cols)


def _launch(x: torch.Tensor, nn: int) -> torch.Tensor:
    from repro_torch.kernels import build
    code = comm_utils.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"the 2PH kernel takes "
                         f"{list(comm_utils.DTYPE_CODES)}, got {x.dtype}")
    total, rank_rows, cols = x.shape
    if total > MAX_RANKS:
        raise ValueError(f"the 2PH kernel takes at most {MAX_RANKS} ranks, "
                         f"got {total}")
    lnum = total // nn
    count = rank_rows // lnum * cols
    lib = build.allreduce_2ph_library()

    def make():
        # every block of the grid spins on its peers, so all must be
        # resident: at most the card's co-resident blocks over all ranks
        cap = lib.allreduce_2ph_max_blocks(code, comm_utils.THREADS)
        if cap < total:
            raise RuntimeError(f"the 2PH kernel cannot keep one block per "
                               f"rank resident ({cap} < {total})")
        blocks = max(1, min(cap // total, -(-x[0].numel() * x.element_size()
                                             // comm_utils.TILE_BYTES)))
        flags = torch.zeros(total * (2 * lnum + nn) * blocks,
                            dtype=torch.int32, device=x.device)
        return comm_utils.Workspace(blocks, (flags,))

    ws = comm_utils.workspace(f"{KERNEL}/nodes{nn}", x, make)
    (flags,) = ws.tensors
    # the phase slots live for one call: scratch contents never matter
    # (every read waits on its flag), and they go back to the allocator
    # as soon as the launch is enqueued
    slots = torch.empty((total, lnum, count), dtype=x.dtype, device=x.device)
    node_slots = torch.empty((total, nn, count), dtype=x.dtype,
                             device=x.device)
    out = torch.empty_like(x)
    rc = lib.allreduce_2ph_launch(
        x.data_ptr(), out.data_ptr(), slots.data_ptr(),
        node_slots.data_ptr(), flags.data_ptr(), code, nn, lnum, count,
        ws.blocks, ws.next_epoch(), comm_utils.THREADS,
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.allreduce_2ph_error_string, KERNEL, x)
    return out
