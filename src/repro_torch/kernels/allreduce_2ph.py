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
``csrc/allreduce_2ph.cu``, one cooperative launch for every rank. Every
rank's buffers lie on one card, so its phase 1 reads the local peers'
inputs (gets) and its phase 2 writes the sum straight into every local
rank's output: the only scratch is one chunk a rank for the phase-1
partial, and flags (:func:`scratch_geometry`).

The fold order is the reference kernel's, rounding after each add:
rank ``(node, l)`` sums its own chunk ``l`` first, then the slots of
local peers ``l+1, ..., l-1``; in phase 2 it starts from its own node's
partial and adds nodes ``node+1, ..., node-1``. The kernel and
:func:`all_reduce_2ph_plain` keep that order, so they are bit-equal to
each other and to the reference in f32 and bf16.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.channels import MemoryChannel
from repro_torch.kernels import comm_utils

__all__ = ["all_reduce_2ph", "all_reduce_2ph_plain", "scratch_geometry",
           "traffic_bytes", "Scratch", "MAX_RANKS"]

KERNEL = "all_reduce_2ph"
MAX_RANKS = 16        # kMaxRanks2ph in csrc/allreduce_2ph.cu: up to 4 x 4
#: bytes of a sub-tile: the kernel's phase 2 on one sub-tile runs after its
#: phase 1 on the next, so about two sub-tiles a block of partials are in
#: flight and stay in L2 (2 x 32 KiB x 264 blocks = 17 MB of its 50 MB)
SUB_BYTES = 32 << 10


@dataclasses.dataclass(frozen=True)
class Scratch:
    """The kernel's launch geometry and device scratch for one payload."""

    blocks: int       # blocks a rank
    sub: int          # elements a sub-tile (a multiple of 16 bytes)
    subtiles: int     # the most sub-tiles a block's tile holds
    partial: int      # elements of each rank's phase-1 partial: one chunk
    flags: int        # entry, ready (one a sub-tile) and done flags, all ranks


def scratch_geometry(nn: int, lnum: int, count: int, element_size: int,
                     max_blocks: int) -> Scratch:
    """The 2PH kernel's geometry for ``nn`` nodes of ``lnum`` ranks, each
    holding ``lnum`` chunks of ``count`` elements, with at most
    ``max_blocks`` blocks resident on the card: one block per TILE_BYTES
    of a rank's input; block b's tile of a chunk as ``primitives.cuh:tile``
    cuts it (bounds on 16-byte units); the partial one chunk a rank (D/L,
    D a rank's input), no D-sized slots."""
    total = nn * lnum
    rank_bytes = lnum * count * element_size
    blocks = max(1, min(max_blocks // total,
                        -(-rank_bytes // comm_utils.TILE_BYTES)))
    align = 16 // element_size
    tile = -(-(-(-count // align)) // blocks) * align
    sub = SUB_BYTES // element_size
    subtiles = max(1, -(-tile // sub))
    return Scratch(blocks=blocks, sub=sub, subtiles=subtiles, partial=count,
                   flags=total * blocks * (subtiles + 2))


def traffic_bytes(nn: int, lnum: int, rank_bytes: int) -> Tuple[int, int]:
    """(read, written) bytes a rank moves through the kernel by its own
    count, D = ``rank_bytes``: phase 1 reads D (a tile of its chunk from
    each local peer) and writes its partial, D/L; phase 2 reads nn
    partials, nn D/L, and writes D (its chunk into L outputs). The bound
    is D read and D written."""
    chunk = rank_bytes // lnum
    return rank_bytes + nn * chunk, chunk + rank_bytes


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
        geo = scratch_geometry(nn, lnum, count, x.element_size(), cap)
        flags = torch.zeros(geo.flags, dtype=torch.int32, device=x.device)
        return comm_utils.Workspace(geo.blocks, (flags,))

    ws = comm_utils.workspace(f"{KERNEL}/nodes{nn}", x, make)
    (flags,) = ws.tensors
    # the same geometry again: a cap of the workspace's blocks gives them back
    geo = scratch_geometry(nn, lnum, count, x.element_size(),
                           ws.blocks * total)
    # the partials live for one call: their contents never matter (every
    # read waits on its flag), and they go back to the allocator as soon as
    # the launch is enqueued
    part = torch.empty((total, geo.partial), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    rc = lib.allreduce_2ph_launch(
        x.data_ptr(), out.data_ptr(), part.data_ptr(), flags.data_ptr(),
        code, nn, lnum, count, ws.blocks, geo.sub, geo.subtiles,
        ws.next_epoch(), comm_utils.THREADS,
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.allreduce_2ph_error_string, KERNEL, x)
    return out
