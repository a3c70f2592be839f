"""One-phase all-pairs AllReduce (1PA), LL or HB protocol.

Port of ``repro/kernels/allreduce_1pa.py``. Paper §4.4-1PA: for small
messages every rank puts its whole buffer into every peer's slot and
reduces all n buffers locally — n-fold traffic, but one synchronisation
step. LL (paper §4.2.2) folds the flag into the data.

The CUDA kernel (``csrc/allreduce_1pa.cu``) runs one thread-block cluster
of n blocks per tile (:func:`geometry`): the slots are the receivers'
shared memory, HB delivers a tile with one multicast bulk copy and LL with
8-byte {data, flag} packets, and nothing outlives the launch — no
workspace, no flags, no epoch.

Rank ``r`` folds rotated from itself, ``x[r] + x[r+1] + ... + x[r-1]``,
rounding after each add like the reference, so ranks may differ in the
last bit; the kernel and :func:`all_reduce_1pa_plain` both keep that
order and are bit-equal to the reference, ``torch.sum`` is not.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Set

import torch

from repro_torch.core.channels import MemoryChannel, Protocol
from repro_torch.kernels import comm_utils

__all__ = ["all_reduce_1pa", "all_reduce_1pa_plain", "geometry", "Geometry"]

KERNEL = "all_reduce_1pa"
SMEM_MAX = 232448        # 227 KB: one block's shared memory on an H100
SLOT0 = 16               # the HB mbarrier, ahead of the slots
MIN_TILE = 2048          # bytes: LL, one packet word a thread (THREADS)
# blocks in all that the tiles aim at once a rank holds more than MIN_TILE
# a cluster (LL, HB): about four and two an SM. An LL block's packet stores
# into its peers, not its bytes, set its time, so LL spreads wider
TARGET_BLOCKS = {True: 512, False: 256}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The launch of one 1PA call: ``grid = n * tiles`` blocks in clusters
    of ``cluster = n``; tile t is elements ``[t * tile_elems, (t + 1) *
    tile_elems)`` of every rank (``tile_bytes`` each, a multiple of 16;
    the last tile may be shorter); each block holds ``n`` slots of
    ``slot_bytes`` (LL: 8-byte packets, one per 4 data bytes) after the
    mbarrier, ``smem_bytes`` of dynamic shared memory in all."""

    tiles: int
    tile_elems: int
    tile_bytes: int
    grid: int
    cluster: int
    slot_bytes: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def geometry(n: int, count: int, esz: int, use_ll: bool) -> Geometry:
    """The tiles of ``count`` elements of ``esz`` bytes a rank: about
    ``TARGET_BLOCKS[use_ll] / n`` clusters, a tile at least ``MIN_TILE``
    bytes and at most what lets n slots fit ``SMEM_MAX``."""
    rank_bytes = count * esz
    per_byte = 2 if use_ll else 1          # an LL packet carries 4 bytes in 8
    cap = (SMEM_MAX - SLOT0) // (n * per_byte) // 16 * 16
    want = -(-rank_bytes // max(1, TARGET_BLOCKS[use_ll] // n))
    tile_bytes = min(cap, max(MIN_TILE, -(-want // 16) * 16))
    tile_elems = tile_bytes // esz
    tiles = -(-count // tile_elems)
    slot_bytes = min(tile_bytes, -(-rank_bytes // 16) * 16) * per_byte
    return Geometry(tiles=tiles, tile_elems=tile_elems, tile_bytes=tile_bytes,
                    grid=n * tiles, cluster=n, slot_bytes=slot_bytes,
                    smem_bytes=SLOT0 + n * slot_bytes)


def ll_flag_value(step: int) -> int:
    """The reference's distinct, never-zero LL flag of a step."""
    return (int(step) % 2 ** 30) * 2 + 0x5A5A5


def all_reduce_1pa(x: torch.Tensor, *, use_ll: bool = True, step: int = 0,
                   backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, rows, cols)``, rank ``r``'s buffer at ``x[r]`` -> the
    same shape, every rank holding the sum.

    ``step`` is kept for the reference's signature: the plain version
    derives its LL flag from it as the reference does, while the kernel
    resets its flags in shared memory at every launch, so a repeated
    ``step`` is safe. ``backend``: ``None`` (kernel for a CUDA tensor,
    plain for a CPU one), ``"cuda"`` or ``"torch"``."""
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


#: (dtype code, use_ll, n, shared memory, device) shapes whose cluster
#: the card was asked about and can hold
_PREPARED: Set[tuple] = set()


def _prepare(lib, code: int, use_ll: bool, n: int, geo: Geometry,
             x: torch.Tensor) -> None:
    """Raise unless the card can schedule a cluster of this shape
    (``cudaOccupancyMaxActiveClusters``); asked once per shape."""
    key = (code, use_ll, n, geo.smem_bytes, x.device)
    if key in _PREPARED:
        return
    clusters = ctypes.c_int(0)
    rc = lib.allreduce_1pa_prepare(code, int(use_ll), n, geo.smem_bytes,
                                   comm_utils.THREADS, ctypes.byref(clusters))
    what = (f"{KERNEL}: a cluster of {n} blocks of {comm_utils.THREADS} "
            f"threads and {geo.smem_bytes} bytes of shared memory")
    if rc != 0:
        raise comm_utils.KernelLaunchError(
            f"{what}: {lib.allreduce_1pa_error_string(rc).decode()}")
    if clusters.value < 1:
        raise comm_utils.KernelLaunchError(
            f"{what} is not schedulable on {x.device} "
            f"(cudaOccupancyMaxActiveClusters: 0)")
    _PREPARED.add(key)


def _launch(x: torch.Tensor, use_ll: bool, pdl: bool = True) -> torch.Tensor:
    """One launch; ``pdl``: programmatic dependent launch (its set-up
    overlaps the previous kernel's tail), what every call takes; False only
    to time the difference."""
    from repro_torch.kernels import build
    code = comm_utils.check_kernel_input(x)
    n, count = x.shape[0], x[0].numel()
    if count == 0:
        return torch.empty_like(x)
    geo = geometry(n, count, x.element_size(), use_ll)
    lib = build.allreduce_1pa_library()
    _prepare(lib, code, use_ll, n, geo, x)
    out = torch.empty_like(x)
    rc = lib.allreduce_1pa_launch(
        x.data_ptr(), out.data_ptr(), code, n, count, geo.tile_elems,
        geo.tiles, geo.slot_bytes, geo.smem_bytes, int(use_ll),
        comm_utils.THREADS, torch.cuda.current_stream(x.device).cuda_stream,
        int(pdl))
    comm_utils.check_launch(rc, lib.allreduce_1pa_error_string, KERNEL, x)
    return out
