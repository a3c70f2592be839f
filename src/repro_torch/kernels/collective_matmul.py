"""AllGather-matmul: ``all_gather(x) @ w`` with the ring transfer of one
chunk overlapped with the product of another (compute/communication
fusion).

Port of ``repro/kernels/collective_matmul.py``, the tensor-parallel
pattern of row-sharded activations gathered into a column-sharded
projection. Ranks are stacked on the leading axis: ``x`` is ``(n, rows,
K)``, rank ``r``'s shard at ``x[r]``; ``w`` is ``(K, F)`` shared by every
rank (as the reference's test passes it) or ``(n, K, F)``, rank ``r``'s
own at ``w[r]`` (a per-device operand under ``shard_map``). The result is
``(n, n*rows, F)``: ``out[r] = concat_s(x[s]) @ w[r]``, rows in
all-gather order.

The reference's schedule is a ring: at step ``i`` rank ``me`` forwards
chunk ``(me - i) mod n`` to rank ``me + 1`` and multiplies it into output
row block ``(me - i) mod n``; :func:`allgather_matmul_plain` runs it on
the channel model with an f32 ``matmul`` per chunk. The CUDA kernel
(``csrc/collective_matmul.cu``) computes the product in its own body with
f32 accumulation, cast once to ``out_dtype``. In bf16 it has two regimes
(:func:`regime`): at prefill the ring, each product a TMA-fed ``wgmma``
GEMM; at decode an all-pairs gather, then one pass over each rank's
``w`` for all gathered rows, split over k to fill the card
(:func:`decode_splits`). f32 in runs the ring on true f32 FMAs.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.channels import MemoryChannel
from repro_torch.kernels import comm_utils

__all__ = ["allgather_matmul", "allgather_matmul_plain", "regime",
           "decode_splits", "DECODE_MAX_ROWS"]

KERNEL = "allgather_matmul"
_TYPES = (torch.float32, torch.bfloat16)
#: gathered rows (n * rows) up to which bf16 takes the decode regime: one
#: 64-row wgmma tile holds every gathered row (``Decode::BM``)
DECODE_MAX_ROWS = 64
#: the decode regime's column tile and k-tile (``Decode::BN``, ``kBK``;
#: the wrapper sizes the split counters and partials by them)
DECODE_BN, K_TILE = 64, 64
_REGIME_CODES = {"prefill": 0, "decode": 1}


def regime(n: int, rows: int) -> str:
    """The bf16 kernel's regime for ``n`` ranks of ``rows`` rows:
    ``"decode"`` when the gathered rows fit one 64-row tile (``n * rows
    <= DECODE_MAX_ROWS = 64``): every rank puts its rows into every peer's
    gather buffer, then one product item per (rank, column tile, k-split)
    reads its tile of ``w[r]`` once for all gathered rows. ``"prefill"``
    above: the ring, one 128 x 256 product item per (rank, slot, row tile,
    column tile)."""
    return "decode" if n * rows <= DECODE_MAX_ROWS else "prefill"


def decode_splits(n: int, k: int, f: int, sms: int) -> Tuple[int, int]:
    """``(splits, k-tiles a split)`` of the decode regime: the fewest
    k-splits that give the ``n * ceil(f / 64)`` column tiles at least
    ``sms`` product items (one per SM), every split a run of whole
    64-deep k-tiles and none empty. The partial sums are added in split
    order, so the result is the same from run to run."""
    tiles_n, kt = -(-f // DECODE_BN), -(-k // K_TILE)
    want = min(kt, max(1, -(-sms // (n * tiles_n))))
    per = -(-kt // want)
    return -(-kt // per), per


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.dtype:
    if x.dim() != 3:
        raise ValueError(f"x must be 2D (rows, K) per rank, stacked as (n, "
                         f"rows, K); got {tuple(x.shape)}")
    if w.dim() not in (2, 3) or (w.dim() == 3 and w.shape[0] != x.shape[0]):
        raise ValueError(f"w must be (K, F) shared or (n, K, F) per rank "
                         f"with n = {x.shape[0]}; got {tuple(w.shape)}")
    if w.shape[-2] != x.shape[2]:
        raise ValueError(f"x's K = {x.shape[2]} does not match w's K = "
                         f"{w.shape[-2]} ({tuple(x.shape)} @ "
                         f"{tuple(w.shape)})")
    if x.dtype != w.dtype or x.dtype not in _TYPES:
        raise ValueError(f"x and w must share one of {list(_TYPES)}, got "
                         f"{x.dtype} and {w.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _TYPES:
        raise ValueError(f"out_dtype must be one of {list(_TYPES)}, got "
                         f"{out_dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} and w on {w.device}")
    return out_dtype


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, *,
                     out_dtype: Optional[torch.dtype] = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """x: ``(n, rows, K)`` shards; w: ``(K, F)`` or ``(n, K, F)`` ->
    ``(n, n*rows, F)`` in ``out_dtype`` (default x's): every rank's
    gathered activations times its weight. ``backend``: ``None`` (kernel
    for a CUDA tensor, plain for a CPU one), ``"cuda"`` or ``"torch"``."""
    out_dtype = _check(x, w, out_dtype)
    if comm_utils.resolve_backend(x, backend) == "torch":
        return allgather_matmul_plain(x, w, out_dtype=out_dtype)
    return _launch(x.contiguous(), w.contiguous(), out_dtype)


def allgather_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """The reference's ring schedule on the channel model: at step ``i``
    the put of chunk ``(me - i) mod n`` to the next rank, then its
    product (f32 accumulation, cast to ``out_dtype``) into that row
    block."""
    out_dtype = _check(x, w, out_dtype)
    n, rows, k = x.shape
    me = torch.arange(n, device=x.device)
    nxt = (me + 1) % n
    xbuf = torch.zeros((n, n, rows, k), dtype=x.dtype, device=x.device)
    xbuf[me, me] = x
    wf = w.float()
    out = torch.empty((n, n, rows, w.shape[-1]), dtype=out_dtype,
                      device=x.device)
    for i in range(n):
        slot = (me - i) % n
        if i < n - 1:
            MemoryChannel(nxt).put(xbuf[me, slot], xbuf, slot)
        out[me, slot] = torch.matmul(xbuf[me, slot].float(), wf).to(out_dtype)
    return out.reshape(n, n * rows, w.shape[-1])


def _launch(x: torch.Tensor, w: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    from repro_torch.kernels import build
    codes = comm_utils.DTYPE_CODES
    n, rows, k = x.shape
    f = w.shape[-1]
    if x.dtype == torch.bfloat16 and (k % 8 or f % 8):
        raise ValueError(f"the bf16 AllGather-matmul kernel takes K and F "
                         f"multiples of 8 (16-byte TMA rows), got K={k}, "
                         f"F={f}")
    lib = build.collective_matmul_library()
    mode = regime(n, rows) if x.dtype == torch.bfloat16 else "prefill"
    splits, kt_split = 1, 1
    if mode == "decode":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits, kt_split = decode_splits(n, k, f, sms)
    tiles_n = -(-f // DECODE_BN)

    def make():
        # arrival flags: [n][n][tiles of at least 64 rows] on the ring,
        # [n][n] at decode; decode's split counters [n][64-column tiles]
        tiles_m = 1 if mode == "decode" else -(-rows // 64)
        return comm_utils.Workspace(1, (
            torch.zeros(n * n * tiles_m, dtype=torch.int32, device=x.device),
            torch.zeros(n * tiles_n, dtype=torch.int32, device=x.device)))

    ws = comm_utils.workspace(f"{KERNEL}/{out_dtype}/{f}/{mode}", x, make)
    flags, counters = ws.tensors
    # the gather buffers and partials live for one call (every read waits
    # on its flag)
    xbuf = torch.empty((n, n, rows, k), dtype=x.dtype, device=x.device)
    part = torch.empty((n, tiles_n, splits, 64, 64) if splits > 1
                       else (1,), dtype=torch.float32, device=x.device)
    out = torch.empty((n, n * rows, f), dtype=out_dtype, device=x.device)
    rc = lib.ag_matmul_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), xbuf.data_ptr(),
        flags.data_ptr(), part.data_ptr(), counters.data_ptr(),
        codes[x.dtype], codes[out_dtype], n, rows, k, f, int(w.dim() == 3),
        _REGIME_CODES[mode], splits, kt_split, ws.next_epoch(),
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.collective_matmul_error_string, KERNEL, x)
    return out
