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

The schedule is the reference's ring: at step ``i`` rank ``me`` forwards
chunk ``(me - i) mod n`` to rank ``me + 1`` and multiplies it into output
row block ``(me - i) mod n``. The CUDA kernel (``csrc/collective_matmul.
cu``) computes the product in its own body (``mma.sync`` for bf16, true
f32 FMAs for f32) with f32 accumulation, cast once to ``out_dtype``;
:func:`allgather_matmul_plain` runs the same schedule on the channel
model with an f32 ``matmul`` per chunk.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.channels import MemoryChannel
from repro_torch.kernels import comm_utils

__all__ = ["allgather_matmul", "allgather_matmul_plain"]

KERNEL = "allgather_matmul"
_TYPES = (torch.float32, torch.bfloat16)


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
    if x.dtype == torch.bfloat16 and (k % 16 or f % 8):
        raise ValueError(f"the bf16 AllGather-matmul kernel takes K a "
                         f"multiple of 16 and F a multiple of 8, got K={k}, "
                         f"F={f}")
    lib = build.collective_matmul_library()

    def make():
        bm, bn = ctypes.c_int(), ctypes.c_int()
        if not lib.ag_matmul_tile(codes[x.dtype], codes[out_dtype],
                                  ctypes.byref(bm), ctypes.byref(bn)):
            raise RuntimeError("the AllGather-matmul kernel has no tile for "
                               f"{x.dtype} -> {out_dtype}")
        tiles = -(-rows // bm.value)
        flags = torch.zeros(n * n * tiles, dtype=torch.int32,
                            device=x.device)
        return comm_utils.Workspace(1, (flags,))

    ws = comm_utils.workspace(f"{KERNEL}/{out_dtype}", x, make)
    (flags,) = ws.tensors
    # the gather buffers live for one call (every read waits on its flag)
    xbuf = torch.empty((n, n, rows, k), dtype=x.dtype, device=x.device)
    out = torch.empty((n, n * rows, f), dtype=out_dtype, device=x.device)
    rc = lib.ag_matmul_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), xbuf.data_ptr(),
        flags.data_ptr(), codes[x.dtype], codes[out_dtype], n, rows, k, f,
        int(w.dim() == 3), ws.next_epoch(),
        torch.cuda.current_stream(x.device).cuda_stream)
    comm_utils.check_launch(rc, lib.collective_matmul_error_string, KERNEL, x)
    return out
