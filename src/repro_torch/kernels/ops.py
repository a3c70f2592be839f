"""One import surface for the port's collective kernels and flash
attention.

Port of ``repro/kernels/ops.py``, the library of tuned collective kernels
behind the standard collective API (paper §4.4):

    from repro_torch.kernels import ops
    y = ops.all_reduce(x, algo="1pa")    # x: (n, rows, cols), rank-stacked
    h = ops.all_reduce(x, algo="2ph", node_size=2)   # n = 2 nodes x n/2 local
    z = ops.all_to_all(x)                # MoE dispatch/combine
    p = ops.fused_allgather_matmul(x, w) # x (n, rows, K), w (K, F) or (n, K, F)
    o = ops.flash_attention(q, k, v)     # q (b, h, s, hd), k/v (b, h_kv, s, hd)

A CUDA tensor runs the hand-written kernel, a CPU tensor its plain
version; ``backend="torch"`` or ``"cuda"`` forces one (a CPU tensor never
reaches a kernel). The reference's ``axis``/``axis_size`` arguments are
the leading rank axis of ``x``. Defaults and ``ValueError`` messages are
the reference's. ``algo="2ph"`` takes the ranks node-major (rank =
node·L + local, :mod:`repro_torch.mesh`) and its ``node_size`` stands for
the reference's ``node_axis``/``node_size`` pair.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import alltoall
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.allgather_ring import all_gather_ring
from repro_torch.kernels.allreduce_1pa import all_reduce_1pa
from repro_torch.kernels.allreduce_2ph import all_reduce_2ph
from repro_torch.kernels.collective_matmul import allgather_matmul
from repro_torch.kernels.reducescatter_2pa import (all_gather_2pa,
                                                   all_reduce_2pa,
                                                   reduce_scatter_2pa)

__all__ = ["all_gather", "reduce_scatter", "all_reduce", "all_to_all",
           "fused_allgather_matmul", "flash_attention"]


def all_gather(x: torch.Tensor, *, algo: str = "ring", **kw) -> torch.Tensor:
    if algo == "ring":
        return all_gather_ring(x, **kw)
    if algo == "allpairs":
        return all_gather_2pa(x, **kw)
    raise ValueError(f"unknown all_gather algo {algo!r}")


def reduce_scatter(x: torch.Tensor, **kw) -> torch.Tensor:
    return reduce_scatter_2pa(x, **kw)


def all_reduce(x: torch.Tensor, *, algo: str = "2pa",
               node_size: Optional[int] = None, **kw) -> torch.Tensor:
    if algo == "1pa":
        return all_reduce_1pa(x, **kw)
    if algo == "2pa":
        return all_reduce_2pa(x, **kw)
    if algo == "2ph":
        return all_reduce_2ph(x, node_size=node_size, **kw)
    raise ValueError(f"unknown all_reduce algo {algo!r}")


def all_to_all(x: torch.Tensor, **kw) -> torch.Tensor:
    return alltoall.all_to_all(x, **kw)


def fused_allgather_matmul(x: torch.Tensor, w: torch.Tensor,
                           **kw) -> torch.Tensor:
    return allgather_matmul(x, w, **kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_kv: int = 128,
                    backend: Optional[str] = None) -> torch.Tensor:
    """The reference's surface: ``q`` ``(b, h, s, hd)``, ``k``/``v``
    ``(b, h_kv, s, hd)``, and ``s`` a multiple of both blocks. The blocks
    are the TPU's tiling and are checked only: the CUDA kernel tiles by
    its own, and :func:`repro_torch.kernels.flash_attention.flash_attention`
    takes any ``s``."""
    s = q.shape[-2]
    if s % block_q or s % block_kv:
        raise ValueError(f"sequence length {s} does not divide into "
                         f"block_q={block_q} and block_kv={block_kv}")
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              backend=backend)
