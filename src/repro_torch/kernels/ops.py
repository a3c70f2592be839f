"""One import surface for the port's collective kernels.

Port of ``repro/kernels/ops.py``, the library of tuned collective kernels
behind the standard collective API (paper §4.4):

    from repro_torch.kernels import ops
    y = ops.all_reduce(x, algo="1pa")    # x: (n, rows, cols), rank-stacked
    z = ops.all_to_all(x)                # MoE dispatch/combine

A CUDA tensor runs the hand-written kernel, a CPU tensor its plain
version; ``backend="torch"`` or ``"cuda"`` forces one (a CPU tensor never
reaches a kernel). The reference's ``axis``/``axis_size`` arguments are
the leading rank axis of ``x``. Defaults and ``ValueError`` messages are
the reference's. Kernels not ported yet raise ``NotImplementedError``
naming their ROADMAP.md §2 item; none is stood in for by a plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import alltoall
from repro_torch.kernels.allgather_ring import all_gather_ring
from repro_torch.kernels.allreduce_1pa import all_reduce_1pa
from repro_torch.kernels.reducescatter_2pa import (all_gather_2pa,
                                                   all_reduce_2pa,
                                                   reduce_scatter_2pa)

__all__ = ["all_gather", "reduce_scatter", "all_reduce", "all_to_all",
           "fused_allgather_matmul", "flash_attention"]


def _not_ported(what: str, item: int, source: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA package yet: ROADMAP.md "
        f"§2 item {item} ({source})")


def all_gather(x: torch.Tensor, *, algo: str = "ring", **kw) -> torch.Tensor:
    if algo == "ring":
        return all_gather_ring(x, **kw)
    if algo == "allpairs":
        return all_gather_2pa(x, **kw)
    raise ValueError(f"unknown all_gather algo {algo!r}")


def reduce_scatter(x: torch.Tensor, **kw) -> torch.Tensor:
    return reduce_scatter_2pa(x, **kw)


def all_reduce(x: torch.Tensor, *, algo: str = "2pa", **kw) -> torch.Tensor:
    if algo == "1pa":
        return all_reduce_1pa(x, **kw)
    if algo == "2pa":
        return all_reduce_2pa(x, **kw)
    if algo == "2ph":
        raise _not_ported("all_reduce algo '2ph'", 10,
                          "kernels/allreduce_2ph.py")
    raise ValueError(f"unknown all_reduce algo {algo!r}")


def all_to_all(x: torch.Tensor, **kw) -> torch.Tensor:
    return alltoall.all_to_all(x, **kw)


def fused_allgather_matmul(x: torch.Tensor, w: torch.Tensor,
                           **kw) -> torch.Tensor:
    raise _not_ported("fused_allgather_matmul", 9,
                      "kernels/collective_matmul.py")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **kw) -> torch.Tensor:
    raise _not_ported("flash_attention", 8, "kernels/flash_attention.py")
