"""Plain torch oracles for the collectives, on rank-stacked tensors.

All oracles take *global* tensors with the rank axis explicit as axis 0
— ``x[d]`` is rank ``d``'s local buffer — the convention of
``repro/kernels/ref.py``, so they compare directly against a plan's
``(n, rows, cols)`` output.

They sum in ``torch.sum``'s order, not in the kernels': the collective
kernels and their plain versions fold rotated from each rank (rank
``r`` adds ``x[r] + x[r+1] + ... + x[r-1]``, rounding after each add,
as the reference's kernels do), so in bf16 an oracle agrees with them
within rounding, not bit for bit.

``flash_attention_ref`` is the attention oracle: per-sequence tensors,
no rank axis.
"""
from __future__ import annotations

import torch

__all__ = ["all_gather_ref", "reduce_scatter_ref", "all_reduce_ref",
           "all_to_all_ref", "broadcast_ref", "allgather_matmul_ref",
           "matmul_reducescatter_ref", "hierarchical_all_reduce_ref",
           "flash_attention_ref"]


def all_gather_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (N, *chunk) per-rank chunks -> (N, N, *chunk): every rank
    holds the concatenation."""
    n = x.shape[0]
    return x.unsqueeze(0).expand((n,) + tuple(x.shape))


def reduce_scatter_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (N, N, *chunk) — x[d, c] is rank d's contribution to chunk c.
    Returns (N, *chunk): rank d holds sum_d' x[d', d]."""
    return x.sum(dim=0)


def all_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (N, *buf) per-rank buffers -> (N, *buf) all equal to the sum."""
    n = x.shape[0]
    s = x.sum(dim=0)
    return s.unsqueeze(0).expand((n,) + tuple(s.shape))


def all_to_all_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (N, N, *chunk) — x[d, c] goes from rank d to rank c.
    Returns y with y[c, d] = x[d, c] (transpose over the rank axes)."""
    return x.transpose(0, 1)


def broadcast_ref(x: torch.Tensor, root: int) -> torch.Tensor:
    """x: (N, *buf) -> every rank holds x[root]."""
    n = x.shape[0]
    return x[root].unsqueeze(0).expand((n,) + tuple(x.shape[1:]))


def allgather_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused all-gather(x over ranks) @ w.

    x: (N, rows_per_rank, K) shards; w: (K, F) replicated. Returns (N,
    N*rows_per_rank, F): each rank computes the full product of the
    gathered activations with its (local) weight shard."""
    n = x.shape[0]
    out = x.reshape(n * x.shape[1], x.shape[2]) @ w
    return out.unsqueeze(0).expand((n,) + tuple(out.shape))


def matmul_reducescatter_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Partial products summed over ranks and scattered by row blocks.

    x: (N, rows, K), rank d's partial activations; w: (K, F) replicated.
    Returns (N, rows/N, F): rank d holds row block d of sum_d x[d] @ w."""
    n, rows = x.shape[0], x.shape[1]
    total = torch.einsum("nrk,kf->nrf", x, w).sum(dim=0)
    return total.reshape(n, rows // n, total.shape[-1])


def hierarchical_all_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """Same as all_reduce_ref; the hierarchy is an implementation detail.
    x: (N_outer*N_inner, *buf)."""
    return all_reduce_ref(x)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None) -> torch.Tensor:
    """q/k/v: (b, h, s, hd) -> (b, h, s, hd). Naive softmax attention in
    f32 with ``-1e30`` masking (``rel = q_pos - k_pos``: causal keeps
    ``rel >= 0``, a window ``rel < window``), cast back to q's dtype."""
    s, hd = q.shape[-2], q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * hd ** -0.5
    pos = torch.arange(s, device=q.device)
    rel = pos[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
