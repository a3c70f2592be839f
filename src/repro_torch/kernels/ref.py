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
           "all_to_all_ref", "flash_attention_ref"]


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
