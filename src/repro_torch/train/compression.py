"""Gradient compression with error feedback for the DP all-reduce (port
of ``repro.train.compression``).

Wire format: bf16 (2x) or int8 (4x: block-scaled over 256-element
blocks, dequantized before the reduction so the sum stays in f32). The
residual (quantization error) is fed back into the next step's gradient,
the EF-SGD construction that keeps convergence unbiased. The explicit
train step's ``dp_wire_dtype`` is the bf16 wire: it casts each leaf
before the plan, as the reference's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib

__all__ = ["compress", "decompress", "ef_roundtrip", "init_residuals"]


def init_residuals(params):
    return tree_lib.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def compress(leaf: torch.Tensor, method: str = "bf16", block: int = 256):
    """Returns (payload, scale_meta). The payload's dtype is the wire
    dtype; int8's meta is ``(scale (blocks, 1) f32, shape, pad)``."""
    x = leaf.float()
    if method == "bf16":
        return x.to(torch.bfloat16), None
    if method == "int8":
        flat = x.reshape(-1)
        pad = (-flat.numel()) % block
        fb = F.pad(flat, (0, pad)).reshape(-1, block)
        scale = fb.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
        q = torch.clamp(torch.round(fb / scale), -127, 127).to(torch.int8)
        return q, (scale, tuple(leaf.shape), pad)
    raise ValueError(method)


def decompress(payload: torch.Tensor, meta, method: str = "bf16"):
    if method == "bf16":
        return payload.float()
    scale, shape, pad = meta
    x = (payload.float() * scale).reshape(-1)
    if pad:
        x = x[:-pad]
    return x.reshape(shape)


def ef_roundtrip(grad: torch.Tensor, residual: torch.Tensor,
                 method: str = "bf16"):
    """Error-feedback quantization: ``q(g + r)`` on the wire, ``r' = (g +
    r) - q``. Returns (wire value in f32, new residual); the caller
    reduces the wire value with the collective of its choice."""
    g = grad.float() + residual
    payload, meta = compress(g, method)
    deq = decompress(payload, meta, method)
    return deq, g - deq
