"""Selective state-space (Mamba-style) head block of the hybrid family's
layers (hymba, arXiv:2411.13676) — the port of ``repro.models.ssm``:
input-dependent ``(dt, B, C)``, a diagonal ``A``, a full-sequence scan
and an O(1)-state decode step.

Every function accepts optional *leading rank dims*, as the model blocks
do (``models/blocks.py``): the auto path calls them on one model (``x``
is ``(b, s, d)``), the explicit-TP decode path on rank-stacked shards
(``x`` is ``(tp, b, s, d)`` and every weight carries the same leading
``tp`` axis). The math runs in f32 where the reference's does.

The reference's ``associative_scan`` becomes a log-depth Hillis–Steele
scan over the sequence on whole tensors (no Python loop over positions):
the same ``combine``, folded in another order, so the two agree within
f32 rounding. The fused-prefill scan (:func:`ssm_prefill_scan`) is the
reference's per-token recurrence over a chunk instead: each step is
:func:`ssm_decode_step`, so it matches token-by-token decode by
construction.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import _lift, init_linear

__all__ = ["init_ssm_head", "init_ssm_state", "ssm_params", "scan",
           "ssm_forward", "ssm_decode_step", "ssm_prefill_scan"]

Params = dict


def init_ssm_head(gen: torch.Generator, cfg, d_inner: int, *, lead=(),
                  device=None) -> Params:
    """``d_inner``: the SSM head width (the model passes ``d_model``).
    ``a_log`` is the reference's table, ``log(1..state)`` on every row,
    made in f32 and cast."""
    s = cfg.ssm.state_dim
    dt_rank = cfg.ssm.dt_rank or max(cfg.d_model // 16, 1)
    dt = cfg.tdtype
    kw = dict(lead=lead, device=device)
    a_log = torch.log(torch.arange(1, s + 1, dtype=torch.float32,
                                   device=device)).expand(
        tuple(lead) + (d_inner, s))
    return {
        "w_in": init_linear(gen, (cfg.d_model, 2 * d_inner), dt, **kw),
        "w_bcdt": init_linear(gen, (d_inner, 2 * s + dt_rank), dt, **kw),
        "w_dt": init_linear(gen, (dt_rank, d_inner), dt, **kw),
        "a_log": a_log.to(dt).contiguous(),
        "d_skip": torch.ones(tuple(lead) + (d_inner,), dtype=dt,
                             device=device),
        "w_out": init_linear(gen, (d_inner, cfg.d_model), dt,
                             scale=d_inner ** -0.5, **kw),
    }


def init_ssm_state(cfg, batch: int, d_inner: int, *, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((batch, d_inner, cfg.ssm.state_dim), dtype=dtype,
                       device=device)


def _proj(x, w):
    return torch.einsum("...bsd,...de->...bse", x, w)


def _local_rows(t: torch.Tensor, d_offset: torch.Tensor,
                d_local: int) -> torch.Tensor:
    """Each rank-stacked shard's ``d_local`` rows of ``t``'s last axis.
    ``d_offset`` is the ``(tp,)`` offsets of the shards, ``r * d_local``
    for rank ``r`` (the layout ``distributed.sharding`` gives a sharded
    leaf), so rank r's rows are block r of ``t[r]``: the diagonal of the
    ``(tp, ..., tp, d_local)`` view, taken with no host read and no
    index tensor."""
    tp = t.shape[0]
    if d_offset.shape != (tp,) or t.shape[-1] != tp * d_local:
        raise ValueError(f"rank-stacked offsets {tuple(d_offset.shape)} do "
                         f"not split {tuple(t.shape)} into {d_local}-row "
                         f"shards")
    blocks = t.unflatten(-1, (tp, d_local))
    return torch.diagonal(blocks, dim1=0, dim2=-2).movedim(-1, 0)


def _softplus(u):
    """``jax.nn.softplus``: ``logaddexp(u, 0)``, the reference's form."""
    return torch.clamp_min(u, 0) + torch.log1p(torch.exp(-u.abs()))


def ssm_params(p: Params, x, cfg, *,
               d_offset: Optional[torch.Tensor] = None):
    """Input-dependent SSM parameters (the reference's ``_ssm_params``):
    ``(xin, z, dA, dBx, C)``, with ``dA``/``dBx`` ``(..., b, s, d_inner,
    state)`` and ``C`` ``(..., b, s, state)`` in f32.

    ``d_offset`` is the explicit-TP decode path, on rank-stacked shards
    (its ``(tp,)`` offsets): ``w_in``/``w_bcdt`` arrive whole
    (replicated), so the shared ``(dt_raw, B, C)`` projections are
    computed over the whole ``d_inner``, while ``w_dt``/``a_log`` arrive
    as each shard's ``d_inner`` rows and ``xin``/``z`` are cut to the
    same rows (:func:`_local_rows`)."""
    st = cfg.ssm.state_dim
    xin, z = _proj(x, p["w_in"]).chunk(2, dim=-1)          # (…, b, s, d_inner)
    bcdt = _proj(xin, p["w_bcdt"])
    B = bcdt[..., :st].float()                             # (…, b, s, st)
    C = bcdt[..., st:2 * st].float()
    if d_offset is not None:
        d_local = p["a_log"].shape[-2]
        xin = _local_rows(xin, d_offset, d_local)
        z = _local_rows(z, d_offset, d_local)
    dt = _softplus(_proj(bcdt[..., 2 * st:], p["w_dt"]).float())
    A = -torch.exp(p["a_log"].float())                     # (…, d_inner, st)
    A = A.reshape(A.shape[:-2] + (1, 1) + A.shape[-2:])
    dA = torch.exp(dt[..., None] * A)                      # (…, b, s, d, st)
    dBx = (dt * xin.float())[..., None] * B.unsqueeze(-2)
    return xin, z, dA, dBx, C


def _gate(y, xin, z, p):
    """``(y + xin * d_skip) * silu(z)`` in f32, the reference's order."""
    y = y + xin.float() * _lift(p["d_skip"], xin).float()
    return y * F.silu(z.float())


def _shifted(t: torch.Tensor, d: int, new_tail: torch.Tensor):
    """``t`` with positions ``d:`` of axis -3 replaced by ``new_tail``,
    out of place."""
    return torch.cat([t[..., :d, :, :], new_tail], dim=-3)


def scan(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """The recurrence ``h_t = dA_t * h_{t-1} + dBx_t`` from ``h_{-1} = 0``
    over axis -3 of ``(..., s, d_inner, state)`` f32 tensors, in
    ceil(log2 s) Hillis–Steele levels of the reference's ``combine``
    ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``, where position t takes
    position t - 2**level's prefix as ``(a1, b1)``. Each level updates
    ``dBx`` then ``dA`` in place behind one temporary of their size;
    returns ``dBx``, which then holds every ``h_t`` (``dA`` is spent).

    Where autograd records the scan (training), each level writes new
    tensors instead, the same products and sums: an in-place write would
    overwrite values the backward saved."""
    s_len = dA.shape[-3]
    recorded = torch.is_grad_enabled() and (dA.requires_grad
                                            or dBx.requires_grad)
    d = 1
    while d < s_len:
        step = dBx[..., :-d, :, :] * dA[..., d:, :, :]
        if recorded:
            dBx = _shifted(dBx, d, dBx[..., d:, :, :] + step)
        else:
            dBx[..., d:, :, :] += step
        del step
        if 2 * d < s_len:             # the last level needs no dA
            prod = dA[..., :-d, :, :] * dA[..., d:, :, :]
            if recorded:
                dA = _shifted(dA, d, prod)
            else:
                dA[..., d:, :, :] = prod
            del prod
        d *= 2
    return dBx


def ssm_forward(p: Params, x, cfg, state: Optional[torch.Tensor] = None):
    """x: (..., b, s, d_model) -> (out, final_state (..., b, d_inner,
    state)), the reference's associative scan as :func:`scan`."""
    xin, z, dA, dBx, C = ssm_params(p, x, cfg)
    if state is not None:
        # fold the incoming state into step 0
        dBx[..., 0, :, :] += dA[..., 0, :, :] * state
    h = scan(dA, dBx)                                      # (…, b, s, d, st)
    y = torch.einsum("...bsdk,...bsk->...bsd", h, C)
    y = _gate(y, xin, z, p)
    return _proj(y.to(x.dtype), p["w_out"]), h[..., -1, :, :]


def ssm_decode_step(p: Params, x, state, cfg, *,
                    d_offset: Optional[torch.Tensor] = None):
    """x: (..., b, 1, d_model); state: (..., b, d_inner, st). O(1)
    update; returns (out (..., b, 1, d_model), new state) and leaves
    ``state`` as it is (the caller writes it back in place).

    ``d_offset`` (explicit TP, see :func:`ssm_params`): ``p`` holds the
    full input projections and each shard's rows of ``w_dt``/``a_log``/
    ``d_skip``/``w_out``, ``state`` each shard's ``(tp, b, d_local, st)``
    rows, and ``out`` is each shard's PARTIAL sum over ``d_model``,
    which the per-layer AllReduce plan completes."""
    xin, z, dA, dBx, C = ssm_params(p, x, cfg, d_offset=d_offset)
    h = dA[..., 0, :, :] * state + dBx[..., 0, :, :]       # (…, b, d, st)
    y = torch.einsum("...bdk,...bk->...bd", h, C[..., 0, :])
    y = _gate(y, xin[..., 0, :], z[..., 0, :], p)
    out = _proj(y.to(x.dtype)[..., None, :], p["w_out"])
    return out, h


def ssm_prefill_scan(p: Params, x, state, cfg, n_tok, *,
                     d_offset: Optional[torch.Tensor] = None):
    """Fused-prefill SSM: :func:`ssm_decode_step` over a chunk, position
    by position. x: (..., b, S, d_model); state: (..., b, d_inner, st);
    ``n_tok``: (b,) real positions a row. Returns (out (..., b, S,
    d_model), new state): ``out[..., j, :]`` is what the decode step
    gives at position j, and a row's state advances only through ``j <
    n_tok`` (a row with ``n_tok == 0`` keeps its state bit for bit).
    ``d_offset`` is the explicit-TP path, as in the decode step."""
    S = x.shape[-2]
    h, outs = state, []
    for j in range(S):
        out, h_new = ssm_decode_step(p, x[..., j:j + 1, :], h, cfg,
                                     d_offset=d_offset)
        h = torch.where((j < n_tok)[:, None, None], h_new, h)
        outs.append(out)
    return torch.cat(outs, dim=-2), h
