"""Shared model blocks for decode: RMS norm, RoPE, GQA decode attention
(whole-model and per-TP-shard), SwiGLU MLP, the dense-einsum MoE layer
and their initializers — the port of ``repro.models.blocks`` that dense
and MoE decode run.

Every function takes plain tensors and accepts optional *leading rank
dims*: the auto path calls them on one model (``x`` is ``(b, s, d)``),
the explicit-TP path on rank-stacked shards (``x`` is ``(tp, b, s, d)``
and every weight carries the same leading ``tp`` axis), so one einsum
computes every rank's shard. Layouts at the public functions are the
reference's (``wq`` is ``(d, heads, hd)``, caches ``(b, kv_heads, kv,
hd)``), so weights carry across one to one.

The reference pins XLA-CPU reduction orders (``_tree_sum``) so fused and
token-by-token programs agree bit for bit; this port's prefill is token
by token, so its sums are plain torch reductions.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "apply_rope", "decode_attention",
           "mlp_swiglu", "top_k", "moe_layer", "init_linear", "init_attn",
           "init_mlp", "init_moe", "padded_heads"]

Params = dict
_MASKED = torch.finfo(torch.float32).min


def _lift(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-feature vector (leading rank dims allowed) shaped to
    broadcast against ``x``: ``(..., d)`` -> ``(..., 1, ..., 1, d)``."""
    return w.reshape(tuple(w.shape[:-1]) + (1,) * (x.dim() - w.dim())
                     + tuple(w.shape[-1:]))


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().sum(-1) / x.shape[-1]
    out = xf * (1.0 / torch.sqrt(var + eps))[..., None]
    return (out * (1.0 + _lift(scale, x).float())).to(x.dtype)


_ROPE_MIN_TABLE = 4096


@functools.lru_cache(maxsize=None)
def _rope_tables(head_dim: int, theta: float, n_pos: int):
    """(cos, sin) host tables of shape (n_pos, head_dim/2), computed once
    with numpy exactly as the reference does."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                             / np.float32(head_dim)))
    angles = np.arange(n_pos, dtype=np.float32)[:, None] * freqs
    return np.cos(angles), np.sin(angles)


@functools.lru_cache(maxsize=None)
def _rope_device_tables(head_dim: int, theta: float, n_pos: int,
                        device: torch.device):
    cos, sin = _rope_tables(head_dim, theta, n_pos)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rope_table_size(max_pos: int) -> int:
    n = _ROPE_MIN_TABLE
    while n < max_pos:
        n *= 2
    return n


def rope(pos: int, head_dim: int, theta: float, device,
         max_pos: Optional[int] = None):
    """Position ``pos`` -> cos/sin (head_dim/2,) from the host table,
    which grows to cover the positions asked for; a position past
    ``max_pos`` raises instead of wrapping."""
    if pos < 0:
        raise ValueError(f"rope(): negative position {pos}")
    if max_pos is not None and pos >= max_pos:
        raise ValueError(f"rope(): position {pos} >= declared max_pos "
                         f"{max_pos}")
    cos_t, sin_t = _rope_device_tables(head_dim, float(theta),
                                       _rope_table_size(pos + 1),
                                       torch.device(device))
    return cos_t[pos], sin_t[pos]


def apply_rope(x, cos, sin):
    """x: (..., head_dim) rotated by cos/sin broadcasting over
    (..., head_dim/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv_proj(p: Params, x, cfg):
    """QKV projection to (..., b, heads, s, hd); qk-norm runs in the
    (b, s, heads, hd) layout before the head transpose, as in the
    reference."""
    q = torch.einsum("...bsd,...dnh->...bsnh", x, p["wq"])
    k = torch.einsum("...bsd,...dnh->...bsnh", x, p["wk"])
    v = torch.einsum("...bsd,...dnh->...bsnh", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q.transpose(-3, -2), k.transpose(-3, -2), v.transpose(-3, -2)


def _softmax(logits):
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    return e / e.sum(dim=-1, keepdim=True)


def decode_attention(p: Params, x, cache_k, cache_v, pos: int, cfg, *,
                     window: Optional[int], head_offset=None):
    """One-token decode with a KV cache (fp caches; the batch shares one
    position in this slice).

    x: (…, b, 1, d); cache_k/v: (…, b, kv_heads, max_kv, hd), updated IN
    PLACE with the new token (the port writes the cache buffer instead of
    returning a new one). Returns the attention output (…, b, 1, d).

    ``head_offset`` (explicit TP): a (tp,) tensor — rank ``r``'s ``p``
    holds the contiguous query/output heads starting at global head
    ``head_offset[r]`` while KV projections and cache are replicated; the
    result is every shard's PARTIAL sum over d_model, which the per-layer
    AllReduce plan completes.
    """
    hd = cfg.hd
    nh, nkv = padded_heads(cfg)
    max_kv = cache_k.shape[-2]
    q, k_new, v_new = _qkv_proj(p, x, cfg)
    cos, sin = rope(pos, hd, cfg.rope_theta, x.device, max_pos=cfg.max_seq)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)

    # ring buffer for windowed layers, linear for global ones
    slot = pos % max_kv if window is not None else pos
    cache_k[..., slot, :] = k_new[..., 0, :]
    cache_v[..., slot, :] = v_new[..., 0, :]
    k_pos = torch.arange(max_kv, device=x.device)
    if window is not None:
        valid = ((slot - k_pos) % max_kv) < min(pos + 1, max_kv)
    else:
        valid = k_pos <= pos

    g = nh // nkv
    if head_offset is not None:
        return _decode_attn_tp_shard(p, q, cache_k, cache_v, valid, cfg,
                                     head_offset=head_offset, g=g)
    lead = q.shape[:-4]
    b = q.shape[-4]
    q = q.reshape(lead + (b, nkv, g, 1, hd))
    logits = torch.einsum("...bngsh,...bnth->...bngst", q, cache_k).float()
    logits = torch.where(valid, logits * hd ** -0.5, _MASKED)
    probs = _softmax(logits).to(x.dtype)
    out = torch.einsum("...bngst,...bnth->...bngsh", probs, cache_v)
    out = out.reshape(lead + (b, nh, 1, hd))
    if nh > cfg.n_heads:
        head_mask = (torch.arange(nh, device=x.device) < cfg.n_heads)
        out = out * head_mask.to(out.dtype)[:, None, None]
    return torch.einsum("...bnsh,...nhd->...bsd", out, p["wo"])


def _decode_attn_tp_shard(p: Params, q, cache_k, cache_v, valid, cfg, *,
                          head_offset, g: int):
    """Per-shard attention of the explicit-TP path on rank-stacked
    tensors: q (tp, b, nh_local, 1, hd) holds every rank's heads; each
    head attends to its own KV head of the replicated cache through a
    gather, and the ``wo`` projection over the local heads is a partial
    sum."""
    tp, _, nh_l, _, hd = q.shape
    hid = head_offset[:, None] + torch.arange(nh_l, device=q.device)
    ranks = torch.arange(tp, device=q.device)[:, None]
    # (tp, b, kv_heads, kv, hd) -> (tp, b, nh_local, kv, hd)
    k_sel = cache_k[ranks, :, hid // g].transpose(1, 2)
    v_sel = cache_v[ranks, :, hid // g].transpose(1, 2)
    logits = torch.einsum("rbnsh,rbnth->rbnst", q, k_sel).float()
    logits = torch.where(valid, logits * hd ** -0.5, _MASKED)
    probs = _softmax(logits).to(q.dtype)
    out = torch.einsum("rbnst,rbnth->rbnsh", probs, v_sel)
    nh, _ = padded_heads(cfg)
    if nh > cfg.n_heads:
        keep = (hid < cfg.n_heads).to(out.dtype)          # (tp, nh_local)
        out = out * keep[:, None, :, None, None]
    return torch.einsum("rbnsh,rnhd->rbsd", out, p["wo"])


def mlp_swiglu(p: Params, x):
    gate = torch.einsum("...bsd,...df->...bsf", x, p["w_gate"])
    up = torch.einsum("...bsd,...df->...bsf", x, p["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    return torch.einsum("...bsf,...fd->...bsd", act, p["w_down"])


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order and their indices, ties going to the lower index (a
    stable descending sort; ``torch.topk`` makes no promise on ties, and
    bf16 router logits cast to f32 tie often enough to flip a route)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_layer(p: Params, x, cfg):
    """Top-k routed MoE, dense formulation: every expert runs on every
    token and the combine weights zero the unrouted ones (the auto
    path's oracle for ``distributed.moe_parallel.moe_layer_ep``).

    x: (b, s, d); ``router`` (d, e), ``w_gate``/``w_up`` (e, d, f),
    ``w_down`` (e, f, d). The expert products are batched matmuls over
    the expert axis, so the (e, d, f) weights are read in place."""
    b, s, d = x.shape
    k = cfg.moe.top_k
    router = torch.einsum("bsd,de->bse", x, p["router"]).float()
    weights, idx = top_k(router, k)                          # (b, s, k)
    weights = torch.softmax(weights, dim=-1).to(x.dtype)
    # the indices of one token are distinct: scattering the weights is
    # the reference's one-hot einsum, exactly
    combine = torch.zeros(router.shape, dtype=x.dtype, device=x.device)
    combine.scatter_(-1, idx, weights)                       # (b, s, e)
    tokens = x.reshape(1, b * s, d)
    gate = torch.matmul(tokens, p["w_gate"])                 # (e, T, f)
    up = torch.matmul(tokens, p["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    out = torch.matmul(act, p["w_down"])                     # (e, T, d)
    y = torch.einsum("etd,te->td", out, combine.reshape(b * s, -1))
    return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# initializers (seeded torch generators; leaves may carry a leading
# ``groups`` axis via ``lead``)
# ---------------------------------------------------------------------------
def init_linear(gen: torch.Generator, shape, dtype, scale=None, *,
                lead=(), device=None):
    """Normal(0, scale^2) weights, ``scale`` defaulting to fan-in^-0.5
    (``shape[0]``), made in float32 and cast, as the reference does."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def padded_heads(cfg):
    """(n_heads_padded, n_kv_padded) under cfg.pad_heads_to."""
    if not cfg.pad_heads_to or cfg.pad_heads_to <= cfg.n_heads:
        return cfg.n_heads, cfg.n_kv_heads
    nh = cfg.pad_heads_to
    g = cfg.group_size
    return nh, (nh + g - 1) // g


def init_attn(gen, cfg, *, lead=(), device=None) -> Params:
    hd, d = cfg.hd, cfg.d_model
    nh, nkv = padded_heads(cfg)
    dt = cfg.tdtype
    kw = dict(lead=lead, device=device)
    p = {
        "wq": init_linear(gen, (d, nh, hd), dt, **kw),
        "wk": init_linear(gen, (d, nkv, hd), dt, **kw),
        "wv": init_linear(gen, (d, nkv, hd), dt, **kw),
        "wo": init_linear(gen, (nh, hd, d), dt, scale=(nh * hd) ** -0.5,
                          **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(tuple(lead) + (hd,), dtype=dt, device=device)
        p["k_norm"] = torch.zeros(tuple(lead) + (hd,), dtype=dt, device=device)
    return p


def init_mlp(gen, cfg, d_ff=None, *, lead=(), device=None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.tdtype
    kw = dict(lead=lead, device=device)
    return {
        "w_gate": init_linear(gen, (d, f), dt, **kw),
        "w_up": init_linear(gen, (d, f), dt, **kw),
        "w_down": init_linear(gen, (f, d), dt, scale=f ** -0.5, **kw),
    }


def init_moe(gen, cfg, *, lead=(), device=None) -> Params:
    """The reference's MoE init, scales included: ``init_linear``'s
    default scale is ``shape[0] ** -0.5``, the expert count for the
    (e, d, f) leaves."""
    d = cfg.d_model
    e = cfg.moe.num_experts
    f = cfg.moe.d_ff_expert or cfg.d_ff
    dt = cfg.tdtype
    kw = dict(lead=lead, device=device)
    return {
        "router": init_linear(gen, (d, e), dt, **kw),
        "w_gate": init_linear(gen, (e, d, f), dt, **kw),
        "w_up": init_linear(gen, (e, d, f), dt, **kw),
        "w_down": init_linear(gen, (e, f, d), dt, scale=f ** -0.5, **kw),
    }
