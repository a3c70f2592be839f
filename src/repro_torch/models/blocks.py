"""Shared model blocks: RMS norm, RoPE, full-sequence GQA attention
(causal, sliding-window or bidirectional), GQA decode attention (a
position shared by the batch or one a row) and cache-filling prefill
attention over a chunk (both whole-model and per-TP-shard), SwiGLU MLP,
the dense-einsum MoE layer and their initializers — the port of
``repro.models.blocks`` that the forward, decode and fused prefill run.

Every decode function takes plain tensors and accepts optional *leading
rank dims*: the auto path calls them on one model (``x`` is ``(b, s,
d)``), the explicit-TP path on rank-stacked shards (``x`` is ``(tp, b,
s, d)`` and every weight carries the same leading ``tp`` axis), so one
einsum computes every rank's shard. Layouts at the public functions are
the reference's (``wq`` is ``(d, heads, hd)``, caches ``(b, kv_heads,
kv, hd)``), so weights carry across one to one.

The reference pins XLA-CPU reduction orders (``_tree_sum``) so fused and
token-by-token programs agree bit for bit; this port's sums are plain
torch reductions, so the two agree within rounding.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import comm_utils
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["rms_norm", "rope", "apply_rope", "attention", "decode_attention",
           "prefill_attention", "device_position", "mlp_swiglu", "top_k", "moe_layer",
           "init_linear", "init_attn", "init_mlp", "init_moe",
           "padded_heads"]

Params = dict
_MASKED = torch.finfo(torch.float32).min
# the full-sequence paths' masked logit: large-negative instead of -inf
# keeps exp() well defined for fully-masked rows of the online softmax
_NEG = -1e30


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


def rope(pos, head_dim: int, theta: float, device,
         max_pos: Optional[int] = None, *, on_device: bool = False):
    """Position(s) -> cos/sin rows of the host table: an int ``pos`` or
    a 0-d tensor gives ``(head_dim/2,)``, a tensor of positions of shape
    ``S`` gives ``S + (head_dim/2,)``.

    Int and tensor positions are read on the host: the table grows to
    cover them, and a negative one or one past ``max_pos`` raises instead
    of wrapping. A 0-d tensor, or any tensor with ``on_device=True`` (the
    scheduler's per-row positions), is read on the device only, never on
    the host (a step captured in a CUDA graph keeps its positions on the
    card): the table is sized from ``max_pos``, which it then needs, and
    the caller, which knows the positions on the host, keeps them in
    ``[0, max_pos)``."""
    if isinstance(pos, torch.Tensor) and (on_device or pos.dim() == 0):
        if max_pos is None:
            raise ValueError("rope(): a device position needs max_pos to "
                             "size the table")
        cos_t, sin_t = _rope_device_tables(
            head_dim, float(theta), _rope_table_size(int(max_pos)),
            torch.device(device))
        idx = pos.to(cos_t.device).reshape(-1)
        shape = tuple(pos.shape) + (cos_t.shape[-1],)
        return (cos_t.index_select(0, idx).reshape(shape),
                sin_t.index_select(0, idx).reshape(shape))
    if isinstance(pos, torch.Tensor):
        lo, hi = ((int(pos.min()), int(pos.max())) if pos.numel()
                  else (0, 0))
    else:
        lo = hi = int(pos)
    if lo < 0:
        raise ValueError(f"rope(): negative position {lo}")
    if max_pos is not None and hi >= max_pos:
        raise ValueError(f"rope(): position {hi} >= declared max_pos "
                         f"{max_pos}")
    cos_t, sin_t = _rope_device_tables(head_dim, float(theta),
                                       _rope_table_size(hi + 1),
                                       torch.device(device))
    if isinstance(pos, torch.Tensor):
        pos = pos.to(cos_t.device)
    return cos_t[pos], sin_t[pos]


def apply_rope(x, cos, sin):
    """x: (..., head_dim) rotated by cos/sin broadcasting over
    (..., head_dim/2): one position's ``(head_dim/2,)`` or a sequence's
    ``(s, head_dim/2)`` against ``x`` of ``(..., s, head_dim)``."""
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


# ---------------------------------------------------------------------------
# full-sequence attention
# ---------------------------------------------------------------------------
def _attn_mask(q_len: int, kv_len: int, *, causal: bool,
               window: Optional[int], q_offset: int = 0, device=None):
    """(q_len, kv_len) boolean mask. ``window``: SWA of that many
    tokens."""
    q_pos = torch.arange(q_len, device=device) + q_offset
    k_pos = torch.arange(kv_len, device=device)
    rel = q_pos[:, None] - k_pos[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    return mask


def attention(p: Params, x, cfg, cos, sin, *, window: Optional[int],
              backend: Optional[str] = None):
    """Full-sequence GQA attention over positions ``0..s-1``. x: (b, s,
    d_model) -> (b, s, d_model); ``cos``/``sin``: the ``(s, hd/2)`` RoPE
    rows of those positions (:func:`rope`), looked up once per forward.

    The core runs the flash-attention kernel on a CUDA tensor, for every
    ``s``. On the CPU (or with ``backend="torch"``) it is the reference's
    plain core: the materialized masked softmax, or the online softmax
    over KV chunks when ``s > cfg.attn_chunk`` and ``s % cfg.attn_chunk
    == 0``, so the (s, s) logits are never held at long context.
    """
    nh, _ = padded_heads(cfg)

    # projected and normed in (b, heads, s, hd), the reference's order here
    q = torch.einsum("bsd,dnh->bnsh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bnsh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bnsh", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if comm_utils.resolve_backend(x, backend) == "cuda":
        out = flash_attention(q, k, v, causal=cfg.causal, window=window,
                              backend="cuda")
    else:
        out = _plain_core(q, k, v, cfg, window=window)
    if nh > cfg.n_heads:
        # hard-mask padded heads: exact math, as in the reference
        head_mask = (torch.arange(nh, device=x.device) < cfg.n_heads)
        out = out * head_mask.to(out.dtype)[:, None, None]
    return torch.einsum("bnsh,nhd->bsd", out, p["wo"])


def _plain_core(q, k, v, cfg, *, window: Optional[int]):
    """q: (b, nh, s, hd), k/v: (b, nkv, s, hd) -> (b, nh, s, hd): the
    reference's torch core, grouped as ``(b, nkv, g, s, hd)``."""
    b, nh, s, hd = q.shape
    nkv = k.shape[1]
    chunk = cfg.attn_chunk
    q = q.reshape(b, nkv, nh // nkv, s, hd)
    if s > chunk and s % chunk == 0:
        out = _chunked_attn(q, k, v, cfg, window=window, chunk=chunk)
    else:
        logits = torch.einsum("bngsh,bnth->bngst", q, k).float()
        logits = logits * hd ** -0.5
        mask = _attn_mask(s, s, causal=cfg.causal, window=window,
                          device=q.device)
        logits = torch.where(mask, logits, _NEG)
        probs = _softmax(logits).to(q.dtype)
        out = torch.einsum("bngst,bnth->bngsh", probs, v)
    return out.reshape(b, nh, s, hd)


def _chunked_attn(q, k, v, cfg, *, window: Optional[int], chunk: int):
    """Online softmax over KV chunks: O(s·chunk) live memory.

    q: (b, nkv, g, s, hd); k/v: (b, nkv, s, hd). Running (max, denom,
    acc) carried across chunks — the flash-attention recurrence."""
    b, nkv, g, s, hd = q.shape
    scale = hd ** -0.5
    dev = q.device
    m = torch.full((b, nkv, g, s), _NEG, device=dev)
    l = torch.zeros((b, nkv, g, s), device=dev)
    acc = torch.zeros((b, nkv, g, s, hd), device=dev)
    for ci in range(s // chunk):
        kc = k[:, :, ci * chunk:(ci + 1) * chunk]
        vc = v[:, :, ci * chunk:(ci + 1) * chunk]
        logits = torch.einsum("bngsh,bnth->bngst", q, kc).float() * scale
        mask = _attn_mask(s, chunk, causal=cfg.causal, window=window,
                          q_offset=-ci * chunk, device=dev)
        logits = torch.where(mask, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(logits - m_new[..., None])
        l = l * alpha + pr.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bngst,bnth->bngsh", pr, vc.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def _quantize(v):
    """int8 KV quantization of one token, the reference's: a per-(…,
    head) scale ``max|v|/127 + 1e-8`` over head_dim and ``round``
    (half to even) clipped to +-127. v: (…, hd) -> (int8 (…, hd), f32
    scale (…, 1))."""
    vf = v.float()
    sc = vf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    return torch.clamp(torch.round(vf / sc), -127, 127).to(torch.int8), sc


def device_position(pos: int, limit: int, device) -> torch.Tensor:
    """An int decode position, checked on the host to lie in ``[0,
    limit)``, as the 0-d tensor that the decode step reads on the
    device."""
    pos = int(pos)
    if not 0 <= pos < limit:
        raise ValueError(f"decode position {pos} outside [0, {limit}): "
                         f"max_seq and each global layer's cache length "
                         f"bound it")
    return torch.tensor(pos, dtype=torch.long, device=device)


def _bf16_dot(eq, a, cache):
    """The reference's int8-cache products: bf16 operands, f32
    accumulation (``preferred_element_type=f32``). Products of bf16
    values are exact in f32, so ``a`` rounded to bf16 times the int8
    ``cache`` in f32 is that dot (an int8 value is exact in bf16 and in
    f32, so the cache goes to f32 in one pass)."""
    return torch.einsum(eq, a.to(torch.bfloat16).float(), cache.float())


def _scatter_kv(cache, val, slots, keep):
    """Write ``val`` ``(…, b, nkv, s, last)`` into ``cache`` in place at
    each row's KV slots ``slots`` ``(b, s)``: one ``scatter_`` along the
    KV axis, so a step touches only the entries it writes, never the
    whole cache. Where ``keep`` ``(b, s)`` is False the entry already in
    the slot is gathered and written back, so that row passes through bit
    for bit. The slots of one row must be distinct."""
    idx = slots[:, None, :, None].expand(val.shape)
    if keep is not None:
        val = torch.where(keep[:, None, :, None], val,
                          cache.gather(-2, idx))
    cache.scatter_(-2, idx, val)


def _write_tokens(cache, scales, val, slots, keep):
    """:func:`_scatter_kv` of new K or V tokens, quantized per token
    first for an int8 cache (its scales written alongside)."""
    if cache.dtype == torch.int8:
        val, sc = _quantize(val)
        _scatter_kv(scales, sc.to(scales.dtype), slots, keep)
    _scatter_kv(cache, val, slots, keep)


def decode_attention(p: Params, x, cache_k, cache_v, pos, cfg, *,
                     window: Optional[int], head_offset=None,
                     k_scale=None, v_scale=None, active=None):
    """One-token decode with a KV cache.

    x: (…, b, 1, d); cache_k/v: (…, b, kv_heads, max_kv, hd), updated IN
    PLACE with the new token (the port writes the cache buffer instead of
    returning a new one). Returns the attention output (…, b, 1, d).

    ``pos``: the position the batch shares — an int, checked on the host
    and made a 0-d tensor (:func:`device_position`), or a 0-d integer
    tensor — or a ``(b,)`` integer tensor of per-row positions (the
    scheduler's slots, each at its own depth). Tensors are read on the
    device only (a step captured in a CUDA graph), and the caller keeps
    them below ``max_kv`` on global layers and below ``cfg.max_seq``.
    The RoPE row, the cache slot (``pos % max_kv`` on windowed layers)
    and the validity mask all come from the tensor, row by row for a
    vector. A vector's new tokens are written with one ``scatter_``
    along the KV axis; ``active`` (a ``(b,)`` bool tensor, vector
    positions only) writes each inactive row's old entry back, so its
    cache row passes through bit for bit.

    int8 cache (``cache_k.dtype == torch.int8``): the new token is written
    as ``round(v / s)`` with a per-(batch, head, token) scale ``s`` kept
    in ``k_scale``/``v_scale`` (…, b, kv_heads, max_kv, 1), also updated
    in place; the k-scale folds in after the q·k dot and the v-scale into
    the probabilities before the value dot, both dots on bf16 operands
    with f32 accumulation — the reference's order.

    ``head_offset`` (explicit TP): a (tp,) tensor — rank ``r``'s ``p``
    holds the contiguous query/output heads starting at global head
    ``head_offset[r]`` while KV projections and cache are replicated; the
    result is every shard's PARTIAL sum over d_model, which the per-layer
    AllReduce plan completes.
    """
    hd = cfg.hd
    max_kv = cache_k.shape[-2]
    if not isinstance(pos, torch.Tensor):
        pos = device_position(pos, cfg.max_seq if window is not None
                              else min(cfg.max_seq, max_kv), x.device)
    vec = pos.dim() == 1
    if active is not None and not vec:
        raise ValueError("decode_attention(): active= needs per-row "
                         "positions")
    q, k_new, v_new = _qkv_proj(p, x, cfg)
    cos, sin = rope(pos, hd, cfg.rope_theta, x.device, max_pos=cfg.max_seq,
                    on_device=True)
    if vec:
        # (b, hd/2) -> (b, 1, 1, hd/2): each row rotates at its own pos
        cos, sin = cos[:, None, None], sin[:, None, None]
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)

    # ring buffer for windowed layers, linear for global ones; the write
    # indexes with the device slot (no host read)
    slot = pos % max_kv if window is not None else pos
    if vec:
        keep = active[:, None] if active is not None else None
        _write_tokens(cache_k, k_scale, k_new, slot[:, None], keep)
        _write_tokens(cache_v, v_scale, v_new, slot[:, None], keep)
    else:
        slot = slot.reshape(1)
        for cache, scales, val in ((cache_k, k_scale, k_new),
                                   (cache_v, v_scale, v_new)):
            if cache.dtype == torch.int8:
                val, sc = _quantize(val)
                scales.index_copy_(scales.dim() - 2, slot,
                                   sc.to(scales.dtype))
            cache.index_copy_(cache.dim() - 2, slot, val)
    k_pos = torch.arange(max_kv, device=x.device)
    p_col, s_col = (pos[:, None], slot[:, None]) if vec else (pos, slot)
    if window is not None:
        valid = ((s_col - k_pos) % max_kv) < torch.clamp(p_col + 1,
                                                         max=max_kv)
    else:
        valid = k_pos <= p_col
    # (rows, queries, kv): rows are b for a vector, 1 for a shared pos
    valid = valid.reshape(-1, 1, max_kv)
    return _attend(p, q, cache_k, cache_v, valid, cfg,
                   head_offset=head_offset, k_scale=k_scale,
                   v_scale=v_scale)


def prefill_attention(p: Params, x, cache_k, cache_v, pos, n_tok, cfg, *,
                      window: Optional[int], head_offset=None,
                      k_scale=None, v_scale=None):
    """Cache-filling attention over a prompt chunk of S tokens a row —
    :func:`decode_attention` over S positions at once, the port of the
    reference's ``prefill_attention``.

    x: (…, b, S, d) — each row's next chunk, left-aligned; ``pos``: (b,)
    the position of each row's first chunk token; ``n_tok``: (b,) how
    many of the S tokens are real. Both are device tensors, read on the
    device only. Returns (…, b, S, d), updating the cache (and an int8
    cache's scales, quantized per token as the decode write does) in
    place; columns past ``n_tok`` write their slot's old entry back, so a
    row with ``n_tok == 0`` passes through bit for bit, and their outputs
    are garbage the caller discards.

    Contract on windowed (ring) layers, as in the reference: per row
    ``n_tok == 1`` or ``pos + n_tok <= kv_len``, and ``S <= kv_len`` —
    a chunk never overwrites a slot its own queries still read. Slots
    are ``(pos + j) % kv_len`` on every layer (on a global layer the
    real columns never wrap), so a row's S slots are distinct and every
    index lies in the cache. Padded columns take RoPE rows from a table
    sized ``cfg.max_seq + S``, so their positions stay inside it."""
    S = x.shape[-2]
    kv_len = cache_k.shape[-2]
    q, k_new, v_new = _qkv_proj(p, x, cfg)
    cols = torch.arange(S, device=x.device)
    pmat = pos[:, None] + cols                              # (b, S)
    cos, sin = rope(pmat, cfg.hd, cfg.rope_theta, x.device,
                    max_pos=cfg.max_seq + S, on_device=True)
    cos, sin = cos[:, None], sin[:, None]                   # (b, 1, S, hd/2)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    slots = pmat % kv_len
    keep = cols < n_tok[:, None]                            # (b, S)
    _write_tokens(cache_k, k_scale, k_new, slots, keep)
    _write_tokens(cache_v, v_scale, v_new, slots, keep)
    k_pos = torch.arange(kv_len, device=x.device)
    if window is not None:
        age = (slots[:, :, None] - k_pos) % kv_len
        valid = age < torch.clamp(pmat + 1, max=kv_len)[:, :, None]
    else:
        valid = k_pos <= pmat[:, :, None]                   # (b, S, kv)
    return _attend(p, q, cache_k, cache_v, valid, cfg,
                   head_offset=head_offset, k_scale=k_scale,
                   v_scale=v_scale)


def _attend(p: Params, q, cache_k, cache_v, valid, cfg, *, head_offset,
            k_scale, v_scale):
    """The attention core of :func:`decode_attention` and
    :func:`prefill_attention` after the cache write: q (…, b, nh, s, hd)
    against the whole cache, ``valid`` (b or 1, s, kv) masking each
    query's keys, then the ``wo`` projection (…, b, s, d)."""
    hd = cfg.hd
    nh, nkv = padded_heads(cfg)
    g = nh // nkv
    quant = cache_k.dtype == torch.int8
    if head_offset is not None:
        return _decode_attn_tp_shard(p, q, cache_k, cache_v, valid[:, None],
                                     cfg, head_offset=head_offset, g=g,
                                     k_scale=k_scale, v_scale=v_scale)
    lead = q.shape[:-4]
    b, s = q.shape[-4], q.shape[-2]
    q = q.reshape(lead + (b, nkv, g, s, hd))
    eq_k = "...bngsh,...bnth->...bngst"
    eq_v = "...bngst,...bnth->...bngsh"
    if quant:
        # (…, b, nkv, kv, 1) -> (…, b, nkv, 1, 1, kv) against the logits
        ks = k_scale[..., 0].float()[..., None, None, :]
        vs = v_scale[..., 0].float()[..., None, None, :]
        logits = _bf16_dot(eq_k, q, cache_k) * ks
    else:
        logits = torch.einsum(eq_k, q, cache_k).float()
    logits = torch.where(valid[:, None, None], logits * hd ** -0.5, _MASKED)
    if quant:
        out = _bf16_dot(eq_v, _softmax(logits) * vs, cache_v).to(q.dtype)
    else:
        out = torch.einsum(eq_v, _softmax(logits).to(q.dtype), cache_v)
    out = out.reshape(lead + (b, nh, s, hd))
    if nh > cfg.n_heads:
        head_mask = (torch.arange(nh, device=q.device) < cfg.n_heads)
        out = out * head_mask.to(out.dtype)[:, None, None]
    return torch.einsum("...bnsh,...nhd->...bsd", out, p["wo"])


def _decode_attn_tp_shard(p: Params, q, cache_k, cache_v, valid, cfg, *,
                          head_offset, g: int, k_scale=None, v_scale=None):
    """Per-shard attention of the explicit-TP path on rank-stacked
    tensors, for decode and for a prefill chunk alike (the reference's
    ``_decode_attn_tp_shard`` and ``_prefill_attn_tp_shard``): q (tp, b,
    nh_local, s, hd) holds every rank's heads; each head attends to its
    own KV head of the replicated cache through a gather (with an int8
    cache, its scales gathered alongside), ``valid`` (b or 1, 1, s, kv)
    masks each query's keys, and the ``wo`` projection over the local
    heads is a partial sum."""
    tp, _, nh_l, _, hd = q.shape
    hid = head_offset[:, None] + torch.arange(nh_l, device=q.device)
    ranks = torch.arange(tp, device=q.device)[:, None]
    # (tp, b, kv_heads, kv, hd) -> (tp, b, nh_local, kv, hd)
    k_sel = cache_k[ranks, :, hid // g].transpose(1, 2)
    v_sel = cache_v[ranks, :, hid // g].transpose(1, 2)
    eq_k, eq_v = "rbnsh,rbnth->rbnst", "rbnst,rbnth->rbnsh"
    if k_scale is not None:
        # (tp, b, nh_local, kv, 1) -> (tp, b, nh_local, 1, kv)
        ks = k_scale[ranks, :, hid // g].transpose(1, 2).float()
        vs = v_scale[ranks, :, hid // g].transpose(1, 2).float()
        ks, vs = ks.transpose(-1, -2), vs.transpose(-1, -2)
        logits = _bf16_dot(eq_k, q, k_sel) * ks
    else:
        logits = torch.einsum(eq_k, q, k_sel).float()
    logits = torch.where(valid, logits * hd ** -0.5, _MASKED)
    if k_scale is not None:
        out = _bf16_dot(eq_v, _softmax(logits) * vs, v_sel).to(q.dtype)
    else:
        out = torch.einsum(eq_v, _softmax(logits).to(q.dtype), v_sel)
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
