"""Flash attention: the attention core of the full-sequence forward.

Port of ``repro/kernels/flash_attention.py`` (``_fa_kernel``): causal,
sliding-window or bidirectional attention over whole sequences from
position 0, with an f32 online softmax (running max, denominator and
accumulator), where KV blocks that lie wholly outside the causal limit
or the window are never visited. The CUDA kernel is
``csrc/flash_attention.cu``; :func:`flash_attention_plain` is the
reference's recurrence in torch (its q/kv blocks and its ``lo``/``hi``
block range), which a CPU tensor runs.

Shapes: ``q`` is ``(b, h, s, hd)`` and ``k``/``v`` are ``(b, h_kv, s,
hd)`` with ``h % h_kv == 0``; query head ``i`` reads KV head ``i // (h
// h_kv)``, the reference model's ``q.reshape(b, nkv, g, s, hd)``
grouping, so broadcast K/V are never materialised. Pre-broadcast K/V
(the reference kernel's contract) is the case ``h_kv == h``. Any ``s``:
a ragged tail block is masked. f32 and bf16, accumulated in f32.

The kernel is a forward only, as the reference's is: with grad mode on it
refuses q, k or v that require a gradient rather than return an output
that autograd cannot trace back (training runs the plain core).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import comm_utils

__all__ = ["flash_attention", "flash_attention_plain", "block_range",
           "tile_class", "kv_tile", "KERNEL", "HEAD_DIMS", "KERNEL_BLOCK_Q"]

KERNEL = "flash_attention"
NEG = -1e30              # masked logit, as the reference's _NEG
BLOCK = 128              # the plain version's q/kv block (the reference's)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
#: query rows a block of the bf16 CUDA kernel (two warpgroups of 64)
KERNEL_BLOCK_Q = 128


def kv_tile(hd: int) -> int:
    """Keys a KV tile of the bf16 CUDA kernel at head dim ``hd``
    (``csrc/flash_attention.cu: WgCfg::kBK``): 64 at hd 256, whose O
    accumulator takes 128 registers a thread, else 128."""
    return 64 if hd > 128 else 128


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q/k/v must be (b, heads, s, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (s, hd):
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} as (b, h_kv, s, hd)")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads do not group over {k.shape[1]} "
                         f"KV heads")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def block_range(q_start: int, block_q: int, block_kv: int, s: int, *,
                causal: bool, window: Optional[int]) -> tuple[int, int]:
    """KV blocks ``[lo, hi)`` that the q block starting at ``q_start``
    visits: from the first block that can hold an in-window key, to the
    last that can hold a causal one (the reference's ``lo_val`` and
    ``hi_val``)."""
    lo = max(q_start - (window - 1), 0) // block_kv if window is not None \
        else 0
    hi = (min(q_start + block_q - 1, s - 1) // block_kv + 1 if causal
          else -(-s // block_kv))
    return lo, hi


def tile_class(q_start: int, k_start: int, s: int, *, block_q: int,
               block_kv: int, causal: bool, window: Optional[int]) -> str:
    """How the bf16 CUDA kernel treats the KV tile at ``k_start`` for the
    query block at ``q_start`` (``csrc/flash_attention.cu``, mirrored
    here): ``"skipped"`` outside :func:`block_range` (never loaded);
    ``"interior"`` when every pair of the tile is kept for every row of
    the block (every key < s, all keys at or before the block's first row
    when causal, inside the window of its last row), so the kernel runs
    no mask there; else ``"masked"``, masked element by element."""
    lo, hi = block_range(q_start, block_q, block_kv, s, causal=causal,
                         window=window)
    if not lo <= k_start // block_kv < hi:
        return "skipped"
    k_last = k_start + block_kv - 1
    if (k_last < s and (not causal or k_last <= q_start)
            and (window is None or q_start + block_q - 1 - k_start < window)):
        return "interior"
    return "masked"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` -> ``(b, h, s, hd)`` in q's
    dtype. A CUDA tensor runs the kernel, a CPU tensor the plain version
    (``backend="torch"``/``"cuda"`` forces one; a CPU tensor never
    reaches the kernel)."""
    _check(q, k, v, window)
    if comm_utils.resolve_backend(q, backend) == "torch":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The reference kernel's recurrence at its default 128-row q and KV
    blocks: for each q block, the KV blocks of :func:`block_range` in
    order, masked logits ``-1e30``, running (max, denominator,
    accumulator) in f32, output ``acc / max(l, 1e-30)``. The last block
    of a ragged ``s`` is shorter."""
    _check(q, k, v, window)
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    qf = q.float() * hd ** -0.5
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for q_start in range(0, s, BLOCK):
        qb = qf[:, :, q_start:q_start + BLOCK]
        bq = qb.shape[2]
        q_pos = torch.arange(q_start, q_start + bq, device=q.device)
        m = torch.full((b, h, bq), NEG, device=q.device)
        l = torch.zeros((b, h, bq), device=q.device)
        acc = torch.zeros((b, h, bq, hd), device=q.device)
        lo, hi = block_range(q_start, BLOCK, BLOCK, s, causal=causal,
                             window=window)
        for ki in range(lo, hi):
            k_start = ki * BLOCK
            kb = kf[:, :, k_start:k_start + BLOCK]
            vb = vf[:, :, k_start:k_start + BLOCK]
            sc = qb @ kb.transpose(-1, -2)
            k_pos = torch.arange(k_start, k_start + kb.shape[2],
                                 device=q.device)
            rel = q_pos[:, None] - k_pos[None, :]
            mask = torch.ones(rel.shape, dtype=torch.bool, device=q.device)
            if causal:
                mask &= rel >= 0
            if window is not None:
                mask &= rel < window
            sc = torch.where(mask, sc, NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vb
            m = m_new
        out[:, :, q_start:q_start + bq] = \
            acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned (the kernel's vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # a ctypes launch records no autograd node: the output would carry
        # no grad_fn and everything upstream of the core would silently
        # get no attention gradient
        raise RuntimeError(
            "the flash-attention kernel has no backward, and q, k or v "
            "requires a gradient: train on the plain core "
            "(transformer.loss_fn(attn_backend='torch'), "
            "blocks.attention(backend='torch')), or call the kernel under "
            "torch.no_grad() / torch.inference_mode()")
    from repro_torch.kernels import build
    code = DTYPE_CODES.get(q.dtype)
    if code is None:
        raise ValueError(f"the flash-attention kernel takes "
                         f"{list(DTYPE_CODES)}, got {q.dtype}")
    b, h, s, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q/k/v lie on {q.device}, {k.device}, {v.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.flash_attention_library()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code, b,
        h, k.shape[1], s, hd, int(causal), window or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    comm_utils.check_launch(rc, lib.flash_attention_error_string, KERNEL, q)
    return out
