"""Plain PyTorch pieces of the references: float32 throughout, no
kernel, no cache, no batching, one sequence at a time. ``precision=
"fp8"`` rounds both operands of every weight matrix product to
float8 e4m3 (the weight by its whole tensor's scale, the activations
row by row) before an f32 product: the control, a precision below the
bf16 the configurations state. Imports nothing of the program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim=None) -> torch.Tensor:
    a = t.abs().amax() if dim is None else t.abs().amax(dim, keepdim=True)
    scale = torch.clamp(a, min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x (rows, k) @ w (k, ...)`` in f32, its operands first rounded
    to fp8 under ``precision="fp8"``."""
    w = w.float().reshape(w.shape[0], -1)
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rms_norm(x, scale, eps):
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return x * (1.0 + scale.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (L, heads, hd) rotated at positions 0..L-1 (halves rotated
    against each other, the frequencies ``theta ** (-2i / hd)``; angles
    in float64)."""
    L, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, lw: dict, config: dict, window, precision: str):
    """Causal GQA attention over the whole sequence (``window``: each
    query sees the ``window`` latest positions, itself included). Only
    the published heads: padded heads, which the program masks to
    nothing, are not computed here at all."""
    L = h.shape[0]
    nh, nkv = config["n_heads"], config["n_kv_heads"]
    hd = config.get("head_dim") or config["d_model"] // nh
    a = lw["attn"]
    q = mm(h, a["wq"][:, :nh], precision).reshape(L, nh, hd)
    k = mm(h, a["wk"][:, :nkv], precision).reshape(L, nkv, hd)
    v = mm(h, a["wv"][:, :nkv], precision).reshape(L, nkv, hd)
    theta = config.get("rope_theta", 10000.0)
    q, k = rope(q, theta), rope(k, theta)
    g = nh // nkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qnh,knh->nqk", q, k) / math.sqrt(hd)
    pos = torch.arange(L, device=h.device)
    rel = pos[:, None] - pos[None, :]
    ok = rel >= 0
    if window is not None:
        ok &= rel < window
    s = torch.where(ok, s, float("-inf"))
    o = torch.einsum("nqk,knh->qnh", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(L, nh * hd), a["wo"][:nh].reshape(nh * hd, -1),
              precision)


def swiglu(h, w: dict, precision: str):
    act = F.silu(mm(h, w["w_gate"], precision)) * mm(h, w["w_up"], precision)
    return mm(act, w["w_down"], precision)


def layer_windows(config: dict) -> list:
    per = config.get("local_global_period", 1)
    w = config.get("window")
    return [w] * (per - 1) + [None] if per > 1 else [w]


def layer_weights(params: dict, i: int, config: dict) -> dict:
    per = config.get("local_global_period", 1)
    slot, g = params["layers"][i % per], i // per
    return {k: ({kk: vv[g] for kk, vv in v.items()} if isinstance(v, dict)
                else v[g]) for k, v in slot.items()}


def logits(params: dict, config: dict, seqs: list, starts: list, layer, *,
           precision: str = "f32") -> list:
    """f32 logits of every sequence in ``seqs`` ((L,) token ids) at its
    positions from ``starts[i]`` on, the model walked layer by layer over
    all the sequences (``layer(x, lw, window, config, precision)`` one
    layer of the family on one sequence's hidden states)."""
    eps = config["norm_eps"]
    xs = [params["embed"][s].float() for s in seqs]
    wins = layer_windows(config)
    for i in range(config["n_layers"]):
        lw = layer_weights(params, i, config)
        xs = [layer(x, lw, wins[i % len(wins)], config, precision)
              for x in xs]
    return [mm(rms_norm(x[s0:], params["ln_f"], eps), params["unembed"],
               precision) for x, s0 in zip(xs, starts)]
