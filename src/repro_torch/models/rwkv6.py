"""RWKV-6 "Finch" layer (arXiv:2404.05892) — the port of
``repro.models.rwkv6``: linear attention with a data-dependent decay.
Attention-free: each head's state is a ``(64, 64)`` matrix updated
recurrently, so a decode step's cost and memory do not grow with the
sequence.

Token-shift lerps, the decay ``w = exp(-exp(w_base + lora(x)))``, the
bonus ``u`` and the channel-mix FFN, with the reference's casts: the
projections run in the input dtype and go to f32 after; ``g``, the
decay LoRA and the WKV recurrence run in f32; the time mix's output goes
back to the input dtype before ``wo``; the token-shift states are kept
in f32.

The recurrence (:func:`wkv_scan`) is the reference's ``lax.scan`` as a
plain loop over the sequence, in the reference's order; it is the one
function a fused kernel would replace.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import init_linear, rms_norm

__all__ = ["HEAD", "STATE_NAMES", "init_rwkv_layer", "init_rwkv_state",
           "wkv_scan", "rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_decode_step"]

HEAD = 64  # rwkv6 head size
#: the recurrent state's leaves, as the reference's ``init_rwkv_state``
STATE_NAMES = ("wkv", "shift_t", "shift_c")

Params = dict


def init_rwkv_layer(gen: torch.Generator, cfg, *, lead=(),
                    device=None) -> Params:
    """One layer's 21 leaves (with the leading dims ``lead``): the
    reference's shapes and constants, random weights drawn from ``gen``
    (the numbers differ from the reference's ``jax.random`` ones)."""
    d, f = cfg.d_model, cfg.d_ff
    nh = d // HEAD
    dt = cfg.tdtype
    kw = dict(lead=lead, device=device)

    def full(shape, value):
        return torch.full(tuple(lead) + shape, value, dtype=dt,
                          device=device)

    return {
        # time-mix projections
        "wr": init_linear(gen, (d, d), dt, **kw),
        "wk": init_linear(gen, (d, d), dt, **kw),
        "wv": init_linear(gen, (d, d), dt, **kw),
        "wg": init_linear(gen, (d, d), dt, **kw),
        "wo": init_linear(gen, (d, d), dt, scale=d ** -0.5, **kw),
        # data-dependent decay LoRA (w = exp(-exp(base + lora(x))))
        "w_base": full((nh, HEAD), -6.0),
        "w_lora_a": init_linear(gen, (d, 64), dt, **kw),
        "w_lora_b": init_linear(gen, (64, d), dt, scale=1e-2, **kw),
        # per-head bonus
        "u": full((nh, HEAD), 0.5),
        # token-shift mixing coefficients (static part)
        "mix_r": full((d,), 0.5), "mix_k": full((d,), 0.5),
        "mix_v": full((d,), 0.5), "mix_w": full((d,), 0.5),
        "mix_g": full((d,), 0.5),
        # channel mix
        "ck": init_linear(gen, (d, f), dt, **kw),
        "cv": init_linear(gen, (f, d), dt, scale=f ** -0.5, **kw),
        "cr": init_linear(gen, (d, d), dt, **kw),
        "mix_ck": full((d,), 0.5), "mix_cr": full((d,), 0.5),
        "ln1": full((d,), 0.0), "ln2": full((d,), 0.0),
    }


def init_rwkv_state(cfg, batch: int, *, device=None,
                    dtype=torch.float32) -> dict:
    """``wkv (b, nh, 64, 64)`` (the (k, v) outer-product state) and the
    last token of the time and channel mixes, ``shift_t``/``shift_c``
    ``(b, d)``, all zero."""
    d = cfg.d_model
    nh = d // HEAD
    return {
        "wkv": torch.zeros((batch, nh, HEAD, HEAD), dtype=dtype,
                           device=device),
        "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _tshift(x, last):
    """Token shift: ``concat(last, x[:, :-1])`` along the sequence."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _mix(x, prev, m):
    return x * (1 - m) + prev * m


def wkv_scan(r, k, v, w, u, wkv):
    """The WKV recurrence over axis 1 of the ``(b, s, nh, 64)`` f32
    tensors ``r, k, v, w`` from the ``(b, nh, 64, 64)`` state ``wkv``,
    ``u`` ``(nh, 64)``: each step, in the reference's order, ``kv = k ⊗
    v``, ``out = r · (wkv + u·kv)``, ``wkv = w·wkv + kv``. Returns (out
    ``(b, s, nh, 64)``, the final state); ``wkv`` is left as it is.

    The state is updated in place on a copy; where autograd records the
    loop (training) each step writes a new tensor instead, the same
    products and sums: an in-place write would overwrite values the
    backward saved."""
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u, wkv))
    if not recorded:
        wkv = wkv.clone()
    bonus = u[..., None]                                  # (nh, K, 1)
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # (b, nh, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 wkv + bonus * kv))
        decay = w[:, t, :, :, None]
        if recorded:
            wkv = decay * wkv + kv
        else:
            wkv.mul_(decay).add_(kv)
    return torch.stack(outs, dim=1), wkv


def rwkv_time_mix(p: Params, x, state: dict):
    """x: (b, s, d) -> (out (b, s, d), new state): the state's ``wkv``
    advanced over the s tokens and ``shift_t`` the last token (f32); the
    other entries passed through. ``state`` is left as it is."""
    b, s, d = x.shape
    nh = d // HEAD
    prev = _tshift(x, state["shift_t"].to(x.dtype))

    def heads(t):
        return t.reshape(b, s, nh, HEAD)

    r = heads(_mix(x, prev, p["mix_r"]) @ p["wr"])
    k = heads(_mix(x, prev, p["mix_k"]) @ p["wk"])
    v = heads(_mix(x, prev, p["mix_v"]) @ p["wv"])
    g = F.silu((_mix(x, prev, p["mix_g"]) @ p["wg"]).float())
    # data-dependent decay (Finch's contribution), in f32
    wlo = (torch.tanh(_mix(x, prev, p["mix_w"]).float()
                      @ p["w_lora_a"].float()) @ p["w_lora_b"].float())
    w = torch.exp(-torch.exp(p["w_base"].float() + heads(wlo)))
    out, wkv = wkv_scan(r.float(), k.float(), v.float(), w,
                        p["u"].float(), state["wkv"])
    out = out.reshape(b, s, d) * g
    new_state = dict(state, wkv=wkv, shift_t=x[:, -1].float())
    return out.to(x.dtype) @ p["wo"], new_state


def rwkv_channel_mix(p: Params, x, state: dict):
    """x: (b, s, d) -> (out, new state with ``shift_c`` the last token)."""
    prev = _tshift(x, state["shift_c"].to(x.dtype))
    k = _mix(x, prev, p["mix_ck"]) @ p["ck"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    r = torch.sigmoid((_mix(x, prev, p["mix_cr"]) @ p["cr"]).float())
    out = (k @ p["cv"]) * r.to(x.dtype)
    return out, dict(state, shift_c=x[:, -1].float())


def rwkv_decode_step(p: Params, x, state: dict, cfg):
    """One layer over x (b, s, d) from ``state``: the time mix and the
    channel mix, each behind its RMS norm and residual. Returns (out, new
    state); ``state`` is left as it is (the caller writes it back). With
    s = 1 it is the decode step; the forward runs it from a zero state."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, state = rwkv_time_mix(p, h, state)
    x = x + att
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    ffn, state = rwkv_channel_mix(p, h, state)
    return x + ffn, state
