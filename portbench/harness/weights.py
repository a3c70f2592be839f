"""The weights a cell serves, made from ``--seed`` by the benchmark
itself and handed to the program and to the plain reference alike.

They are laid out as the port's ``Engine`` takes them (its reference
layout: ``embed``, ``ln_f``, ``unembed`` and ``layers``, a list of one
dict a period slot whose leaves carry a leading ``groups`` axis), made
on the device in the type they are served in, one ``randn`` call a leaf
and every layer of a leaf in that call. The same seed on the same device
makes the same numbers, so the reference makes them again once the
program's state is freed instead of holding a second copy.

Scales are each matrix's fan-in ``** -0.5`` (the embedding 1); the
matrices that write into the residual stream (attention's ``wo``, the
MLP's and experts' ``w_down``, the SSM's ``w_out``) are scaled by the
configuration's ``init.residual_scale`` besides (GPT-2's scaled
initialisation, ``1 / sqrt(2 n_layers)``: with fan-in scales alone a
random model's logits move by their own spread under bf16 rounding, and
no check could tell a rounding from a fault). Attention's ``wo`` is
scaled by ``init.attn_out_scale`` as well (1 by default): a random
model's near-uniform softmax averages the values of hundreds of keys,
which shrinks the attention branch by the square root of their number,
so its tokens hardly depend on the context, and a cache that is never
written, or half of it, would change few of them. Norm scales are ``0.1 *
N(0, 1)`` (the norms multiply by ``1 + scale``), so a path that skipped
a norm's scale would be seen. The SSM's ``a_log`` is ``log(1..state)``
on every row and ``d_skip`` 1, Mamba's initial values.
"""
from __future__ import annotations

import torch


def padded_heads(config: dict) -> tuple:
    """(query heads, KV heads) as held: ``pad_heads_to`` pads the query
    heads (hard-masked to nothing in the program) and the KV heads with
    them, so that the heads divide over the TP ranks."""
    nh, nkv = config["n_heads"], config["n_kv_heads"]
    pad = config.get("pad_heads_to") or 0
    if pad <= nh:
        return nh, nkv
    g = nh // nkv
    return pad, (pad + g - 1) // g


def head_dim(config: dict) -> int:
    return config.get("head_dim") or config["d_model"] // config["n_heads"]


def dt_rank(config: dict) -> int:
    return config["ssm"].get("dt_rank") or max(config["d_model"] // 16, 1)


def groups(config: dict) -> tuple:
    """(period slots, groups): layers come in groups of one period."""
    per = config.get("local_global_period", 1)
    if config["n_layers"] % per:
        raise ValueError("n_layers must be a whole number of periods")
    return per, config["n_layers"] // per


def slot_shapes(config: dict) -> dict:
    """{(part, leaf): (shape without the groups axis, scale)} of one
    period slot; a scale of ``"norm"``, ``"a_log"`` or ``"ones"`` names
    a leaf made otherwise."""
    d, hd = config["d_model"], head_dim(config)
    nh, nkv = padded_heads(config)
    init = config.get("init", {})
    rs = init.get("residual_scale", 1.0)
    ao = rs * init.get("attn_out_scale", 1.0)
    out = {("", "ln_attn"): ((d,), "norm"), ("", "ln_mlp"): ((d,), "norm"),
           ("attn", "wq"): ((d, nh, hd), d ** -0.5),
           ("attn", "wk"): ((d, nkv, hd), d ** -0.5),
           ("attn", "wv"): ((d, nkv, hd), d ** -0.5),
           ("attn", "wo"): ((nh, hd, d),
                            ao * (config["n_heads"] * hd) ** -0.5)}
    if config["family"] == "moe":
        e = config["moe"]["num_experts"]
        f = config["moe"].get("d_ff_expert") or config["d_ff"]
        out.update({("moe", "router"): ((d, e), d ** -0.5),
                    ("moe", "w_gate"): ((e, d, f), d ** -0.5),
                    ("moe", "w_up"): ((e, d, f), d ** -0.5),
                    ("moe", "w_down"): ((e, f, d), rs * f ** -0.5)})
    else:
        f = config["d_ff"]
        out.update({("mlp", "w_gate"): ((d, f), d ** -0.5),
                    ("mlp", "w_up"): ((d, f), d ** -0.5),
                    ("mlp", "w_down"): ((f, d), rs * f ** -0.5)})
    if config["family"] == "hybrid":
        s, r = config["ssm"]["state_dim"], dt_rank(config)
        out.update({("ssm", "w_in"): ((d, 2 * d), d ** -0.5),
                    ("ssm", "w_bcdt"): ((d, 2 * s + r), d ** -0.5),
                    ("ssm", "w_dt"): ((r, d), r ** -0.5),
                    ("ssm", "a_log"): ((d, s), "a_log"),
                    ("ssm", "d_skip"): ((d,), "ones"),
                    ("ssm", "w_out"): ((d, d), rs * d ** -0.5)})
    return out


def _leaf(gen, shape, scale, dtype, device):
    if scale == "norm":
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device).mul_(0.1)
    if scale == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if scale == "a_log":
        s = shape[-1]
        row = torch.log(torch.arange(1, s + 1, dtype=torch.float32,
                                     device=device))
        return row.expand(shape).to(dtype).contiguous()
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def make(config: dict, seed: int, device) -> dict:
    """The cell's weights from ``seed`` on ``device``."""
    device = torch.device(device)
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, v = config["d_model"], config["vocab"]
    per, n_groups = groups(config)
    params = {"embed": _leaf(gen, (v, d), 1.0, dtype, device),
              "ln_f": _leaf(gen, (d,), "norm", dtype, device),
              "unembed": _leaf(gen, (d, v), d ** -0.5, dtype, device),
              "layers": []}
    for _ in range(per):
        slot: dict = {}
        for (part, name), (shape, scale) in slot_shapes(config).items():
            leaf = _leaf(gen, (n_groups,) + shape, scale, dtype, device)
            (slot.setdefault(part, {}) if part else slot)[name] = leaf
        params["layers"].append(slot)
    return params

