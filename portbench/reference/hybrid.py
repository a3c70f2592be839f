"""Plain float32 reference of the ``hybrid`` family (hymba as the port
defines it): in each layer a windowed GQA attention and a selective SSM
head read the same normed input, their outputs averaged, then a SwiGLU
MLP. The SSM, token by token from a zero state::

    xin, z = split(h @ w_in);  B, C, r = split(xin @ w_bcdt)
    dt = softplus(r @ w_dt);   A = -exp(a_log)
    s_t = exp(dt_t A) * s_{t-1} + (dt_t xin_t) B_t
    y_t = (s_t C_t + xin_t * d_skip) * silu(z_t);   out = y @ w_out

Departures of the port's model from the published one are in the
configuration's ``departures``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import plain


def ssm(h, w, config, precision):
    d = config["d_model"]
    st = config["ssm"]["state_dim"]
    xz = plain.mm(h, w["w_in"], precision)
    xin, z = xz[:, :d], xz[:, d:]
    bcdt = plain.mm(xin, w["w_bcdt"], precision)
    B, C = bcdt[:, :st], bcdt[:, st:2 * st]
    dt = F.softplus(plain.mm(bcdt[:, 2 * st:].contiguous(), w["w_dt"],
                             precision))
    A = -torch.exp(w["a_log"].float())                  # (d_inner, state)
    s = torch.zeros_like(A)
    ys = []
    for t in range(h.shape[0]):
        s = torch.exp(dt[t][:, None] * A) * s + \
            (dt[t] * xin[t])[:, None] * B[t][None, :]
        ys.append(s @ C[t])
    y = torch.stack(ys) + xin * w["d_skip"].float()
    return plain.mm(y * F.silu(z), w["w_out"], precision)


def layer(x, lw, window, config, precision):
    eps = config["norm_eps"]
    h = plain.rms_norm(x, lw["ln_attn"], eps)
    mix = 0.5 * (plain.attention(h, lw, config, window, precision)
                 + ssm(h, lw["ssm"], config, precision))
    x = x + mix
    return x + plain.swiglu(plain.rms_norm(x, lw["ln_mlp"], eps), lw["mlp"],
                            precision)


def logits(params, config, seqs, starts, *, precision="f32"):
    return plain.logits(params, config, seqs, starts, layer,
                        precision=precision)
