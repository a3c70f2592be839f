"""Plain float32 reference of the ``moe`` family (phi3.5-moe as the
port defines it): pre-norm RMSNorm blocks, causal GQA attention with
RoPE, and a routed SwiGLU expert layer: a token's router logits over
every expert, its ``top_k`` largest (ties to the lower index), their
softmax as the weights of those experts' outputs. Departures of the
port's model from the published one are in the configuration's
``departures``."""
from __future__ import annotations

import torch

from reference import plain


def layer(x, lw, window, config, precision):
    eps = config["norm_eps"]
    x = x + plain.attention(plain.rms_norm(x, lw["ln_attn"], eps), lw,
                            config, window, precision)
    h = plain.rms_norm(x, lw["ln_mlp"], eps)
    m = lw["moe"]
    k = config["moe"]["top_k"]
    r = plain.mm(h, m["router"], precision)
    vals, idx = torch.sort(r, dim=-1, descending=True, stable=True)
    w = torch.softmax(vals[:, :k], dim=-1)
    idx = idx[:, :k]
    y = torch.zeros_like(h)
    for e in range(m["router"].shape[-1]):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if len(tok):
            out = plain.swiglu(h[tok], {n: m[n][e] for n in
                                        ("w_gate", "w_up", "w_down")},
                               precision)
            y.index_add_(0, tok, out * w[tok, choice][:, None])
    return x + y


def logits(params, config, seqs, starts, *, precision="f32"):
    return plain.logits(params, config, seqs, starts, layer,
                        precision=precision)
