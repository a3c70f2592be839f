"""The LM's decode path for the dense and MoE families (port of
``repro.models.transformer``): seeded init, decode cache, one-token
decode step — unsharded (auto) or on rank-stacked TP shards with the
per-layer collectives replayed through compiled plans (explicit; for
MoE the same axis carries expert parallelism).

Parameter layout is the reference's: ``params["layers"]`` is a list
(length = period) of per-slot layer dicts whose leaves carry a leading
``groups`` axis, so weights carry across one to one. The explicit
layout (``distributed.sharding.explicit_decode_params``) puts a rank
axis in front of every leaf: ``wq`` ``(groups, d, nh, hd)`` becomes
``(tp, groups, d, nh/tp, hd)``. The other families (hybrid, rwkv6,
encoder) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.mesh import DeviceLike, resolve_device
from repro_torch.models import blocks
from repro_torch.models.blocks import rms_norm
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "init_cache", "decode_step", "logits_fn",
           "layer_windows", "n_groups"]

FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port's decode "
            f"covers {FAMILIES}")


def layer_windows(cfg: ModelConfig) -> list[Optional[int]]:
    """Attention window per layer within one period group."""
    per = cfg.local_global_period
    if per > 1:
        return [cfg.window] * (per - 1) + [None]
    return [cfg.window]


def n_groups(cfg: ModelConfig) -> int:
    per = cfg.local_global_period
    assert cfg.n_layers % per == 0, (cfg.n_layers, per)
    return cfg.n_layers // per


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None, seed: int = 0) -> dict:
    """Seeded random weights on ``device`` (default: the CUDA card).
    The numbers differ from the reference's ``jax.random`` ones; to hold
    the two against each other, carry the reference's weights across
    with :func:`repro_torch.interop.params_from_jax`."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    groups = n_groups(cfg)
    d, dt = cfg.d_model, cfg.tdtype
    lead = (groups,)
    slots = []
    for _ in layer_windows(cfg):
        slot = {
            "ln_attn": torch.zeros(lead + (d,), dtype=dt, device=device),
            "ln_mlp": torch.zeros(lead + (d,), dtype=dt, device=device),
            "attn": blocks.init_attn(gen, cfg, lead=lead, device=device),
        }
        if cfg.family == "moe":
            slot["moe"] = blocks.init_moe(gen, cfg, lead=lead, device=device)
        else:
            slot["mlp"] = blocks.init_mlp(gen, cfg, lead=lead, device=device)
        slots.append(slot)
    params = {
        "embed": blocks.init_linear(gen, (cfg.vocab, d), dt, scale=1.0,
                                    device=device),
        "ln_f": torch.zeros((d,), dtype=dt, device=device),
        "layers": slots,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = blocks.init_linear(gen, (d, cfg.vocab), dt,
                                               device=device)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_kv: int, *,
               device: DeviceLike = None, dtype=None,
               ranks: Optional[int] = None) -> dict:
    """Decode cache: per period slot, ``(groups, b, kv_heads, kv_i, hd)``
    with ``kv_i = min(window, max_kv)`` for windowed slots. ``ranks``
    adds a leading rank axis: the explicit-TP cache is replicated, every
    rank holding every KV head."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.tdtype
    _, nkv = blocks.padded_heads(cfg)
    lead = (ranks,) if ranks else ()

    def kv(win):
        size = min(win, max_kv) if win is not None else max_kv
        return torch.zeros(lead + (n_groups(cfg), batch, nkv, size, cfg.hd),
                           dtype=dtype, device=device)

    wins = layer_windows(cfg)
    return {"k": [kv(w) for w in wins], "v": [kv(w) for w in wins]}


def logits_fn(params, cfg: ModelConfig, hidden):
    w = params["embed"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["unembed"]
    return torch.einsum("...bsd,...dv->...bsv", hidden, w).float()


def _group(tree, g: int, ranked: bool):
    """Layer params of group ``g`` (views; rank axis first if ranked)."""
    if isinstance(tree, dict):
        return {k: _group(v, g, ranked) for k, v in tree.items()}
    return tree[:, g] if ranked else tree[g]


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *, comms=None):
    """tokens: (b,) int; pos: int shared by the batch, or a (b,) tensor.
    Returns (logits (b, vocab) f32, cache) — the cache is updated in
    place and returned for the reference's calling convention.

    ``comms`` — the explicit-TP hook (``distributed.step.TPDecodeComms``):
    params and cache arrive rank-stacked, the per-layer hidden-state
    partials (attention out-proj, MLP down-proj) are completed by
    ``comms.hidden`` (a replay of the compiled AllReduce plan), the
    vocab-sharded embedding lookup and the logits go through
    ``comms.embed`` / ``comms.logits``, and attention receives every
    shard's global head offset. A MoE layer runs ``comms.moe`` —
    expert-parallel dispatch and combine through the compiled
    capacity-bucketed all_to_all plan, whose output is complete on
    every rank, so no AllReduce follows it — where the auto path runs
    the dense oracle ``blocks.moe_layer``. ``comms=None`` is the auto
    path.
    """
    _check_family(cfg)
    ranked = comms is not None
    if ranked and cfg.family == "moe" and comms.moe_plan is None:
        raise NotImplementedError(
            "explicit MoE decode needs a compiled 'moe_alltoall' plan "
            "(experts divisible by the TP axis); without one the family "
            "stays on auto")
    if ranked:
        x = comms.embed(params["embed"], tokens)[..., None, :]
    else:
        x = params["embed"][tokens][:, None]              # (b, 1, d)
    wins = layer_windows(cfg)
    for g in range(n_groups(cfg)):
        for i, win in enumerate(wins):
            lp = _group(params["layers"][i], g, ranked)
            ck = cache["k"][i][:, g] if ranked else cache["k"][i][g]
            cv = cache["v"][i][:, g] if ranked else cache["v"][i][g]
            h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
            ho = (comms.head_offset(lp["attn"]["wq"].shape[-2])
                  if ranked else None)
            att = blocks.decode_attention(lp["attn"], h, ck, cv, pos, cfg,
                                          window=win, head_offset=ho)
            if ranked:
                att = comms.hidden(att)     # complete the out-proj partial
            x = x + att
            h = rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
            if cfg.family == "moe":
                mlp_out = (comms.moe(lp["moe"], h) if ranked
                           else blocks.moe_layer(lp["moe"], h, cfg))
            else:
                mlp_out = blocks.mlp_swiglu(lp["mlp"], h)
                if ranked:
                    mlp_out = comms.hidden(mlp_out)   # down-proj partial
            x = x + mlp_out
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if ranked:
        return comms.logits(params, h), cache
    return logits_fn(params, cfg, h)[:, 0], cache
