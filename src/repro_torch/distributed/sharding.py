"""Rank slicing of the params for explicit tensor-parallel decode (port
of ``repro.distributed.sharding.explicit_decode_supported`` and of the
layout ``explicit_decode_pspecs`` describes).

Where the reference hands PartitionSpecs to ``shard_map``, the port
builds the rank-stacked tensors themselves: every leaf gains a leading
rank axis, and that axis either holds each rank's shard or a replica.

* query/output heads (``wq`` axis 2, ``wo`` axis 1), the MLP hidden dim
  (``w_gate``/``w_up`` axis 2, ``w_down`` axis 1) and, when the vocab
  divides, ``embed`` (axis 0) / ``unembed`` (axis 1) split over TP;
* MoE experts split whole over the same axis, which then carries expert
  parallelism (axis 1 of the ``(groups, e, d, f)`` leaves ``w_gate``,
  ``w_up``, ``w_down``); the router is replicated;
* the hybrid family's SSM branch splits on its inner dim ``d_inner``
  (``w_dt`` axis 2, ``a_log``, ``d_skip`` and ``w_out`` axis 1, the
  reference's ``_ssm_specs``), while its input projections ``w_in`` and
  ``w_bcdt`` are replicated: ``(dt, B, C)`` contract over the whole
  ``d_inner``, so every rank computes them whole;
* ``wk``/``wv``, the norms and the KV cache are replicated — every rank
  computes the same new K/V token, so the replicated cache stays
  consistent without a gather.

:func:`auto_decode_params` and :func:`auto_decode_cache` undo the layout
(the serving guardrails' explicit→auto fallback, where the reference
reshards under ``in_shardings``): sharded leaves joined in rank order,
replicated ones taken from rank 0, the SSM state's rank shards joined
along ``d_inner``. Every leaf is a new tensor, so the explicit tree can
be freed (or keep being written by an abandoned step) without touching
the result.
"""
from __future__ import annotations

import torch

from repro_torch.mesh import RankAxis
from repro_torch.models.blocks import padded_heads
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv6 import STATE_NAMES

__all__ = ["explicit_decode_supported", "explicit_decode_params",
           "auto_decode_params", "auto_decode_cache", "SHARD_DIMS"]

#: per-layer leaf -> the axis (of the ``(groups, ...)`` leaf) split over
#: TP; leaves not listed are replicated
SHARD_DIMS = {("attn", "wq"): 2, ("attn", "wo"): 1,
              ("mlp", "w_gate"): 2, ("mlp", "w_up"): 2, ("mlp", "w_down"): 1,
              ("moe", "w_gate"): 1, ("moe", "w_up"): 1, ("moe", "w_down"): 1,
              ("ssm", "w_dt"): 2, ("ssm", "a_log"): 1, ("ssm", "d_skip"): 1,
              ("ssm", "w_out"): 1}


def explicit_decode_supported(cfg: ModelConfig, tp: int) -> tuple[bool, str]:
    """Can the explicit decode step run this config on a TP axis of
    size ``tp``? The (padded) heads must divide; dense and hybrid tensor
    parallelism also needs ``d_ff`` to divide, MoE expert parallelism
    the expert count (``d_ff`` does not matter: experts stay whole), and
    the hybrid SSM branch its inner dim ``d_model``. Any other family
    (rwkv6, encoder) stays on auto, as in the reference."""
    if tp <= 1:
        return False, "no TP axis of size > 1: nothing to make explicit"
    if cfg.family not in ("dense", "moe", "hybrid"):
        return False, (f"family {cfg.family!r} not supported (explicit "
                       f"decode covers dense TP, MoE expert parallelism "
                       f"and hybrid attention+SSM sharding)")
    nh, _ = padded_heads(cfg)
    if nh % tp != 0:
        return False, f"attention heads {nh} not divisible by TP={tp}"
    if cfg.family == "moe":
        e = cfg.moe.num_experts
        if e % tp != 0:
            return False, (f"experts {e} not divisible by EP={tp} "
                           f"(TP-in-expert has no explicit path)")
    elif cfg.d_ff % tp != 0:
        return False, f"d_ff {cfg.d_ff} not divisible by TP={tp}"
    if cfg.family == "hybrid" and cfg.d_model % tp != 0:
        return False, (f"SSM inner dim d_model {cfg.d_model} not "
                       f"divisible by TP={tp}")
    return True, ""


def _shard_layer_leaf(axis: RankAxis, v, dim: int):
    """Rank-stack a ``(groups, ...)`` layer leaf split on ``dim``, group
    major: a ``(tp, groups, ...)`` view of a ``(groups, tp, ...)`` copy,
    so that one layer's slice ``[:, g]`` is contiguous and the batched
    matmuls over (rank, ...) — the MoE layer's over (rank, expert) —
    read the weights in place instead of copying them every step."""
    size = v.shape[dim]
    if size % axis.n:
        raise ValueError(f"dim {dim} of size {size} does not divide over "
                         f"{axis.n} ranks of axis {axis.name!r}")
    return (v.to(axis.device).unflatten(dim, (axis.n, size // axis.n))
            .movedim(dim, 1).contiguous().movedim(1, 0))


def explicit_decode_params(params: dict, cfg: ModelConfig,
                           axis: RankAxis) -> dict:
    """The rank-stacked explicit-decode layout of ``params`` on
    ``axis.device`` (copies; ``params`` is left as it is)."""
    ok, why = explicit_decode_supported(cfg, axis.n)
    if not ok:
        raise ValueError(f"explicit-TP decode unsupported here: {why}")
    vocab_split = cfg.vocab % axis.n == 0

    def layer(slot: dict) -> dict:
        out = {}
        for k, v in slot.items():
            if isinstance(v, dict):
                out[k] = {kk: (_shard_layer_leaf(axis, vv,
                                                 SHARD_DIMS[(k, kk)])
                               if (k, kk) in SHARD_DIMS
                               else axis.replicate(vv))
                          for kk, vv in v.items()}
            else:
                out[k] = axis.replicate(v)
        return out

    out = {
        "embed": (axis.shard(params["embed"], 0) if vocab_split
                  else axis.replicate(params["embed"])),
        "ln_f": axis.replicate(params["ln_f"]),
        "layers": [layer(slot) for slot in params["layers"]],
    }
    if "unembed" in params:
        out["unembed"] = (axis.shard(params["unembed"], 1) if vocab_split
                          else axis.replicate(params["unembed"]))
    return out


def _unshard(x, dim: int):
    """Inverse of :func:`_shard_layer_leaf` and ``RankAxis.shard`` for a
    rank-stacked leaf split on ``dim`` of the unstacked leaf: the ranks'
    blocks joined in rank order (a new tensor)."""
    return x.movedim(0, dim).flatten(dim, dim + 1).clone(
        memory_format=torch.contiguous_format)


def auto_decode_params(params: dict, cfg: ModelConfig) -> dict:
    """The reference (auto) layout of rank-stacked explicit params —
    the inverse of :func:`explicit_decode_params`, exact (pure data
    movement), on the same device. Padded heads stay: the reference
    layout holds them too (``blocks.padded_heads``, masked to zero)."""
    n = params["ln_f"].shape[0]
    vocab_split = cfg.vocab % n == 0

    def layer(slot: dict) -> dict:
        out = {}
        for k, v in slot.items():
            if isinstance(v, dict):
                out[k] = {kk: (_unshard(vv, SHARD_DIMS[(k, kk)])
                               if (k, kk) in SHARD_DIMS else vv[0].clone())
                          for kk, vv in v.items()}
            else:
                out[k] = v[0].clone()
        return out

    out = {
        "embed": (_unshard(params["embed"], 0) if vocab_split
                  else params["embed"][0].clone()),
        "ln_f": params["ln_f"][0].clone(),
        "layers": [layer(slot) for slot in params["layers"]],
    }
    if "unembed" in params:
        out["unembed"] = (_unshard(params["unembed"], 1) if vocab_split
                          else params["unembed"][0].clone())
    return out


def auto_decode_cache(cache: dict) -> dict:
    """The auto layout of an explicit decode cache (``init_cache(...,
    ranks=n)``): rank 0's copy of the replicated KV leaves and their
    int8 scales, the SSM state's rank shards ``(n, groups, b, d/n,
    state)`` joined along ``d`` into ``(groups, b, d, state)``. The
    rwkv6 family's state has no explicit layout: its leaves pass through
    as copies."""
    def auto(name, leaf):
        if name in STATE_NAMES:
            return leaf.clone()
        return _unshard(leaf, 2) if name == "ssm" else leaf[0].clone()

    return {name: [auto(name, leaf) for leaf in leaves]
            for name, leaves in cache.items()}
