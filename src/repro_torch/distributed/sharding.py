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

The spec half of the reference module is here too: :class:`MeshAxes`,
:func:`param_pspecs`, :func:`batch_pspec`, :func:`cache_pspecs`,
:func:`apply_fsdp` and :func:`logical_rules`, as plain functions over
axis names and sizes. A grid is anything with a ``shape`` dict of axis
sizes (:class:`~repro_torch.mesh.NamedGrid`, or a ``jax`` mesh in the
tests), and a spec is a tuple with one entry a dim — an axis name, a
tuple of names, or ``None`` — the reference's ``PartitionSpec`` entries
in the reference's order. The port's trainer reads the FSDP specs
(``distributed/fsdp.py``), the dry run all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.mesh import RankAxis
from repro_torch.models.blocks import padded_heads
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv6 import STATE_NAMES

__all__ = ["explicit_decode_supported", "explicit_decode_params",
           "auto_decode_params", "auto_decode_cache", "SHARD_DIMS",
           "MeshAxes", "param_pspecs", "batch_pspec", "cache_pspecs",
           "apply_fsdp", "logical_rules", "spec_map"]

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


# ---------------------------------------------------------------------------
# the sharding specs (reference ``distributed/sharding.py:36-228, :359-405``)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: tuple = ("data",)     # DP axes (("pod", "data") multi-pod)
    model: str = "model"        # TP/EP axis


def _div(n: int, grid, axis: str) -> bool:
    return axis in grid.shape and n % grid.shape[axis] == 0


def _attn_specs(cfg: ModelConfig, grid, ax: MeshAxes) -> dict:
    m = ax.model
    nh, nkv = padded_heads(cfg)
    nh_ok, nkv_ok, hd_ok = (_div(nh, grid, m), _div(nkv, grid, m),
                            _div(cfg.hd, grid, m))
    # q/o shard heads if possible, else head_dim, else replicate
    q = (None, None, m, None) if nh_ok else (
        (None, None, None, m) if hd_ok else (None,) * 4)
    o = (None, m, None, None) if nh_ok else (
        (None, None, m, None) if hd_ok else (None,) * 4)
    kv = (None, None, m, None) if nkv_ok else (None,) * 4
    sp = {"wq": q, "wk": kv, "wv": kv, "wo": o}
    if cfg.qk_norm:
        sp["q_norm"] = (None, None)
        sp["k_norm"] = (None, None)
    return sp


def _mlp_specs(cfg: ModelConfig, grid, ax: MeshAxes, d_ff: int) -> dict:
    m = ax.model if _div(d_ff, grid, ax.model) else None
    return {"w_gate": (None, None, m), "w_up": (None, None, m),
            "w_down": (None, m, None)}


def _moe_specs(cfg: ModelConfig, grid, ax: MeshAxes) -> dict:
    m = ax.model
    if _div(cfg.moe.num_experts, grid, m):
        # expert parallelism: experts sharded across the model axis
        return {"router": (None, None, None), "w_gate": (None, m, None, None),
                "w_up": (None, m, None, None),
                "w_down": (None, m, None, None)}
    # TP inside each expert (fewer experts than the axis)
    f = cfg.moe.d_ff_expert or cfg.d_ff
    fm = m if _div(f, grid, m) else None
    return {"router": (None, None, None), "w_gate": (None, None, None, fm),
            "w_up": (None, None, None, fm), "w_down": (None, None, fm, None)}


def _rwkv_specs(cfg: ModelConfig, grid, ax: MeshAxes) -> dict:
    m = ax.model if _div(cfg.d_model, grid, ax.model) else None
    fm = ax.model if _div(cfg.d_ff, grid, ax.model) else None
    hm = ax.model if _div(cfg.d_model // 64, grid, ax.model) else None
    rep1 = (None, None)
    return {
        "wr": (None, None, m), "wk": (None, None, m), "wv": (None, None, m),
        "wg": (None, None, m), "wo": (None, m, None),
        "w_base": (None, hm, None), "u": (None, hm, None),
        "w_lora_a": (None, None, None), "w_lora_b": (None, None, None),
        "mix_r": rep1, "mix_k": rep1, "mix_v": rep1, "mix_w": rep1,
        "mix_g": rep1, "mix_ck": rep1, "mix_cr": rep1,
        "ck": (None, None, fm), "cv": (None, fm, None), "cr": (None, None, m),
        "ln1": rep1, "ln2": rep1,
    }


def _ssm_specs(cfg: ModelConfig, grid, ax: MeshAxes) -> dict:
    m = ax.model if _div(cfg.d_model, grid, ax.model) else None
    return {"w_in": (None, None, m), "w_bcdt": (None, m, None),
            "w_dt": (None, None, m), "a_log": (None, m, None),
            "d_skip": (None, m), "w_out": (None, m, None)}


def param_pspecs(cfg: ModelConfig, grid, ax: MeshAxes = MeshAxes()) -> dict:
    """Spec tree matching ``init_params``' structure; layer leaves keep
    their leading ``groups`` dim unsharded."""
    m = ax.model
    vocab_m = m if _div(cfg.vocab, grid, m) else None
    if cfg.family == "rwkv6":
        layer = _rwkv_specs(cfg, grid, ax)
    else:
        layer = {"ln_attn": (None, None), "ln_mlp": (None, None),
                 "attn": _attn_specs(cfg, grid, ax)}
        if cfg.family == "moe":
            layer["moe"] = _moe_specs(cfg, grid, ax)
        else:
            layer["mlp"] = _mlp_specs(cfg, grid, ax, cfg.d_ff)
        if cfg.family == "hybrid":
            layer["ssm"] = _ssm_specs(cfg, grid, ax)
    per = cfg.local_global_period if cfg.local_global_period > 1 else 1
    specs = {"embed": (vocab_m, None), "ln_f": (None,),
             "layers": [layer for _ in range(per)]}
    if not cfg.tie_embeddings:
        specs["unembed"] = (None, vocab_m)
    return specs


def _data_axes(grid, ax: MeshAxes):
    daxes = tuple(a for a in ax.data if a in grid.shape)
    dp = 1
    for a in daxes:
        dp *= grid.shape[a]
    return daxes, dp, (daxes if len(daxes) > 1
                       else (daxes[0] if daxes else None))


def batch_pspec(cfg: ModelConfig, grid, ax: MeshAxes, *, global_batch: int,
                embedded: bool = False) -> tuple:
    """DP over the data axes when the batch divides; the batch-1
    long-context cell shards the sequence instead."""
    _, dp, d = _data_axes(grid, ax)
    if global_batch % max(dp, 1) == 0 and global_batch >= dp:
        return (d, None, None) if embedded else (d, None)
    return (None, d, None) if embedded else (None, d)


def cache_pspecs(cfg: ModelConfig, grid, ax: MeshAxes, *, batch: int,
                 kv_lens: Optional[list] = None) -> dict:
    """Decode-cache specs, KV ``(groups, batch, n_kv, kv_len, hd)``: the
    batch on the data axes and ``kv_len`` on ``model`` when the batch
    divides; at batch 1 ``kv_len`` takes the axes greedily while its
    length divides. rwkv6's state shards its heads on ``model``."""
    from repro_torch.models import transformer as tf

    daxes, dp, d = _data_axes(grid, ax)
    batch_ok = batch % max(dp, 1) == 0 and batch >= dp
    m = ax.model
    if cfg.family == "rwkv6":
        hspec = m if _div(cfg.d_model // 64, grid, m) else None
        b = d if batch_ok else None
        return {"wkv": (None, b, hspec, None, None),
                "shift_t": (None, b, None), "shift_c": (None, b, None)}
    wins = tf.layer_windows(cfg)
    kv_lens = [0 for _ in wins] if kv_lens is None else kv_lens

    def kvspec(kv_len):
        seq_m = m if (kv_len == 0 or _div(kv_len, grid, m)) else None
        if batch_ok:
            return (None, d, None, seq_m, None)
        seq_axes, prod = [], 1
        for a in daxes + (m,):
            if kv_len == 0 or kv_len % (prod * grid.shape[a]) == 0:
                seq_axes.append(a)
                prod *= grid.shape[a]
        # one axis is its name, as a PartitionSpec entry reads
        seq = (tuple(seq_axes) if len(seq_axes) > 1
               else (seq_axes[0] if seq_axes else None))
        return (None, None, None, seq, None)

    cache = {"k": [kvspec(n) for n in kv_lens],
             "v": [kvspec(n) for n in kv_lens]}
    if cfg.family == "hybrid":
        dm = m if _div(cfg.d_model, grid, m) else None
        cache["ssm"] = [(None, d if batch_ok else None, dm, None)
                        for _ in wins]
    return cache


def spec_map(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a spec tree (dicts and lists, a tuple a
    leaf) and trees of its structure."""
    if isinstance(specs, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [spec_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(specs)]
    return fn(specs, *rest)


#: leaves under this many elements keep their spec (reference ``:376``)
FSDP_MIN_ELEMENTS = 1 << 16


def apply_fsdp(specs, shapes, grid, ax: MeshAxes = MeshAxes(), *,
               fsdp_axis: str = "data") -> Any:
    """ZeRO-3/FSDP: every leaf of at least :data:`FSDP_MIN_ELEMENTS`
    elements is sharded over ``fsdp_axis`` too, on its first
    still-unsharded dim that the axis divides. ``shapes``: a tree of the
    specs' structure whose leaves have a ``shape`` (tensors on the
    ``meta`` device will do)."""
    if fsdp_axis not in grid.shape:
        return specs
    n = grid.shape[fsdp_axis]

    def one(sp, leaf):
        shape = tuple(leaf.shape)
        numel = 1
        for dim in shape:
            numel *= dim
        if numel < FSDP_MIN_ELEMENTS:
            return sp
        entries = list(sp) + [None] * (len(shape) - len(sp))
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % n == 0 and dim >= n:
                entries[i] = fsdp_axis
                return tuple(entries)
        return sp

    return spec_map(one, specs, shapes)


def logical_rules(cfg: ModelConfig) -> dict:
    """Human-readable summary of the mapping."""
    return {
        "batch": "pod×data (seq on data when batch=1)",
        "attn heads": "model (kv replicated when n_kv < axis)",
        "mlp ff": "model",
        "experts": "model when divisible else TP-in-expert",
        "vocab": "model when divisible else replicated",
        "layers": "scan dim, never sharded",
    }
