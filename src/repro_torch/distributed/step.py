"""Explicit tensor-parallel decode (paper §5.2: compiled plans on the
token hot path) — port of ``repro.distributed.step``'s serving half.

* :func:`compile_decode_plans` compiles, once, the per-layer hidden
  AllReduce (``layer_allreduce``, also the vocab-sharded embedding's
  gather-reduce), the vocab-sharded ``logits_allgather``, bucketed over
  active-slot counts, and for MoE the expert-parallel ``moe_alltoall``,
  bucketed over per-rank token capacities;
* :class:`TPDecodeComms` replays them inside ``decode_step(comms=)``;
* :func:`make_serve_step` builds the one-token step in ``auto`` mode
  (the unsharded model on one device) or ``explicit`` mode (rank-stacked
  shards, every collective a plan replay).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import comm as comm_lib
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.moe_parallel import ep_capacity, moe_layer_ep
from repro_torch.mesh import RankAxis
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

__all__ = ["slot_buckets", "compile_decode_plans", "TPDecodeComms",
           "make_serve_step", "StepLayout"]


def slot_buckets(batch_local: int) -> tuple[int, ...]:
    """Active-slot bucket ladder: powers of two up to (and always
    including) the full local batch."""
    out, k = [], 1
    while k < batch_local:
        out.append(k)
        k *= 2
    out.append(batch_local)
    return tuple(out)


def compile_decode_plans(cfg: ModelConfig, comm, *, batch_local: int,
                         tp: int, buckets=None) -> dict:
    """The decode-step collective plans, compiled once and replayed every
    generated token: ``layer_allreduce`` over ``(rows, d_model)`` in the
    model dtype; when the vocab divides the TP axis, ``logits_allgather``
    over ``(rows, vocab/tp)`` in float32; and for the MoE family with
    experts divisible by the axis, ``moe_alltoall`` — the dispatch and
    combine all_to_all over ``(tp * rows, d_model)``, bucketed over the
    rows per per-rank block ``e_local * ep_capacity(b)`` of each slot
    bucket ``b`` (lossless capacity, so nothing drops)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"decode plans for family {cfg.family!r} are not ported yet")
    buckets = tuple(buckets) if buckets else slot_buckets(batch_local)
    plans = {"layer_allreduce": comm.plan_for(
        "all_reduce", (batch_local, cfg.d_model), cfg.dtype,
        buckets=buckets)}
    if cfg.vocab % tp == 0:
        plans["logits_allgather"] = comm.plan_for(
            "all_gather", (batch_local, cfg.vocab // tp), "float32",
            buckets=buckets)
    if cfg.family == "moe" and cfg.moe.num_experts % tp == 0:
        e_local = cfg.moe.num_experts // tp
        caps = tuple(sorted({e_local * ep_capacity(b, cfg.moe.top_k)
                             for b in buckets}))
        plans["moe_alltoall"] = comm.plan_for(
            "all_to_all", (tp * caps[-1], cfg.d_model), cfg.dtype,
            buckets=caps)
    return plans


class TPDecodeComms:
    """The per-layer TP communication hook that the explicit step hands
    to ``transformer.decode_step``. Every method is pure plan replay on
    rank-stacked tensors: the plans were compiled before the first
    token. For the MoE family the same axis doubles as the
    expert-parallel axis: ``moe_plan`` is the capacity-bucketed
    dispatch/combine all_to_all and :meth:`moe` runs the sparse layer
    through it."""

    def __init__(self, cfg: ModelConfig, axis: RankAxis, *, hidden_plan,
                 logits_plan=None, moe_plan=None):
        self.cfg = cfg
        self.axis = axis
        self.tp = axis.n
        self.hidden_plan = hidden_plan      # bucketed all_reduce (b, d_model)
        self.logits_plan = logits_plan      # bucketed all_gather or None
        self.moe_plan = moe_plan            # bucketed EP all_to_all or None
        self.vocab_sharded = logits_plan is not None
        self._ranks = axis.index()

    def head_offset(self, nh_local: int) -> torch.Tensor:
        """(tp,) global index of every shard's first query head."""
        return self._ranks * nh_local

    def moe(self, lp, x):
        """Expert-parallel MoE layer on a rank-stacked (tp, b, s,
        d_model) hidden state: dispatch and combine replay the
        capacity-bucketed all_to_all plan, at lossless capacity, so no
        token drops on the decode path."""
        return moe_layer_ep(lp, x, self.cfg, plan=self.moe_plan)

    def hidden(self, x):
        """AllReduce a rank-stacked (tp, b, s, d_model) partial."""
        tp, b, s, d = x.shape
        return self.hidden_plan(x.reshape(tp, b * s, d)).reshape(tp, b, s, d)

    def embed(self, table, tokens):
        """Lookup on the (tp, vocab/tp, d) sharded table: out-of-shard
        tokens read zero rows, then the AllReduce plan completes the
        gather (zero rows are exact under the sum)."""
        if not self.vocab_sharded:
            return table[:, tokens]
        vloc = table.shape[1]
        idx = tokens[None, :] - (self._ranks * vloc)[:, None]   # (tp, b)
        ok = (idx >= 0) & (idx < vloc)
        rows = table[self._ranks[:, None], idx.clamp(0, vloc - 1)]
        x = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
        return self.hidden_plan(x)

    def logits(self, params, hidden):
        """(tp, b, 1, d_model) hidden -> (b, vocab) f32 logits, the
        vocab-sharded columns gathered through the AllGather plan. Every
        rank ends with the same logits; rank 0's are returned."""
        w = params["embed"].transpose(-1, -2) if self.cfg.tie_embeddings \
            else params["unembed"]
        local = torch.einsum("rbsd,rdv->rbsv", hidden, w).float()[:, :, 0]
        if not self.vocab_sharded:
            return local[0]
        tp, b, vloc = local.shape
        g = self.logits_plan(local)                     # (tp, tp*b, vloc)
        return g.reshape(tp, tp, b, vloc)[0].transpose(0, 1).reshape(
            b, tp * vloc)


class StepLayout(NamedTuple):
    """How a step's inputs are laid out: ``params(p)`` turns reference-
    layout params into the step's layout on its device, ``cache()``
    makes an empty decode cache for it."""

    params: Callable[[dict], dict]
    cache: Callable[[], dict]


def _on(params, device):
    if isinstance(params, dict):
        return {k: _on(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_on(v, device) for v in params]
    return params.to(device)


def make_serve_step(cfg: ModelConfig, axis: RankAxis, *, batch: int,
                    max_kv: int, mode: str = "auto", comm=None, plans=None):
    """One-token decode step ``step(params, cache, tokens, pos) ->
    (logits, cache)`` and its :class:`StepLayout`.

    * ``auto`` — the unsharded model on ``axis.device``;
    * ``explicit`` — rank-stacked shards over ``axis`` (``axis.n`` TP
      ranks on one device); every per-layer AllReduce and the logits
      AllGather (and, for MoE, each layer's dispatch and combine
      all_to_all) replay the plans of ``plans`` (compiled here on ``comm``
      — by default a new :class:`~repro_torch.core.comm.Communicator`
      with the device's backend — when omitted).
    """
    if mode == "auto":
        def step(params, cache, tokens, pos):
            return tf.decode_step(params, cfg, cache, tokens, pos)

        return step, StepLayout(
            params=lambda p: _on(p, axis.device),
            cache=lambda: tf.init_cache(cfg, batch, max_kv,
                                        device=axis.device))
    if mode != "explicit":
        raise ValueError(f"unknown serve mode {mode!r}")
    ok, why = shd.explicit_decode_supported(cfg, axis.n)
    if not ok:
        raise ValueError(f"mode='explicit' unsupported here: {why}")
    if comm is None:
        comm = comm_lib.Communicator(axis.name, n=axis.n, device=axis.device)
    if plans is None:
        plans = compile_decode_plans(cfg, comm, batch_local=batch, tp=axis.n)
    comms = TPDecodeComms(cfg, axis, hidden_plan=plans["layer_allreduce"],
                          logits_plan=plans.get("logits_allgather"),
                          moe_plan=plans.get("moe_alltoall"))

    def step(params, cache, tokens, pos):
        return tf.decode_step(params, cfg, cache, tokens, pos, comms=comms)

    return step, StepLayout(
        params=lambda p: shd.explicit_decode_params(p, cfg, axis),
        cache=lambda: tf.init_cache(cfg, batch, max_kv, device=axis.device,
                                    ranks=axis.n))
