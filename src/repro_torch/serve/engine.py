"""Batched inference engine: token-by-token prefill + greedy decode over
a KV cache (port of ``repro.serve.engine``, §5.2 deployment shape).

The engine owns a :class:`~repro_torch.core.comm.Communicator` for its
TP axis and compiles the decode-step collective plans at ``__init__``
(:func:`~repro_torch.distributed.step.compile_decode_plans`), bucketed
over active-slot counts. With ``mode="explicit"`` every generated token
replays those plans — on the card through the hand-written DSL-executor
kernel, for MoE each layer's dispatch and combine all_to_all too — and
the compile counters stay flat across decode calls;
``mode="auto"`` runs the unsharded model and keeps the plans as the
cost/inspection artifact.

The reference's fallback ladder (retry, watchdog, explicit -> auto) is
not ported in this slice: a failure on the explicit path raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import comm as comm_lib
from repro_torch.distributed.step import compile_decode_plans, make_serve_step
from repro_torch.mesh import DeviceLike, RankAxis
from repro_torch.models.config import ModelConfig

__all__ = ["ServeConfig", "Engine"]


def _check_plan_set(cfg: ModelConfig, plans: dict, *, tp: int,
                    batch_local: int) -> None:
    """Validate a loaded decode-plan set against this engine's config
    and axis; raises ValueError naming the mismatch."""
    if tp <= 1:
        raise ValueError("decode plans need a TP axis of size > 1")
    ar = plans.get("layer_allreduce")
    if ar is None:
        raise ValueError(f"plan set has no 'layer_allreduce' "
                         f"(names: {sorted(plans)})")
    if isinstance(ar, comm_lib.BucketedPlan):
        n, cols, top, dtype = ar.n, ar.cols, ar.buckets[-1], ar.dtype
    else:
        n, cols, top, dtype = ar.n, ar.shape[1], ar.shape[0], ar.dtype
    if n != tp:
        raise ValueError(f"layer_allreduce compiled for axis size {n}; "
                         f"this engine has tp={tp}")
    if cols != cfg.d_model:
        raise ValueError(f"layer_allreduce compiled for d_model={cols}; "
                         f"this config has {cfg.d_model}")
    if dtype != cfg.dtype:
        raise ValueError(f"layer_allreduce compiled for dtype {dtype}; "
                         f"this config computes in {cfg.dtype}")
    if top < batch_local:
        raise ValueError(f"layer_allreduce top bucket {top} < local batch "
                         f"{batch_local}: re-export the set with the "
                         f"serving batch")
    if cfg.vocab % tp == 0 and "logits_allgather" not in plans:
        raise ValueError("plan set missing 'logits_allgather' for the "
                         "vocab-sharded logits path")
    if (cfg.family == "moe" and cfg.moe.num_experts % tp == 0
            and "moe_alltoall" not in plans):
        raise ValueError("plan set missing 'moe_alltoall' for the MoE "
                         "expert-parallel path")


@dataclasses.dataclass
class ServeConfig:
    batch: int = 8
    max_kv: int = 1024
    eos_id: int = 2
    temperature: float = 0.0       # 0 -> greedy
    mode: str = "auto"             # 'auto' | 'explicit' (plan replay)
    verify: str = "strict"         # plan verification: 'off'|'warn'|'strict'


class Engine:
    """``Engine(cfg, params, serve_cfg, tp=4)`` serves ``params`` (the
    reference layout, e.g. from ``transformer.init_params`` or
    ``interop.params_from_jax``) with ``tp`` tensor-parallel ranks
    stacked on ``device`` (default: the CUDA card — raises where there is
    none; pass ``device="cpu"`` for the plain path)."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig, *,
                 tp: int = 1, device: DeviceLike = None,
                 mode: Optional[str] = None,
                 comm: Optional[comm_lib.Communicator] = None,
                 decode_plans: Optional[dict] = None):
        self.cfg = cfg
        self.scfg = serve_cfg
        self.axis = RankAxis("model", tp, device)
        self.device = self.axis.device
        self.mode = mode if mode is not None else serve_cfg.mode
        if self.mode not in ("auto", "explicit"):
            raise ValueError(f"unknown serve mode {self.mode!r}")
        self.comm = comm if comm is not None else comm_lib.Communicator(
            self.axis.name, n=tp, device=self.device,
            verify=serve_cfg.verify)
        if decode_plans is not None:
            _check_plan_set(cfg, decode_plans, tp=tp,
                            batch_local=serve_cfg.batch)
            self.decode_plans = dict(decode_plans)
        elif tp > 1:
            self.decode_plans = compile_decode_plans(
                cfg, self.comm, batch_local=serve_cfg.batch, tp=tp)
        else:
            self.decode_plans = {}
        kw = (dict(comm=self.comm, plans=self.decode_plans)
              if self.mode == "explicit" else {})
        self.step_fn, layout = make_serve_step(
            cfg, self.axis, batch=serve_cfg.batch, max_kv=serve_cfg.max_kv,
            mode=self.mode, **kw)
        self.params = layout.params(params)
        self.cache = layout.cache()
        self.pos = 0
        self.active = np.zeros(serve_cfg.batch, bool)

    def _run_step(self, tokens: torch.Tensor):
        with torch.inference_mode():
            logits, self.cache = self.step_fn(self.params, self.cache,
                                              tokens, self.pos)
        return logits

    def plan_report(self) -> dict:
        """Per-bucket cost cards + dispatch hit counts of the decode
        plans, and the predicted per-token communication time at full
        occupancy: per layer 2 AllReduces (dense: attention out-proj and
        MLP down-proj) or 1 AllReduce and 2 all_to_alls (MoE: out-proj,
        dispatch and combine), the embedding gather-reduce and the
        logits gather."""
        def top_plan(p):
            return p.plans[p.buckets[-1]] if isinstance(
                p, comm_lib.BucketedPlan) else p

        cards = {name: (p.report() if isinstance(p, comm_lib.BucketedPlan)
                        else p.cost_card())
                 for name, p in self.decode_plans.items()}
        per_tok = 0.0
        ar = self.decode_plans.get("layer_allreduce")
        if ar is not None:
            ar_per_layer = 1 if self.cfg.family == "moe" else 2
            per_tok += ar_per_layer * self.cfg.n_layers * \
                top_plan(ar).estimate_us
            if "logits_allgather" in self.decode_plans:
                per_tok += top_plan(ar).estimate_us
        ag = self.decode_plans.get("logits_allgather")
        if ag is not None:
            per_tok += top_plan(ag).estimate_us
        a2a = self.decode_plans.get("moe_alltoall")
        if a2a is not None:
            per_tok += 2 * self.cfg.n_layers * top_plan(a2a).estimate_us
        return dict(mode=self.mode, plans=cards,
                    predicted_comm_us_per_token=round(per_tok, 2),
                    health=dict(self.comm.health),
                    communicator=repr(self.comm))

    # -- prefill: feed prompts token by token through the decode path ------
    def prefill(self, prompts: np.ndarray):
        """prompts: (batch, prompt_len) int. Returns the last logits."""
        b, plen = prompts.shape
        if b != self.scfg.batch:
            raise ValueError(f"prompts hold {b} rows; the engine serves "
                             f"batch={self.scfg.batch}")
        logits = None
        for t in range(plen):
            logits = self._run_step(torch.as_tensor(
                prompts[:, t], dtype=torch.long, device=self.device))
            self.pos += 1
        self.active[:] = True
        return logits

    def _sample(self, logits, gen: torch.Generator):
        if self.scfg.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def decode(self, first_logits, num_tokens: int, seed: int = 0):
        """Greedy (or temperature) decode for ``num_tokens`` steps;
        returns (batch, num_tokens) generated ids."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        logits = first_logits
        for _ in range(num_tokens):
            tok = self._sample(logits, gen)
            out.append(tok.cpu().numpy())
            self.active &= ~(out[-1] == self.scfg.eos_id)
            logits = self._run_step(tok)
            self.pos += 1
        return np.stack(out, axis=1)
