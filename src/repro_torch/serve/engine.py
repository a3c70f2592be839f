"""Batched inference engine: token-by-token prefill + greedy or
temperature decode over a KV cache (port of ``repro.serve.engine``, §5.2
deployment shape). A temperature draw follows the reference's key
stream (``serve.sampling``, a copy of ``jax.random``'s threefry and
Gumbel sampler), so one seed gives the reference's tokens.

The engine owns a :class:`~repro_torch.core.comm.Communicator` for its
TP axis and compiles the decode-step collective plans at ``__init__``
(:func:`~repro_torch.distributed.step.compile_decode_plans`), bucketed
over active-slot counts. With ``mode="explicit"`` every generated token
replays those plans — on the card through the hand-written DSL-executor
kernel, for MoE each layer's dispatch and combine all_to_all too — and
the compile counters stay flat across decode calls;
``mode="auto"`` runs the unsharded model and keeps the plans as the
cost/inspection artifact.

On the card the engine captures its one-token step once, at its first
step (or :meth:`Engine.capture`), in one CUDA graph
(:func:`~repro_torch.distributed.step.capture_serve_step`), and every
token replays it in both modes: the position lives on the card and the
executor kernel keeps its flag epoch there, so nothing of the step is
dispatched from Python. On the CPU the same step runs eagerly on the
same 0-d position tensor. An engine that a
:class:`~repro_torch.serve.scheduler.Scheduler` serves from lends it its
cache and never steps (or captures) itself.

The reference's fallback ladder (retry, watchdog, explicit -> auto) is
not ported in this slice: a failure on the explicit path raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import comm as comm_lib
from repro_torch.distributed.step import (capture_serve_step,
                                          compile_decode_plans,
                                          make_serve_step)
from repro_torch.mesh import DeviceLike, RankAxis
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_windows
from repro_torch.serve import sampling

__all__ = ["ServeConfig", "Engine"]


def _check_plan_set(cfg: ModelConfig, plans: dict, *, tp: int,
                    batch_local: int, seq_buckets=None) -> None:
    """Validate a loaded decode-plan set against this engine's config
    and axis; raises ValueError naming the mismatch. ``seq_buckets``:
    the fused-prefill sequence buckets the engine serves, each of which
    needs its ``batch_local * s`` row bucket in ``layer_allreduce``."""
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
    ladder = (ar.buckets if isinstance(ar, comm_lib.BucketedPlan)
              else (ar.shape[0],))
    for s in (seq_buckets or ()):
        need = batch_local * int(s)
        if need not in ladder:
            raise ValueError(
                f"layer_allreduce ladder {tuple(ladder)} is missing the "
                f"{need}-row bucket for prefill sequence bucket {s} "
                f"(batch_local={batch_local}): re-export the plan set with "
                f"compile_decode_plans(..., seq_buckets="
                f"{tuple(seq_buckets)})")
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
    kv_quant: bool = False         # int8 KV cache with per-token scales
    # fused-prefill sequence buckets (prompt-chunk lengths the scheduler
    # prefills in one micro-step); None: token-by-token prefill plans only
    prefill_seq_buckets: Optional[tuple] = None


class Engine:
    """``Engine(cfg, params, serve_cfg, tp=4)`` serves ``params`` (the
    reference layout, e.g. from ``transformer.init_params`` or
    ``interop.params_from_jax``) with ``tp`` tensor-parallel ranks
    stacked on ``device`` (default: the CUDA card — raises where there is
    none; pass ``device="cpu"`` for the plain path).

    On the card the first step captures the step in a CUDA graph
    (``self.graph``, a :class:`~repro_torch.distributed.step.
    CapturedStep`; :meth:`capture` does it ahead) and raises if the
    capture fails. The plans' ``hits`` then count the capture's warm-up
    steps and the capture itself, not the replays, as the reference's
    count traces its step under ``jax.jit``. A
    :class:`~repro_torch.serve.scheduler.Scheduler` built on the engine
    serves from the engine's cache; from then on the engine's own steps
    raise."""

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
        #: the mode serving was configured for; the port raises where the
        #: reference would fall back, so ``mode`` never leaves it
        self.requested_mode = self.mode
        #: the reference's runtime guardrail counters; no guardrail is
        #: ported, so they stay at 0 (the router sums them)
        self.health = {"retries": 0, "fallbacks": 0, "faults_detected": 0,
                       "timeouts": 0}
        self.comm = comm if comm is not None else comm_lib.Communicator(
            self.axis.name, n=tp, device=self.device,
            verify=serve_cfg.verify)
        if decode_plans is not None:
            _check_plan_set(cfg, decode_plans, tp=tp,
                            batch_local=serve_cfg.batch,
                            seq_buckets=serve_cfg.prefill_seq_buckets)
            self.decode_plans = dict(decode_plans)
        elif tp > 1:
            self.decode_plans = compile_decode_plans(
                cfg, self.comm, batch_local=serve_cfg.batch, tp=tp,
                seq_buckets=serve_cfg.prefill_seq_buckets)
        else:
            self.decode_plans = {}
        kw = (dict(comm=self.comm, plans=self.decode_plans)
              if self.mode == "explicit" else {})
        self.step_fn, layout = make_serve_step(
            cfg, self.axis, batch=serve_cfg.batch, max_kv=serve_cfg.max_kv,
            mode=self.mode, kv_quant=serve_cfg.kv_quant, **kw)
        self.params = layout.params(params)
        self.cache = layout.cache()
        self.pos = 0
        self.active = np.zeros(serve_cfg.batch, bool)
        self._pos = torch.zeros((), dtype=torch.long, device=self.device)
        self._global_layers = None in layer_windows(cfg)
        self.graph = None
        self._step = self._eager
        #: a weak reference to the Scheduler serving from ``cache``
        self.scheduler = None

    def capture(self) -> None:
        """On the card, capture the step in its CUDA graph (once; the
        warm-up steps run on the cache, which is zeroed after them)."""
        if self.graph is None and self.device.type == "cuda":
            self.graph = capture_serve_step(
                self.step_fn, self.params, self.cache,
                batch=self.scfg.batch, device=self.device)
            self._step = self.graph.run

    def _eager(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """The step dispatched op by op, at the same 0-d position tensor
        the graph reads."""
        self._pos.fill_(pos)
        logits, self.cache = self.step_fn(self.params, self.cache, tokens,
                                          self._pos)
        return logits

    def _run_step(self, tokens: torch.Tensor):
        if self.scheduler is not None and self.scheduler() is not None:
            raise RuntimeError(
                "a Scheduler serves from this engine's cache: step the "
                "scheduler, not the engine")
        self.capture()
        # the graph cannot bounds-check its position: the host does (a
        # global layer's cache ends at max_kv, a windowed one wraps)
        if self.pos >= self.cfg.max_seq or (
                self._global_layers and self.pos >= self.scfg.max_kv):
            raise ValueError(
                f"position {self.pos} is past the model (max_seq="
                f"{self.cfg.max_seq}) or a global layer's cache (max_kv="
                f"{self.scfg.max_kv})")
        with torch.inference_mode():
            return self._step(tokens, self.pos)

    def plan_report(self) -> dict:
        """Per-bucket cost cards + dispatch hit counts of the decode
        plans, and the predicted per-token communication time at full
        occupancy: per layer 2 AllReduces (dense: attention out-proj and
        MLP down-proj), 3 (hybrid: the SSM out-proj too) or 1 AllReduce
        and 2 all_to_alls (MoE: out-proj, dispatch and combine), the
        embedding gather-reduce and the logits gather."""
        def top_plan(p):
            return p.plans[p.buckets[-1]] if isinstance(
                p, comm_lib.BucketedPlan) else p

        cards = {name: (p.report() if isinstance(p, comm_lib.BucketedPlan)
                        else p.cost_card())
                 for name, p in self.decode_plans.items()}
        per_tok = 0.0
        ar = self.decode_plans.get("layer_allreduce")
        if ar is not None:
            ar_per_layer = {"moe": 1, "hybrid": 3}.get(self.cfg.family, 2)
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
        health = dict(self.health, **self.comm.health)
        return dict(mode=self.mode, requested_mode=self.requested_mode,
                    degraded=self.mode != self.requested_mode, plans=cards,
                    predicted_comm_us_per_token=round(per_tok, 2),
                    health=health, communicator=repr(self.comm))

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

    def _sample(self, logits, key: sampling.Key):
        if self.scfg.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        return sampling.categorical(key, logits / self.scfg.temperature)

    def decode(self, first_logits, num_tokens: int, seed: int = 0):
        """Greedy (or temperature) decode for ``num_tokens`` steps;
        returns (batch, num_tokens) generated ids. A temperature draw
        takes the reference's key stream: ``key(seed)``, then each step
        ``key, sub = split(key)`` and ``categorical(sub, logits / T)``
        (greedy draws no key)."""
        key = sampling.key(seed)
        out = []
        logits = first_logits
        for _ in range(num_tokens):
            sub = None
            if self.scfg.temperature > 0:
                key, sub = sampling.split(key)
            tok = self._sample(logits, sub)
            out.append(tok.cpu().numpy())
            self.active &= ~(out[-1] == self.scfg.eos_id)
            logits = self._run_step(tok)
            self.pos += 1
        return np.stack(out, axis=1)
