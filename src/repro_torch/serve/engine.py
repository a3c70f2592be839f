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

Runtime guardrails (the reference's fallback ladder): every step is
guarded. A transient failure (``faults.FaultInjected``; on the CPU any
``RuntimeError``, as in the reference) retries with bounded exponential
backoff; an optional watchdog (``plan_timeout_s``) bounds an explicit
step's wall clock on the host, running it (its capture included) in a
worker thread and waiting for the card; an optional numeric guard
(``guard_numerics``) rejects non-finite logits with one
``isfinite().all()`` read; and an unrecovered explicit failure — a
timeout, non-finite logits, retries exhausted, and on the CPU a plan
failure — degrades the engine to auto: its params and cache are
converted to the unsharded layout (``sharding.auto_decode_params``/
``auto_decode_cache``), the explicit graph dropped, the auto step built
(and captured on the card) and the failed step re-run from its pre-step
state. A rejected plan set, a failed plan compile and a configuration
the explicit step does not serve fall back when the engine is made.
Falling back from a broken kernel would hide it behind the plain model,
so :func:`unrecoverable` failures are never retried or fallen back
from: a kernel build that failed, a kernel launch its wrapper or the
runtime refused, a captured graph that is not the step, a CUDA error,
and a watched step the card still runs; on the card every failure but
an injected fault and a timeout.

The watchdog recovers a step that stalls on the host (in a capture, or
waiting on anything but the card). A step that hangs on the card cannot
be given up: the stream stays blocked behind it, and so would the
fallback's work. So at a timeout the engine asks the step's stream
whether it is done; if it is not, it raises :class:`StepHungError` (the
timeout counted, no fallback), and neither the engine nor the process's
CUDA context can be trusted after it.

With the guards off (the default) the step and its graph are what they
were: the guarded call is the plain step inside a try/except. Counters
(``health``: retries, fallbacks, faults_detected, timeouts) and
``requested_mode``/``degraded`` report through ``plan_report()``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import comm as comm_lib
from repro_torch.core import faults
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.step import (CaptureError, capture_serve_step,
                                          compile_decode_plans,
                                          make_serve_step)
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
from repro_torch.mesh import DeviceLike, RankAxis
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import position_limit
from repro_torch.serve import sampling

__all__ = ["ServeConfig", "Engine", "StepHungError", "unrecoverable"]


class StepHungError(RuntimeError):
    """A watched step ran past ``plan_timeout_s`` and the card is still
    running it: its stream is blocked, so no fallback can run behind it.
    Never retried or fallen back from."""


def unrecoverable(e: BaseException, device: DeviceLike = None) -> bool:
    """Whether no guardrail may retry ``e`` or fall back from it.

    Always: a kernel library that failed to build (:class:`~repro_torch.
    kernels.build.KernelBuildError`), a kernel its wrapper or the runtime
    would not launch (:class:`~repro_torch.kernels.build.
    KernelLaunchError`), a captured graph that is not the step
    (:class:`~repro_torch.distributed.step.CaptureError`), a watched step
    the card still runs (:class:`StepHungError`), and a CUDA error, which
    the context does not survive (``torch.AcceleratorError`` where the
    installed torch has it, else a ``RuntimeError`` whose message names
    one). On the card (``device`` a CUDA device) every other failure as
    well, but an injected fault (``faults.FaultInjected``) and the
    watchdog's ``TimeoutError``: there the hand-written kernels run the
    step, and any other failure (a plan that does not fit the step, an
    out-of-memory) is a defect that serving on the plain model would
    hide. On the CPU the reference's classes are handled as the reference
    handles them."""
    if isinstance(e, (KernelBuildError, KernelLaunchError, CaptureError,
                      StepHungError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    if isinstance(e, RuntimeError) and "CUDA error" in str(e):
        return True
    if device is not None and torch.device(device).type == "cuda":
        return not isinstance(e, (faults.FaultInjected, TimeoutError))
    return False


class _Abandoned(Exception):
    """Raised in a watchdog's worker that the engine gave up on."""


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
    kv_quant: bool = False         # int8 KV cache with per-token scales
    # fused-prefill sequence buckets (prompt-chunk lengths the scheduler
    # prefills in one micro-step); None: token-by-token prefill plans only
    prefill_seq_buckets: Optional[tuple] = None
    # -- robustness knobs (the reference's guardrails) ---------------------
    verify: str = "strict"         # plan verification: 'off'|'warn'|'strict'
    max_retries: int = 2           # bounded retry on transient step failure
    retry_backoff_s: float = 0.05  # base of the exponential backoff
    plan_timeout_s: Optional[float] = None   # per-step watchdog (None = off)
    guard_numerics: bool = False   # reject non-finite logits, redo on auto
    # record each decode plan's per-instruction timeline at its first call
    # outside a CUDA-graph capture (core/trace.py; plan_report()["trace"])
    trace: bool = False


class Engine:
    """``Engine(cfg, params, serve_cfg, tp=4)`` serves ``params`` (the
    reference layout, e.g. from ``transformer.init_params`` or
    ``interop.params_from_jax``) with ``tp`` tensor-parallel ranks
    stacked on ``device`` (default: the CUDA card — raises where there is
    none; pass ``device="cpu"`` for the plain path).

    On the card the first step captures the step in a CUDA graph
    (``self.graph``, a :class:`~repro_torch.distributed.step.
    CapturedStep`; :meth:`capture` does it ahead) and replays it from
    then on; an explicit engine builds and loads its kernel library when
    it is made, so the first step's watched time is warm-ups and capture.
    The plans' ``hits`` count the capture's warm-up steps and the capture
    itself, not the replays, as the reference's count traces its step
    under ``jax.jit``. A :class:`~repro_torch.serve.scheduler.Scheduler`
    built on the engine serves from the engine's cache; from then on the
    engine's own steps raise.

    Every step goes through the guardrail ladder (module docstring):
    ``mode`` is the mode running and ``requested_mode`` the one
    configured; they part exactly when the engine fell back to auto."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig, *,
                 tp: int = 1, device: DeviceLike = None,
                 mode: Optional[str] = None,
                 comm: Optional[comm_lib.Communicator] = None,
                 decode_plans: Optional[dict] = None):
        self.cfg = cfg
        self.scfg = serve_cfg
        self.axis = RankAxis("model", tp, device)
        self.device = self.axis.device
        mode = mode if mode is not None else serve_cfg.mode
        if mode not in ("auto", "explicit"):
            raise ValueError(f"unknown serve mode {mode!r}")
        #: the mode serving was configured for; ``mode`` is the mode
        #: running — they part exactly when this engine degraded
        self.requested_mode = mode
        #: runtime guardrail counters; plan_report() merges them with the
        #: communicator's compile-side health
        self.health = {"retries": 0, "fallbacks": 0, "faults_detected": 0,
                       "timeouts": 0}
        self.comm = comm if comm is not None else comm_lib.Communicator(
            self.axis.name, n=tp, device=self.device,
            verify=serve_cfg.verify, trace=serve_cfg.trace)
        self.decode_plans: dict = {}
        plan_err: Optional[Exception] = None
        if decode_plans is not None:
            try:
                _check_plan_set(cfg, decode_plans, tp=tp,
                                batch_local=serve_cfg.batch,
                                seq_buckets=serve_cfg.prefill_seq_buckets)
                self.decode_plans = dict(decode_plans)
            except Exception as e:    # mismatched or incomplete shipped set
                plan_err = e
                warnings.warn(f"loaded decode-plan set rejected ({e}); "
                              f"serving without plan artifacts",
                              stacklevel=2)
        elif tp > 1:
            try:
                self.decode_plans = compile_decode_plans(
                    cfg, self.comm, batch_local=serve_cfg.batch, tp=tp,
                    seq_buckets=serve_cfg.prefill_seq_buckets)
            except Exception as e:    # verification or compile failure
                if unrecoverable(e):
                    raise
                plan_err = e
                warnings.warn(f"decode-plan compilation failed ({e}); "
                              f"serving without plan artifacts",
                              stacklevel=2)
        self.mode = mode
        if mode == "explicit":
            if plan_err is not None:
                self._build_fallback(f"plan compilation failed: {plan_err}")
            else:
                try:
                    self.step_fn, layout = self._build_step("explicit")
                except (NotImplementedError, ValueError) as e:
                    # a configuration the explicit step does not serve;
                    # a kernel's failure is no ValueError and propagates
                    self._build_fallback(str(e))
        if self.mode == "auto":
            self.step_fn, layout = self._build_step("auto")
        self.params = layout.params(params)
        self.cache = layout.cache()
        self.pos = 0
        self.active = np.zeros(serve_cfg.batch, bool)
        self._pos = torch.zeros((), dtype=torch.long, device=self.device)
        #: the graph cannot bounds-check its position: the host does
        self._pos_limit = position_limit(cfg, serve_cfg.max_kv)
        self.graph = None
        self._step = self._eager
        #: a weak reference to the Scheduler serving from ``cache``
        self.scheduler = None
        # -- guardrail state ------------------------------------------------
        self._lock = threading.Lock()
        self._gen = 0                  # bumped at fallback: workers stop
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        #: futures of watchdog workers given up on (they may still run)
        self.abandoned: list = []
        self._worker_stream = None     # the stream a watched step ran on
        # exact re-run after a detected-bad step needs its pre-step state:
        # KV writes are idempotent, the recurrent SSM state is not, so the
        # detecting guards keep a copy of it (the reference turns off
        # donation instead); the default step keeps none
        self._ssm_saved = None
        if self.mode == "explicit" and self.device.type == "cuda":
            from repro_torch.kernels import build
            build.executor_library()   # nvcc now, not in a watched step

    def _build_fallback(self, why: str) -> None:
        warnings.warn(f"mode='explicit' unavailable ({why}); falling back "
                      f"to auto decode", stacklevel=3)
        self.health["fallbacks"] += 1
        self.mode = "auto"

    def _build_step(self, mode: str):
        kw = (dict(comm=self.comm, plans=self.decode_plans)
              if mode == "explicit" else {})
        return make_serve_step(
            self.cfg, self.axis, batch=self.scfg.batch,
            max_kv=self.scfg.max_kv, mode=mode,
            kv_quant=self.scfg.kv_quant, **kw)

    def capture(self, check=None) -> None:
        """On the card, capture the step in its CUDA graph (once; the
        warm-up steps run on the cache, which is zeroed after them, or
        put back as it was when the engine is past position 0, after a
        fallback). ``check`` is a watchdog worker's liveness test."""
        if self.graph is None and self.device.type == "cuda":
            graph = capture_serve_step(
                self.step_fn, self.params, self.cache,
                batch=self.scfg.batch, device=self.device,
                keep_cache=self.pos > 0, check=check)
            with self._lock:
                if check is not None:
                    check()
                self.graph = graph
                self._step = graph.run

    def _eager(self, tokens: torch.Tensor, pos: int,
               bound: Optional[tuple] = None) -> torch.Tensor:
        """The step dispatched op by op, at the same 0-d position tensor
        the graph reads (``bound``: the step, params, cache and position
        tensor a watchdog worker took under the lock)."""
        step_fn, params, cache, p = bound or (
            self.step_fn, self.params, self.cache, self._pos)
        p.fill_(pos)
        logits, _ = step_fn(params, cache, tokens, p)
        return logits

    def _call(self, tokens: torch.Tensor, pos: int, check=None):
        """One step: capture on the card if not yet, then replay (or the
        eager step). Under a watchdog (``check``) the replay is enqueued,
        or the eager step's inputs taken, under the engine's lock, so a
        worker given up on touches nothing of the engine after it."""
        self.capture(check)
        with torch.inference_mode():
            if check is None:
                return self._step(tokens, pos)
            with self._lock:
                check()
                if self._step != self._eager:
                    return self._step(tokens, pos)
                bound = (self.step_fn, self.params, self.cache, self._pos)
            return self._eager(tokens, pos, bound)

    def _watched(self, tokens: torch.Tensor, pos: int, gen: int):
        """The watchdog worker's run: the step, then a wait for the
        card. ``gen`` is the engine's generation when it was handed out;
        once a fallback moved it on, every check raises."""
        def check():
            if self._gen != gen:
                raise _Abandoned("the engine fell back; this step is void")

        check()
        if self.device.type == "cuda":
            self._worker_stream = torch.cuda.current_stream(self.device)
        logits = self._call(tokens, pos, check)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return logits

    def _card_busy(self) -> bool:
        """Whether the stream a watched step ran on still has work queued
        (the capture's warm-ups join it before the capture begins)."""
        stream = self._worker_stream
        return stream is not None and not stream.query()

    def _dispatch(self, tokens: torch.Tensor, pos: int):
        """One step, under the watchdog when configured. The unwatched
        path is a plain call. The watchdog arms in explicit mode only:
        ``plan_timeout_s`` bounds plan replay (and an explicit capture);
        auto has no plan to watch. On a timeout the worker's pool is
        abandoned (a fresh one serves the next watched step) and the
        engine's generation moves on, so the worker, when it wakes,
        touches neither the cache nor a capture nor a replay."""
        if self.scfg.plan_timeout_s is None or self.mode != "explicit":
            return self._call(tokens, pos)
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="engine-watchdog")
        fut = self._pool.submit(self._watched, tokens, pos, self._gen)
        try:
            return fut.result(timeout=self.scfg.plan_timeout_s)
        except concurrent.futures.TimeoutError:
            with self._lock:
                self._gen += 1
            self._pool.shutdown(wait=False)
            self._pool = None
            self.abandoned.append(fut)
            raise TimeoutError(
                f"decode step exceeded plan_timeout_s="
                f"{self.scfg.plan_timeout_s}") from None

    def _run_step(self, tokens: torch.Tensor):
        """The step with the guardrail ladder: bounded retry with
        exponential backoff for transient failures; a timeout, a plan
        failure, exhausted retries or non-finite logits (with
        ``guard_numerics``) fall back to auto and re-run the step there;
        :func:`unrecoverable` failures raise, counting nothing, and so
        does a timeout while the card still runs the step
        (:class:`StepHungError`, the timeout counted)."""
        if self.scheduler is not None and self.scheduler() is not None:
            raise RuntimeError(
                "a Scheduler serves from this engine's cache: step the "
                "scheduler, not the engine")
        # a global layer's cache ends at max_kv, a windowed one wraps,
        # rwkv6 has none
        if self.pos >= self._pos_limit:
            raise ValueError(
                f"position {self.pos} is past the model (max_seq="
                f"{self.cfg.max_seq}) or a global layer's cache (max_kv="
                f"{self.scfg.max_kv})")
        self._save_state()
        attempt = 0
        while True:
            try:
                logits = self._dispatch(tokens, self.pos)
            except Exception as e:
                if unrecoverable(e, self.device):
                    raise
                if isinstance(e, RuntimeError):   # FaultInjected among them
                    if attempt < self.scfg.max_retries:
                        attempt += 1
                        self.health["retries"] += 1
                        time.sleep(self.scfg.retry_backoff_s
                                   * (2 ** (attempt - 1)))
                        continue
                    return self._fallback_to_auto(
                        f"transient failure persisted through {attempt} "
                        f"retries: {e}", tokens)
                if isinstance(e, TimeoutError):
                    self.health["timeouts"] += 1
                    self.health["faults_detected"] += 1
                    if self._card_busy():
                        raise StepHungError(
                            f"{e}, and the card is still running the step: "
                            f"a hang on the card, which no fallback can "
                            f"get past") from e
                    return self._fallback_to_auto(str(e), tokens)
                if isinstance(e, (ValueError, NotImplementedError)):
                    # structural plan failure: verification, bucket
                    # overflow, shape/dtype guards
                    return self._fallback_to_auto(f"plan failure: {e}",
                                                  tokens)
                raise
            if self.scfg.guard_numerics and \
                    not bool(torch.isfinite(logits).all()):
                self.health["faults_detected"] += 1
                return self._fallback_to_auto(
                    "non-finite logits (corrupted step output)", tokens)
            return logits

    def _save_state(self) -> None:
        """With a detecting guard armed (watchdog or numeric guard), keep
        the hybrid family's SSM state as the step finds it."""
        if (self.mode != "explicit" or "ssm" not in self.cache
                or not (self.scfg.guard_numerics
                        or self.scfg.plan_timeout_s is not None)):
            return
        if self._ssm_saved is None:
            self._ssm_saved = [leaf.clone() for leaf in self.cache["ssm"]]
        else:
            for saved, leaf in zip(self._ssm_saved, self.cache["ssm"]):
                saved.copy_(leaf)

    def _fallback_to_auto(self, reason: str, tokens: torch.Tensor):
        """Graceful degradation: convert to the auto path and re-run the
        failed step from its pre-step state."""
        if self.mode == "auto":
            raise RuntimeError(f"decode step failed on the auto path — no "
                               f"further fallback: {reason}")
        warnings.warn(
            f"explicit decode step failed ({reason}); falling back to "
            f"auto (the unsharded step) for the remainder of serving",
            stacklevel=3)
        self.health["fallbacks"] += 1
        self._to_auto()
        return self._dispatch(tokens, self.pos)

    def _to_auto(self) -> None:
        """Leave explicit mode for good: void any watchdog worker, drop
        the explicit graph, convert params and cache to the unsharded
        layout (the explicit tree is freed once nothing holds it; the
        detecting guards' SSM copy is put back first), and build the auto
        step, captured on the card at the next step."""
        with self._lock:
            self._gen += 1
            self.graph = None
            self._step = self._eager
            if self._ssm_saved is not None:
                for leaf, saved in zip(self.cache["ssm"], self._ssm_saved):
                    leaf.copy_(saved)
                self._ssm_saved = None
            self.params = shd.auto_decode_params(self.params, self.cfg)
            self.cache = shd.auto_decode_cache(self.cache)
            self.step_fn, _ = self._build_step("auto")
            self._pos = torch.zeros((), dtype=torch.long,
                                    device=self.device)
            self.mode = "auto"

    def plan_report(self) -> dict:
        """Per-bucket cost cards + dispatch hit counts of the decode
        plans, and the predicted per-token communication time at full
        occupancy: per layer 2 AllReduces (dense: attention out-proj and
        MLP down-proj), 3 (hybrid: the SSM out-proj too) or 1 AllReduce
        and 2 all_to_alls (MoE: out-proj, dispatch and combine), the
        embedding gather-reduce and the logits gather. With
        ``ServeConfig.trace`` the ``trace`` key holds each plan's (its
        largest bucket's) latest timeline summary, None before that
        bucket ran."""
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
        traces = {name: (tr.summary() if (tr := top_plan(p).last_trace)
                         is not None else None)
                  for name, p in self.decode_plans.items()}
        return dict(mode=self.mode, requested_mode=self.requested_mode,
                    degraded=self.mode != self.requested_mode, plans=cards,
                    predicted_comm_us_per_token=round(per_tok, 2),
                    health=health, trace=traces,
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
