"""Continuous-batching scheduler over one :class:`~repro_torch.serve.
engine.Engine` replica, and its asyncio front end — the port of
``repro.serve.scheduler``.

A fixed budget of decode *slots*, FIFO admission, chunked prefill
interleaved with decode so a long prompt never stalls the token stream,
per-request token streaming and slot recycling on EOS, driven either
synchronously (:meth:`Scheduler.tick`, a deterministic virtual-clock
step) or through :class:`AsyncServeEngine`'s async generators.

How it composes with the plan layer: every tick runs ONE batched decode
step (:func:`~repro_torch.distributed.step.make_sched_step`) at the
smallest slot *bucket* that covers the active slots (the
``slot_buckets`` ladder the engine's
:class:`~repro_torch.core.comm.BucketedPlan` families were compiled
over); in explicit mode every bucket's step replays the engine's one
plan set. A fused prefill micro-step
(:func:`~repro_torch.distributed.step.make_prefill_sched_step`) replays
the same families at the ``b·S`` row bucket of its chunk.

On the card the scheduler captures its decode step once per slot
bucket, at ``__init__``, in a CUDA graph (all graphs in one memory
pool), and every tick replays the bucket's graph; fused prefill
micro-steps run eagerly on the card, launching the executor kernel. The
scheduler serves from the engine's cache (its first ``max_slots``
rows; the engine itself no longer steps), and the graphs write it in
place through views of its first ``b`` rows, so admission, compaction
and prefix seeding are in-place copies into the same storage; a
replaced cache leaf raises. Only the
``(b,)`` sampled tokens cross to the host each tick: greedy rows take
the ``argmax`` on the card, temperature rows one draw over their rows
with per-request keys ``fold_in(key(seed), emitted)``
(:func:`~repro_torch.serve.sampling.categorical_rows`).

Determinism: every per-row op of the step is row-independent (einsums
contract within a row, softmax and rms_norm are per row, the replayed
collectives are elementwise across rows, the MoE all_to_all has
lossless capacity) and the sampling keys derive from (request seed,
tokens emitted), never from the slot or the clock. At one bucket a
row's stream is therefore bit-identical whatever its co-residents; a
different bucket may pick different library kernels for the same row
on the card, so there a stream matches the sequential run up to
rounding.

Tracing: ``Scheduler(..., trace=spans.Tracer())`` records the loop's
host spans (``serve.tick`` and the phases inside it), the model step's
device marks and its counters (:mod:`repro_torch.core.spans`); a graph
captured under a tracer holds one stamp node a mark. With ``trace=None``
(the default) nothing is recorded and no span is entered.

Virtual time: the scheduler never reads a wall clock. ``tick(now)``
takes the caller's clock (the load generator charges each tick ``step_s
* (1 + micro_steps)``), so traces replay exactly and the metrics are
reproducible.

The reference's explicit→auto fallback: an explicit step or fused
prefill step that fails degrades the scheduler (and its engine) to auto
— a warning, one more ``fallbacks`` in the engine's health, every slot
bucket's graph and step dropped, the engine's params and cache converted
to the unsharded layout (the scheduler's cache views follow, on purpose),
the auto graphs captured on the card — and re-runs the step there from
its pre-step state (the SSM state is written after a step's last
executor call; the KV writes are idempotent). ``plan_report()
['degraded']`` then names it, and the router lists the replica. A kernel
build or launch failure, a captured graph that is not the step and a
CUDA error (``serve.engine.unrecoverable``; on the card every failure
but an injected fault) raise instead.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import warnings
import weakref
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed import step as step_mod
from repro_torch.models import transformer as tf
from repro_torch.serve import sampling
from repro_torch.serve.engine import unrecoverable

__all__ = ["Request", "Emission", "TickInfo", "Scheduler",
           "AsyncServeEngine"]

#: the span entered without a tracer: nothing
_NO_SPAN = contextlib.nullcontext()

#: cache-leaf kinds the prefix cache snapshots (the attention tape; the
#: recurrent SSM state is excluded, see Scheduler._seed_prefix)
_PC_KINDS = ("k", "v", "k_scale", "v_scale")


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_s`` is in virtual seconds (the
    load generator's clock); ``seed`` drives temperature sampling —
    per request, so the sample stream is schedule-independent."""
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32, non-empty
    max_new_tokens: int
    arrival_s: float = 0.0
    temperature: float = 0.0           # 0 -> greedy
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Emission:
    """One streamed token: ``done`` marks the request's final token
    (EOS or the max_new_tokens budget)."""
    rid: int
    token: int
    done: bool
    t: float                           # virtual emission time


@dataclasses.dataclass(frozen=True)
class TickInfo:
    now: float
    admitted: int
    micro_steps: int                   # prefill-only steps this tick
    bucket: int                        # slot bucket of the combined step
    n_active: int                      # active slots after completions
    queued: int
    emissions: tuple                   # Emission, in slot order


class _Slot:
    __slots__ = ("req", "pos", "consumed", "last_token", "emitted",
                 "t_admit", "t_first", "pc_handle")

    def __init__(self, req: Request, t_admit: float):
        self.req = req
        self.pos = 0          # tokens written into this slot's cache row
        self.consumed = 0     # prompt tokens stepped so far
        self.last_token = 0
        self.emitted = 0
        self.t_admit = t_admit
        self.t_first: Optional[float] = None
        self.pc_handle = None   # prefix-cache lease held while resident


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A cache segment for the prefix cache: bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16:
        return t.view(torch.int16).view(torch.bfloat16)
    return t.to(dtype)


class Scheduler:
    """Continuous-batching loop over one engine replica; the reference's
    rules:

    * **Admission** — FIFO; a request enters a free slot once its
      ``arrival_s`` has passed, never more than ``max_slots`` resident.
      The queue is unbounded by default; ``queue_limit`` opts into
      backpressure: :meth:`submit` returns False and ``rejected`` counts.
    * **Fused prefill** (``fused_prefill=True``) — each prefill
      micro-step pushes a whole prompt chunk a slot through
      :func:`~repro_torch.distributed.step.make_prefill_sched_step` (up
      to the largest sequence bucket, ring-capped per row so windowed
      layers stay exact) instead of one token.
    * **Prefix reuse** (``prefix_cache=`` a :class:`~repro_torch.serve.
      prefix_cache.PrefixCache`) — admission seeds a fresh slot with the
      longest cached prompt prefix (attention caches only; recurrent
      state is not per-token sliceable), and the first sampled token
      inserts the completed prompt's row, so later requests sharing the
      prefix skip those prefill tokens.
    * **Chunked prefill** — each tick runs up to ``prefill_chunk - 1``
      prefill-only micro-steps (advancing only slots with more than one
      prompt token left) and then one *combined* step, in which
      prefilling slots consume their next prompt token and decode slots
      their last sampled token; a slot's final prompt token always runs
      in a combined step, so its logits row yields the first token.
    * **Completion** — EOS (``ServeConfig.eos_id``) or the request's
      ``max_new_tokens`` frees the slot; the last active slot moves into
      the freed row (one in-place cache-row copy), keeping the active
      slots a prefix and the bucket minimal.

    Positions are checked on the host: an active row past the model
    (``max_seq``) or a global layer's cache (``max_kv``) raises, and an
    inactive row presents a position inside them (the device path
    cannot raise). On the card each tick replays the slot bucket's
    captured graph; on the CPU the step runs eagerly.

    ``trace``: a :class:`~repro_torch.core.spans.Tracer` that records
    the loop's spans, the step's marks and its counters, or ``None``.
    """

    def __init__(self, engine, *, max_slots: Optional[int] = None,
                 prefill_chunk: int = 4, fused_prefill: bool = False,
                 queue_limit: Optional[int] = None, prefix_cache=None,
                 trace=None):
        self.eng = engine
        scfg = engine.scfg
        self.max_slots = int(max_slots or scfg.batch)
        if not 1 <= self.max_slots <= scfg.batch:
            raise ValueError(
                f"max_slots={self.max_slots} must be in [1, engine batch "
                f"{scfg.batch}] (the engine's plans were bucketed for that "
                f"batch)")
        _, sharded = step_mod.local_batch(engine.axis, scfg.batch)
        if sharded:
            raise ValueError("Scheduler needs an unsharded batch (slots "
                             "live on one replica)")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefill_chunk = int(prefill_chunk)
        self.eos_id = scfg.eos_id
        self.mode = engine.mode
        self.device = engine.device
        cfg = engine.cfg
        self._buckets = list(step_mod.slot_buckets(self.max_slots))
        self._steps: Dict[int, object] = {}
        # the engine's cache, its first max_slots rows: one cache a
        # replica; the engine (and an earlier scheduler on it) no longer
        # steps
        self.cache = step_mod.cache_rows(engine.cache, self.max_slots)
        engine.scheduler = weakref.ref(self)
        self._slots: List[_Slot] = []
        self._queue: deque = deque()
        self.streams: Dict[int, List[int]] = {}
        self._done: Dict[int, dict] = {}
        self._now = 0.0
        self._ticks = 0
        self._n_steps = 0
        self._micro_total = 0
        self._bucket_steps: Dict[int, int] = {b: 0 for b in self._buckets}
        if queue_limit is not None and queue_limit < 1:
            raise ValueError("queue_limit must be >= 1 or None")
        self.queue_limit = queue_limit
        self._rejected = 0
        kv_lens = [min(w, scfg.max_kv) if w is not None else scfg.max_kv
                   for w in tf.layer_windows(cfg)]
        self._min_kv = min(kv_lens)
        #: positions a row may present: RoPE covers max_seq, a global
        #: layer's cache max_kv (a windowed one wraps; rwkv6 has none)
        self._pos_limit = tf.position_limit(cfg, scfg.max_kv)
        self.fused_prefill = (bool(fused_prefill)
                              and cfg.family in tf.PREFILL_FAMILIES)
        ladder = (scfg.prefill_seq_buckets
                  or step_mod.slot_buckets(self.prefill_chunk))
        self._seq_buckets = tuple(sorted(
            {int(s) for s in ladder if 1 <= int(s) <= self._min_kv}))
        dropped = tuple(sorted({int(s) for s in ladder
                                if int(s) > self._min_kv}))
        if dropped and scfg.prefill_seq_buckets is not None:
            warnings.warn(
                f"prefill sequence buckets {dropped} exceed the smallest "
                f"layer kv_len {self._min_kv} and were dropped; fused "
                f"prefill chunks cap at "
                f"{max(self._seq_buckets) if self._seq_buckets else 0} "
                f"(usable ladder {self._seq_buckets})", stacklevel=2)
        if self.fused_prefill and not self._seq_buckets:
            raise ValueError(
                f"no usable prefill sequence bucket <= the smallest layer "
                f"kv_len {self._min_kv} (configured {tuple(ladder)})")
        #: explicit fused prefill replays the engine's plan set when the
        #: engine compiled the sequence buckets into it; otherwise each
        #: (bucket, seq) step compiles its own family on the engine's
        #: communicator
        self._shared_prefill_plans = scfg.prefill_seq_buckets is not None
        self._prefill_steps: Dict[tuple, object] = {}
        self._prefill_bucket_steps: Dict[tuple, int] = {}
        # recurrent state (SSM, rwkv6) is a running reduction, not a
        # per-token tape: only pure attention caches are prefix-sliceable
        self.prefix_cache = (prefix_cache if "k" in self.cache
                             and "ssm" not in self.cache else None)
        self._prefix = {"hits": 0, "misses": 0, "tokens_reused": 0,
                        "inserts": 0}
        self.graphs: Dict[int, step_mod.CapturedSchedStep] = {}
        self.trace = trace
        if trace is not None:
            trace.bind(self.device)
        if self.device.type == "cuda":
            self._capture_graphs()
            for leaves in self.cache.values():
                for leaf in leaves:
                    leaf.zero_()
        self._ptrs = self._leaf_ptrs()

    def _capture_graphs(self) -> None:
        """On the card, capture the decode step at every slot bucket, all
        graphs in one memory pool (the warm-ups run with every row
        inactive, so a live cache passes through them)."""
        pool = torch.cuda.graph_pool_handle()
        with (self.trace.capturing() if self.trace is not None
              else _NO_SPAN):
            for b in self._buckets:
                self.graphs[b] = step_mod.capture_sched_step(
                    self._step_fn(b), self.eng.params,
                    step_mod.cache_rows(self.cache, b), batch=b,
                    device=self.device, pool=pool)

    def _span(self, name: str):
        """The tracer's host span ``serve.<name>`` (no step's), or
        nothing without a tracer."""
        return _NO_SPAN if self.trace is None else self.trace.span(name)

    # -- clock (virtual; the caller owns it) -------------------------------
    @property
    def now(self) -> float:
        return self._now

    @property
    def n_active(self) -> int:
        return len(self._slots)

    def advance(self, dt: float) -> None:
        self._now += float(dt)

    def advance_to(self, t: float) -> None:
        self._now = max(self._now, float(t))

    def next_arrival(self) -> Optional[float]:
        return self._queue[0].arrival_s if self._queue else None

    def outstanding(self) -> int:
        return len(self._queue) + len(self._slots)

    # -- submission --------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request. Returns True when accepted; with
        ``queue_limit`` set, a full queue rejects (returns False and
        counts in ``metrics()['rejected']``)."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be >=1")
        if req.rid in self.streams or any(r.rid == req.rid
                                          for r in self._queue):
            raise ValueError(f"duplicate request id {req.rid}")
        if (self.queue_limit is not None
                and len(self._queue) >= self.queue_limit):
            self._rejected += 1
            return False
        self._queue.append(dataclasses.replace(req, prompt=prompt))
        return True

    # -- step machinery ----------------------------------------------------
    def _plan_kw(self, prefill: bool) -> dict:
        if self.mode != "explicit":
            return {}
        kw = dict(comm=self.eng.comm)
        if not prefill or self._shared_prefill_plans:
            kw["plans"] = self.eng.decode_plans or None
        return kw

    def _bucket(self, k: int) -> int:
        for b in self._buckets:
            if b >= k:
                return b
        return self._buckets[-1]

    def _step_fn(self, b: int):
        fn = self._steps.get(b)
        if fn is None:
            fn, _ = step_mod.make_sched_step(
                self.eng.cfg, self.eng.axis, batch=b,
                max_kv=self.eng.scfg.max_kv,
                kv_quant=self.eng.scfg.kv_quant, mode=self.mode,
                **self._plan_kw(prefill=False))
            self._steps[b] = fn
        return fn

    def _leaf_ptrs(self) -> tuple:
        return tuple((name, leaf.data_ptr()) for name, leaves
                     in sorted(self.cache.items()) for leaf in leaves)

    def _check_leaves(self) -> None:
        if self.eng.scheduler is None or self.eng.scheduler() is not self:
            raise RuntimeError(
                "another Scheduler serves from this engine's cache now")
        if self._leaf_ptrs() != self._ptrs:
            raise RuntimeError(
                "a cache leaf of the scheduler was replaced: its steps (and "
                "captured graphs) write the leaves made at __init__ in "
                "place; copy into them instead")

    def _position(self, pos: int, active: bool, n: int = 1) -> int:
        """The position row ``pos`` presents to a step writing ``n``
        tokens: checked when the row is active, kept inside the model
        when it is not."""
        if not active:
            return min(pos, self._pos_limit - 1)
        if pos + n > self._pos_limit:
            raise ValueError(
                f"a slot at position {pos} writing {n} token(s) passes the "
                f"model (max_seq={self.eng.cfg.max_seq}) or a global "
                f"layer's cache (max_kv={self.eng.scfg.max_kv})")
        return pos

    def step_inputs(self, pred) -> tuple:
        """(bucket, the ``(3, b)`` int64 inputs — tokens, positions,
        active — and the slots ``pred`` advances) of one masked step
        over the active-slot prefix."""
        k = len(self._slots)
        b = self._bucket(k)
        inputs = np.zeros((3, b), np.int64)
        stepped = []
        for i, s in enumerate(self._slots):
            on = bool(pred(s))
            inputs[0, i] = (s.req.prompt[s.consumed]
                            if s.consumed < len(s.req.prompt)
                            else s.last_token)
            inputs[1, i] = self._position(s.pos, on)
            inputs[2, i] = on
            if on:
                stepped.append(s)
        return b, torch.from_numpy(inputs), stepped

    def _fallback(self, e: Exception, what: str) -> None:
        """The reference's scheduler fallback, or ``e`` re-raised (auto
        has no further fallback; :func:`~repro_torch.serve.engine.
        unrecoverable` failures never fall back)."""
        if self.mode == "auto" or unrecoverable(e, self.device):
            raise e
        warnings.warn(f"explicit {what} failed ({e}); falling back to auto "
                      f"(the unsharded step) for the remainder of serving",
                      stacklevel=4)
        self.eng.health["fallbacks"] += 1
        self.mode = "auto"
        self.graphs = {}
        self._steps.clear()
        self._prefill_steps.clear()
        self.eng._to_auto()
        # the converted cache replaces the old one on purpose: the views,
        # and the pointers _check_leaves holds, follow it
        self.cache = step_mod.cache_rows(self.eng.cache, self.max_slots)
        self._ptrs = self._leaf_ptrs()
        if self.device.type == "cuda":
            self._capture_graphs()

    def run_step(self, b: int, inputs: torch.Tensor, *,
                 graph: Optional[bool] = None) -> torch.Tensor:
        """The step at bucket ``b`` on the ``(3, b)`` inputs, by replay of
        the bucket's graph or eagerly: (b, vocab) f32 logits on the
        device (a graph's static output, valid until its next replay).
        An explicit step that fails falls back (:meth:`_fallback`) and
        runs again on auto."""
        if self.trace is None:
            return self._guarded("scheduler step", self._run_step, b,
                                 inputs, graph)
        with self.trace.span("replay", b=b,
                             rows=int(inputs[2].count_nonzero())):
            return self._guarded("scheduler step", self._run_step, b,
                                 inputs, graph)

    def _guarded(self, what: str, run, *args):
        """``run(*args)`` on the scheduler's own cache leaves; an explicit
        step that fails falls back (:meth:`_fallback`) and runs again."""
        self._check_leaves()
        try:
            return run(*args)
        except Exception as e:
            self._fallback(e, what)
        return run(*args)

    def _run_step(self, b, inputs, graph):
        graph = bool(self.graphs) if graph is None else graph
        with torch.inference_mode():
            if graph:
                return self.graphs[b].run(inputs)
            x = inputs.to(self.device)
            logits, _ = self._step_fn(b)(
                self.eng.params, step_mod.cache_rows(self.cache, b), x[0],
                x[1], x[2] != 0)
            return logits

    def _step_once(self, pred) -> tuple:
        """One masked batched step over the active-slot prefix;
        ``pred(slot)`` selects the slots that advance, the rest (and the
        bucket's free rows) pass their cache rows through bit for bit.
        Returns (logits rows, bucket)."""
        with self._span("inputs"):
            b, inputs, stepped = self.step_inputs(pred)
        logits = self.run_step(b, inputs)
        for s in stepped:
            if s.consumed < len(s.req.prompt):
                s.consumed += 1
            s.pos += 1
        self._n_steps += 1
        self._bucket_steps[b] += 1
        return logits, b

    # -- fused prefill (sequence-bucketed chunk micro-steps) ----------------
    def _prefill_fn(self, b: int, s: int):
        fn = self._prefill_steps.get((b, s))
        if fn is None:
            fn, _ = step_mod.make_prefill_sched_step(
                self.eng.cfg, self.eng.axis, batch=b, seq=s,
                max_kv=self.eng.scfg.max_kv,
                kv_quant=self.eng.scfg.kv_quant, mode=self.mode,
                **self._plan_kw(prefill=True))
            self._prefill_steps[(b, s)] = fn
        return fn

    def _chunk_len(self, s: _Slot) -> int:
        """How many prompt tokens slot ``s`` may fuse into this
        micro-step: those it has left before its FINAL prompt token
        (which runs in the combined step), capped at the largest sequence
        bucket and at the ring headroom ``min_kv - pos``, so a windowed
        layer never overwrites a slot its own chunk's queries read (a
        1-token chunk is the always-exact fallback once the ring is
        full)."""
        remaining = len(s.req.prompt) - 1 - s.consumed
        if remaining <= 0:
            return 0
        n = min(remaining, self._seq_buckets[-1], self._min_kv - s.pos)
        return max(n, 1)

    def prefill_inputs(self) -> tuple:
        """(bucket, seq bucket, ``(b, S + 2)`` int64 inputs — the chunk's
        tokens, then each row's position and token count — and the
        chunk lengths) of one fused prefill micro-step."""
        k = len(self._slots)
        b = self._bucket(k)
        chunks = [self._chunk_len(s) for s in self._slots]
        S = next(sb for sb in self._seq_buckets if sb >= max(chunks))
        inputs = np.zeros((b, S + 2), np.int64)
        for i, (s, n) in enumerate(zip(self._slots, chunks)):
            inputs[i, S] = self._position(s.pos, n > 0, n)
            if n > 0:
                inputs[i, :n] = s.req.prompt[s.consumed:s.consumed + n]
                inputs[i, S + 1] = n
        return b, S, torch.from_numpy(inputs), chunks

    def run_prefill(self, b: int, S: int, inputs: torch.Tensor) -> None:
        """The fused prefill micro-step at ``(b, S)``, eagerly (on the
        card it launches the executor kernel at the ``b·S`` bucket). An
        explicit step that fails falls back (:meth:`_fallback`) and runs
        again on auto."""
        if self.trace is None:
            return self._guarded("fused-prefill step", self._run_prefill, b,
                                 S, inputs)
        with self.trace.span("prefill", b=b, S=S,
                             rows=int(inputs[:, S + 1].sum())):
            return self._guarded("fused-prefill step", self._run_prefill, b,
                                 S, inputs)

    def _run_prefill(self, b, S, inputs):
        x = inputs.to(self.device)
        with torch.inference_mode():
            self._prefill_fn(b, S)(
                self.eng.params, step_mod.cache_rows(self.cache, b),
                x[:, :S], x[:, S], x[:, S + 1])

    def _prefill_once(self) -> None:
        """One fused prefill micro-step: every prefilling slot advances
        by its chunk; the others, and the bucket's free rows, pass their
        cache through bit for bit (``n_tok = 0``). No logits."""
        with self._span("inputs"):
            b, S, inputs, chunks = self.prefill_inputs()
        self.run_prefill(b, S, inputs)
        for s, n in zip(self._slots, chunks):
            if n > 0:
                s.consumed += n
                s.pos += n
        self._n_steps += 1
        self._prefill_bucket_steps[(b, S)] = \
            self._prefill_bucket_steps.get((b, S), 0) + 1

    def _sample(self, logits: torch.Tensor, rows) -> np.ndarray:
        """The tokens of ``rows`` (slot index, slot), drawn on the card:
        greedy rows by ``argmax``, temperature rows by one draw under
        their keys ``fold_in(key(seed), emitted)`` — independent of slot,
        co-residents and tick, so sampled streams are schedule-invariant
        like greedy ones. Only the ``(b,)`` tokens come to the host."""
        with self._span("sample"):
            tok = torch.argmax(logits, dim=-1)
            hot = [(i, s) for i, s in rows if s.req.temperature > 0]
            if hot:
                idx = torch.tensor([i for i, _ in hot],
                                   device=logits.device)
                temps = torch.tensor([s.req.temperature for _, s in hot],
                                     dtype=torch.float32,
                                     device=logits.device)
                keys = [sampling.fold_in(sampling.key(s.req.seed),
                                         s.emitted) for _, s in hot]
                drawn = sampling.categorical_rows(
                    keys, logits.index_select(0, idx) / temps[:, None])
                tok = tok.index_copy(0, idx, drawn)
            return tok.cpu().numpy()

    # -- admission / release -----------------------------------------------
    def _rows(self, i: int, kinds=None):
        """(kind, layer slot, leaf, row ``i`` of the leaf) of every cache
        leaf, or of ``kinds``."""
        for name, leaves in self.cache.items():
            if kinds is None or name in kinds:
                for j, leaf in enumerate(leaves):
                    yield name, j, leaf, leaf.select(
                        step_mod.batch_axis(name, leaf), i)

    def _seed_prefix(self, slot: _Slot, i: int) -> None:
        """Seed a freshly admitted slot's cache row with the longest
        cached prompt prefix (every rank's row, under explicit mode). The
        lease stays pinned until the slot is released; reuse is capped
        at ``prompt_len - 1`` (the final prompt token runs through the
        combined step, so the first sampled token comes off live logits)
        and at the smallest layer kv_len."""
        prompt = slot.req.prompt
        plen = len(prompt)
        if self.prefix_cache is None or plen < 2:
            return
        cap = min(plen - 1, self._min_kv)
        L, segs, handle = self.prefix_cache.acquire(prompt[:cap])
        if L == 0:
            self._prefix["misses"] += 1
            return
        self._prefix["hits"] += 1
        self._prefix["tokens_reused"] += L
        slot.pc_handle = handle
        for name, j, leaf, row in self._rows(i, _PC_KINDS):
            seg = _from_numpy(segs[f"{name}{j}"], leaf.dtype)
            row[..., :L, :].copy_(seg.to(row.device))
        slot.pos = slot.consumed = L

    def _snapshot_prefix(self, slot: _Slot, i: int) -> None:
        """Index the just-completed prompt: at the first sampled token
        the slot's cache row holds exactly the prompt's KV entries
        (positions 0..plen-1; under explicit mode every rank holds the
        same, rank 0's is taken). Skipped when the ring wrapped or the
        trie already holds the whole prompt."""
        prompt = slot.req.prompt
        plen = len(prompt)
        if (self.prefix_cache is None or plen < 2 or plen > self._min_kv
                or self.prefix_cache.match(prompt) >= plen):
            return
        ranked = self.mode == "explicit"
        segs = {f"{name}{j}": _to_numpy((row[0] if ranked else row)
                                        [..., :plen, :])
                for name, j, _, row in self._rows(i, _PC_KINDS)}
        handle = self.prefix_cache.insert(prompt, segs)
        self._prefix["inserts"] += 1
        # swap the admission lease for the insert lease (deeper pin)
        self.prefix_cache.release(slot.pc_handle)
        slot.pc_handle = handle

    def _admit(self, now: float) -> int:
        admitted = 0
        with self._span("admit"):
            while (self._queue and len(self._slots) < self.max_slots
                   and self._queue[0].arrival_s <= now):
                req = self._queue.popleft()
                i = len(self._slots)
                # zero the recycled row: attention is masked by position,
                # but the SSM state must start from its init value
                for _, _, _, row in self._rows(i):
                    row.zero_()
                slot = _Slot(req, now)
                self._slots.append(slot)
                self.streams[req.rid] = []
                self._seed_prefix(slot, i)
                admitted += 1
        return admitted

    def _finish(self, s: _Slot, now: float) -> None:
        self._done[s.req.rid] = dict(
            rid=s.req.rid, arrival=s.req.arrival_s, admit=s.t_admit,
            first=s.t_first, finish=now, n_tokens=s.emitted,
            prompt_len=int(len(s.req.prompt)))

    def _release(self, i: int) -> None:
        with self._span("release"):
            if self.prefix_cache is not None:
                self.prefix_cache.release(self._slots[i].pc_handle)
                self._slots[i].pc_handle = None
            last = len(self._slots) - 1
            if i != last:
                # compact: copy the last active slot's rows into the freed
                # row in place (a permutation of rows, so every stream is
                # unaffected)
                for name, _, leaf, row in self._rows(i):
                    row.copy_(leaf.select(step_mod.batch_axis(name, leaf),
                                          last))
                self._slots[i] = self._slots[last]
            self._slots.pop()

    # -- the tick ----------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> TickInfo:
        """Advance the world by one scheduling round at virtual time
        ``now`` (default: the internal clock): admit, run the chunked
        prefill micro-steps, run the combined step, sample and stream,
        and recycle completed slots."""
        with self._span("tick"):
            return self._tick_once(now)

    def _tick_once(self, now: Optional[float]) -> TickInfo:
        now = self._now if now is None else float(now)
        if now < self._now:
            raise ValueError(f"virtual clock moved backwards "
                             f"({now} < {self._now})")
        self._now = now
        admitted = self._admit(now)
        emissions: List[Emission] = []
        micro = 0
        bucket = 0
        if self._slots:
            def prefilling(s):
                return s.consumed < len(s.req.prompt) - 1

            while micro < self.prefill_chunk - 1 and \
                    any(prefilling(s) for s in self._slots):
                if self.fused_prefill:
                    self._prefill_once()
                else:
                    self._step_once(prefilling)
                micro += 1
            logits, bucket = self._step_once(lambda s: True)
            rows = [(i, s) for i, s in enumerate(self._slots)
                    if s.consumed >= len(s.req.prompt)]
            toks = self._sample(logits, rows) if rows else None
            done_idx = []
            for i, s in rows:
                tok = int(toks[i])
                s.last_token = tok
                s.emitted += 1
                if s.t_first is None:
                    s.t_first = now
                    # first sampled token: the cache row holds exactly
                    # the prompt tape — index it for prefix reuse
                    self._snapshot_prefix(s, i)
                self.streams[s.req.rid].append(tok)
                fin = (tok == self.eos_id
                       or s.emitted >= s.req.max_new_tokens)
                emissions.append(Emission(s.req.rid, tok, fin, now))
                if fin:
                    self._finish(s, now)
                    done_idx.append(i)
            # release in descending index order so each compaction's
            # "last slot" is still correct
            for i in sorted(done_idx, reverse=True):
                self._release(i)
        self._ticks += 1
        self._micro_total += micro
        return TickInfo(now=now, admitted=admitted, micro_steps=micro,
                        bucket=bucket, n_active=len(self._slots),
                        queued=len(self._queue),
                        emissions=tuple(emissions))

    def run_until_drained(self, *, step_s: float = 1.0,
                          max_ticks: int = 100_000) -> List[TickInfo]:
        """Drive the internal virtual clock until every submitted request
        completed: each tick costs ``step_s * (1 + micro_steps)`` virtual
        seconds; idle gaps fast-forward to the next arrival."""
        infos = []
        while self.outstanding():
            if len(infos) >= max_ticks:
                raise RuntimeError(
                    f"scheduler did not drain in {max_ticks} ticks "
                    f"({self.outstanding()} requests outstanding)")
            nxt = self.next_arrival()
            if not self._slots and nxt is not None and nxt > self._now:
                self.advance_to(nxt)
            info = self.tick()
            infos.append(info)
            self.advance(step_s * (1 + info.micro_steps))
        return infos

    # -- reporting ---------------------------------------------------------
    def metrics(self) -> dict:
        """Per-request serving metrics in virtual seconds. ``dropped`` is
        0 by construction (the queue drops nothing; a full bounded queue
        rejects at submit); ``wait`` is the admission delay."""
        recs = list(self._done.values())
        ttft = sorted(r["first"] - r["arrival"] for r in recs)
        wait = sorted(r["admit"] - r["arrival"] for r in recs)
        toks = sum(r["n_tokens"] for r in recs)
        dur = max(self._now, 1e-9)
        px = self._prefix
        px_total = px["hits"] + px["misses"]
        return dict(
            completed=len(recs), dropped=0, outstanding=self.outstanding(),
            rejected=self._rejected,
            tokens=toks, ticks=self._ticks, steps=self._n_steps,
            micro_steps=self._micro_total,
            tokens_per_vs=round(toks / dur, 3),
            ttft_vs={"p50": _pct(ttft, 0.5), "p95": _pct(ttft, 0.95),
                     "max": ttft[-1] if ttft else 0.0},
            wait_vs={"p50": _pct(wait, 0.5), "p95": _pct(wait, 0.95),
                     "max": wait[-1] if wait else 0.0},
            bucket_steps=dict(self._bucket_steps),
            prefix_hits=px["hits"], prefix_misses=px["misses"],
            prefix_tokens_reused=px["tokens_reused"],
            prefix_inserts=px["inserts"],
            prefix_hit_rate=round(px["hits"] / px_total, 4)
            if px_total else 0.0)

    def plan_report(self) -> dict:
        """The engine's plan and health report plus the scheduler's view:
        ``degraded`` flags a mode that left the requested one (an
        explicit→auto fallback), and ``graphs`` the executor launches
        captured and the replays of each slot bucket's graph."""
        rep = self.eng.plan_report()
        rep["mode"] = self.mode
        rep["degraded"] = self.mode != self.eng.requested_mode
        rep["scheduler"] = dict(
            max_slots=self.max_slots, prefill_chunk=self.prefill_chunk,
            ticks=self._ticks, steps=self._n_steps,
            micro_steps=self._micro_total, active=len(self._slots),
            queued=len(self._queue), bucket_steps=dict(self._bucket_steps),
            fused_prefill=self.fused_prefill,
            seq_buckets=list(self._seq_buckets),
            prefill_bucket_steps={
                f"{b}x{s}": n
                for (b, s), n in sorted(self._prefill_bucket_steps.items())},
            graphs={b: dict(launches=g.launches, replays=g.replays)
                    for b, g in self.graphs.items()},
            rejected=self._rejected,
            prefix=dict(self._prefix,
                        **(self.prefix_cache.stats()
                           if self.prefix_cache is not None else {})))
        return rep


class AsyncServeEngine:
    """Asyncio front end: ``generate(request)`` is an async generator
    yielding the request's tokens as the shared pump loop produces them.
    One pump drives the scheduler (or a :class:`~repro_torch.serve.
    router.Router`, the same surface) for every in-flight request,
    yielding to the event loop between ticks; it advances the same
    virtual clock the sync path uses, so async streams equal
    ``tick``-driven ones."""

    def __init__(self, sched, *, step_s: float = 1.0):
        self._sched = sched
        self._step_s = float(step_s)
        self._queues: Dict[int, asyncio.Queue] = {}
        self._pump_task: Optional[asyncio.Task] = None

    async def generate(self, request: Request):
        q: asyncio.Queue = asyncio.Queue()
        self._queues[request.rid] = q
        self._sched.submit(request)
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())
        try:
            while True:
                em = await q.get()
                yield em.token
                if em.done:
                    return
        finally:
            self._queues.pop(request.rid, None)

    async def _pump(self):
        sched = self._sched
        while sched.outstanding():
            nxt = sched.next_arrival()
            if sched.n_active == 0 and nxt is not None and nxt > sched.now:
                sched.advance_to(nxt)
            info = sched.tick()
            for em in info.emissions:
                q = self._queues.get(em.rid)
                if q is not None:
                    q.put_nowait(em)
            sched.advance(self._step_s * (1 + info.micro_steps))
            await asyncio.sleep(0)
