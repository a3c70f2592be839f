"""The system under test, built from a cell's configuration, and the
wall-clock session a traffic driver serves through.

The system is the port's own serving path: an explicit-mode ``Engine``
(the decode plans compiled and replayed by the executor kernel) under a
``Scheduler`` whose ``tick(now)`` the session calls with the wall
clock's seconds since the window opened. The benchmark wraps the
scheduler's calls into its layers, and nothing else:

* host spans ``pb.<name>`` (``torch.profiler.record_function``) around
  admission, each fused prefill step, each step replay, sampling,
  release and the whole tick, in a traced run only;
* in a traced run only, a record of each step: CUDA events around
  ``run_step`` and ``run_prefill`` (read after the window), the rows it
  carried and their positions (for the FLOP and byte counts), and the
  executor launches a fused prefill step made. An untraced run calls
  straight through, so the host does nothing more on the timed path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from harness import counts


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ModelConfig(**kw)


@dataclasses.dataclass
class StepRecord:
    tick: int
    kind: str                 # "decode" or "prefill"
    rows: int                 # real rows (positions) the step carried
    ctx: dict                 # counts.context_sums of those positions
    launches: int             # executor launches made (graph: captured)
    events: Optional[tuple] = None


def scheduler_class():
    """The port's Scheduler with the benchmark's probes around its
    calls into the model step (built on first use: importing this module
    imports nothing of the program)."""
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.serve.scheduler import Scheduler

    class Probed(Scheduler):
        def __init__(self, *args, bench_config, traced=False, **kw):
            self.bench_config = bench_config
            self.traced = traced
            self.records: list = []
            self.tick_index = -1
            super().__init__(*args, **kw)

        def span(self, name):
            if not self.traced:
                return contextlib.nullcontext()
            return torch.profiler.record_function(f"pb.{name}")

        def _timed(self):
            if self.device.type != "cuda":
                return None
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            return e0, e1

        def run_step(self, b, inputs, *, graph=None):
            if not self.traced:
                return super().run_step(b, inputs, graph=graph)
            x = inputs.numpy()
            on = x[2] != 0
            ctx = counts.context_sums(self.bench_config, x[1][on],
                                      np.ones(int(on.sum()), np.int64))
            with self.span("replay"):
                ev = self._timed()
                logits = super().run_step(b, inputs, graph=graph)
                if ev:
                    ev[1].record()
            g = self.graphs.get(b)
            self.records.append(StepRecord(
                self.tick_index, "decode", int(on.sum()), ctx,
                g.launches if g is not None else 0, ev))
            return logits

        def run_prefill(self, b, S, inputs):
            if not self.traced:
                return super().run_prefill(b, S, inputs)
            x = inputs.numpy()
            ctx = counts.context_sums(self.bench_config, x[:, S], x[:, S + 1])
            before = CudaExecutor.launches
            with self.span("prefill"):
                ev = self._timed()
                super().run_prefill(b, S, inputs)
                if ev:
                    ev[1].record()
            self.records.append(StepRecord(
                self.tick_index, "prefill", int(x[:, S + 1].sum()), ctx,
                CudaExecutor.launches - before, ev))

        def _admit(self, now):
            with self.span("admit"):
                return super()._admit(now)

        def _sample(self, logits, rows):
            with self.span("sample"):
                return super()._sample(logits, rows)

        def _release(self, i):
            with self.span("release"):
                return super()._release(i)

        def tick(self, now=None):
            self.tick_index += 1
            with self.span("tick"):
                return super().tick(now)

    return Probed


def build(config: dict, params: dict, device, *, traced: bool):
    """The engine and its probed scheduler for ``config``, serving
    ``params`` (the engine takes its own layout of them; the caller may
    drop its copy once this returns)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    s = config["serving"]
    cfg = model_config(config)
    seq = s.get("prefill_seq_buckets")
    eng = Engine(cfg, params, ServeConfig(
        batch=s["slots"], max_kv=s["max_kv"], eos_id=s["eos_id"],
        mode=s["mode"], prefill_seq_buckets=tuple(seq) if seq else None),
        tp=s["tp"], device=device)
    if eng.mode != s["mode"]:
        raise RuntimeError(f"the engine serves {eng.mode!r}, the "
                           f"configuration asks for {s['mode']!r}")
    sched = scheduler_class()(
        eng, max_slots=s["slots"], prefill_chunk=s["prefill_chunk"],
        fused_prefill=bool(s.get("fused_prefill")), bench_config=config,
        traced=traced)
    return sched


def warm(sched) -> None:
    """Run every shape this configuration's traffic can reach, on rows
    that are all inactive (their cache passes through bit for bit): each
    slot bucket's step once more, each (bucket, sequence bucket) fused
    prefill step, and the sampler."""
    for b in sched._buckets:
        inputs = torch.zeros((3, b), dtype=torch.long)
        logits = sched.run_step(b, inputs)
        torch.argmax(logits, dim=-1).cpu()
        if sched.fused_prefill:
            for S in sched._seq_buckets:
                sched.run_prefill(b, S, torch.zeros((b, S + 2),
                                                    dtype=torch.long))
    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    sched.records.clear()


@dataclasses.dataclass
class Track:
    """One request as the client saw it, in seconds from the window's
    start."""
    rid: int
    prompt: np.ndarray
    max_new: int
    due: float
    submitted: float
    admitted: Optional[float] = None
    stamps: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class Session:
    """The wall-clock window a driver serves through: ``submit`` a
    request due at a time, ``tick`` the scheduler at the clock's reading,
    read each request's admission and token stamps. The driver may serve
    before it calls ``open``, to bring its loop to a steady state; that
    is set-up, and ``open`` starts the window's clock at 0 (what was
    stamped before it reads below 0). The window closes at the end of the
    first tick that ends ``seconds`` or more after it opened (``closed``).
    With ``profile`` (the traffic file's ``{"from": share of the window,
    "ticks": n}``) it profiles ``n`` ticks from that point of the window
    on, after one warm-up tick."""

    def __init__(self, sched, seconds: float, *, profile=None,
                 first_rid: int = 0):
        self.sched = sched
        self.seconds = float(seconds)
        self.tracks: dict = {}
        self._fifo: deque = deque()
        self._next_rid = first_rid
        self.profile_cfg = profile
        self.prof = None
        self.profiled = None          # (first tick, ticks) of the profile
        self.ticks = 0
        self.t0 = time.perf_counter()
        #: seconds the profiler's start and its flush held the loop: the
        #: session's clock stops for them, so the traced run's host
        #: timings and due times see the same serving as an untraced one
        self.paused = 0.0
        self.end = None
        self.opened = None            # perf_counter() when the window opened
        #: the scheduler's clock runs on from set-up: its reading is the
        #: window's plus the seconds served before the window opened
        self.base = 0.0

    @property
    def slots(self) -> int:
        return self.sched.max_slots

    def now(self) -> float:
        return time.perf_counter() - self.t0 - self.paused

    def open(self) -> None:
        """Open the window: its clock, tick count and step records start
        here; the times of what was served before shift below 0."""
        shift = self.now()
        self.t0 += shift
        self.base += shift
        self.opened = time.perf_counter()
        for tr in self.tracks.values():
            tr.due -= shift
            tr.submitted -= shift
            if tr.admitted is not None:
                tr.admitted -= shift
            tr.stamps = [s - shift for s in tr.stamps]
        self.ticks = 0
        self.sched.tick_index = -1
        self.sched.records.clear()

    def _hold(self, fn) -> None:
        t = time.perf_counter()
        fn()
        self.paused += time.perf_counter() - t

    @property
    def closed(self) -> bool:
        return self.end is not None

    def submit(self, req, due: float) -> int:
        from repro_torch.serve.scheduler import Request
        rid = self._next_rid
        self._next_rid += 1
        t = self.now()
        self.tracks[rid] = Track(rid, req.prompt, req.max_new, due, t)
        self.sched.submit(Request(rid=rid, prompt=req.prompt,
                                  max_new_tokens=req.max_new,
                                  arrival_s=due + self.base))
        self._fifo.append(rid)
        return rid

    def idle(self) -> bool:
        return self.sched.outstanding() == 0

    def wait_until(self, t: float) -> None:
        """Sleep until ``t`` or the window's close, whichever is first;
        a wait that reaches the close closes the window."""
        limit = min(t, self.seconds)
        with self.sched.span("driver"):
            while self.now() < limit:
                time.sleep(min(0.001, limit - self.now()))
        if self.now() >= self.seconds:
            self.end = self.now()

    def _profile_start(self) -> None:
        p = self.profile_cfg
        if (p is None or self.prof is not None or self.opened is None
                or self.now() < p["from"] * self.seconds):
            return
        from torch.profiler import ProfilerActivity, profile, schedule
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=p["ticks"],
                              repeat=1))
        self._hold(self.prof.start)
        # the tick about to run is the profiler's warm-up (CUPTI loses the
        # head of a session's first graph replay); the next ones are kept
        self.profiled = (self.ticks + 1, p["ticks"])

    def tick(self) -> list:
        """One scheduler tick at the clock's reading; returns the ids of
        the requests it finished."""
        self._profile_start()
        now = self.now()
        info = self.sched.tick(now + self.base)
        t = self.now()
        self.ticks += 1
        if self.prof is not None and self.ticks <= sum(self.profiled):
            self._hold(self.prof.step)
        for _ in range(info.admitted):
            self.tracks[self._fifo.popleft()].admitted = now
        finished = []
        for em in info.emissions:
            tr = self.tracks[em.rid]
            tr.stamps.append(t)
            tr.tokens.append(em.token)
            if em.done:
                tr.done = True
                finished.append(em.rid)
        if self.opened is not None and t >= self.seconds:
            self.end = t
        return finished

    def finish(self) -> None:
        """After the window: stop the profiler (a window that closed
        before its profiled ticks were done keeps those it profiled) and
        wait for the device."""
        if self.end is None:
            self.end = self.now()
        if self.prof is not None:
            first, n = self.profiled
            self.profiled = (first, max(0, min(n, self.ticks - first)))
            self.prof.stop()
        if self.sched.device.type == "cuda":
            torch.cuda.synchronize(self.sched.device)
