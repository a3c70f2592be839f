"""Spans, counters and device marks of the serving loop and the model
step: the tracer a :class:`~repro_torch.serve.scheduler.Scheduler`
takes (``Scheduler(..., trace=spans.Tracer())``). Off by default, and
free when off: without a tracer the scheduler enters no span, and
:func:`mark` and :func:`count` return at once, so a graph captured
without one holds exactly the nodes it held before marks existed.

What a tracer records, kept in memory until :meth:`Tracer.export`:

* **Host spans** ``serve.<name>`` (:data:`SPANS`), each a pair of
  ``time.perf_counter_ns()`` stamps and, while a ``torch.profiler``
  profile runs, a ``record_function("serve.<name>")`` range inside
  them, on the profile's clock beside the device's records. Every span
  names its parent, the tick it ran in (``None`` outside a tick). The
  step spans (:data:`STEPS`: a decode step, a fused prefill micro-step)
  also carry their slot bucket ``b`` (and ``S``), the ``rows`` they
  carried (active rows; a micro-step's prompt tokens, ``sum(chunks)``)
  and their counters.
* **Device marks** (:data:`MARKS`), placed in the model code that the
  captured decode step and the eager fused prefill step both run. On
  the card a mark launches a one-thread stamp kernel
  (``csrc/spans.cu``) that writes ``(mark code, %globaltimer)`` into a
  device ring at an index taken with an atomic bump of a device cursor:
  a graph captured under a tracer holds one stamp node a mark, and the
  host reads the ring once, at export. On the CPU, where a step runs
  eagerly and synchronously, a mark is a host ``perf_counter_ns``
  stamp. Each step starts with ``step.begin``: the n-th one recorded is
  the n-th step span. The other marks come in (begin, end) pairs of one
  name within a step, once a layer or more (``moe.route`` brackets the
  routing before the dispatch all_to_all and the combine after the
  inverse one).
* **Counters** (:data:`COUNTERS`), added to the step that runs them,
  only while Python runs the step (a fused prefill step on the card,
  every step on the CPU; never in a capture).

Clocks: :meth:`Tracer.export` puts every time on the profiler's clock.
Given the profile, the host offset is fitted from the profile's
``serve.tick`` ranges against the tracer's own ticks, and the device
offset from the stamp kernels' records in the profile against the
ring's ``%globaltimer`` readings (the mode of their differences);
without one, the host offset is ``CLOCK_REALTIME`` minus
``CLOCK_MONOTONIC`` (the profiler's clock is Unix time) and the device
offset the probe taken when the tracer bound to its card (one stamp the
host waited for). The export records which, and how far every profiled
record lies from its converted copy.

Plan-level instruction traces of the executor kernel are
:mod:`repro_torch.core.trace`'s, not this module's.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["SPANS", "STEPS", "MARKS", "COUNTERS", "Tracer", "mark",
           "count", "summary", "graph_nodes"]

#: host spans, ``serve.<name>``: the tick; admission (row zeroing and
#: prefix seeding included); the host build of a step's inputs; a decode
#: step (the graph launch on the card); a fused prefill micro-step from
#: entry to return (its host enqueue on the card); sampling (the argmax
#: and the ``(b,)`` copy that waits for the device); a release
#: (compaction)
SPANS = ("tick", "admit", "inputs", "replay", "prefill", "sample",
         "release")
#: the spans that are steps of the model
STEPS = ("replay", "prefill")
#: device marks: a step's start; the KV gather up to the QK product; the
#: MoE router, top-k, sort and dispatch scatter, and the combine's
#: gather and weighted sum; the three expert matmuls and the activation
MARKS = ("step.begin", "attn.kv_read", "moe.route", "moe.experts")
#: a step's counters: the expert rows its MoE layers computed
#: (``e_total * ep * capacity`` a layer) and the expert choices a token
#: makes over them (``top_k`` a layer)
COUNTERS = ("moe.expert_rows", "moe.choices")

#: the mark a step starts with
STEP_BEGIN = MARKS[0]
#: the stamp kernel's name in a profile
STAMP_KERNEL = "span_stamp_kernel"

# (tracer, capture only) while a step or a capture of the scheduler runs
_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_spans_scope", default=None)


def mark(name: str) -> None:
    """A device mark ``name`` in the step that runs; nothing when no
    tracer's step or capture is running."""
    scope = _SCOPE.get()
    if scope is None:
        return
    tracer, capture_only = scope
    if capture_only and not torch.cuda.is_current_stream_capturing():
        return
    tracer._stamp(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the step that runs, where
    Python runs it; nothing otherwise."""
    scope = _SCOPE.get()
    if scope is None or scope[1]:
        return
    scope[0]._count(name, n)


class Tracer:
    """In-memory spans, counters and device marks of one scheduler
    (module docstring). ``capacity``: mark records the ring holds (16
    bytes each on the card; about 97 a decode step of a 12-layer MoE
    model); records past it are lost, counted, and make the marks
    unreadable (:func:`summary` raises)."""

    def __init__(self, capacity: int = 1 << 18):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.device: Optional[torch.device] = None
        self._codes: Dict[str, int] = {}
        self._names: List[str] = []
        self._ring = self._cursor = self._lib = None
        #: (perf_counter_ns minus %globaltimer, half its uncertainty)
        self.probe: Optional[tuple] = None
        #: the card's timers (``executor.device_timer``): the marks'
        #: resolution is its ``tick_ns``
        self.timer: Optional[dict] = None
        self.reset()

    # -- state --------------------------------------------------------------
    def reset(self) -> None:
        """Forget every span, counter and mark (the ring's cursor is
        zeroed in stream order, after the steps already enqueued)."""
        self.spans: List[dict] = []
        self._next_id = 0
        self._tick: Optional[int] = None
        self._step: Optional[dict] = None
        self._host_marks: List[tuple] = []
        self._host_lost = 0
        if self._cursor is not None:
            self._cursor.zero_()

    def bind(self, device) -> None:
        """Bind to the device the scheduler serves on: on a card, load
        the stamp kernel, allocate the ring and probe the clock (before
        any capture: a capture may not allocate)."""
        device = torch.device(device)
        if self.device is not None:
            if device != self.device:
                raise ValueError(f"the tracer is bound to {self.device}, "
                                 f"not {device}")
            return
        self.device = device
        if device.type != "cuda":
            return
        from repro_torch.core.executor import device_timer
        from repro_torch.kernels import build
        self._lib = build.spans_library()
        self.timer = device_timer(device)
        self._ring = torch.zeros((self.capacity, 2), dtype=torch.int64,
                                 device=device)
        self._cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.probe = self._probe_clock()

    # -- recording ------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """The host span ``serve.<name>``; a step span (:data:`STEPS`)
        also lets the marks and counters of the step it wraps record."""
        if name not in SPANS:
            raise ValueError(f"unknown span {name!r} (spans: {SPANS})")
        rec = {"id": self._next_id, "name": name, "parent": self._tick,
               **attrs}
        self._next_id += 1
        step = name in STEPS
        if step:
            rec["counts"] = {}
            self._step = rec
        token = _SCOPE.set((self, False)) if step else None
        if name == "tick":
            self._tick = rec["id"]
        rf = (torch.profiler.record_function(f"serve.{name}")
              if torch.autograd.profiler._is_profiler_enabled else None)
        if rf is not None:
            rf.__enter__()
        # next to the profile's own stamps: its start is taken late in
        # the enter, its end early in the exit (about 10 us before the
        # exit returns on an H100's host)
        rec["start"] = time.perf_counter_ns()
        try:
            yield rec
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            rec["end"] = time.perf_counter_ns()
            if token is not None:
                _SCOPE.reset(token)
                self._step = None
            if name == "tick":
                self._tick = None
            self.spans.append(rec)

    @contextlib.contextmanager
    def capturing(self):
        """Inside: the marks of a step being captured in a CUDA graph go
        into the graph, and the warm-up steps run before the capture
        record nothing."""
        token = _SCOPE.set((self, True))
        try:
            yield
        finally:
            _SCOPE.reset(token)

    def _code(self, name: str) -> int:
        code = self._codes.get(name)
        if code is None:
            if name not in MARKS:
                raise ValueError(f"unknown mark {name!r} (marks: {MARKS})")
            code = self._codes[name] = len(self._names)
            self._names.append(name)
        return code

    def _stamp(self, name: str) -> None:
        code = self._code(name)
        if self._ring is None:
            if len(self._host_marks) < self.capacity:
                self._host_marks.append((code, time.perf_counter_ns()))
            else:
                self._host_lost += 1
            return
        self._launch(self._ring, self._cursor, self.capacity, code)

    def _launch(self, ring, cursor, capacity, code) -> None:
        from repro_torch.kernels import build
        rc = self._lib.span_stamp_launch(
            ring.data_ptr(), cursor.data_ptr(), capacity, code,
            torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise build.KernelLaunchError(
                f"span_stamp_launch: "
                f"{self._lib.spans_error_string(rc).decode()}")

    def _count(self, name: str, n: int) -> None:
        if name not in COUNTERS:
            raise ValueError(f"unknown counter {name!r} (counters: "
                             f"{COUNTERS})")
        if self._step is not None:
            c = self._step["counts"]
            c[name] = c.get(name, 0) + int(n)

    def _probe_clock(self, tries: int = 5) -> tuple:
        """perf_counter_ns minus %globaltimer by one stamp into a scratch
        ring that the host waits for, the tightest of ``tries``: (offset,
        half the interval the stamp fell in)."""
        ring = torch.zeros((1, 2), dtype=torch.int64, device=self.device)
        cursor = torch.zeros(1, dtype=torch.int64, device=self.device)
        best = None
        for _ in range(tries):
            cursor.zero_()
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter_ns()
            self._launch(ring, cursor, 1, 0)
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter_ns()
            g = int(ring[0, 1])
            if best is None or t1 - t0 < 2 * best[1]:
                best = ((t0 + t1) // 2 - g, (t1 - t0) // 2)
        return best

    # -- export ---------------------------------------------------------------
    def _records(self) -> tuple:
        """(the mark records as an (n, 2) int64 array of (code, stamp) in
        the order they were taken, records lost)."""
        if self._ring is None:
            return (np.array(self._host_marks, np.int64).reshape(-1, 2),
                    self._host_lost)
        torch.cuda.synchronize(self.device)
        taken = int(self._cursor.item())
        kept = min(taken, self.capacity)
        return self._ring[:kept].cpu().numpy(), taken - kept

    def export(self, prof=None) -> dict:
        """Every span, mark and counter, times in ns on the profiler's
        clock (``prof``: the profile of part of the run, which fits the
        clocks; module docstring). Marks are paired into ``(name, step,
        start_ns, end_ns)`` regions, ``None`` when records were lost.
        Raises where the device's steps are not the host's."""
        from repro_torch.core.trace import run_meta
        recs, lost = self._records()
        events = _profile_events(prof) if prof is not None else []
        host, clock = _host_offset(self.spans, events)
        if self._ring is None:
            clock.update(device="perf_counter_ns", device_fit="host")

            def convert(t):
                return np.asarray(t, np.int64) + host
        else:
            clock.update(probe_half_width_ns=int(self.probe[1]),
                         device_tick_ns=int(self.timer["tick_ns"]))
            convert = _device_map(
                recs[:, 1], np.array([s for _, s, _, c in events if c],
                                     np.int64), self.probe[0] + host, clock)
        spans = sorted(({**s, "start": s["start"] + host,
                         "end": s["end"] + host} for s in self.spans),
                       key=lambda s: s["id"])
        steps = [s["id"] for s in spans if s["name"] in STEPS]
        marks = None
        if not lost:
            marks = _pair(recs, self._names, steps, convert)
        return {"meta": run_meta(), "clock": clock, "spans": spans,
                "marks": marks,
                "ring": {"capacity": self.capacity, "records": len(recs),
                         "lost": lost}}

    def save(self, path, prof=None) -> dict:
        """:meth:`export` written to ``path`` as JSON; returns it."""
        out = self.export(prof)
        with open(path, "w") as f:
            json.dump(out, f)
        return out


def _profile_events(prof) -> List[tuple]:
    """[(name, start_ns, end_ns, on the device)] of a profile: its
    ``serve.*`` host ranges and the stamp kernels' device records."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        cuda = str(e.device_type()).endswith("CUDA")
        if not (cuda and STAMP_KERNEL in name
                or not cuda and name.startswith("serve.")):
            continue
        if hasattr(e, "start_ns"):
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        else:
            start = int(e.start_us() * 1000)
            end = start + int(e.duration_us() * 1000)
        out.append((name, int(start), int(end), cuda))
    return out


def _nearest(sorted_vals: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Index of the value of ``sorted_vals`` nearest each ``x``."""
    if len(sorted_vals) < 2:
        return np.zeros(len(x), np.int64)
    i = np.clip(np.searchsorted(sorted_vals, x), 1, len(sorted_vals) - 1)
    left = sorted_vals[i - 1]
    return np.where(np.abs(x - left) <= np.abs(sorted_vals[i] - x), i - 1, i)


def _host_offset(spans: List[dict], events: List[tuple]) -> tuple:
    """(profiler clock minus perf_counter_ns, the clock's record): first
    the median difference of the profile's ``serve.tick`` ranges to the
    tracer's own ticks (the run of consecutive ticks that agrees best),
    then the median difference of both ends of every profiled
    ``serve.*`` range to its copy (the nearest of its name), and how far
    each range lies from its copy on that offset."""
    realtime = time.time_ns() - time.perf_counter_ns()
    clock = {"host": "perf_counter_ns",
             "realtime_minus_host_ns": int(realtime)}

    def both(name):
        mine = sorted((s["start"], s["end"]) for s in spans
                      if s["name"] == name)
        theirs = sorted((s, e) for n, s, e, c in events
                        if not c and n == f"serve.{name}")
        return (np.array(mine, np.int64).reshape(-1, 2),
                np.array(theirs, np.int64).reshape(-1, 2))

    mine, theirs = both("tick")
    if not len(theirs) or not len(mine):
        clock.update(host_fit="realtime", profiler_minus_host_ns=realtime)
        return realtime, clock
    m = len(theirs)
    if m > len(mine):
        raise RuntimeError(f"the profile holds {m} ticks, the tracer "
                           f"{len(mine)}: not this tracer's profile")
    if m == 1:
        k = int(_nearest(mine[:, 0], theirs[:1, 0] - realtime)[0])
    else:
        k = int(np.argmin([np.ptp(theirs[:, 0] - mine[k:k + m, 0])
                           for k in range(len(mine) - m + 1)]))
    off = int(np.median(theirs[:, 0] - mine[k:k + m, 0]))
    # then the median over both ends of every profiled range, each paired
    # with the nearest copy of its name
    diffs = []
    for name in SPANS:
        mine, theirs = both(name)
        if len(mine) and len(theirs):
            diffs.append(theirs - mine[_nearest(mine[:, 0] + off,
                                                theirs[:, 0])])
    diffs = np.concatenate(diffs)
    off = int(np.median(diffs))
    res = np.abs(diffs - off).max(axis=1)
    clock.update(host_fit="profile", profiler_minus_host_ns=off,
                 host_spans_profiled=len(res),
                 host_residual_ns={"p50": int(np.median(res)),
                                   "p99": int(np.percentile(res, 99)),
                                   "max": int(res.max())},
                 host_spans_within_20us=int((res <= 20_000).sum()))
    return off, clock


#: a stamp kernel's profiled start and its %globaltimer reading agree
#: within this, plus the profile's own rate error (CUPTI's GPU clock ran
#: 250 ppm off %globaltimer between its re-syncs on an H100) over the
#: time since the previous stamp
_MATCH_NS, _MATCH_RATE = 2_000, 3e-4
#: stamps a line of the fit covers at most: the profile's GPU clock
#: also changes its rate between jumps
_PIECE = 256


def _anchor(g: np.ndarray, stamps: np.ndarray, guess: int) -> Optional[int]:
    """The ring index of the stamp ``stamps[0]``: among the records near
    the guess (5 ms, else 50 ms, else 500 ms), the one from which the
    most of the next stamps find a record as far on (records the profile
    dropped do not count against it)."""
    w = min(64, len(stamps))
    dp = stamps[:w] - stamps[0]
    tol = _MATCH_NS + _MATCH_RATE * dp
    for reach in (5_000_000, 50_000_000, 500_000_000):
        lo = np.searchsorted(g, stamps[0] - guess - reach)
        hi = np.searchsorted(g, stamps[0] - guess + reach)
        best, best_k = 0, None
        for k in range(lo, hi):
            want = g[k] + dp
            ok = int((np.abs(g[_nearest(g, want)] - want) <= tol).sum())
            if ok > best:
                best, best_k = ok, k
        if best >= max(2, w // 2):
            return best_k
    return None


def _device_map(g: np.ndarray, stamps: np.ndarray, guess: int,
                clock: dict):
    """A function that puts %globaltimer readings on the profiler's
    clock, fitted to the profile's stamp kernel records ``stamps`` (in
    the order they ran, as the ring's ``g``). Each stamp is paired with
    the ring record its time predicts from the pairs before it (offset
    and rate), so records the profile dropped are passed over; where no
    record is near, the profile's clock jumped (CUPTI's re-syncs) and
    the pairing is anchored anew. A line is fitted to each run of at
    most :data:`_PIECE` pairs between jumps. Readings outside every
    piece keep the nearest piece's offset. Without a stamp in the
    profile, the probe's ``guess``."""
    clock.update(device="globaltimer")
    profiled = len(stamps)
    pi, pj, cuts = [], [], []
    i = misses = 0
    while i < len(stamps) and misses < 256:
        # anchor at stamp i (after the last pair, near its offset)
        lo = pj[-1] + 1 if pj else 0
        near = stamps[pi[-1]] - g[pj[-1]] if pi else guess
        k = _anchor(g[lo:], stamps[i:], near) if lo < len(g) else None
        if k is None:
            i += 1
            misses += 1
            continue
        misses = 0
        if pi:
            cuts.append(len(pi))
        pi.append(i)
        pj.append(lo + k)
        i += 1
        # then follow the offset and its rate from pair to pair
        while i < len(stamps):
            a = stamps[pi[-1]] - g[pj[-1]]
            back = max(len(pi) - 32, 0 if not cuts else cuts[-1])
            dp = stamps[pi[-1]] - stamps[pi[back]]
            rate = ((a - (stamps[pi[back]] - g[pj[back]])) / dp
                    if dp > 0 else 0.0)
            gap = stamps[i] - stamps[pi[-1]]
            want = stamps[i] - a - rate * gap
            jj = pj[-1] + 1 + int(_nearest(g[pj[-1] + 1:],
                                           np.array([want]))[0])
            if jj >= len(g) or abs(int(g[jj]) - want) > \
                    _MATCH_NS + _MATCH_RATE * gap:
                break
            pi.append(i)
            pj.append(jj)
            i += 1
    if not pi:
        clock.update(device_fit="probe", profiler_minus_device_ns=guess,
                     device_stamps_profiled=profiled)
        return lambda t: t + guess
    sp, gp = stamps[np.array(pi)], g[np.array(pj)]
    lines = []                     # (first g, last g, slope, intercept)
    pieces = [c for piece in np.split(np.arange(len(pi)), cuts)
              for c in np.array_split(piece, -(-len(piece) // _PIECE))]
    for piece in pieces:
        if len(piece) >= 8:
            x = (gp[piece] - gp[piece[0]]).astype(np.float64)
            b, a = np.polyfit(x, (sp[piece] - gp[piece]).astype(
                np.float64), 1)
            lines.append((int(gp[piece[0]]), int(gp[piece[-1]]), b,
                          a - b * int(gp[piece[0]])))
    if not lines:
        raise RuntimeError("the profile's stamp kernels fit no clock")
    first, last = (np.array(c, np.int64) for c in list(zip(*lines))[:2])
    slope, icpt = (np.array(c) for c in list(zip(*lines))[2:])

    def convert(t):
        t = np.asarray(t, np.int64)
        i = np.clip(np.searchsorted(first, t, side="right") - 1, 0,
                    len(lines) - 1)
        inside = np.clip(t, first[i], last[i])  # past a piece: its edge's
        return t + np.rint(slope[i] * inside + icpt[i]).astype(np.int64)

    res = np.abs(sp - convert(gp))
    clock.update(device_fit="profile",
                 device_stamps_profiled=profiled,
                 device_stamps_paired=len(pi),
                 device_clock_jumps=len(cuts),
                 device_clock_pieces=len(lines),
                 device_residual_ns={"p50": int(np.median(res)),
                                     "p99": int(np.percentile(res, 99)),
                                     "max": int(res.max())},
                 device_stamps_within_2us=int((res <= 2_000).sum()))
    return convert


def _pair(recs: np.ndarray, names: List[str], steps: List[int],
          convert) -> List[list]:
    """[name, step span id, start_ns, end_ns] regions of the marks:
    the n-th ``step.begin`` opens the n-th step, and the marks of one
    name alternate begin and end inside it. A region starts where
    ``convert`` puts its first stamp and lasts as long as its stamps are
    apart on the device's own clock."""
    out: List[list] = []
    n = -1
    open_: Dict[str, tuple] = {}
    at = convert(recs[:, 1]) if len(recs) else recs[:, 1]

    def close_step():
        if open_:
            raise RuntimeError(
                f"step {steps[n]}: marks {sorted(open_)} opened and never "
                f"closed")

    for (code, t), pos in zip(recs.tolist(), at.tolist()):
        name = names[code]
        if name == STEP_BEGIN:
            if n >= 0:
                close_step()
            n += 1
            if n >= len(steps):
                raise RuntimeError(
                    f"the device ran more steps than the host's "
                    f"{len(steps)} step spans")
            continue
        if n < 0:
            raise RuntimeError(f"mark {name!r} before any step began")
        if name in open_:
            t0, pos0 = open_.pop(name)
            out.append([name, steps[n], pos0, pos0 + t - t0])
        else:
            open_[name] = (t, pos)
    if n >= 0:
        close_step()
    if n + 1 != len(steps):
        raise RuntimeError(f"the device began {n + 1} steps, the host "
                           f"recorded {len(steps)}")
    return out


def summary(export: dict, *, start_ns: Optional[int] = None,
            end_ns: Optional[int] = None) -> dict:
    """What an export reads, over the spans that start in [start_ns,
    end_ns) on its clock (all by default):

    * ``spans_ms``: each span's mean length (ms) and ``spans``: counts;
    * ``marks_ms``: for each step kind, each mark's device time summed
      over the step's regions (its layers), the mean over the kind's
      steps (ms);
    * ``expert_fill``: over the fused prefill steps, the prompt tokens
      they carried times each token's expert choices over the expert
      rows computed (%; None without such a step).

    Raises when the ring lost records."""
    if export["ring"]["lost"]:
        raise RuntimeError(f"{export['ring']['lost']} device mark records "
                           f"were lost past the ring's capacity "
                           f"{export['ring']['capacity']}: the marks "
                           f"cannot be read")
    lo = -np.inf if start_ns is None else start_ns
    hi = np.inf if end_ns is None else end_ns
    spans = [s for s in export["spans"] if lo <= s["start"] < hi]
    out = {"spans": {}, "spans_ms": {}, "marks_ms": {}}
    for name in SPANS:
        ms = [(s["end"] - s["start"]) / 1e6 for s in spans
              if s["name"] == name]
        if ms:
            out["spans"][name] = len(ms)
            out["spans_ms"][name] = float(np.mean(ms))
    kind = {s["id"]: s["name"] for s in spans if s["name"] in STEPS}
    per: Dict[str, Dict[str, float]] = {}
    for name, step, t0, t1 in export["marks"]:
        if step in kind:
            d = per.setdefault(kind[step], {})
            d[name] = d.get(name, 0) + (t1 - t0)
    for k, d in per.items():
        n = sum(1 for v in kind.values() if v == k)
        out["marks_ms"][k] = {name: v / n / 1e6 for name, v in d.items()}
    fill = [s for s in spans if s["name"] == "prefill"]
    rows = sum(s["counts"].get("moe.expert_rows", 0) for s in fill)
    out["expert_fill"] = (100.0 * sum(
        s["rows"] * s["counts"].get("moe.choices", 0) for s in fill) / rows
        if rows else None)
    return out


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> np.ndarray:
    """The nodes of a graph captured with ``keep_graph=True``, one row
    each in the graph's order: (node type, 1 for a stamp kernel, the
    kernel's function address, grid size, block size, dynamic shared
    memory; -1 where not a kernel the runtime reads)."""
    import ctypes

    from repro_torch.kernels import build
    lib = build.spans_library()
    n = ctypes.c_int()
    rc = lib.span_graph_nodes(graph.raw_cuda_graph(), None, 0,
                              ctypes.byref(n))
    if rc == 0 and n.value:
        out = np.zeros((n.value, 6), np.int64)
        rc = lib.span_graph_nodes(graph.raw_cuda_graph(),
                                  out.ctypes.data, n.value, ctypes.byref(n))
    else:
        out = np.zeros((0, 6), np.int64)
    if rc != 0:
        raise RuntimeError(f"reading the graph's nodes failed: "
                           f"{lib.spans_error_string(rc).decode()}")
    return out
