"""Per-instruction execution traces — the profiler half of the tuning loop
(port of ``repro.core.trace``).

MSCCL++ §5 motivates a measure → refit → re-select loop: the selector's
α-β constants should come from observed executions. This module records
one timeline per plan execution:

* :class:`Emission` — one lowered unit of work. Both executors expose
  ``trace_emissions(n)``: ``TorchExecutor`` labels its lowering as the
  reference's ``XlaExecutor`` does (one ``all_to_all`` emission per
  fan-out round, ...), ``CudaExecutor`` emits one emission per row of
  its encoded instruction table (a slab put is one ``put_slab``, a WAIT
  one ``flag_wait`` per flag slot).
* :class:`TraceEvent` — one emission on one rank: ids, kind, peer,
  bytes (raw and hop-weighted), round, and issue/complete/blocked times.
* :class:`Trace` — one JSON document per execution, schema
  :data:`TRACE_SCHEMA_VERSION` (the reference's: a trace from either
  package loads in the other).

Where the times come from:

* **On the card** (a ``CudaExecutor``): the executor kernel's traced
  instantiation (``csrc/executor.cu``) stamps every op of every block
  with ``%globaltimer`` and ``clock64()``. A rank's event is issued at
  the earliest stamp of its blocks and completes at the latest; a wait is
  blocked from its issue until the latest completion among the puts it
  depends on; the span is the stamps' own. When ``%globaltimer``'s tick
  (the larger of the probe's, :func:`~repro_torch.core.executor.
  device_timer`, and the step the stamps move in) is coarser than the
  median op, op times come from ``clock64()`` deltas converted
  with the SM clock (calibrated against ``%globaltimer`` over 2 ms), each
  block anchored at its first ``%globaltimer`` stamp. The untraced kernel
  that plans replay is not changed: a captured graph holds only it.
* **On the CPU** (a ``TorchExecutor``): the reference's timed host
  emulation of the emission stream — per-rank numpy chunk buffers, each
  event's service timed on the host — scheduled over the same event DAG
  by :func:`schedule`. These are host times, not device times.

Either way each event keeps its least service over
:data:`_CAPTURE_REPEATS` runs.

Capture entry points: ``Communicator(trace=True)`` (each plan records at
its first call outside a CUDA-graph capture, ``ExecutionPlan.
last_trace``, ``Engine.plan_report()["trace"]``), :func:`capture_plan`,
:func:`capture` (a raw program) and :func:`collect` (one trace per
executor call inside the block). Traces feed :func:`repro_torch.core.
selector.fit_from_traces`, :func:`repro_torch.core.simulate.replay` /
``whatif`` and ``TuningTable.from_traces``.

The serving loop's spans, counters and device marks (a tick's phases,
the model step's KV gather and MoE layers, also inside a captured graph)
are :mod:`repro_torch.core.spans`'s; that module reuses
:func:`run_meta` for its exports.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dsl import IndexExpr, Program

__all__ = [
    "TRACE_SCHEMA_VERSION", "Emission", "TraceEvent", "Trace",
    "TraceCollector", "collect", "active", "capture", "capture_plan",
    "schedule", "synthesize_events", "run_meta",
]

#: Trace file schema version. Readers reject any other value.
TRACE_SCHEMA_VERSION = 1

#: bytes an element of each payload type the traces name
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4}
#: numpy storage of the host emulation (bf16 emulated in f16: the bytes
#: and the DAG are what matter)
_HOST_DTYPE = {"float32": np.float32, "bfloat16": np.float16,
               "float16": np.float16, "int32": np.int32}


def _itemsize(dtype: str) -> int:
    try:
        return _ITEMSIZE[dtype]
    except KeyError:
        raise ValueError(f"unsupported trace dtype {dtype!r}; expected one "
                         f"of {sorted(_ITEMSIZE)}") from None


def run_meta() -> Dict[str, str]:
    """Provenance stamp for recorded artifacts: the checkout's git SHA
    (or 'unknown') and an ISO-8601 UTC timestamp."""
    import datetime
    import os
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10).stdout.strip()
    except Exception:
        sha = ""
    created = datetime.datetime.now(datetime.timezone.utc) \
        .isoformat(timespec="seconds")
    return dict(git_sha=sha or "unknown", created=created)


# ---------------------------------------------------------------------------
# emissions: the lowered instruction stream
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Emission:
    """One lowered unit of work for one DSL instruction: ``iid`` is the
    instruction's index in ``program.instructions()`` and ``sub`` the
    emission's index within it; ``lowered`` names the construct."""

    iid: int
    sub: int
    op: str                      # 'put'|'wait'|'copy'|'reduce'|'barrier'
    lowered: str
    round_id: int
    shift: Optional[int] = None  # uniform ring shift; None = fan-out
    # put: ((sb, si), (db, di), to) triples this emission covers
    puts: Tuple = ()
    # wait: ((db, di), frm) pairs this emission covers
    waits: Tuple = ()
    dst: Optional[Tuple[str, IndexExpr]] = None    # copy/reduce
    srcs: Tuple = ()                               # copy/reduce


# ---------------------------------------------------------------------------
# events + trace schema
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TraceEvent:
    """One emission observed on one rank. ``peer`` is the destination
    (put) / source (wait) rank of a single-peer emission, else -1;
    ``deps`` the (iid, sub, rank) puts a wait's completion depends on;
    ``service_us`` (derived) the event's own work time, ``blocked_us``
    its time waiting on dependencies."""

    iid: int
    sub: int
    op: str
    lowered: str
    rank: int
    peer: int
    round_id: int
    chunks: int
    bytes: int
    wire_bytes: int
    issue_us: float = 0.0
    complete_us: float = 0.0
    blocked_us: float = 0.0
    deps: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)

    @property
    def service_us(self) -> float:
        return self.complete_us - self.issue_us - self.blocked_us

    def to_dict(self) -> dict:
        return dict(
            iid=self.iid, sub=self.sub, op=self.op, lowered=self.lowered,
            rank=self.rank, peer=self.peer, round=self.round_id,
            chunks=self.chunks, bytes=self.bytes, wire_bytes=self.wire_bytes,
            issue_us=round(self.issue_us, 4),
            complete_us=round(self.complete_us, 4),
            blocked_us=round(self.blocked_us, 4),
            deps=[list(d) for d in self.deps])

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(
            iid=d["iid"], sub=d["sub"], op=d["op"], lowered=d["lowered"],
            rank=d["rank"], peer=d["peer"], round_id=d["round"],
            chunks=d["chunks"], bytes=d["bytes"],
            wire_bytes=d["wire_bytes"], issue_us=d["issue_us"],
            complete_us=d["complete_us"], blocked_us=d["blocked_us"],
            deps=[tuple(x) for x in d.get("deps", [])])


def _req(d: dict, key: str):
    try:
        return d[key]
    except KeyError:
        raise ValueError(
            f"trace payload missing required field {key!r} "
            f"(has {sorted(d)[:10]}): not a Trace.to_json() document, "
            f"or truncated") from None


@dataclasses.dataclass
class Trace:
    """One recorded plan execution. ``shape`` is the caller's per-rank
    payload shape, ``rows_in`` the executor's input rows (payload +
    padding). ``backend`` is the executor that ran: ``"torch"`` or
    ``"cuda"`` here, ``"xla"`` or ``"pallas"`` in a reference trace
    (kept as written, so a loaded trace serialises back unchanged).
    ``device`` (not serialised) holds what a capture on the card saw: the
    timer used, its tick, the SM clock and the best run's stamps."""

    name: str
    backend: str
    n: int
    shape: Tuple[int, int]
    rows_in: int
    cols: int
    dtype: str
    chunk_rows: int
    chunk_bytes: int
    events: List[TraceEvent]
    span_us: float = 0.0
    collective: Optional[str] = None
    algo: Optional[str] = None
    opt_level: Optional[int] = None
    git_sha: str = "unknown"
    created: str = ""
    version: int = TRACE_SCHEMA_VERSION
    device: Optional[dict] = dataclasses.field(default=None, repr=False,
                                               compare=False)

    # -- inspection --------------------------------------------------------
    def summary(self) -> dict:
        """Compact JSON-able digest (what ``plan_report()['trace']``
        surfaces)."""
        by_op: Dict[str, float] = {}
        for ev in self.events:
            by_op[ev.op] = by_op.get(ev.op, 0.0) + ev.service_us
        return dict(
            name=self.name, collective=self.collective, algo=self.algo,
            backend=self.backend, opt_level=self.opt_level, n=self.n,
            events=len(self.events), span_us=round(self.span_us, 3),
            service_us_by_op={k: round(v, 3) for k, v in sorted(by_op.items())},
            bytes_per_rank=sum(ev.bytes for ev in self.events
                               if ev.op == "put") // max(self.n, 1),
            git_sha=self.git_sha, created=self.created)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return dict(
            version=self.version, kind="trace", name=self.name,
            collective=self.collective, algo=self.algo,
            backend=self.backend, opt_level=self.opt_level, n=self.n,
            shape=list(self.shape), rows_in=self.rows_in, cols=self.cols,
            dtype=self.dtype, chunk_rows=self.chunk_rows,
            chunk_bytes=self.chunk_bytes, span_us=round(self.span_us, 4),
            git_sha=self.git_sha, created=self.created,
            events=[ev.to_dict() for ev in self.events])

    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("indent", 2)
        json_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        if not isinstance(d, dict) or d.get("version") is None:
            raise ValueError(
                "trace payload has no schema 'version' field: not a "
                "Trace.to_json() document, or truncated")
        if d["version"] != TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported trace schema version {d['version']!r}; "
                f"this build reads version {TRACE_SCHEMA_VERSION} — "
                f"re-capture the trace")
        if d.get("kind") != "trace":
            raise ValueError(
                f"not a trace payload (kind={d.get('kind')!r})")
        return cls(
            name=_req(d, "name"), collective=d.get("collective"),
            algo=d.get("algo"), backend=_req(d, "backend"),
            opt_level=d.get("opt_level"), n=_req(d, "n"),
            shape=tuple(_req(d, "shape")), rows_in=_req(d, "rows_in"),
            cols=_req(d, "cols"), dtype=_req(d, "dtype"),
            chunk_rows=_req(d, "chunk_rows"),
            chunk_bytes=_req(d, "chunk_bytes"), span_us=_req(d, "span_us"),
            git_sha=d.get("git_sha", "unknown"), created=d.get("created", ""),
            events=[TraceEvent.from_dict(e) for e in _req(d, "events")],
            version=d["version"])

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> None:
        import pathlib
        pathlib.Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "Trace":
        import pathlib
        return cls.from_json(pathlib.Path(path).read_text())


# ---------------------------------------------------------------------------
# dependency-aware timeline scheduler (shared with simulate)
# ---------------------------------------------------------------------------
def schedule(events: Sequence[TraceEvent], service_of) -> float:
    """Assign issue/complete/blocked times over the event DAG.

    Events are emission-major / rank-minor (capture order). Per-rank
    clocks advance through each rank's events in program order; a wait
    also blocks until every dep put has completed; a barrier aligns the
    clocks of its ranks. ``service_of(ev)`` gives each event's own work
    time. Returns the span (the latest completion). Deterministic."""
    clock: Dict[int, float] = {}
    done: Dict[Tuple[int, int, int], float] = {}
    events = list(events)
    i = 0
    while i < len(events):
        j = i
        key = (events[i].iid, events[i].sub)
        while j < len(events) and (events[j].iid, events[j].sub) == key:
            j += 1
        group = events[i:j]
        if group[0].op == "barrier":
            gate = max((clock.get(ev.rank, 0.0) for ev in group), default=0.0)
            for ev in group:
                svc = service_of(ev)
                ev.issue_us = clock.get(ev.rank, 0.0)
                ev.blocked_us = max(0.0, gate - ev.issue_us)
                ev.complete_us = gate + svc
                clock[ev.rank] = ev.complete_us
        else:
            for ev in group:
                svc = service_of(ev)
                ev.issue_us = clock.get(ev.rank, 0.0)
                ready = max((done.get(tuple(d), 0.0) for d in ev.deps),
                            default=0.0)
                ev.blocked_us = max(0.0, ready - ev.issue_us)
                ev.complete_us = ev.issue_us + ev.blocked_us + svc
                clock[ev.rank] = ev.complete_us
                if ev.op == "put":
                    done[(ev.iid, ev.sub, ev.rank)] = ev.complete_us
        i = j
    return max((ev.complete_us for ev in events), default=0.0)


# ---------------------------------------------------------------------------
# host emulation of an emission stream
# ---------------------------------------------------------------------------
#: runs per capture; each event keeps its least service
_CAPTURE_REPEATS = 3


def _emulate(emissions: Sequence[Emission], program: Program, n: int,
             chunk_rows: int, cols: int, dtype: str,
             timed: bool = True) -> Tuple[List[TraceEvent], List[float]]:
    """Run the emission stream over per-rank numpy chunk buffers, timing
    each event's service on the host (``timed=True``), and record the
    wait→put dependencies. Untimed, no data moves: the DAG does not
    depend on it. Returns (events, services) in capture order —
    emission-major, rank-minor."""
    chunk_bytes = chunk_rows * cols * _itemsize(dtype)
    bufs: List[Dict[str, np.ndarray]] = []
    if timed:
        dt = np.dtype(_HOST_DTYPE[dtype])
        rng = np.random.default_rng(0)
        for _ in range(n):
            b = {}
            for name, k in program.chunks.items():
                if name == program.in_buffer:
                    arr = rng.standard_normal((k, chunk_rows, cols))
                    b[name] = arr.astype(dt) if dt.kind == "f" \
                        else (arr * 16).astype(dt)
                else:
                    b[name] = np.zeros((k, chunk_rows, cols), dt)
            bufs.append(b)

    # (dest_rank, buffer, chunk_index) -> (iid, sub, sender_rank) of the
    # latest put that delivered it — the wait dependency map
    put_done: Dict[Tuple[int, str, int], Tuple[int, int, int]] = {}
    events: List[TraceEvent] = []
    services: List[float] = []
    clk = time.perf_counter_ns

    for em in emissions:
        for r in range(n):
            if em.op == "put":
                t0 = clk()
                wire_chunks = 0
                for (sb, si), (db, di), to in em.puts:
                    p = to(r, n) % n
                    s = (p - r) % n
                    dst_idx = di(r, n)
                    if timed:
                        bufs[p][db][dst_idx] = bufs[r][sb][si(r, n)]
                    put_done[(p, db, dst_idx)] = (em.iid, em.sub, r)
                    wire_chunks += min(s, n - s)
                svc = (clk() - t0) / 1e3 if timed else 0.0
                k = len(em.puts)
                events.append(TraceEvent(
                    iid=em.iid, sub=em.sub, op="put", lowered=em.lowered,
                    rank=r,
                    peer=(r + em.shift) % n if em.shift is not None else -1,
                    round_id=em.round_id, chunks=k, bytes=k * chunk_bytes,
                    wire_bytes=wire_chunks * chunk_bytes))
            elif em.op == "wait":
                t0 = clk()
                deps: List[Tuple[int, int, int]] = []
                peer = -1
                for (db, di), frm in em.waits:
                    idx = di(r, n)
                    dep = put_done.get((r, db, idx))
                    if dep is None:
                        raise ValueError(
                            f"trace emulation: wait on {db}[{idx}] at rank "
                            f"{r} has no preceding put in program order — "
                            f"the program interleaves waits before their "
                            f"puts, which the emulator (and both "
                            f"executors) cannot schedule")
                    deps.append(dep)
                    if timed:     # a flag check reads a word, not the chunk
                        _ = float(bufs[r][db][idx].flat[0])
                    peer = frm(r, n) % n
                svc = (clk() - t0) / 1e3 if timed else 0.0
                k = len(em.waits)
                events.append(TraceEvent(
                    iid=em.iid, sub=em.sub, op="wait", lowered=em.lowered,
                    rank=r, peer=peer if k == 1 else -1,
                    round_id=em.round_id, chunks=k, bytes=k * chunk_bytes,
                    wire_bytes=0, deps=deps))
            elif em.op == "barrier":
                t0 = clk()
                svc = (clk() - t0) / 1e3 if timed else 0.0
                events.append(TraceEvent(
                    iid=em.iid, sub=em.sub, op="barrier", lowered=em.lowered,
                    rank=r, peer=-1, round_id=em.round_id, chunks=0,
                    bytes=0, wire_bytes=0))
            elif em.op in ("copy", "reduce"):
                db, di = em.dst
                t0 = clk()
                if timed:
                    acc = None
                    for sb, si in em.srcs:
                        val = bufs[r][sb][si(r, n)]
                        acc = val.copy() if acc is None else acc + val
                    bufs[r][db][di(r, n)] = acc
                svc = (clk() - t0) / 1e3 if timed else 0.0
                nb = len(em.srcs) * chunk_bytes if em.op == "reduce" \
                    else chunk_bytes
                events.append(TraceEvent(
                    iid=em.iid, sub=em.sub, op=em.op, lowered=em.lowered,
                    rank=r, peer=-1, round_id=em.round_id,
                    chunks=len(em.srcs), bytes=nb, wire_bytes=0))
            else:  # pragma: no cover
                raise NotImplementedError(em.op)
            services.append(svc)
    return events, services


def synthesize_events(executor, n: int, chunk_rows: int, cols: int,
                      dtype: str) -> Tuple[List[TraceEvent], int]:
    """The event DAG (ids, bytes, deps) of an executor's emission stream
    with zero services — the simulator re-times it under a cost model.
    Returns ``(events, chunk_bytes)``."""
    emissions = executor.trace_emissions(n)
    events, _ = _emulate(emissions, executor.program, n, chunk_rows, cols,
                         dtype, timed=False)
    return events, chunk_rows * cols * _itemsize(dtype)


def _host_timeline(executor, n, chunk_rows, cols, dtype):
    """Timed host emulation, best of :data:`_CAPTURE_REPEATS`, scheduled
    over the DAG: (events, span_us, None)."""
    emissions = executor.trace_emissions(n)
    events = services = None
    for _ in range(_CAPTURE_REPEATS):
        evs, svcs = _emulate(emissions, executor.program, n, chunk_rows,
                             cols, dtype, timed=True)
        if services is None:
            events, services = evs, svcs
        else:
            services = [min(a, b) for a, b in zip(services, svcs)]
    svc_of = dict(zip((id(ev) for ev in events), services))
    return events, schedule(events, lambda ev: svc_of[id(ev)]), None


# ---------------------------------------------------------------------------
# the card's own timeline: the traced executor kernel's stamps
# ---------------------------------------------------------------------------
def _stamp_times(stamps: np.ndarray, timer: str, cycles_per_ns: float):
    """(start_ns, end_ns) ``[blocks][ops]`` from raw stamps ``[blocks][ops]
    [4]`` (global start, global end, clock start, clock end): the global
    timer's readings, or clock64() deltas at ``cycles_per_ns`` from each
    block's first global stamp."""
    st = stamps.astype(np.float64)
    if timer == "globaltimer":
        return st[:, :, 0], st[:, :, 1]
    g0, c0 = st[:, :1, 0], st[:, :1, 2]
    return (g0 + (st[:, :, 2] - c0) / cycles_per_ns,
            g0 + (st[:, :, 3] - c0) / cycles_per_ns)


def _run_events(events, index, start, end, nb: int):
    """One run's (issue, complete, blocked) µs per event, relative to the
    run's first stamp, and its span. ``index[e]`` lists (rank, op row) of
    event e."""
    origin = start.min()
    out = []
    for e, ev in enumerate(events):
        r, i = index[e]
        blk = slice(r * nb, (r + 1) * nb)
        out.append([(start[blk, i].min() - origin) / 1e3,
                    (end[blk, i].max() - origin) / 1e3, 0.0])
    return out, (end.max() - origin) / 1e3


def _blocked(events, times, by_id, groups):
    """Set each wait's blocked time (from its issue to the latest
    completion of its dep puts) and each barrier's (from its issue to the
    latest issue among its ranks), each at most its duration."""
    for e, ev in enumerate(events):
        issue, complete = times[e][0], times[e][1]
        if ev.op == "wait" and ev.deps:
            ready = max(times[by_id[tuple(d)]][1] for d in ev.deps)
        elif ev.op == "barrier":
            ready = max(times[g][0] for g in groups[(ev.iid, ev.sub)])
        else:
            continue
        times[e][2] = min(max(0.0, ready - issue), complete - issue)


def _device_timeline(executor, x, repeats: int = _CAPTURE_REPEATS):
    """The traced kernel on ``x``, ``repeats`` times: (events, span_us,
    device info). The timeline is the run with the least span; each
    event keeps its least service over the runs (its completion moved
    back to issue + blocked + that service, which keeps every wait after
    its puts)."""
    from repro_torch.core.executor import device_timer
    enc = executor.encoded
    n = enc.n
    p = executor.program
    emissions = executor.trace_emissions(n)
    rows = x.shape[1] // p.chunks[p.in_buffer]
    dtype = str(x.dtype).replace("torch.", "")
    events, _ = _emulate(emissions, p, n, rows, x.shape[2], dtype,
                         timed=False)
    # event (emission e, rank r) <- the row of rank r tagged e
    eid = {(em.iid, em.sub): k for k, em in enumerate(emissions)}
    index: Dict[int, Tuple[int, int]] = {}
    for r in range(n):
        for i, (iid, sub) in enumerate(enc.tags[r].tolist()):
            if iid >= 0:
                index[eid[(iid, sub)] * n + r] = (r, i)
    if len(index) != len(events):
        raise RuntimeError(f"{p.name!r}: the table's rows cover "
                           f"{len(index)} of {len(events)} trace events")
    runs = []
    for _ in range(repeats):
        _, stamps = executor.launch_traced(x)
        runs.append(stamps.cpu().numpy())
    nb = runs[0].shape[0] // n
    timer_info = device_timer(x.device)
    # the timer: %globaltimer unless its tick is coarser than the median
    # op. Its tick is the larger of the probe's (the least step a tight
    # loop of readings sees) and the step the stamps themselves move in
    # (the greatest common divisor of their offsets from the first)
    glob = runs[0][:, :, :2]
    stamp_tick = int(np.gcd.reduce((glob - glob.min()).ravel()))
    tick_ns = max(timer_info["tick_ns"], stamp_tick)
    tagged = np.asarray([index[e] for e in range(len(events))])
    cycles = runs[0][:, :, 3] - runs[0][:, :, 2]
    op_ns = np.concatenate([cycles[r * nb:(r + 1) * nb, i]
                            for r, i in tagged]) / timer_info["cycles_per_ns"]
    median_op_ns = float(np.median(op_ns))
    timer = "clock64" if tick_ns > median_op_ns else "globaltimer"
    by_id = {(ev.iid, ev.sub, ev.rank): e for e, ev in enumerate(events)}
    groups: Dict[Tuple[int, int], List[int]] = {}
    for e, ev in enumerate(events):
        groups.setdefault((ev.iid, ev.sub), []).append(e)
    timelines = []
    for st in runs:
        start, end = _stamp_times(st, timer, timer_info["cycles_per_ns"])
        times, span = _run_events(events, index, start, end, nb)
        _blocked(events, times, by_id, groups)
        timelines.append((span, times))
    best = min(range(repeats), key=lambda k: timelines[k][0])
    span, times = timelines[best]
    service = [min(tl[1][e][1] - tl[1][e][0] - tl[1][e][2]
                   for tl in timelines) for e in range(len(events))]
    for e, ev in enumerate(events):
        ev.issue_us = times[e][0]
        ev.complete_us = times[e][1]
        if ev.op == "wait" and ev.deps:
            ready = max(events[by_id[tuple(d)]].complete_us for d in ev.deps)
            ev.blocked_us = max(0.0, ready - ev.issue_us)
        elif ev.op == "barrier":
            ev.blocked_us = times[e][2]
        ev.complete_us = ev.issue_us + ev.blocked_us + service[e]
    info = dict(timer=timer, median_op_ns=median_op_ns, tick_ns=tick_ns,
                probe_tick_ns=timer_info["tick_ns"],
                stamp_tick_ns=stamp_tick,
                cycles_per_ns=timer_info["cycles_per_ns"], blocks=nb,
                spans_us=[tl[0] for tl in timelines], stamps=runs[best],
                index=index)
    return events, span, info


def _capture(executor, n: int, chunk_rows: int, cols: int, dtype: str, *,
             backend: str, shape: Optional[Tuple[int, int]] = None,
             collective: Optional[str] = None, algo: Optional[str] = None,
             opt_level: Optional[int] = None, x=None) -> Trace:
    """A trace of one executor: the card's timeline for ``backend
    "cuda"`` (on ``x``, or on seeded random data of the shape), the host
    emulation otherwise."""
    program = executor.program
    n_in = program.chunks[program.in_buffer]
    rows_in = chunk_rows * n_in
    if backend == "cuda":
        import torch
        if x is None:
            gen = torch.Generator(device="cuda").manual_seed(0)
            dt = getattr(torch, dtype)
            x = (torch.randn((n, rows_in, cols), generator=gen,
                             device="cuda") * 16).to(dt)
        events, span, info = _device_timeline(executor, x)
    else:
        events, span, info = _host_timeline(executor, n, chunk_rows, cols,
                                            dtype)
    return Trace(
        name=program.name, backend=backend, n=n,
        shape=tuple(shape) if shape is not None else (rows_in, cols),
        rows_in=rows_in, cols=cols, dtype=dtype, chunk_rows=chunk_rows,
        chunk_bytes=chunk_rows * cols * _itemsize(dtype), events=events,
        span_us=span, collective=collective, algo=algo, opt_level=opt_level,
        device=info, **run_meta())


def capture_plan(plan, x=None) -> Trace:
    """A trace of a compiled :class:`~.comm.ExecutionPlan`: on the card
    (``backend "cuda"``) its traced kernel runs on a copy of ``x`` (the
    plan's ``(n, rows, cols)`` payload; default seeded random data),
    else the host emulation."""
    import torch.nn.functional as F
    program = plan.program
    if plan.groups != 1:
        raise ValueError("a trace covers one group of ranks; capture a "
                         "group view's plan compiled for one group")
    n_in = program.chunks[program.in_buffer]
    rows_in = plan.shape[0] + plan.pad
    if rows_in % n_in:
        raise ValueError(
            f"plan rows {rows_in} not divisible by its {n_in}-chunk grid")
    if x is not None and x.shape[1] == plan.shape[0] and plan.pad:
        x = F.pad(x, (0, 0, 0, plan.pad))
    return _capture(plan.executor, plan.n, rows_in // n_in, plan.shape[1],
                    plan.dtype, backend=plan.backend, shape=plan.shape,
                    collective=plan.collective, algo=plan.algo,
                    opt_level=plan.opt_level, x=x)


def capture(program: Program, n: int, *, rows: int, cols: int,
            dtype: str = "float32", backend: str = "torch",
            opt_level: Optional[int] = None) -> Trace:
    """A trace of a raw DSL program (optimized first when ``opt_level``
    is given) over ``(n, rows, cols)``: ``backend "torch"`` the host
    emulation, ``"cuda"`` the traced kernel on the card."""
    from repro_torch.core.executor import CudaExecutor, TorchExecutor
    if opt_level is not None:
        from repro_torch.core import passes
        program = passes.optimize(program, opt_level, n)
    if not program._frozen:
        program = program.freeze()
    n_in = program.chunks[program.in_buffer]
    if rows % n_in:
        raise ValueError(
            f"rows={rows} not divisible by the {n_in}-chunk input grid "
            f"of {program.name!r}")
    if backend == "cuda":
        executor: Any = CudaExecutor(program).prepare(n)
    elif backend == "torch":
        executor = TorchExecutor(
            program, vectorize=opt_level is None or opt_level > 0)
    else:
        raise ValueError(f"unknown backend {backend!r}; expected 'torch' "
                         f"or 'cuda'")
    return _capture(executor, n, rows // n_in, cols, dtype, backend=backend,
                    algo=program.name, opt_level=opt_level)


# ---------------------------------------------------------------------------
# collector hook
# ---------------------------------------------------------------------------
class TraceCollector:
    """Accumulates one :class:`Trace` per executor call inside a
    :func:`collect` context."""

    def __init__(self) -> None:
        self.traces: List[Trace] = []

    def record(self, executor, *, n: int, chunk_rows: int, cols: int,
               dtype: str, backend: str, x=None) -> None:
        self.traces.append(_capture(executor, n, chunk_rows, cols, dtype,
                                    backend=backend, x=x))


_ACTIVE: Optional[TraceCollector] = None


def active() -> Optional[TraceCollector]:
    """The collector of the innermost :func:`collect` context (None
    outside one); both executors check it at each call."""
    return _ACTIVE


@contextlib.contextmanager
def collect():
    """Record a trace for every executor call in the block::

        with trace.collect() as col:
            y = plan(x)             # any DSL plan inside
        col.traces                  # one Trace per call

    On the card each call also runs the traced kernel on its input, so it
    cannot sit inside a CUDA-graph capture (the traced launch raises
    there)."""
    global _ACTIVE
    col = TraceCollector()
    prev, _ACTIVE = _ACTIVE, col
    try:
        yield col
    finally:
        _ACTIVE = prev
