"""What-if DAG replay over recorded traces — the simulator half of the
tuning loop (port of ``repro.core.simulate``).

A :class:`~.trace.Trace` is a dependency DAG with a measured service a
event. This module re-times it:

* :func:`replay` — re-schedule the recorded events: with no link the
  measured services replay (checking the scheduler against the recorded
  span, :data:`REPLAY_TOLERANCE`); with a :class:`~.selector.LinkModel`
  the communication events are re-timed under α/β/sync and compute keeps
  its measured (or rate-fitted) time.
* :func:`whatif` — rebuild the collective at another algorithm,
  opt_level or backend, synthesize its event DAG at the trace's geometry
  (:func:`~.trace.synthesize_events`) and predict its span under the
  model, whose constants default to :func:`~.selector.fit_from_traces`
  on the trace itself.

A trace's backend names the executor that recorded it; a reference
trace says ``"xla"`` or ``"pallas"``, which rebuild here as ``"torch"``
and ``"cuda"`` (as plan files do).

Cost of an event under the model (the selector's α-β model, at event
granularity): put ``α + bytes/β`` (hop-weighted ``wire_bytes`` on a
torus link); wait ``sync_us``; barrier ``α``; copy/reduce the measured
service or an affine bytes→µs rate fitted from the trace
(:class:`ComputeRates`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import trace as trace_mod

__all__ = ["SimResult", "ComputeRates", "replay", "whatif",
           "REPLAY_TOLERANCE", "VALIDATION_TOLERANCE"]

#: Replaying the measured services must land within this relative
#: tolerance of the recorded span (host emulation: the same scheduler).
REPLAY_TOLERANCE = 0.05

#: The reference's stated accuracy of a prediction with fitted constants
#: on host emulation; no gate of the port reads it on the card.
VALIDATION_TOLERANCE = 0.35

#: a reference trace's backend -> the port's executor
_BACKENDS = {"xla": "torch", "pallas": "cuda", "torch": "torch",
             "cuda": "cuda"}


def _backend(name: str) -> str:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown trace backend {name!r}; expected one of "
                         f"{sorted(_BACKENDS)}") from None


@dataclasses.dataclass
class SimResult:
    """One simulation: the predicted span, the source trace's measured
    span (when comparable) and the predicted timeline's service by op."""

    predicted_us: float
    measured_us: Optional[float]
    events: int
    service_us_by_op: Dict[str, float]
    config: dict

    @property
    def delta_us(self) -> Optional[float]:
        if self.measured_us is None:
            return None
        return self.predicted_us - self.measured_us

    @property
    def rel_err(self) -> Optional[float]:
        if self.measured_us in (None, 0):
            return None
        return abs(self.predicted_us - self.measured_us) / self.measured_us


class ComputeRates:
    """Affine bytes→µs service of local compute (copy/reduce), fitted
    from a trace's measured compute events; zero without any."""

    def __init__(self, intercept_us: float = 0.0,
                 us_per_byte: float = 0.0) -> None:
        self.intercept_us = intercept_us
        self.us_per_byte = us_per_byte

    @classmethod
    def from_trace(cls, trace: "trace_mod.Trace") -> "ComputeRates":
        pts = [(ev.bytes, ev.service_us) for ev in trace.events
               if ev.op in ("copy", "reduce")]
        if not pts:
            return cls()
        if len({b for b, _ in pts}) < 2:
            # one size: a flat cost an event is the best available fit
            return cls(intercept_us=float(np.mean([s for _, s in pts])))
        A = np.array([[1.0, b] for b, _ in pts], float)
        y = np.array([s for _, s in pts], float)
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        return cls(intercept_us=max(0.0, float(sol[0])),
                   us_per_byte=max(0.0, float(sol[1])))

    def __call__(self, ev: "trace_mod.TraceEvent") -> float:
        return self.intercept_us + self.us_per_byte * ev.bytes


def _model_service(link, rates: Optional[ComputeRates],
                   measured: Optional[Dict[int, float]] = None):
    """An event's service under the α-β model; ``measured`` maps
    id(event) -> recorded service for compute events without rates."""
    def service(ev: "trace_mod.TraceEvent") -> float:
        if ev.op == "put":
            nb = ev.wire_bytes if link.torus else ev.bytes
            return link.alpha_us + nb / (link.beta_GBps * 1e3)
        if ev.op == "wait":
            return link.sync_us
        if ev.op == "barrier":
            return link.alpha_us
        if rates is not None:
            return rates(ev)
        if measured is not None:
            return measured[id(ev)]
        return 0.0

    return service


def _copy_events(events) -> List["trace_mod.TraceEvent"]:
    return [dataclasses.replace(ev, deps=list(ev.deps)) for ev in events]


def _by_op(events) -> Dict[str, float]:
    by_op: Dict[str, float] = {}
    for ev in events:
        by_op[ev.op] = by_op.get(ev.op, 0.0) + ev.service_us
    return {k: round(v, 3) for k, v in sorted(by_op.items())}


def replay(trace: "trace_mod.Trace", *, link=None,
           rates: Optional[ComputeRates] = None) -> SimResult:
    """Re-schedule a recorded trace: ``link=None`` replays the measured
    services; with a link, communication is re-timed under it and
    compute keeps its measured services (or ``rates``)."""
    measured = [ev.service_us for ev in trace.events]
    events = _copy_events(trace.events)
    pos = {id(ev): i for i, ev in enumerate(events)}
    if link is None:
        service = lambda ev: measured[pos[id(ev)]]  # noqa: E731
    else:
        service = _model_service(
            link, rates, measured={id(ev): measured[pos[id(ev)]]
                                   for ev in events})
    span = trace_mod.schedule(events, service)
    return SimResult(
        predicted_us=span, measured_us=trace.span_us, events=len(events),
        service_us_by_op=_by_op(events),
        config=dict(mode="replay", algo=trace.algo,
                    opt_level=trace.opt_level,
                    link=None if link is None else dataclasses.asdict(link)))


def _rebuild_executor(trace: "trace_mod.Trace", algo: str, level: int,
                      backend: str):
    """The executor of ``algo`` at ``level`` on the trace's axis for
    ``backend`` (``"torch"``/``"cuda"``; pure Python, no card), and its
    chunk rows at the trace's input rows."""
    from repro_torch.core import algorithms as algos
    from repro_torch.core import passes
    from repro_torch.core.executor import CudaExecutor, TorchExecutor

    builder = algos.REGISTRY.get(algo)
    if builder is None:
        from repro_torch.core import selector as sel
        cands = sel.CANDIDATES.get(trace.collective)
        hint = (f"registry candidates for {trace.collective!r}: {cands}"
                if cands else f"candidates: {sorted(algos.REGISTRY)}")
        raise ValueError(
            f"whatif cannot rebuild algorithm {algo!r}: not in "
            f"algorithms.REGISTRY ({hint})")
    prog = passes.optimize(builder(trace.n), level, trace.n)
    n_in = prog.chunks[prog.in_buffer]
    chunk_rows = max(1, -(-trace.rows_in // n_in))   # pad up if needed
    if _backend(backend) == "cuda":
        ex = CudaExecutor(prog)
    else:
        ex = TorchExecutor(prog, vectorize=level > 0)
    return ex, chunk_rows


def whatif(trace: "trace_mod.Trace", *, algo: Optional[str] = None,
           opt_level: Optional[int] = None, link=None,
           backend: Optional[str] = None) -> SimResult:
    """Predict the span of the trace's collective rebuilt with another
    algorithm / opt_level / backend / link, before compiling anything.
    Communication is timed by ``link`` (default: fitted from this trace,
    α pinned when its puts have one size), compute by rates fitted from
    the trace."""
    from repro_torch.core import selector as sel

    algo = algo if algo is not None else trace.algo
    if algo is None:
        raise ValueError(
            "whatif needs an algorithm: the trace records none and no "
            "algo= was given")
    level = trace.opt_level if opt_level is None else opt_level
    level = 2 if level is None else level
    backend = _backend(backend or trace.backend)
    executor, chunk_rows = _rebuild_executor(trace, algo, level, backend)
    if link is None:
        link = sel.fit_from_traces([trace], allow_single_size=True)
    events, _ = trace_mod.synthesize_events(
        executor, trace.n, chunk_rows, trace.cols, trace.dtype)
    rates = ComputeRates.from_trace(trace)
    span = trace_mod.schedule(events, _model_service(link, rates))
    same_shape = (algo == trace.algo and level == trace.opt_level
                  and backend == _backend(trace.backend))
    return SimResult(
        predicted_us=span,
        measured_us=trace.span_us if same_shape else None,
        events=len(events), service_us_by_op=_by_op(events),
        config=dict(mode="whatif", algo=algo, opt_level=level,
                    backend=backend, link=dataclasses.asdict(link)))
