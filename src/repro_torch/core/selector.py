"""Algorithm selection — the tuning layer of the collective API (port of
``repro.core.selector``).

An α-β cost model over the DSL programs' analytic stats (rounds = α
term, bytes on the wire = β term) ranks the registered candidates of a
collective (:func:`choose`); a deployment overrides it with a
:class:`TuningTable` built from measurements (:meth:`TuningTable.
from_bench`) or from per-instruction traces through the simulator
(:meth:`TuningTable.from_traces`), and fits the link itself from those
traces (:func:`fit_from_traces`): the measure → refit → re-select loop
of paper §5.

``ICI``/``DCN`` are the reference's TPU constants, kept only so a
parity test can hold :func:`choose` against the reference. They
describe no part of the H100. The port's default link
(:data:`UNFITTED`) is a named placeholder whose numbers are not fitted
to any measurement; ``chip_smoke.py`` phase 14 fits a link for ranks
stacked on one H100 from traces the executor kernel stamps, and reports
what it would choose, but the default stays the placeholder.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core import algorithms as algos
from repro_torch.core import passes

__all__ = ["LinkModel", "ICI", "DCN", "UNFITTED", "estimate_us", "choose",
           "TuningTable", "CANDIDATES", "register_algorithm", "supports",
           "fit_link_model", "fit_from_traces"]


@dataclasses.dataclass(frozen=True)
class LinkModel:
    alpha_us: float       # per-round latency
    beta_GBps: float      # per-rank injection bandwidth
    torus: bool = True    # point-to-point torus: puts pay hop distance
    sync_us: float = 0.2  # per EXTRA sync step beyond one per round

    def time_us(self, rounds: int, bytes_on_wire: int,
                extra_syncs: int = 0) -> float:
        return (rounds * self.alpha_us + extra_syncs * self.sync_us
                + bytes_on_wire / (self.beta_GBps * 1e3))


# the reference's TPU v5e constants (parity tests only)
ICI = LinkModel(alpha_us=1.0, beta_GBps=50.0, torus=True, sync_us=0.2)
DCN = LinkModel(alpha_us=10.0, beta_GBps=6.25, torus=False, sync_us=1.0)

#: Placeholder for ranks stacked on one H100: all-to-all addressing (no
#: torus hops), one flag handshake per round. UNFITTED — these are not
#: measured values; they only rank candidates until a fit replaces them.
UNFITTED = LinkModel(alpha_us=1.0, beta_GBps=100.0, torus=False,
                     sync_us=0.2)

#: candidate algorithms per collective, in the order ``choose`` breaks
#: ties in (the reference's), filled through :func:`register_algorithm`
#: below: the entry point user code extends the selector with
CANDIDATES: dict[str, list[str]] = {}

#: algorithm name -> geometry predicate (n -> bool); a candidate whose
#: predicate refuses n is not offered at n
_SUPPORTS: dict[str, Callable[[int], bool]] = {}


def register_algorithm(collective: str, name: str,
                       builder: Optional[Callable] = None, *,
                       supports: Optional[Callable[[int], bool]] = None
                       ) -> None:
    """Register ``name`` as a selector candidate for ``collective``.

    ``builder`` (``n -> Program``) is added to ``algorithms.REGISTRY``
    when given; omit it for an algorithm already there. ``supports``
    (``n -> bool``) restricts the axis sizes the candidate is offered at:
    :func:`choose` skips it elsewhere and :func:`estimate_us` refuses it.
    Registering the same (collective, name) again adds nothing."""
    if builder is not None:
        algos.REGISTRY[name] = builder
    elif name not in algos.REGISTRY:
        raise ValueError(
            f"cannot register {name!r}: not in algorithms.REGISTRY and "
            f"no builder given — pass builder=<n -> Program>")
    cands = CANDIDATES.setdefault(collective, [])
    if name not in cands:
        cands.append(name)
    if supports is not None:
        _SUPPORTS[name] = supports


def supports(name: str, n: int) -> bool:
    """True when algorithm ``name`` can run on an ``n``-rank axis."""
    pred = _SUPPORTS.get(name)
    return pred is None or bool(pred(n))


for _coll, _name in [
    ("all_reduce", "allreduce_1pa"),
    ("all_reduce", "allreduce_2pa"),
    ("all_reduce", "allreduce_ring"),
    ("all_gather", "allpairs_ag"),
    ("all_gather", "ring_ag"),
    ("reduce_scatter", "allpairs_rs"),
    ("reduce_scatter", "ring_rs"),
    ("all_to_all", "alltoall"),
]:
    register_algorithm(_coll, _name)
# the log-step family: power-of-two axes only, ring stays the any-n one
for _coll, _name in [
    ("all_reduce", "allreduce_rd"),
    ("all_reduce", "swing_allreduce"),
    ("all_gather", "doubling_ag"),
    ("reduce_scatter", "halving_rs"),
]:
    register_algorithm(_coll, _name, supports=algos.is_power_of_two)
del _coll, _name


def estimate_us(algo_name: str, n: int, nbytes: int,
                link: LinkModel = UNFITTED,
                opt_level: Optional[int] = None) -> float:
    """α-β estimate for one algorithm on an n-rank axis, costed in its
    post-optimizer form at ``opt_level`` (default pipeline level)."""
    if not supports(algo_name, n):
        raise ValueError(
            f"algorithm {algo_name!r} does not support n={n} ranks; "
            f"choose() skips it automatically")
    prog = passes.optimize(algos.REGISTRY[algo_name](n),
                           passes.DEFAULT_OPT_LEVEL if opt_level is None
                           else opt_level, n)
    n_in = prog.chunks[prog.in_buffer]
    chunk_bytes = max(nbytes // n_in, 1)
    stats = prog.comm_stats(n, chunk_bytes)
    bytes_key = "wire_bytes_per_rank" if link.torus else "bytes_per_rank"
    return link.time_us(stats["comm_rounds"] + stats["barriers"],
                        stats[bytes_key],
                        extra_syncs=max(0, stats["sync_steps"]
                                        - stats["comm_rounds"]))


@dataclasses.dataclass
class TuningTable:
    """Deployment override: (collective, max_bytes) -> algorithm name.
    Entries are tried by increasing max_bytes, the first match wins;
    past the largest the cost model decides."""

    entries: list[tuple[str, int, str]] = dataclasses.field(
        default_factory=list)

    def lookup(self, collective: str, nbytes: int) -> Optional[str]:
        for coll, max_bytes, name in sorted(self.entries, key=lambda e: e[1]):
            if coll == collective and nbytes <= max_bytes:
                return name
        return None

    @classmethod
    def from_traces(cls, traces, *, link: Optional[LinkModel] = None,
                    opt_level: Optional[int] = None) -> "TuningTable":
        """A table from simulating every registered candidate at each
        traced (collective, size) point (:func:`repro_torch.core.
        simulate.whatif`): one trace per size is enough, the other
        candidates are predicted. ``link`` defaults to
        :func:`fit_from_traces` over the same traces. Brackets are in the
        units :func:`choose` is queried with (all_gather's scaled to the
        gathered message); a collective with one candidate is skipped."""
        from repro_torch.core import simulate as sim

        traces = list(traces)
        if not traces:
            raise ValueError(
                "from_traces needs at least one captured trace; record "
                "one with Communicator(trace=True), "
                "ExecutionPlan.capture_trace(), or trace.capture(...)")
        if link is None:
            link = fit_from_traces(traces)
        best: dict = {}   # (collective, bracket_bytes) -> (pred_us, algo)
        for t in traces:
            cands = CANDIDATES.get(t.collective)
            if cands is None or len(cands) < 2:
                continue
            itemsize = t.chunk_bytes // (t.chunk_rows * t.cols)
            nbytes = t.shape[0] * t.cols * itemsize
            if t.collective == "all_gather":
                nbytes *= t.n
            key = (t.collective, nbytes)
            if key in best:
                continue          # the first trace of a (collective, size)
            preds = {}
            for cand in cands:
                try:
                    preds[cand] = sim.whatif(
                        t, algo=cand, link=link,
                        opt_level=opt_level).predicted_us
                except ValueError:
                    continue      # not rebuildable at this geometry
            if len(preds) < 2:
                continue
            algo = min(preds, key=preds.get)
            best[key] = (preds[algo], algo)
        return cls(entries=[(c, nb, a)
                            for (c, nb), (_, a) in sorted(best.items())])

    @classmethod
    def from_bench(cls, bench: dict) -> "TuningTable":
        """A table from a ``BENCH_collectives.json`` payload: for every
        (collective, size) its ``opt_compare`` section measured with more
        than one candidate, the measured-fastest algorithm. Sizes become
        ``max_bytes`` brackets (all_gather's scaled by the bench's ``n``
        to the gathered message, the units :func:`choose` is queried
        with)."""
        _check_bench_payload(bench, "TuningTable.from_bench")
        coll_of = {a: c for c, cands in CANDIDATES.items() for a in cands}
        n = bench.get("n", 1)
        best: dict = {}   # (collective, nbytes) -> (wall_us, algo)
        counts: dict = {}
        for p in bench.get("points", []):
            if p.get("bench") != "opt_compare":
                continue
            coll = coll_of.get(p.get("algo"))
            if coll is None or "wall_us_opt" not in p:
                continue
            nbytes = p["nbytes"] * (n if coll == "all_gather" else 1)
            k = (coll, nbytes)
            counts[k] = counts.get(k, 0) + 1
            if k not in best or p["wall_us_opt"] < best[k][0]:
                best[k] = (p["wall_us_opt"], p["algo"])
        return cls(entries=[(c, nb, a)
                            for (c, nb), (_, a) in sorted(best.items())
                            if counts[(c, nb)] > 1])


def _check_bench_payload(bench, what: str) -> None:
    """An empty or field-missing bench payload fails loudly instead of
    fitting a degenerate model or installing an empty table."""
    if not isinstance(bench, dict):
        raise ValueError(
            f"{what} expects the parsed BENCH_collectives.json dict, "
            f"got {type(bench).__name__}; load it with json.load() or "
            f"pass the path to Communicator.load_bench_tuning")
    if "points" not in bench:
        raise ValueError(
            f"{what}: bench payload has no 'points' field "
            f"(keys: {sorted(bench)[:8]}) — not a BENCH_collectives.json "
            f"payload; regenerate it with `python benchmarks/run.py "
            f"--json`")
    if not bench["points"]:
        raise ValueError(
            f"{what}: bench payload has an empty 'points' list — "
            f"nothing to fit/rank; regenerate it with `python "
            f"benchmarks/run.py --json`")


def fit_from_traces(traces, base: LinkModel = UNFITTED, *,
                    allow_single_size: bool = False) -> LinkModel:
    """Fit α, β and ``sync_us`` from per-instruction traces
    (:mod:`repro_torch.core.trace`).

    * **α, β**: least squares of put service time against bytes moved
      (a put costs ``α + bytes/β``); bytes are tried raw and hop-weighted
      and the better fit also sets ``torus``.
    * **sync_us**: the median wait service.

    With puts at one byte count α and β cannot be separated: that raises,
    unless ``allow_single_size=True``, which pins α at ``base.alpha_us``
    and solves β from the median put service (what :func:`~repro_torch.
    core.simulate.whatif` does with a single trace). A fit whose slope is
    not positive raises: the services do not follow the model."""
    traces = list(traces)
    if not traces:
        raise ValueError(
            "fit_from_traces needs at least one captured trace; record "
            "one with Communicator(trace=True) or trace.capture(...)")
    puts = [(ev.bytes, ev.wire_bytes, ev.service_us)
            for t in traces for ev in t.events if ev.op == "put"]
    if not puts:
        raise ValueError(
            "fit_from_traces: no put events in the given traces — "
            "cannot fit β; capture a communication collective")
    waits = [ev.service_us for t in traces for ev in t.events
             if ev.op == "wait"]
    sync = float(np.median(waits)) if waits else base.sync_us

    if len({b for b, _, _ in puts}) < 2:
        if not allow_single_size:
            raise ValueError(
                "fit_from_traces: all put events move the same byte "
                "count — β is unidentifiable; capture traces at >= 2 "
                "payload sizes (or pass allow_single_size=True to pin "
                "α at the base model and fit β alone)")
        nb = puts[0][1] if base.torus else puts[0][0]
        svc = float(np.median([s for _, _, s in puts]))
        slope = max(svc - base.alpha_us, 1e-9) / max(nb, 1)
        return dataclasses.replace(base, beta_GBps=1e-3 / slope,
                                   sync_us=sync)

    def _beta_fit(xs):
        A = np.array([[1.0, x] for x in xs], float)
        y = np.array([s for _, _, s in puts], float)
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        pred = A @ sol
        return float(sol[0]), float(sol[1]), float(np.sum((y - pred) ** 2))

    int_raw, slope_raw, res_raw = _beta_fit([b for b, _, _ in puts])
    int_wire, slope_wire, res_wire = _beta_fit([w for _, w, _ in puts])
    if res_wire < res_raw:
        torus, alpha, slope = True, int_wire, slope_wire
    elif res_raw < res_wire:
        torus, alpha, slope = False, int_raw, slope_raw
    else:                      # indistinguishable (e.g. all shift-1 puts)
        torus = base.torus
        alpha, slope = (int_wire, slope_wire) if torus else (int_raw,
                                                             slope_raw)
    if slope <= 0:
        raise ValueError(
            f"fit_from_traces: degenerate β fit (slope={slope:.4g} us/B "
            f"<= 0): put service times do not grow with bytes — the "
            f"traces do not follow the cost model; not installing")
    if alpha <= 0:             # noise can push the intercept past zero
        alpha = base.alpha_us
    return dataclasses.replace(base, alpha_us=alpha,
                               beta_GBps=1e-3 / slope, torus=torus,
                               sync_us=sync)


def fit_link_model(bench: dict, base: LinkModel = UNFITTED) -> LinkModel:
    """Fit (α, β) from the wall times of a ``BENCH_collectives.json``
    payload: least squares over its single-collective points
    (``allreduce``/``allgather``, xla backend) of ``wall_us ≈ α·rounds +
    bytes/β``, each point's rounds and bytes from its optimized program.
    ``sync_us`` and ``torus`` come from ``base``."""
    _check_bench_payload(bench, "fit_link_model")
    n = bench.get("n", 8)
    level = bench.get("opt_default", None)
    rows, y = [], []
    for p in bench.get("points", []):
        if p.get("bench") not in ("allreduce", "allgather") \
                or p.get("backend") != "xla" or "wall_us" not in p:
            continue
        prog = passes.optimize(algos.REGISTRY[p["algo"]](n),
                               passes.DEFAULT_OPT_LEVEL if level is None
                               else level, n)
        n_in = prog.chunks[prog.in_buffer]
        stats = prog.comm_stats(n, max(p["nbytes"] // n_in, 1))
        bytes_key = "wire_bytes_per_rank" if base.torus else "bytes_per_rank"
        rows.append([stats["comm_rounds"] + stats["barriers"],
                     stats[bytes_key]])
        y.append(p["wall_us"])
    if len(rows) < 2:
        raise ValueError(
            f"fit_link_model: only {len(rows)} usable point(s) in the "
            f"bench payload (needs >= 2 'allreduce'/'allgather' points "
            f"with backend='xla' and a 'wall_us' field); regenerate "
            f"with `python benchmarks/run.py --json` or fit from traces "
            f"via fit_from_traces")
    sol, *_ = np.linalg.lstsq(np.asarray(rows, float),
                              np.asarray(y, float), rcond=None)
    alpha_us = float(sol[0])
    inv_beta_us_per_byte = float(sol[1])
    if alpha_us <= 0 or inv_beta_us_per_byte <= 0:
        raise ValueError(
            f"degenerate alpha-beta fit (alpha={alpha_us:.4g}us, "
            f"1/beta={inv_beta_us_per_byte:.4g}us/B); bench payload does "
            "not follow the cost model — not installing")
    return dataclasses.replace(base, alpha_us=alpha_us,
                               beta_GBps=1e-3 / inv_beta_us_per_byte)


def choose(collective: str, *, n: int, nbytes: int,
           link: LinkModel = UNFITTED,
           table: Optional[TuningTable] = None,
           opt_level: Optional[int] = None) -> str:
    """The table's entry for ``(collective, nbytes)`` when it has one,
    else the candidate with the least α-β estimate at ``opt_level``
    (the first of equals, in :data:`CANDIDATES` order)."""
    if table is not None:
        hit = table.lookup(collective, nbytes)
        if hit is not None:
            return hit
    cands = [a for a in CANDIDATES[collective] if supports(a, n)]
    return min(cands, key=lambda a: estimate_us(a, n, nbytes, link,
                                                opt_level=opt_level))
