"""Multi-replica request router over per-replica schedulers — the port
of ``repro.serve.router``.

The §4.4 deployment model, end to end: decode plans are compiled ONCE
(on a planner communicator), exported as JSON plan files
(:func:`repro_torch.core.comm.export_plan_set`), and every engine
replica starts from the SAME exported file set
(:func:`~repro_torch.core.comm.load_plan_set` →
``Engine(decode_plans=...)``) — replicas replay identical frozen
programs without running selection, the pass pipeline or compilation
themselves. The router is the front door: it fans requests across the
replicas (deterministic least-loaded), drives all their schedulers on
one shared virtual clock, and aggregates their ``plan_report()``.

Replica placement on one card: a replica is an ``Engine`` with its own
:class:`~repro_torch.mesh.RankAxis` of ``tp`` ranks stacked on the
device, its own cache and its own plan objects (own hit counters); the
replicas share the card, as the reference's share a host.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.scheduler import Request, Scheduler, TickInfo, _pct

__all__ = ["Router", "build_replicas"]


class Router:
    """Deterministic least-loaded router over N :class:`Scheduler`
    replicas. Routing is a pure function of outstanding counts (ties
    break to the lowest replica index), so a seeded trace routes — and
    therefore emits — identically on every run. Presents the same
    surface as a single scheduler (submit / tick / outstanding /
    metrics / plan_report), so :class:`~repro_torch.serve.scheduler.
    AsyncServeEngine` and the load generator drive either
    interchangeably."""

    def __init__(self, replicas: List[Scheduler]):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        self.replicas = list(replicas)
        self.routed: Dict[int, int] = {}      # rid -> replica index

    # -- clock (shared across replicas; replicas tick in lockstep) ---------
    @property
    def now(self) -> float:
        return max(r.now for r in self.replicas)

    @property
    def n_active(self) -> int:
        return sum(r.n_active for r in self.replicas)

    def advance(self, dt: float) -> None:
        for r in self.replicas:
            r.advance(dt)

    def advance_to(self, t: float) -> None:
        for r in self.replicas:
            r.advance_to(t)

    def next_arrival(self) -> Optional[float]:
        ts = [t for r in self.replicas
              if (t := r.next_arrival()) is not None]
        return min(ts) if ts else None

    def outstanding(self) -> int:
        return sum(r.outstanding() for r in self.replicas)

    # -- routing -----------------------------------------------------------
    def submit(self, req: Request) -> Optional[int]:
        """Route to the replica with the fewest outstanding requests
        (lowest index on ties) and return its index — or ``None`` when
        that replica rejected the request (``queue_limit``
        backpressure: the drop is counted in its ``metrics()
        ['rejected']`` and the rid is NOT recorded in ``routed``, so a
        rid in ``routed`` always eventually appears in ``streams``)."""
        loads = [r.outstanding() for r in self.replicas]
        i = int(np.argmin(loads))
        if not self.replicas[i].submit(req):
            return None
        self.routed[req.rid] = i
        return i

    def tick(self, now: Optional[float] = None) -> TickInfo:
        """Tick every replica at the same virtual instant (replicas run
        in parallel in a real deployment, so a router tick costs the
        MAX of the per-replica micro-step counts, not the sum) and
        merge the emissions."""
        now = self.now if now is None else float(now)
        infos = [r.tick(now) for r in self.replicas]
        emissions = tuple(e for i in infos for e in i.emissions)
        return TickInfo(
            now=now, admitted=sum(i.admitted for i in infos),
            micro_steps=max(i.micro_steps for i in infos),
            bucket=max(i.bucket for i in infos),
            n_active=sum(i.n_active for i in infos),
            queued=sum(i.queued for i in infos), emissions=emissions)

    def run_until_drained(self, *, step_s: float = 1.0,
                          max_ticks: int = 100_000) -> List[TickInfo]:
        """Drive the shared virtual clock until every replica drained
        (mirrors ``Scheduler.run_until_drained``)."""
        infos: List[TickInfo] = []
        while self.outstanding():
            if len(infos) >= max_ticks:
                raise RuntimeError(
                    f"router did not drain in {max_ticks} ticks "
                    f"({self.outstanding()} requests outstanding)")
            nxt = self.next_arrival()
            if self.n_active == 0 and nxt is not None and nxt > self.now:
                self.advance_to(nxt)
            info = self.tick()
            infos.append(info)
            self.advance(step_s * (1 + info.micro_steps))
        return infos

    # -- aggregation -------------------------------------------------------
    @property
    def streams(self) -> Dict[int, List[int]]:
        """rid -> emitted tokens, merged across replicas (rids are
        globally unique — submit() enforces it per replica and the
        router never routes one rid twice)."""
        out: Dict[int, List[int]] = {}
        for r in self.replicas:
            out.update(r.streams)
        return out

    def metrics(self) -> dict:
        """Fleet metrics: summed counters, merged per-request records
        (TTFT/wait percentiles recomputed over ALL requests), and the
        per-replica breakdown."""
        per = [r.metrics() for r in self.replicas]
        recs = [rec for r in self.replicas for rec in r._done.values()]
        ttft = sorted(rec["first"] - rec["arrival"] for rec in recs)
        wait = sorted(rec["admit"] - rec["arrival"] for rec in recs)
        toks = sum(m["tokens"] for m in per)
        dur = max(self.now, 1e-9)
        bucket_steps: Dict[int, int] = {}
        for m in per:
            for b, c in m["bucket_steps"].items():
                bucket_steps[b] = bucket_steps.get(b, 0) + c
        hits = sum(m.get("prefix_hits", 0) for m in per)
        misses = sum(m.get("prefix_misses", 0) for m in per)
        return dict(
            replicas=len(self.replicas),
            completed=sum(m["completed"] for m in per), dropped=0,
            outstanding=self.outstanding(), tokens=toks,
            tokens_per_vs=round(toks / dur, 3),
            ttft_vs={"p50": _pct(ttft, 0.5), "p95": _pct(ttft, 0.95),
                     "max": ttft[-1] if ttft else 0.0},
            wait_vs={"p50": _pct(wait, 0.5), "p95": _pct(wait, 0.95),
                     "max": wait[-1] if wait else 0.0},
            bucket_steps=bucket_steps,
            rejected=sum(m.get("rejected", 0) for m in per),
            prefix_hits=hits, prefix_misses=misses,
            prefix_tokens_reused=sum(m.get("prefix_tokens_reused", 0)
                                     for m in per),
            prefix_hit_rate=(round(hits / (hits + misses), 4)
                             if hits + misses else 0.0),
            per_replica=per)

    def plan_report(self) -> dict:
        """Fleet plan/health view: per-replica reports, summed health
        counters, the per-replica modes, and a ``degraded`` list naming
        every replica whose running mode diverged from its requested
        mode (the reference's explicit→auto fallbacks; the port raises
        instead, so it stays empty), so a degraded replica is visible at
        the router without reading N engines."""
        reps = [r.plan_report() for r in self.replicas]
        health: Dict[str, int] = {}
        for rep in reps:
            for k, v in rep["health"].items():
                health[k] = health.get(k, 0) + int(v)
        return dict(
            replicas=reps,
            modes=[rep["mode"] for rep in reps],
            requested_modes=[rep["requested_mode"] for rep in reps],
            degraded=[i for i, rep in enumerate(reps) if rep["degraded"]],
            health=health)


def build_replicas(cfg, serve_cfg, *, n_replicas: int, tp: int, plan_dir,
                   params, mode: Optional[str] = None,
                   max_slots: Optional[int] = None, prefill_chunk: int = 4,
                   fused_prefill: bool = False, queue_limit=None,
                   prefix_cache_tokens=None, device=None) -> Router:
    """A router over ``n_replicas`` engine replicas on ``device`` (default:
    the CUDA card), ALL started from the same exported plan-file set —
    the §4.4 round trip:

    1. compile the decode plans once on a planner communicator,
    2. ``export_plan_set(plans, plan_dir)`` — JSON files + manifest,
    3. each replica ``load_plan_set(plan_dir)`` → ``Engine(
       decode_plans=...)`` — verified on load, no recompilation.

    Every replica serves the same ``params`` (the reference layout, as
    ``Engine`` takes them), so any replica serves any request with the
    same tokens and routing can never change an output stream.
    ``fused_prefill``/``queue_limit`` go to each :class:`Scheduler`;
    with ``serve_cfg.prefill_seq_buckets`` the exported set carries the
    prefill sequence buckets. ``prefix_cache_tokens`` builds one
    :class:`~repro_torch.serve.prefix_cache.PrefixCache` PER replica
    (``0`` = unbounded, ``None`` = disabled)."""
    from repro_torch.core import comm as comm_lib
    from repro_torch.distributed import step as step_mod
    from repro_torch.mesh import resolve_device
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.prefix_cache import PrefixCache

    device = resolve_device(device)
    # 1-2: plan once on a planner communicator, export the artifact
    planner = comm_lib.Communicator("model", n=tp, device=device,
                                    verify=serve_cfg.verify)
    plans = step_mod.compile_decode_plans(
        cfg, planner, batch_local=serve_cfg.batch, tp=tp,
        seq_buckets=serve_cfg.prefill_seq_buckets)
    comm_lib.export_plan_set(plans, plan_dir)

    schedulers = []
    for _ in range(n_replicas):
        # 3: the replica loads the shipped files — fresh plan objects,
        # own hit counters, verified on load
        loaded = comm_lib.load_plan_set(plan_dir, device=device,
                                        verify=serve_cfg.verify)
        eng = Engine(cfg, params, serve_cfg, tp=tp, device=device,
                     mode=mode, decode_plans=loaded)
        # one trie a replica: replicas never share KV entries
        pc = (PrefixCache(capacity_tokens=prefix_cache_tokens or None)
              if prefix_cache_tokens is not None else None)
        schedulers.append(Scheduler(eng, max_slots=max_slots,
                                    prefill_chunk=prefill_chunk,
                                    fused_prefill=fused_prefill,
                                    queue_limit=queue_limit,
                                    prefix_cache=pc))
    return Router(schedulers)
