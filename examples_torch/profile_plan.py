"""Trace profiler + what-if simulator walkthrough on the port.

Capture a per-instruction timeline from a compiled ExecutionPlan, replay
it through the simulator, fit α/β/sync link constants from the traces,
ask "what if" questions (different algorithm, different opt_level,
different link), and generate a trace-driven TuningTable. Eight ranks
stacked on one device.

On the card a capture is the executor kernel's traced instantiation:
every block stamps each op's start and end (``%globaltimer`` and
``clock64``), and the trace is built from those stamps; on the CPU it is
the reference's host emulation of the plan's emission stream. Either
way the executed program is the plan's own.

    PYTHONPATH=src python examples_torch/profile_plan.py            # card
    PYTHONPATH=src python examples_torch/profile_plan.py --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

import torch

from repro_torch.core import selector as sel
from repro_torch.core import simulate, trace
from repro_torch.core.comm import Communicator
from repro_torch.mesh import resolve_device

N = 8
SHAPES = ((64, 8), (1024, 128), (4096, 128))   # the traced ring plans


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' traces the host emulation)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    comm = Communicator("x", n=N, device=device)
    res: dict = dict(device=str(device))

    # -- 1. capture: one trace per (collective, size) -----------------------
    traces = []
    for rows, cols in SHAPES:
        plan = comm.compile("all_reduce", (rows, cols), torch.float32,
                            algo="allreduce_ring", opt_level=2)
        traces.append(trace.capture_plan(plan))
    t = traces[1]
    print(f"[capture] {t.algo} O{t.opt_level} {t.shape}: "
          f"{len(t.events)} events, span={t.span_us:.1f}us")
    print(f"[capture] summary: {t.summary()}")
    res["events"] = {f"{r}x{c}": len(tr.events)
                     for (r, c), tr in zip(SHAPES, traces)}
    res["span_us"] = {f"{r}x{c}": tr.span_us
                      for (r, c), tr in zip(SHAPES, traces)}

    # traces serialize to versioned JSON: save/load round-trips
    rt = trace.Trace.from_json(t.to_json())
    assert abs(rt.span_us - t.span_us) < 1e-3   # serialized at µs 4dp
    assert len(rt.events) == len(t.events)
    print(f"[capture] JSON round-trip OK "
          f"({len(t.to_json()) // 1024} KiB, schema v{t.version})")

    # -- 2. replay: the simulator reproduces the measured span --------------
    rep = simulate.replay(t)
    print(f"[replay] measured={t.span_us:.1f}us replayed="
          f"{rep.predicted_us:.1f}us (tolerance "
          f"{simulate.REPLAY_TOLERANCE:.0%})")
    res["replay"] = dict(measured_us=t.span_us, predicted_us=rep.predicted_us)

    # -- 3. fit: α/β/sync_us and the torus flag from the traces -------------
    link = sel.fit_from_traces(traces)
    print(f"[fit] {link}")
    mod = simulate.replay(t, link=link)
    print(f"[fit] model replay: {mod.predicted_us:.1f}us "
          f"(rel_err={mod.rel_err:.2f}, documented tolerance "
          f"{simulate.VALIDATION_TOLERANCE:.0%})")
    res["link"] = dataclasses.asdict(link)
    res["model_replay"] = dict(predicted_us=mod.predicted_us,
                               rel_err=mod.rel_err)

    # -- 4. what-if: re-plan WITHOUT recompiling or re-running --------------
    res["whatif"] = {}
    for algo in ("allreduce_2pa", "allreduce_1pa"):
        w = simulate.whatif(t, algo=algo, link=link)
        print(f"[whatif] {algo}: predicted {w.predicted_us:.1f}us "
              f"(ring measured {t.span_us:.1f}us)")
        res["whatif"][algo] = w.predicted_us
    w0 = simulate.whatif(t, algo="allreduce_1pa", opt_level=0, link=link)
    w2 = simulate.whatif(t, algo="allreduce_1pa", opt_level=2, link=link)
    print(f"[whatif] 1pa O0 {w0.predicted_us:.1f}us ({w0.events} events) vs "
          f"O2 {w2.predicted_us:.1f}us ({w2.events} events) — "
          f"sync batching visible without recompiling")
    slow = dataclasses.replace(link, beta_GBps=link.beta_GBps / 10)
    ws = simulate.whatif(t, link=slow)
    print(f"[whatif] 10x slower link: {ws.predicted_us:.1f}us")
    res["whatif_events"] = dict(O0=w0.events, O2=w2.events)

    # -- 5. tune: a TuningTable generated from the traces -------------------
    table = sel.TuningTable.from_traces(traces, link=link)
    print(f"[tune] from_traces table: {table.entries}")
    for coll, nbytes, algo in table.entries:
        default = sel.choose(coll, n=N, nbytes=nbytes)
        mark = "  <- changed" if default != algo else ""
        print(f"[tune] {coll} @ {nbytes}B: default={default} "
              f"traced={algo}{mark}")
    comm2 = Communicator("x", n=N, device=device, table=table, link=link)
    plan2 = comm2.compile("all_reduce", (1024, 128), torch.float32)
    print(f"[tune] tuned communicator picked: {plan2.algo}")
    res.update(table=[list(e) for e in table.entries], tuned_algo=plan2.algo)

    # -- 6. the serving surface ---------------------------------------------
    # Engine(ServeConfig(trace=True)) flows the flag to its communicator;
    # every decode plan then records a timeline at its first call and
    # plan_report()["trace"] carries the summaries.
    tr_comm = Communicator("x", n=N, device=device, trace=True)
    tr_plan = tr_comm.compile("all_reduce", (64, 8), torch.float32)
    tr = tr_plan.capture_trace()
    print(f"[serve] plan.last_trace: {json.dumps(tr.summary(), default=str)}")
    res["serve_trace_events"] = len(tr.events)
    res["serve_trace_algo"] = tr_plan.algo
    return res


if __name__ == "__main__":
    main()
