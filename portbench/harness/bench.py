"""One run of one cell: set-up, the measured window, the metrics, the
check. ``run.py`` is its command line; the tests call :func:`run` on the
CPU at tiny sizes.

Set-up (``setup_s``) runs from the process's start to the window's:
the weights made on the device from the seed, the engine (its plans
compiled, its kernels loaded), the scheduler (a graph captured a slot
bucket), every shape the cell's traffic reaches run once
(``serving.warm``), and whatever the traffic's driver
(``drivers/<driver>.py``) serves before it opens the window to bring
its loop to a steady state; the result's ``notes.setup_phases_s`` holds
the seconds of each part. The window then serves the traffic mix
through the driver on the wall clock. Metrics are read by
``metrics/<name>.py``, each found by its name before the first ``.``:
the end-to-end ones in every run, the per-layer ones in a traced run
(``--trace 1``), which profiles a few ticks of the window. After the
window the peak memory is read, the program's state freed, and the
reference judges a sample of what was served (``harness/check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import time
from typing import Optional

import numpy as np
import torch

from harness import check, peaks, serving
from harness import trace as trace_lib
from harness import traffic as traffic_lib
from harness import weights


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""
    config: dict
    window_s: float               # the window's length by the host clock
    tracks: dict                  # rid -> serving.Track
    records: list                 # serving.StepRecord, every step (traced)
    setup_s: float
    peaks: Optional[dict]
    profiled: Optional[tuple] = None      # (first tick, ticks)
    trace: Optional[dict] = None          # trace.reduce() of them

    def in_profile(self, rec) -> bool:
        return (self.profiled is not None and self.profiled[0] <= rec.tick
                < sum(self.profiled))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(cell, data: RunData, entries: list) -> dict:
    """{name: {"value", "unit"}} of the metric entries whose reader
    finds something to read."""
    out = {}
    for m in entries:
        base = m["name"].split(".")[0]
        reader = _load(cell.bench_dir / "metrics" / f"{base}.py",
                       f"portbench_metric_{base}")
        v = reader.read(data, m["name"])
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _free(sched) -> None:
    eng = sched.eng
    sched.graphs.clear()
    eng.params = eng.cache = sched.cache = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> dict:
    """The run's result line (a dict), ``correct`` decided (``control``:
    with the control's reading too, ``check.judge``)."""
    config, traffic = cell.config, cell.traffic
    device = torch.device(device)
    cuda = device.type == "cuda"
    need = traffic_lib.longest(traffic)
    if need > config["serving"]["max_kv"]:
        raise ValueError(f"a request of this mix fills {need} positions, "
                         f"past the cache's max_kv "
                         f"{config['serving']['max_kv']}")
    phases = _Phases(t_start)
    params = weights.make(config, seed, device)
    phases.mark("weights")
    sched = serving.build(config, params, device, traced=trace)
    del params
    gc.collect()
    phases.mark("engine")
    serving.warm(sched)
    phases.mark("warm")

    # the profile needs the card's records: a CPU run (the tests) has none
    session = serving.Session(sched, seconds,
                              profile=traffic.get("profile")
                              if trace and cuda else None)
    driver = _load(cell.bench_dir / "drivers" / f"{traffic['driver']}.py",
                   f"portbench_driver_{traffic['driver']}")
    driver.drive(session, traffic, config["vocab"], seed)
    session.finish()
    if session.opened is None:
        raise RuntimeError(f"driver {traffic['driver']!r} never opened "
                           f"the window")
    setup_s = session.opened - t_start
    phases.mark("loop", at=session.opened)

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    mem = torch.cuda.max_memory_allocated(device) if cuda else 0
    data = RunData(config=config, window_s=session.end,
                   tracks=session.tracks, records=sched.records,
                   setup_s=setup_s, peaks=peaks.of(kind),
                   profiled=session.profiled)
    dev_block = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                 "count": cell.chips if cuda else 0,
                 "memory_peak_bytes": int(mem)}
    notes = {"window_s": session.end, "ticks": session.ticks,
             "requests_due": len(session.tracks),
             "requests_finished": sum(t.done for t in
                                      session.tracks.values()),
             "generator_late_ms": _late(session.tracks),
             "setup_phases_s": phases.spans}
    result = {}
    if trace:
        if session.prof is not None and session.profiled[1]:
            data.trace = trace_lib.reduce(session.prof)
            dev_block["busy_s"] = data.trace["busy_s"]
            dev_block["window_s"] = data.trace["window_s"]
            result["breakdown"] = {"device_ops": data.trace["device_ops"],
                                   "idle_gaps": data.trace["idle_gaps"]}
            notes["executor_records_dropped"] = _dropped(data)
        metrics = read_metrics(cell, data, cell.per_layer)
    else:
        metrics = read_metrics(cell, data, cell.end_to_end)
    session.prof = None
    tracks = session.tracks
    _free(sched)
    del sched, session
    gc.collect()

    verdict = check.judge(config, seed, tracks, device, control=control)
    out = {"correct": verdict["ok"], "attempted": len(tracks), "failed": 0,
           "metrics": metrics, "device": dev_block}
    out.update(result)
    notes["gaps"] = verdict.get("spread")
    if control:
        notes["control"] = verdict["control"]
        notes["control_correct"] = verdict["control_ok"]
    out["notes"] = notes
    out["checks"] = verdict["checks"]
    return out


class _Phases:
    """Seconds each part of set-up took, from the process's start (the
    first is the start-up: the interpreter, torch and the program's
    modules)."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.spans = {"start": time.perf_counter() - t_start}
        self.last += self.spans["start"]

    def mark(self, name: str, at: Optional[float] = None) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter() if at is None else at
        self.spans[name] = t - self.last
        self.last = t


def _late(tracks: dict) -> dict:
    late = np.array([t.submitted - t.due for t in tracks.values()
                     if t.due >= 0]) * 1e3
    if not len(late):
        return {}
    return {"p50": float(np.median(late)), "max": float(late.max())}


def _dropped(data: RunData) -> int:
    """Executor records the profile should hold (each profiled replay's
    captured launches, each fused step's launches) less those it holds:
    CUPTI drops a graph's records now and then."""
    want = sum(r.launches for r in data.records if data.in_profile(r))
    return int(want - data.trace["executor_records"])
