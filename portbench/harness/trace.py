"""The profiled window reduced to numbers: the device's busy time (the
union of its kernel, copy and set intervals), the operations that took
most of it, the idle gaps by the host span the benchmark was in, and
the executor kernel's records and time.

Host spans are the benchmark's own ``torch.profiler.record_function``
ranges, named ``pb.<span>`` (``harness/serving.py``); the window runs
from the first profiled tick's start to the last one's end, in the
profiler's clock, which it shares with the device's records."""
from __future__ import annotations

import numpy as np

EXECUTOR = "dsl_executor_kernel"
TICK = "pb.tick"


def _events(prof):
    """([(name, start_ns, end_ns)] on the device, [...] host spans)."""
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if hasattr(e, "start_ns"):
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        else:
            start = int(e.start_us() * 1000)
            end = start + int(e.duration_us() * 1000)
        user = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                else name.startswith("pb."))
        if str(e.device_type()).endswith("CUDA"):
            if not user:
                dev.append((name, start, end))
        elif user and name.startswith("pb."):
            spans.append((name, start, end))
    return dev, spans


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end) rows, sorted and disjoint."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.r_[idx[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], axis=1)


def _innermost(mid: np.ndarray, spans: list) -> np.ndarray:
    """The name of the shortest ``pb.`` span holding each midpoint
    ("pb.driver" outside every tick: the loop's own work and waits)."""
    out = np.full(len(mid), "pb.driver", dtype=object)
    best = np.full(len(mid), np.inf)
    for name in sorted({s[0] for s in spans}):
        iv = np.array([(s, e) for n, s, e in spans if n == name], np.int64)
        iv = iv[np.argsort(iv[:, 0])]
        i = np.searchsorted(iv[:, 0], mid, side="right") - 1
        ok = i >= 0
        inside = np.zeros(len(mid), bool)
        inside[ok] = iv[i[ok], 1] > mid[ok]
        length = np.where(inside, (iv[np.clip(i, 0, None), 1]
                                   - iv[np.clip(i, 0, None), 0]), np.inf)
        take = inside & (length < best)
        out[take] = name
        best[take] = length[take]
    return out


def reduce(prof) -> dict:
    """The profiled window's numbers (seconds unless named otherwise)."""
    dev, spans = _events(prof)
    ticks = [s for s in spans if s[0] == TICK]
    if not ticks or not dev:
        raise RuntimeError(
            f"the profile holds {len(ticks)} tick spans and {len(dev)} "
            f"device records: nothing to reduce")
    w0 = min(s[1] for s in ticks)
    w1 = max(s[2] for s in ticks)
    iv = np.array([(max(s, w0), min(e, w1)) for _, s, e in dev
                   if e > w0 and s < w1], np.int64)
    busy = _merge(iv)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    # idle gaps: before the first record, between records, after the last
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    by_span: dict = {}
    if len(gaps):
        names = _innermost((gaps[:, 0] + gaps[:, 1]) // 2, spans)
        for n, g in zip(names, gaps[:, 1] - gaps[:, 0]):
            by_span[n] = by_span.get(n, 0) + int(g)
    ops: dict = {}
    for name, s, e in dev:
        if e > w0 and s < w1:
            ops[name] = ops.get(name, 0) + (min(e, w1) - max(s, w0))
    ex = [(s, e) for n, s, e in dev if EXECUTOR in n and e > w0 and s < w1]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "ticks": len(ticks),
        "executor_records": len(ex),
        "executor_s": sum(e - s for s, e in ex) / 1e9,
        "device_ops": [[n[:120], t / 1e9] for n, t in
                       sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n[3:], t / 1e9] for n, t in
                      sorted(by_span.items(), key=lambda kv: -kv[1])[:10]],
    }
