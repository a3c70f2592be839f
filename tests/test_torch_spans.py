"""The serving tracer (``repro_torch.core.spans``) on the CPU: off by
default and free when off, a traced scheduler serving the same streams
as an untraced one, the spans, marks and counters it records, and the
export's reduction and clock fit on synthetic records."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import spans
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, Scheduler

TINY_MOE = (pathlib.Path(__file__).resolve().parents[1] / "portbench" /
            "tests" / "data" / "configs" / "tiny-moe.json")


def _tiny_moe():
    conf = json.loads(TINY_MOE.read_text())
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in conf.items() if k in fields}
    kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw), conf["serving"]


def _serve(trace=None, n_requests=5, seed=0):
    """Serve a seeded set of requests to the end on the tiny MoE cell's
    configuration, fused prefill on: (streams, scheduler)."""
    cfg, s = _tiny_moe()
    params = tf.init_params(cfg, seed=seed, device="cpu")
    eng = Engine(cfg, params, ServeConfig(
        batch=s["slots"], max_kv=s["max_kv"], eos_id=s["eos_id"],
        mode=s["mode"], prefill_seq_buckets=tuple(s["prefill_seq_buckets"])),
        tp=s["tp"], device="cpu")
    sched = Scheduler(eng, max_slots=s["slots"],
                      prefill_chunk=s["prefill_chunk"], fused_prefill=True,
                      trace=trace)
    rng = np.random.default_rng(seed)
    for rid in range(n_requests):
        sched.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(2, 14))).astype(np.int32),
            max_new_tokens=int(rng.integers(1, 5)), arrival_s=0.5 * rid))
    sched.run_until_drained(step_s=0.25)
    return sched.streams, sched


@pytest.fixture(scope="module")
def served():
    torch.set_num_threads(1)
    tracer = spans.Tracer()
    streams, sched = _serve(tracer)
    return streams, sched, tracer, tracer.export()


def test_without_a_tracer_nothing_is_entered(monkeypatch):
    """``trace=None``: no record_function is entered, and a mark or a
    count outside a traced step does nothing."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a tracer")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    streams, sched = _serve(None, n_requests=2)
    assert sched.trace is None and all(streams.values())
    spans.mark("attn.kv_read")
    spans.count("moe.expert_rows", 5)


def test_traced_streams_equal_untraced(served):
    streams, _, _, _ = served
    plain, _ = _serve(None)
    assert streams == plain


def test_spans_parents_and_names(served):
    _, sched, tracer, out = served
    names = {s["name"] for s in out["spans"]}
    assert names == set(spans.SPANS)
    ticks = {s["id"] for s in out["spans"] if s["name"] == "tick"}
    assert len(ticks) == sched.metrics()["ticks"]
    by_id = {s["id"]: s for s in out["spans"]}
    for s in out["spans"]:
        if s["name"] == "tick":
            assert s["parent"] is None
            continue
        tick = by_id[s["parent"]]
        assert tick["name"] == "tick"
        assert tick["start"] <= s["start"] <= s["end"] <= tick["end"]
    steps = [s for s in out["spans"] if s["name"] in spans.STEPS]
    assert len(steps) == sched.metrics()["steps"]
    for s in steps:
        assert s["b"] in sched._buckets and s["rows"] >= 1
        assert ("S" in s) == (s["name"] == "prefill")


def test_each_steps_marks_pair_once_a_layer(served):
    _, sched, _, out = served
    cfg = sched.eng.cfg
    steps = [s["id"] for s in out["spans"] if s["name"] in spans.STEPS]
    per = {}
    for name, step, t0, t1 in out["marks"]:
        assert t0 <= t1
        per.setdefault(step, {}).setdefault(name, 0)
        per[step][name] += 1
    # attention's gather once a layer, the routing twice (dispatch side
    # and combine side), the experts once
    want = {"attn.kv_read": cfg.n_layers, "moe.route": 2 * cfg.n_layers,
            "moe.experts": cfg.n_layers}
    assert sorted(per) == steps
    assert all(v == want for v in per.values())
    assert out["ring"] == {"capacity": 1 << 18, "lost": 0,
                           "records": len(steps) * (1 + 2 * sum(
                               want.values()))}


def test_fill_counter_equals_a_hand_count():
    """Two prompts of 7 and 3 tokens admitted together: the tick's one
    fused micro-step carries chunks of 6 and 2 (each prompt's last token
    goes through the combined step) at slot bucket 2 and sequence bucket
    8, so each of the 2 MoE layers routes 2 x 8 rows at capacity 16 x 2
    into 4 experts on each of 2 ranks."""
    cfg, s = _tiny_moe()
    assert (cfg.n_layers, cfg.moe.num_experts, cfg.moe.top_k, s["tp"]) == \
        (2, 4, 2, 2)
    tracer = spans.Tracer()
    eng = Engine(cfg, tf.init_params(cfg, seed=1, device="cpu"),
                 ServeConfig(batch=4, max_kv=64, eos_id=s["eos_id"],
                             mode="explicit", prefill_seq_buckets=(4, 8)),
                 tp=2, device="cpu")
    sched = Scheduler(eng, max_slots=4, prefill_chunk=3, fused_prefill=True,
                      trace=tracer)
    for rid, n in enumerate((7, 3)):
        sched.submit(Request(rid=rid, prompt=np.arange(1, n + 1,
                                                       dtype=np.int32),
                             max_new_tokens=2))
    sched.tick()
    (step,) = [x for x in tracer.spans if x["name"] == "prefill"]
    assert (step["b"], step["S"], step["rows"]) == (2, 8, 6 + 2)
    rows = 2 * 4 * 2 * (2 * 8 * 2)        # layers x experts x ep x capacity
    assert step["counts"] == {"moe.expert_rows": rows,
                              "moe.choices": 2 * 2}
    fill = spans.summary(tracer.export())["expert_fill"]
    assert fill == pytest.approx(100.0 * 8 * 2 * 2 / rows)


def test_step_rows_are_the_positions_carried(served):
    """Over a run served to the end, the steps' rows add up to every
    prompt token and every fed-back output token (each request's last
    one is never fed back): a fused micro-step's rows are its chunks."""
    _, sched, tracer, _ = served
    done = sched._done.values()
    want = sum(r["prompt_len"] + r["n_tokens"] - 1 for r in done)
    assert sum(s["rows"] for s in tracer.spans
               if s["name"] in spans.STEPS) == want
    assert any(s["name"] == "prefill" and s["rows"] > 1
               for s in tracer.spans)


def test_reset_forgets_everything():
    tracer = spans.Tracer()
    _serve(tracer, n_requests=1)
    assert tracer.spans
    tracer.reset()
    out = tracer.export()
    assert out["spans"] == [] and out["marks"] == []
    assert out["ring"]["records"] == 0


def test_records_past_the_capacity_are_lost_and_counted():
    tracer = spans.Tracer(capacity=20)
    _serve(tracer, n_requests=1)
    out = tracer.export()
    assert out["ring"]["records"] == 20 and out["ring"]["lost"] > 0
    assert out["marks"] is None
    with pytest.raises(RuntimeError, match="lost"):
        spans.summary(out)


# ---------------------------------------------------------------------------
# the export's reduction and clocks, on synthetic records
# ---------------------------------------------------------------------------
def _span(i, name, start, end, parent=None, **kw):
    return {"id": i, "name": name, "parent": parent, "start": start,
            "end": end, **kw}


def test_summary_on_synthetic_records():
    out = {"ring": {"lost": 0, "capacity": 8, "records": 0},
           "spans": [_span(0, "tick", 0, 100),
                     _span(1, "replay", 10, 20, 0, b=4, rows=3, counts={}),
                     _span(2, "prefill", 30, 60, 0, b=4, S=8, rows=10,
                           counts={"moe.expert_rows": 400,
                                   "moe.choices": 4}),
                     _span(3, "replay", 70, 90, 0, b=4, rows=4, counts={}),
                     _span(4, "tick", 200, 300)],
           "marks": [["attn.kv_read", 1, 0, 2_000_000],
                     ["attn.kv_read", 1, 3_000_000, 4_000_000],
                     ["attn.kv_read", 3, 0, 1_000_000],
                     ["moe.experts", 2, 0, 5_000_000]]}
    r = spans.summary(out)
    assert r["marks_ms"]["replay"] == {"attn.kv_read": 2.0}
    assert r["marks_ms"]["prefill"] == {"moe.experts": 5.0}
    assert r["spans_ms"]["prefill"] == pytest.approx(30e-6)
    assert r["spans"] == {"tick": 2, "replay": 2, "prefill": 1}
    assert r["expert_fill"] == pytest.approx(100.0 * 10 * 4 / 400)
    # a window that holds the second replay alone
    w = spans.summary(out, start_ns=65, end_ns=100)
    assert w["marks_ms"]["replay"] == {"attn.kv_read": 1.0}
    assert w["expert_fill"] is None
    out["ring"]["lost"] = 3
    with pytest.raises(RuntimeError, match="lost"):
        spans.summary(out)


def test_pairing_refuses_what_does_not_pair():
    names = list(spans.MARKS)
    b, kv = names.index("step.begin"), names.index("attn.kv_read")
    ok = np.array([[b, 0], [kv, 1], [kv, 3], [b, 5], [kv, 6], [kv, 9]])

    def shift(t):
        return t + 100

    # a region starts where it is put and lasts as long as on the device
    assert spans._pair(ok, names, [7, 8], shift) == [
        ["attn.kv_read", 7, 101, 103], ["attn.kv_read", 8, 106, 109]]
    with pytest.raises(RuntimeError, match="never closed"):
        spans._pair(ok[:5], names, [7, 8], shift)
    with pytest.raises(RuntimeError, match="began 2 steps"):
        spans._pair(ok, names, [7, 8, 9], shift)
    with pytest.raises(RuntimeError, match="more steps"):
        spans._pair(ok, names, [7], shift)


def test_host_clock_fit_on_synthetic_records():
    """The host offset from the profile's ticks (uneven, as a decode tick
    and a prefill tick are), each range's ends against its copy."""
    host_off = 1_000_000_000_000
    starts = [0, 3_000_000, 11_000_000, 12_500_000, 30_000_000]
    mine = [_span(i, "tick", t, t + 1_000_000) for i, t in
            enumerate(starts)]
    events = [("serve.tick", s["start"] + host_off + 700,
               s["end"] + host_off - 900, False) for s in mine[1:4]]
    off, clock = spans._host_offset(mine, events)
    # the median of both ends' differences (+700 and -900 each)
    assert off == host_off - 100
    assert clock["host_fit"] == "profile"
    assert clock["host_spans_profiled"] == 3
    assert clock["host_residual_ns"]["max"] == 800
    assert clock["host_spans_within_20us"] == 3
    # no profile: Unix time
    off, clock = spans._host_offset(mine, [])
    assert clock["host_fit"] == "realtime"


def test_device_clock_fit_on_synthetic_records():
    """Stamps 1-40 us apart on the device; the profile's clock runs 250
    ppm fast, jumps back 780 us a third of the way in (a re-sync), and
    drops a run of 30 records; the probe is 1 ms off. Every profiled
    stamp is paired with its record and lands within 2 us of it."""
    rng = np.random.default_rng(0)
    g = 5_000_000 + np.cumsum(rng.integers(1_000, 40_000, 3_000))
    recs = g.astype(np.int64)
    off = 123_456_789
    prof = off + g + ((g - g[0]) * 2.5e-4).astype(np.int64)
    third = len(g) // 3
    prof[third:] -= 780_000
    keep = np.ones(len(g), bool)
    keep[2_000:2_030] = False
    clock = {}
    convert = spans._device_map(recs, prof[keep], off + 1_000_000, clock)
    assert clock["device_fit"] == "profile"
    assert clock["device_clock_jumps"] == 1
    assert clock["device_stamps_profiled"] == keep.sum()
    assert clock["device_stamps_within_2us"] == keep.sum()
    assert np.abs(convert(g[keep]) - prof[keep]).max() <= 2_000
    # a probe 20 ms off: the search widens
    clock = {}
    spans._device_map(recs, prof[keep], off + 20_000_000, clock)
    assert clock["device_stamps_within_2us"] == keep.sum()
    # a reading past the profile keeps the last piece's offset
    assert convert(g[-1:] + 10**9)[0] == prof[-1] + 10**9
    # no stamp in the profile: the probe's guess
    clock = {}
    assert spans._device_map(recs, np.zeros(0, np.int64), 7, clock)(
        np.array([5]))[0] == 12
    assert clock["device_fit"] == "probe"
