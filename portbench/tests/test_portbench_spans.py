"""The serving tracer's device marks (``repro_torch.core.spans``) on the
card, on the tiny MoE cell's configuration: a graph captured under a
tracer holds the untraced graph's nodes plus one stamp node a mark,
every replay advances the ring's cursor by its marks, and a profiled
run puts the marks and the host spans on the profile's clock."""
import json

import numpy as np
import pytest
import torch

from portbench_helpers import DATA


def _scheduler(device, trace=None):
    from harness import serving
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Scheduler
    config = json.loads((DATA / "configs" / "tiny-moe.json").read_text())
    cfg, s = serving.model_config(config), config["serving"]
    eng = Engine(cfg, tf.init_params(cfg, seed=0, device=device),
                 ServeConfig(batch=s["slots"], max_kv=s["max_kv"],
                             eos_id=s["eos_id"], mode=s["mode"],
                             prefill_seq_buckets=tuple(
                                 s["prefill_seq_buckets"])),
                 tp=s["tp"], device=device)
    return Scheduler(eng, max_slots=s["slots"],
                     prefill_chunk=s["prefill_chunk"], fused_prefill=True,
                     trace=trace)


def _marks_a_step(sched) -> int:
    """step.begin, then a begin and an end of each layer's attention
    gather, its two routing regions and its experts."""
    return 1 + 2 * 4 * sched.eng.cfg.n_layers


@pytest.mark.card
def test_traced_graph_is_the_untraced_graph_plus_stamps(card):
    from repro_torch.core import spans
    plain = _scheduler(card)
    traced = _scheduler(card, spans.Tracer())
    assert sorted(plain.graphs) == sorted(traced.graphs)
    for b in plain.graphs:
        a = spans.graph_nodes(plain.graphs[b].graph)
        t = spans.graph_nodes(traced.graphs[b].graph)
        assert not a[:, 1].any()
        assert int(t[:, 1].sum()) == _marks_a_step(traced)
        keep = t[:, 1] == 0
        # node types, kernels, grids, blocks and shared memory, in order
        np.testing.assert_array_equal(t[keep][:, [0, 2, 3, 4, 5]],
                                      a[:, [0, 2, 3, 4, 5]])
        assert traced.graphs[b].launches == plain.graphs[b].launches


@pytest.mark.card
def test_each_replay_advances_the_cursor_by_its_marks(card):
    from repro_torch.core import spans
    tracer = spans.Tracer(capacity=4096)
    sched = _scheduler(card, tracer)
    tracer.reset()
    per = _marks_a_step(sched)
    for n, b in enumerate(sched._buckets * 2, start=1):
        sched.run_step(b, torch.zeros((3, b), dtype=torch.long))
        torch.cuda.synchronize(card)
        assert int(tracer._cursor.item()) == n * per
    out = tracer.export()
    assert out["ring"] == {"capacity": 4096, "records": n * per, "lost": 0}
    assert len(out["marks"]) == n * (per - 1) // 2
    assert all(t0 < t1 for _, _, t0, t1 in out["marks"])


@pytest.mark.card
def test_a_profiled_run_puts_marks_and_spans_on_one_clock(card):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spans
    from repro_torch.serve.scheduler import Request
    tracer = spans.Tracer()
    sched = _scheduler(card, tracer)
    rng = np.random.default_rng(0)
    for rid in range(6):
        sched.submit(Request(rid=rid, prompt=rng.integers(
            0, 128, int(rng.integers(20, 50))).astype(np.int32),
            max_new_tokens=8))
    sched.tick()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(6):
            sched.tick()
        torch.cuda.synchronize(card)
    out = tracer.export(prof)
    c = out["clock"]
    print(c)
    assert c["host_fit"] == "profile" and c["device_fit"] == "profile", c
    assert c["host_residual_ns"]["p50"] <= 20_000, c
    assert c["device_residual_ns"]["max"] <= 2_000, c
    assert c["device_stamps_paired"] >= 0.9 * c["device_stamps_profiled"], c
    assert c["device_stamps_profiled"] > 0, c
    assert spans.summary(out)["marks_ms"]["prefill"]["moe.experts"] > 0
