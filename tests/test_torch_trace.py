"""The port's trace module (``repro_torch.core.trace``) against the
reference's: one JSON schema both ways, the same emission streams and
event DAGs from ``TorchExecutor`` as from ``XlaExecutor``, the same put
emissions and bytes from ``CudaExecutor`` as from ``PallasExecutor``
(the CUDA table's tags name every emission once a rank), traced plans
bit-equal to untraced ones, the collector, bucketed traces and the
engine's ``plan_report()["trace"]``."""
import numpy as np
import pytest
import torch

from repro.core import algorithms as ref_algos
from repro.core import passes as ref_passes
from repro.core import trace as ref_trace
from repro.core.executor import PallasExecutor, XlaExecutor
from repro_torch import configs
from repro_torch.core import algorithms as algos
from repro_torch.core import passes, simulate, trace
from repro_torch.core.comm import Communicator
from repro_torch.core.executor import CudaExecutor, TorchExecutor, encode
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

N = 8
CASES = [(name, lvl, n) for name in sorted(algos.REGISTRY)
         for lvl in (0, 2) for n in (2, 4, 8)]


def _x(n, rows, cols, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, rows, cols).astype(np.float32))


def _programs(name, lvl, n):
    ref = ref_passes.optimize(ref_algos.REGISTRY[name](n), lvl, n)
    port = passes.optimize(algos.REGISTRY[name](n), lvl, n)
    return ref, port


def _em(em, n):
    """An emission as plain data: every IndexExpr evaluated per rank."""
    def ev(e):
        return [e(r, n) for r in range(n)]
    return dict(
        iid=em.iid, sub=em.sub, op=em.op, lowered=em.lowered,
        round_id=em.round_id, shift=em.shift,
        puts=[(sb, ev(si), db, ev(di), ev(to))
              for (sb, si), (db, di), to in em.puts],
        waits=[(db, ev(di), ev(frm)) for (db, di), frm in em.waits],
        dst=None if em.dst is None else (em.dst[0], ev(em.dst[1])),
        srcs=[(b, ev(e)) for b, e in em.srcs])


def _dag(events):
    return [(e.iid, e.sub, e.op, e.lowered, e.rank, e.peer, e.round_id,
             e.chunks, e.bytes, e.wire_bytes, [tuple(d) for d in e.deps])
            for e in events]


def _small_trace(**kw):
    plan = Communicator("x", n=N, device="cpu", **kw).compile(
        "all_reduce", (16, 8), torch.float32, algo="allreduce_ring",
        opt_level=2)
    return trace.capture_plan(plan)


# ---------------------------------------------------------------------------
# schema: one format for both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_reference_trace_loads_and_reserialises(backend):
    t = ref_trace.capture(ref_algos.REGISTRY["allreduce_ring"](N), N,
                          rows=16, cols=8, backend=backend, opt_level=2)
    d = t.to_dict()
    back = trace.Trace.from_dict(d)
    assert back.to_dict() == d
    assert trace.Trace.from_json(t.to_json()).to_dict() == d
    assert simulate.replay(back).rel_err <= simulate.REPLAY_TOLERANCE


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_port_trace_loads_in_reference(backend):
    prog = algos.REGISTRY["allreduce_2pa"](4)
    if backend == "torch":
        t = trace.capture(prog, 4, rows=16, cols=8, opt_level=2)
    else:           # the CUDA executor's DAG, timed here by the model
        ex = CudaExecutor(passes.optimize(prog, 2, 4)).prepare(4)
        events, cb = trace.synthesize_events(ex, 4, 4, 8, "float32")
        trace.schedule(events, lambda ev: 1.0 + ev.bytes / 1e3)
        t = trace.Trace(name=prog.name, backend="cuda", n=4, shape=(16, 8),
                        rows_in=16, cols=8, dtype="float32", chunk_rows=4,
                        chunk_bytes=cb, events=events, span_us=max(
                            e.complete_us for e in events))
    d = t.to_dict()
    assert ref_trace.Trace.from_dict(d).to_dict() == d


def test_trace_save_load_roundtrip(tmp_path):
    t = _small_trace()
    p = tmp_path / "t.json"
    t.save(p)
    rt = trace.Trace.load(p)
    assert [e.to_dict() for e in rt.events] == [e.to_dict() for e in t.events]
    assert rt.device is None          # what a capture saw is not serialised


def test_trace_schema_rejections():
    good = _small_trace().to_dict()
    with pytest.raises(ValueError, match="no schema 'version'"):
        trace.Trace.from_dict({k: v for k, v in good.items()
                               if k != "version"})
    with pytest.raises(ValueError, match="unsupported trace schema"):
        trace.Trace.from_dict({**good, "version": 99})
    with pytest.raises(ValueError, match="kind"):
        trace.Trace.from_dict({**good, "kind": "plan"})
    with pytest.raises(ValueError, match="missing required field 'events'"):
        trace.Trace.from_dict({k: v for k, v in good.items()
                               if k != "events"})
    with pytest.raises(ValueError, match="unsupported trace dtype"):
        trace.synthesize_events(TorchExecutor(algos.REGISTRY["allreduce_1pa"](
            2)), 2, 1, 4, "float64")


# ---------------------------------------------------------------------------
# emission streams and event DAGs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,lvl,n", CASES)
def test_torch_emissions_equal_xla(name, lvl, n):
    ref, port = _programs(name, lvl, n)
    want = XlaExecutor(ref, "x", vectorize=lvl > 0).prepare(n)
    got = TorchExecutor(port, vectorize=lvl > 0).prepare(n)
    assert [_em(e, n) for e in got.trace_emissions(n)] == \
        [_em(e, n) for e in want.trace_emissions(n)]
    n_in = port.chunks[port.in_buffer]
    ref_events, ref_cb = ref_trace.synthesize_events(want, n, 2, 8, "float32")
    events, cb = trace.synthesize_events(got, n, 2, 8, "float32")
    assert cb == ref_cb and n_in == ref.chunks[ref.in_buffer]
    assert _dag(events) == _dag(ref_events)


_PALLAS_NAMES = {"dma_slab": "put_slab", "dma": "put"}


@pytest.mark.parametrize("name,lvl,n", CASES)
def test_cuda_emissions_match_pallas_and_table(name, lvl, n):
    ref, port = _programs(name, lvl, n)
    pallas = PallasExecutor(ref, "x").prepare(n).trace_emissions(n)
    cuda_ex = CudaExecutor(port).prepare(n)
    cuda = cuda_ex.trace_emissions(n)
    puts = [dict(_em(e, n), lowered=_PALLAS_NAMES[e.lowered])
            for e in pallas if e.op == "put"]
    assert [_em(e, n) for e in cuda if e.op == "put"] == puts
    # the same bytes a rank, through the two DAGs
    for dtype in ("float32", "bfloat16"):
        got, _ = trace.synthesize_events(cuda_ex, n, 3, 8, dtype)
        want, _ = ref_trace.synthesize_events(
            PallasExecutor(ref, "x").prepare(n), n, 3, 8,
            "float32" if dtype == "float32" else "float16")
        for r in range(n):
            assert sum(e.bytes for e in got if e.op == "put"
                       and e.rank == r) == \
                sum(e.bytes for e in want if e.op == "put" and e.rank == r)
    # every rank's table rows run every emission exactly once, each
    # wait emission one flag slot
    enc = encode(port, n)
    ids = sorted((e.iid, e.sub) for e in cuda)
    opcodes = {(e.iid, e.sub): e.op for e in cuda}
    for r in range(n):
        tags = [tuple(t) for t in enc.tags[r].tolist() if t[0] >= 0]
        assert sorted(tags) == ids
        for (iid, sub), row in zip(enc.tags[r].tolist(), enc.ops[r]):
            if iid >= 0 and opcodes[(iid, sub)] == "wait":
                assert row[0] == 2


class _WaitsOnly:
    """An executor whose stream is a program's first wait alone."""

    def __init__(self, prog):
        self.program = prog
        self._ems = [e for e in TorchExecutor(prog).trace_emissions(2)
                     if e.op == "wait"][:1]

    def trace_emissions(self, n):
        return self._ems


def test_emulation_rejects_wait_before_put():
    with pytest.raises(ValueError, match="no preceding put"):
        trace.synthesize_events(
            _WaitsOnly(algos.REGISTRY["allreduce_ring"](2)), 2, 1, 4,
            "float32")


# ---------------------------------------------------------------------------
# capture surfaces
# ---------------------------------------------------------------------------
def test_traced_plan_output_identical_and_records_once():
    x = _x(N, 16, 32, seed=1)
    on = Communicator("x", n=N, device="cpu", trace=True).compile(
        "all_reduce", (16, 32), torch.float32)
    off = Communicator("x", n=N, device="cpu").compile(
        "all_reduce", (16, 32), torch.float32)
    assert torch.equal(on(x), off(x))
    first = on.last_trace
    assert first is not None and off.last_trace is None
    assert first.backend == "torch" and first.n == N and first.span_us > 0
    on(x)
    assert on.last_trace is first                 # the first call records
    again = on.capture_trace(x)                   # an explicit capture
    assert on.last_trace is again and again is not first
    pairs = [(e.iid, e.sub) for e in first.events]
    assert pairs == sorted(pairs)


def test_collect_records_each_executor_call():
    plan = Communicator("x", n=N, device="cpu").compile(
        "all_gather", (4, 8), torch.float32)
    x = _x(N, 4, 8)
    assert trace.active() is None
    with trace.collect() as col:
        plan(x)
        plan(x)
    assert trace.active() is None
    assert len(col.traces) == 2
    assert all(t.backend == "torch" and t.n == N for t in col.traces)
    put_ids = {(e.iid, e.sub, e.rank) for e in col.traces[0].events
               if e.op == "put"}
    for e in col.traces[0].events:
        if e.op == "wait":
            assert e.deps and all(tuple(d) in put_ids for d in e.deps)


def test_bucketed_plan_last_traces():
    fam = Communicator("x", n=N, device="cpu", trace=True).plan_for(
        "all_reduce", (16, 32), torch.float32, buckets=(8, 16))
    fam(_x(N, 16, 32))
    assert fam.last_trace is not None
    traces = fam.last_traces()
    assert set(traces) == {8, 16}
    assert traces[16] is fam.last_trace and traces[8] is None


def test_engine_plan_report_trace():
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    assert ServeConfig().trace is False
    eng = Engine(cfg, tf.init_params(cfg, device="cpu"),
                 ServeConfig(batch=4, max_kv=16, trace=True), tp=2,
                 device="cpu", mode="explicit")
    assert eng.comm.trace is True
    report = eng.plan_report()
    assert report["trace"] == {name: None for name in eng.decode_plans}
    logits = eng.prefill(np.zeros((4, 2), np.int32))
    eng.decode(logits, num_tokens=1)
    report = eng.plan_report()
    assert set(report["trace"]) == set(eng.decode_plans)
    summ = report["trace"]["layer_allreduce"]
    assert summ["events"] > 0 and summ["span_us"] > 0
    assert summ["backend"] == "torch" and summ["n"] == 2


def test_capture_refuses_a_group_view():
    plan = Communicator("x", n=2, device="cpu").compile(
        "all_reduce", (4, 8), torch.float32, groups=2)
    with pytest.raises(ValueError, match="one group"):
        trace.capture_plan(plan)


class _StampedExecutor:
    """A stand-in for ``CudaExecutor`` on the CPU: the real encoded table
    and emissions, and a traced launch that returns planted stamps (op
    ``i`` of block ``b`` starts at ``1000 i + 10 b`` ns and ends 400 ns
    later; ``clock64()`` counts 2 cycles a ns from an offset a block)."""

    NB = 2

    def __init__(self, prog, n):
        self._ex = CudaExecutor(prog).prepare(n)
        self.program, self.encoded = self._ex.program, self._ex.encoded
        self.launches = 0

    def trace_emissions(self, n):
        return self._ex.trace_emissions(n)

    def launch_traced(self, x):
        self.launches += 1
        n, ops = self.encoded.n, self.encoded.ops.shape[1]
        b = np.arange(n * self.NB)[:, None]
        i = np.arange(ops)[None, :]
        start = 5_000_000 + 1000 * i + 10 * b
        st = np.stack([start, start + 400, 2 * (start - 5_000_000) + 7 * b,
                       2 * (start + 400 - 5_000_000) + 7 * b], axis=-1)
        return None, torch.from_numpy(st.astype(np.int64))


@pytest.mark.parametrize("name,lvl", [("allreduce_1pa", 2), ("allreduce_ring",
                                                             0)])
def test_device_timeline_from_planted_stamps(monkeypatch, name, lvl):
    """The card's timeline from stamps (no card here): each rank's event
    spans its blocks' earliest start to latest end, a wait is blocked
    until its latest dep put completes, and both timers read alike."""
    from repro_torch.core import executor as executor_mod
    monkeypatch.setattr(executor_mod, "device_timer", lambda device=None: dict(
        tick_ns=32, cycles_per_ns=2.0, probe_ns=2_000_000, changes=1))
    n = 2
    prog = passes.optimize(algos.REGISTRY[name](n), lvl, n)
    ex = _StampedExecutor(prog, n)
    x = torch.zeros((n, 8 * prog.chunks[prog.in_buffer], 4))
    events, span, info = trace._device_timeline(ex, x)
    assert ex.launches == trace._CAPTURE_REPEATS
    assert info["stamp_tick_ns"] == 10 and info["tick_ns"] == 32
    assert info["timer"] == "globaltimer"
    nb, ops = _StampedExecutor.NB, ex.encoded.ops.shape[1]
    assert span == pytest.approx((1000 * (ops - 1) + 10 * (n * nb - 1)
                                  + 400) / 1e3)
    row = {}
    for r in range(n):
        for i, (iid, sub) in enumerate(ex.encoded.tags[r].tolist()):
            if iid >= 0:
                row[(iid, sub, r)] = i
    by_id = {(e.iid, e.sub, e.rank): e for e in events}
    for ev in events:
        i = row[(ev.iid, ev.sub, ev.rank)]
        issue = (1000 * i + 10 * ev.rank * nb) / 1e3
        end = (1000 * i + 10 * (ev.rank * nb + nb - 1) + 400) / 1e3
        assert ev.issue_us == pytest.approx(issue)
        ready = max((by_id[tuple(d)].complete_us for d in ev.deps),
                    default=0.0)
        blocked = max(0.0, ready - issue) if ev.op == "wait" else 0.0
        service = end - issue - min(blocked, end - issue)
        assert ev.blocked_us == pytest.approx(blocked)
        assert ev.complete_us == pytest.approx(issue + blocked + service)
        assert ev.complete_us >= max(ev.issue_us, ready)
    # the clock64 reading, anchored at each block's first global stamp,
    # gives the same times
    start, end = trace._stamp_times(info["stamps"], "clock64", 2.0)
    g_start, g_end = trace._stamp_times(info["stamps"], "globaltimer", 2.0)
    np.testing.assert_allclose(start, g_start)
    np.testing.assert_allclose(end, g_end)
