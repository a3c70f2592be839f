"""Chaos: the runtime fault classes against the port's serving guardrails
(``repro_torch.serve.engine`` / ``.scheduler``), each case of
``tests/test_chaos.py`` at TP 2 and 4 for the dense (the reference
test's own model) and int8-cache families (MoE and hybrid:
``tests/test_torch_chaos_families.py``; shared code:
``tests/_torch_chaos_common.py``).

Every recovered engine's greedy tokens equal the reference's clean auto
engine's on the same weights (carried across with ``params_from_jax``),
and its guardrail counters equal the reference engine's at the same TP
under the same ``FaultSpec``. Beyond the reference's cases: a
mid-stream scheduler
fallback on the reference scheduler test's model and trace; re-run
safety of a step that raised part-way (the hybrid SSM state, a wrapping
fused-prefill chunk on gemma3-reduced with a window of 4); the
failures that propagate with no counter moved (a kernel build failure,
a refused kernel launch, the capture's node check, a CUDA error, and on
the card every failure but an injected fault or a timeout); a timeout
while the card still runs the step; and a watchdog's abandoned worker
leaving the engine's cache bit-equal when it wakes."""
import dataclasses
import threading

import _torch_chaos_common as common
import jax
import numpy as np
import pytest
import torch
from _torch_chaos_common import (BATCH, COUNTERS, MAX_KV, TOKENS, TPS,
                                 _cfg, _decode, _engine, _params, _prompts,
                                 _same, _snapshot)
from jax.sharding import Mesh

from benchmarks import loadgen as ref_loadgen
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.router import build_replicas as ref_build_replicas
from repro_torch import configs
from repro_torch.core import faults
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step as step_mod
from repro_torch.distributed.step import CaptureError
from repro_torch.interop import params_from_jax
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
from repro_torch.mesh import RankAxis
from repro_torch.models import transformer as tf
from repro_torch.serve import loadgen
from repro_torch.serve.engine import (Engine, ServeConfig, StepHungError,
                                     unrecoverable)
from repro_torch.serve.router import Router
from repro_torch.serve.scheduler import Scheduler

torch.set_num_threads(1)

GRID = [(f, tp) for f in ("dense", "int8") for tp in TPS]


# ---------------------------------------------------------------------------
# the reference's cases, dense and int8 (MoE and hybrid:
# tests/test_torch_chaos_families.py), TP 2 and 4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,tp", GRID)
def test_guardrails_do_not_perturb_clean_decode(family, tp):
    common.guardrails_do_not_perturb_clean_decode(family, tp)


@pytest.mark.parametrize("family,tp", GRID)
def test_transient_failure_recovers_by_retry(family, tp):
    common.transient_failure_recovers_by_retry(family, tp)


@pytest.mark.parametrize("family,tp", GRID)
def test_persistent_failure_falls_back_to_auto(family, tp):
    common.persistent_failure_falls_back_to_auto(family, tp)


@pytest.mark.parametrize("family,tp", GRID)
def test_numeric_guard_detects_corruption(family, tp):
    common.numeric_guard_detects_corruption(family, tp)


@pytest.mark.parametrize("family,tp", GRID)
def test_watchdog_times_out_stalled_rank(family, tp):
    common.watchdog_times_out_stalled_rank(family, tp)


@pytest.mark.parametrize("tp", TPS)
def test_health_counters_in_plan_report(tp):
    eng = _engine("dense", tp, "explicit")
    health = eng.plan_report()["health"]
    for key in ("retries", "timeouts", "faults_detected", "fallbacks",
                "verified", "verify_failures", "recompiles"):
        assert key in health
    assert health["verified"] > 0      # init-compiled plans were verified


def test_fault_spec_validation():
    from repro_torch.core.algorithms import REGISTRY
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultSpec("melt_gpu")
    with pytest.raises(ValueError, match="runtime fault"):
        faults.inject_program(REGISTRY["allreduce_ring"](4),
                              faults.FaultSpec("fail_call"), 4)
    with pytest.raises(ValueError, match="static fault"):
        faults.FaultInjector(faults.FaultSpec("drop_put"))
    assert faults.active() is None


# ---------------------------------------------------------------------------
# failures that are never retried or fallen back from
# ---------------------------------------------------------------------------
class _Raise:
    """A stand-in injector raising ``exc`` at the ``at``-th executor call
    from its installation on (``every``: at each call from then on)."""

    def __init__(self, exc, at=1, every=False):
        self.exc, self.at, self.every, self.calls = exc, at, every, 0

    def on_execute(self, x):
        self.calls += 1
        if self.calls == self.at or (self.every and self.calls > self.at):
            raise self.exc
        return x


def _accelerator_error():
    cls = getattr(torch, "AcceleratorError", None)
    msg = "CUDA error: an illegal memory access was encountered"
    return cls(msg) if cls is not None else RuntimeError(msg)


UNRECOVERABLE = {
    "kernel_build": lambda: KernelBuildError("nvcc failed on executor.cu"),
    "kernel_launch": lambda: KernelLaunchError(
        "dsl_executor launch failed for 'allreduce_1pa' (n=2, groups=1): "
        "too many blocks in cooperative launch"),
    "capture_check": lambda: CaptureError(
        "the captured step holds 57 executor kernel nodes, 57 of them "
        "cooperative, and 0 traced nodes, for 58 launches"),
    "cuda_error": _accelerator_error,
}


@pytest.mark.parametrize("what", sorted(UNRECOVERABLE))
def test_unrecoverable_failures_propagate_from_engine(what, monkeypatch):
    eng = _engine("dense", 2, "explicit", guard_numerics=True,
                  plan_timeout_s=30.0)
    exc = UNRECOVERABLE[what]()
    assert unrecoverable(exc)
    monkeypatch.setattr(faults, "_ACTIVE", _Raise(exc))
    with pytest.raises(type(exc), match=str(exc)[:12]):
        _decode(eng)
    assert eng.mode == "explicit"
    assert all(eng.health[k] == 0 for k in COUNTERS)


@pytest.mark.parametrize("what", sorted(UNRECOVERABLE))
@pytest.mark.parametrize("fused", [False, True])
def test_unrecoverable_failures_propagate_from_scheduler(what, fused,
                                                         monkeypatch):
    cfg = _cfg("dense")
    eng = Engine(cfg, _params("dense", 2), ServeConfig(
        batch=BATCH, max_kv=MAX_KV, prefill_seq_buckets=(2,)), tp=2,
        device="cpu", mode="explicit")
    sched = Scheduler(eng, prefill_chunk=4, fused_prefill=fused)
    sched.submit(loadgen.Request(0, np.arange(1, 8, dtype=np.int32), 3))
    exc = UNRECOVERABLE[what]()
    monkeypatch.setattr(faults, "_ACTIVE", _Raise(exc))
    with pytest.raises(type(exc), match=str(exc)[:12]):
        sched.tick()
    assert sched.mode == eng.mode == "explicit"
    assert sched.plan_report()["degraded"] is False
    assert all(eng.health[k] == 0 for k in COUNTERS)


def test_non_fatal_runtime_errors_are_recoverable():
    assert not unrecoverable(faults.FaultInjected("x"))
    assert not unrecoverable(TimeoutError("decode step exceeded"))
    assert not unrecoverable(ValueError("bucket overflow"))
    assert unrecoverable(KernelLaunchError("dsl_executor launch failed"))
    assert unrecoverable(StepHungError("decode step exceeded"))
    assert unrecoverable(RuntimeError("CUDA error: misaligned address"))


@pytest.mark.parametrize("exc,ladder", [
    (faults.FaultInjected("injected"), True),
    (TimeoutError("decode step exceeded plan_timeout_s=1"), True),
    (RuntimeError("dsl_executor launch failed: too many blocks"), False),
    (ValueError("rows exceed the top bucket"), False),
    (NotImplementedError("no explicit path"), False),
    (torch.OutOfMemoryError("out of memory"), False),
])
def test_card_ladder_takes_only_faults_and_timeouts(exc, ladder):
    """On the card the ladder retries or falls back from an injected
    fault and a timeout only; every other failure is the port's own and
    propagates (on the CPU the reference's classes stay recoverable)."""
    assert unrecoverable(exc, torch.device("cuda", 0)) is not ladder
    assert unrecoverable(exc, "cuda") is not ladder
    assert not unrecoverable(exc, "cpu")


@pytest.mark.parametrize("tp", TPS)
def test_timeout_with_the_card_busy_raises(tp, monkeypatch):
    """A watched step that times out while its stream still has work
    queued (a hang on the card) raises StepHungError, counting the
    timeout and falling back from nothing: a fallback would queue behind
    the hung step."""
    eng = _engine("dense", tp, "explicit", plan_timeout_s=0.3)
    monkeypatch.setattr(Engine, "_card_busy", lambda self: True)
    with faults.inject(faults.FaultSpec("stall_rank", count=1,
                                        delay_s=1.5)):
        with pytest.raises(StepHungError, match="still running"):
            _decode(eng)
    assert unrecoverable(StepHungError("x"))
    assert eng.mode == "explicit" and eng.requested_mode == "explicit"
    assert eng.health == dict(retries=0, fallbacks=0, faults_detected=1,
                              timeouts=1)
    (worker,) = eng.abandoned
    worker.exception(timeout=30)            # let the stalled worker end


# ---------------------------------------------------------------------------
# re-run safety of a step that raised part-way
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp", TPS)
def test_hybrid_step_raising_after_a_layer_reruns_exactly(tp, monkeypatch):
    """A hybrid explicit step raising at its 4th executor call — past the
    first layer's SSM branch and its replay — leaves the recurrent state
    as it found it; the engine's retry then gives the clean run's
    tokens and cache."""
    clean = _engine("hybrid", tp, "explicit")
    clean_toks = _decode(clean)
    cfg = _cfg("hybrid")
    eng = _engine("hybrid", tp, "explicit")
    logits = eng.prefill(_prompts(cfg.vocab))
    state = _snapshot(eng.cache)
    inj = _Raise(faults.FaultInjected("mid-step"), at=4)
    monkeypatch.setattr(faults, "_ACTIVE", inj)
    with pytest.raises(faults.FaultInjected):
        eng._eager(torch.zeros(BATCH, dtype=torch.long), eng.pos)
    assert inj.calls == 4
    assert all(torch.equal(a, b) for a, b in zip(eng.cache["ssm"],
                                                 state["ssm"]))
    # through the ladder: the same fault once, retried
    monkeypatch.setattr(faults, "_ACTIVE",
                        _Raise(faults.FaultInjected("mid-step"), at=4))
    toks = eng.decode(logits, num_tokens=TOKENS)
    assert eng.health["retries"] == 1 and eng.mode == "explicit"
    np.testing.assert_array_equal(toks, clean_toks)
    assert _same(eng.cache, clean.cache)


@pytest.mark.parametrize("at", [1, 3, 6])
def test_wrapping_prefill_chunk_reruns_exactly(at, monkeypatch):
    """gemma3-reduced with a window of 4 (the windowed layers' ring is 4
    slots): a fused prefill chunk whose padded columns wrap the ring (a
    row at 2 with 2 tokens: slots 2, 3, 0, 1) beside a full ring (a row
    at 5 with 1 token), raising at executor call ``at`` and run again,
    leaves the cache bit-equal to one clean run."""
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config("gemma3-12b")), window=4)
    axis = RankAxis("model", 2, "cpu")
    params = tf.init_params(cfg, device="cpu", seed=3)
    step, layout = step_mod.make_prefill_sched_step(
        cfg, axis, batch=2, seq=4, max_kv=16, mode="explicit")
    p = layout.params(params)
    cache = layout.cache()
    gen = torch.Generator().manual_seed(0)
    for leaves in cache.values():
        for leaf in leaves:
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    tokens = torch.randint(0, cfg.vocab, (2, 4), generator=gen)
    pos, n_tok = torch.tensor([2, 5]), torch.tensor([2, 1])
    clean = _snapshot(cache)
    with torch.inference_mode():
        step(p, clean, tokens, pos, n_tok)
        inj = _Raise(faults.FaultInjected("mid-chunk"), at=at)
        monkeypatch.setattr(faults, "_ACTIVE", inj)
        with pytest.raises(faults.FaultInjected):
            step(p, cache, tokens, pos, n_tok)
        assert inj.calls == at
        monkeypatch.setattr(faults, "_ACTIVE", None)
        step(p, cache, tokens, pos, n_tok)
    assert _same(cache, clean)


# ---------------------------------------------------------------------------
# the layout conversion the fallback runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
@pytest.mark.parametrize("tp", TPS)
def test_auto_layout_inverts_the_explicit_one(family, tp):
    cfg = _cfg(family)
    params = tf.init_params(cfg, device="cpu", seed=1)
    axis = RankAxis("model", tp, "cpu")
    back = shd.auto_decode_params(shd.explicit_decode_params(params, cfg,
                                                             axis), cfg)

    def flat(t):
        if isinstance(t, torch.Tensor):
            return [t]
        return [y for v in (t.values() if isinstance(t, dict) else t)
                for y in flat(v)]

    assert len(flat(back)) == len(flat(params))
    assert all(torch.equal(a, b) for a, b in zip(flat(back), flat(params)))
    cache = tf.init_cache(cfg, BATCH, 8, device="cpu", ranks=tp)
    gen = torch.Generator().manual_seed(0)
    for name, leaves in cache.items():
        for leaf in leaves:
            val = torch.randn(leaf.shape[1:], generator=gen)
            if name == "ssm":
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
            else:
                leaf.copy_(val.expand(leaf.shape))
    auto = shd.auto_decode_cache(cache)
    want = tf.init_cache(cfg, BATCH, 8, device="cpu")
    for name, leaves in auto.items():
        for j, leaf in enumerate(leaves):
            assert leaf.shape == want[name][j].shape
            if name == "ssm":
                d = leaf.shape[-2] // tp
                for r in range(tp):
                    assert torch.equal(leaf[..., r * d:(r + 1) * d, :],
                                       cache[name][j][r])
            else:
                assert torch.equal(leaf, cache[name][j][0])
            assert leaf.data_ptr() != cache[name][j].data_ptr()


# ---------------------------------------------------------------------------
# the scheduler: a mid-stream fallback on the reference test's trace
# ---------------------------------------------------------------------------
SCHED_TP, SCHED_BATCH, SCHED_MAX_KV = 2, 4, 64
TRAFFIC = dict(seed=3, n_requests=14, rate_rps=5.0, max_prompt=10,
               max_new=6, step_s=0.05)


@pytest.fixture(scope="module")
def sched_reference(tmp_path_factory):
    """The reference scheduler's streams on tests/test_scheduler.py's
    model and trace (greedy), one explicit replica of TP 2."""
    cfg = ref_loadgen._serve_model()
    router = ref_build_replicas(
        cfg, RefServeConfig(batch=SCHED_BATCH, max_kv=SCHED_MAX_KV,
                            mode="explicit"),
        n_replicas=1, tp=SCHED_TP,
        plan_dir=tmp_path_factory.mktemp("ref_plans"), mode="explicit")
    trace = ref_loadgen.synth_trace(ref_loadgen.TrafficConfig(**TRAFFIC),
                                    cfg.vocab)
    ref_loadgen.run_load(router, trace, step_s=TRAFFIC["step_s"])
    mesh = Mesh(np.asarray(jax.devices()[:SCHED_TP]).reshape(1, SCHED_TP),
                ("data", "model"))
    params = ref_step.init_sharded(cfg, mesh, ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    return dict(streams=dict(router.streams),
                params=jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("fused", [False, True])
def test_scheduler_falls_back_mid_stream(sched_reference, fused):
    """A fault installed after 3 ticks fires in the next explicit step
    (a fused prefill step with ``fused``): the scheduler warns, counts a
    fallback, converts the engine's cache (its leaf pointers follow, so
    the check does not refuse the new ones) and re-runs the step on
    auto; every stream equals the reference scheduler's and the router
    names the replica in ``degraded``."""
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    params = params_from_jax(sched_reference["params"], cfg, device="cpu")
    eng = Engine(cfg, params, ServeConfig(
        batch=SCHED_BATCH, max_kv=SCHED_MAX_KV, mode="explicit",
        prefill_seq_buckets=(2, 4) if fused else None), tp=SCHED_TP,
        device="cpu")
    router = Router([Scheduler(eng, fused_prefill=fused)])
    trace = loadgen.synth_trace(loadgen.TrafficConfig(**TRAFFIC), cfg.vocab)
    old = [leaf.data_ptr() for v in eng.cache.values() for leaf in v]
    infos, held = [], []

    def tick():
        if len(infos) == 3:
            held.append(faults.install(faults.FaultSpec("fail_call")))
        infos.append(router.tick())
        return infos[-1]

    try:
        with pytest.warns(UserWarning, match="falling back to auto"):
            _drive(router, trace, tick)
    finally:
        faults.clear()
    assert held[0].fired == 1
    sched = router.replicas[0]
    assert sched.mode == eng.mode == "auto"
    assert eng.health["fallbacks"] == 1
    assert all(eng.health[k] == 0 for k in COUNTERS if k != "fallbacks")
    rep = router.plan_report()
    assert rep["degraded"] == [0] and rep["modes"] == ["auto"]
    new = [leaf.data_ptr() for v in eng.cache.values() for leaf in v]
    assert not set(new) & set(old), "the cache was not converted"
    m = router.metrics()
    assert m["completed"] == len(trace) and m["dropped"] == 0
    assert router.streams == sched_reference["streams"]


def _drive(router, trace, tick):
    """``loadgen.run_load`` with a tick hook."""
    from collections import deque
    pending = deque(sorted(trace, key=lambda r: (r.arrival_s, r.rid)))
    while pending or router.outstanding():
        while pending and pending[0].arrival_s <= router.now:
            router.submit(pending.popleft())
        if router.n_active == 0 and router.outstanding() == 0 and pending:
            router.advance_to(pending[0].arrival_s)
            continue
        info = tick()
        router.advance(TRAFFIC["step_s"] * (1 + info.micro_steps))


def test_failed_capture_takes_its_marks_back():
    """A shape first launched into a capture is marked (an explicit
    re-bind of it is refused while its graph lives); a capture that
    fails takes back the marks its own scope made, and only those: a
    capture in another thread, with a scope of its own, keeps its
    marks."""
    from repro_torch.core import algorithms
    from repro_torch.core import executor as ex
    a = ex.CudaExecutor(algorithms.REGISTRY["allreduce_1pa"](2))
    b = ex.CudaExecutor(algorithms.REGISTRY["allreduce_ring"](2))
    entered, failed = threading.Event(), threading.Event()

    def other_capture():
        with ex.capture_scope() as scope:
            for e in (a, b):
                e._captured.add("kept")
                scope.marks.append((e, "kept"))
            entered.set()
            failed.wait(timeout=30)       # still capturing meanwhile
        assert scope.marks == [(a, "kept"), (b, "kept")]

    worker = threading.Thread(target=other_capture)
    worker.start()
    assert entered.wait(timeout=30)
    assert getattr(ex._SCOPE, "scope", None) is None
    with ex.capture_scope() as scope:
        assert ex._SCOPE.scope is scope
        for e in (a, b):
            e._captured.add("failed")
            scope.marks.append((e, "failed"))
        scope.discard()
    failed.set()
    worker.join(timeout=30)
    assert getattr(ex._SCOPE, "scope", None) is None
    assert scope.marks == [] and scope.launches == 0
    assert a._captured == b._captured == {"kept"}
