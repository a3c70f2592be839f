"""The port's serving stack (``repro_torch.serve.{scheduler,router,
loadgen}``) against the reference's on the reference test's trace, then
its own invariants, on the CPU:

* the reference's headline run (tests/test_scheduler.py): a seeded
  Poisson/Zipf trace (seed 3, 14 requests, every third at T = 0.8)
  through 2 explicit replicas × TP 2 built from one exported plan set —
  the port's streams token-equal to the reference router's (a
  temperature stream may part at a counted near-tie of the perturbed
  logits, as tests/test_torch_sampling.py counts them), the same
  ``routed`` map, and equal ``metrics()`` where every stream is equal;
* scheduler == sequential (dense, MoE and hybrid; token-by-token and
  fused prefill; f32 and the int8 cache), prefix cache == cold,
  explicit == auto, async == sync;
* the port's ``synth_trace`` equal to the reference's for three seeds,
  the vectorised temperature draw bit-equal to the row-by-row one;
* ``queue_limit`` backpressure, clock and submit validation, a plan set
  exported without the sequence buckets rejected, a replaced cache leaf
  refused, and the report surface the router aggregates.
"""
import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from benchmarks import loadgen as ref_loadgen
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.router import build_replicas as ref_build_replicas
from repro_torch import configs
from repro_torch.core import comm as comm_lib
from repro_torch.distributed import step as step_mod
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.serve import loadgen, sampling
from repro_torch.serve.engine import Engine, ServeConfig, _check_plan_set
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.router import Router, build_replicas
from repro_torch.serve.scheduler import (AsyncServeEngine, Request,
                                         Scheduler)

torch.set_num_threads(1)

TP, BATCH, MAX_KV = 2, 4, 64
# tests/test_torch_sampling.py's margin: torch's and XLA's f32 logs differ
# in the last place, so two perturbed logits this close may order apart
NEAR_TIE = 1e-5
TRAFFIC = dict(seed=3, n_requests=14, rate_rps=5.0, max_prompt=10,
               max_new=6, step_s=0.05)


def _hot(trace, temperature=0.8):
    """Every third request at a temperature, as the reference test."""
    return [dataclasses.replace(r, temperature=temperature)
            if i % 3 == 2 else r for i, r in enumerate(trace)]


def _cfg(arch="qwen3-1.7b", **kw):
    return dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               **kw)


# ---------------------------------------------------------------------------
# the reference's run and the port's, on the same trace and weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    cfg = ref_loadgen._serve_model()
    scfg = RefServeConfig(batch=BATCH, max_kv=MAX_KV, mode="explicit")
    router = ref_build_replicas(cfg, scfg, n_replicas=2, tp=TP,
                                plan_dir=tmp_path_factory.mktemp("ref_plans"),
                                mode="explicit")
    trace = _hot(ref_loadgen.synth_trace(
        ref_loadgen.TrafficConfig(**TRAFFIC), cfg.vocab))
    ref_loadgen.run_load(router, trace, step_s=TRAFFIC["step_s"])
    mesh = Mesh(np.asarray(jax.devices()[:TP]).reshape(1, TP),
                ("data", "model"))
    params = ref_step.init_sharded(cfg, mesh, ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    return dict(streams=dict(router.streams), metrics=router.metrics(),
                routed=dict(router.routed), trace=trace,
                params=jax.tree.map(np.asarray, params))


class _Recording(Scheduler):
    """A Scheduler that keeps every sampled row's logits by (rid,
    tokens emitted before it), to read a parted stream's logits."""

    rows: dict = {}

    def _sample(self, logits, rows):
        for i, s in rows:
            self.rows[(s.req.rid, s.emitted)] = logits[i].clone()
        return super()._sample(logits, rows)


@pytest.fixture(scope="module")
def port_run(ref_run, tmp_path_factory):
    cfg = _cfg()
    params = params_from_jax(ref_run["params"], cfg, device="cpu")
    plan_dir = tmp_path_factory.mktemp("port_plans")
    scfg = ServeConfig(batch=BATCH, max_kv=MAX_KV, mode="explicit")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("repro_torch.serve.router.Scheduler", _Recording)
        router = build_replicas(cfg, scfg, n_replicas=2, tp=TP,
                                plan_dir=plan_dir, params=params,
                                mode="explicit", device="cpu")
    trace = _hot(loadgen.synth_trace(loadgen.TrafficConfig(**TRAFFIC),
                                     cfg.vocab))
    hits_before = [dict(r.eng.decode_plans["layer_allreduce"].hits)
                   for r in router.replicas]
    infos = loadgen.run_load(router, trace, step_s=TRAFFIC["step_s"])
    base = build_replicas(cfg, scfg, n_replicas=1, tp=TP, plan_dir=plan_dir,
                          params=params, mode="explicit", device="cpu")
    base_streams = loadgen.sequential_baseline(base.replicas[0], trace,
                                               step_s=TRAFFIC["step_s"])
    return dict(router=router, trace=trace, infos=infos, base=base_streams,
                hits_before=hits_before, plan_dir=plan_dir, scfg=scfg,
                params=params, rows=dict(_Recording.rows))


def _near_tie(row, req, t):
    """Whether the reference's perturbed logits at the parting step have
    their top two within NEAR_TIE (the draw is then the logs' last
    place)."""
    key = jax.random.fold_in(jax.random.key(req.seed), t)
    logits = row.numpy() / np.float32(req.temperature)
    perturbed = logits + np.asarray(jax.random.gumbel(key, logits.shape))
    top2 = np.sort(perturbed)[-2:]
    return top2[1] - top2[0] <= NEAR_TIE


def test_streams_match_reference(ref_run, port_run):
    """Every greedy stream token-equal to the reference router's; a
    temperature stream may part only at a counted near-tie."""
    streams = port_run["router"].streams
    near_ties = 0
    for req in port_run["trace"]:
        got, want = streams[req.rid], ref_run["streams"][req.rid]
        if got == want:
            continue
        assert req.temperature > 0, f"greedy request {req.rid} parted"
        t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        assert _near_tie(port_run["rows"][(req.rid, t)], req, t), \
            f"request {req.rid} parted at token {t} outside a near-tie"
        near_ties += 1
    assert near_ties <= 1, near_ties


def test_routing_and_metrics_match_reference(ref_run, port_run):
    router = port_run["router"]
    assert router.routed == ref_run["routed"]
    assert set(router.routed.values()) == {0, 1}
    if router.streams == ref_run["streams"]:
        m, want = router.metrics(), ref_run["metrics"]
        assert m == want


def test_trace_matches_reference(ref_run, port_run):
    for got, want in zip(port_run["trace"], ref_run["trace"]):
        assert (got.rid, got.max_new_tokens, got.arrival_s, got.temperature,
                got.seed) == (want.rid, want.max_new_tokens, want.arrival_s,
                              want.temperature, want.seed)
        np.testing.assert_array_equal(got.prompt, want.prompt)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synth_trace_matches_reference(seed):
    kw = dict(seed=seed, n_requests=12, rate_rps=3.0, max_prompt=40,
              max_new=9, temperature=0.5, prefix_pool=3, prefix_len=5)
    got = loadgen.synth_trace(loadgen.TrafficConfig(**kw), 512)
    want = ref_loadgen.synth_trace(ref_loadgen.TrafficConfig(**kw), 512)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for k in ("rid", "max_new_tokens", "arrival_s", "temperature",
                  "seed"):
            assert getattr(a, k) == getattr(b, k)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_streams_equal_sequential(port_run):
    """Continuous batching, chunked prefill, compaction, bucket switching
    and routing change no token against each request run alone."""
    m = port_run["router"].metrics()
    assert m["completed"] == len(port_run["trace"]) and m["dropped"] == 0
    assert m["outstanding"] == 0
    for req in port_run["trace"]:
        assert port_run["router"].streams[req.rid] == \
            port_run["base"][req.rid]


def test_bucket_ladder_and_hits(port_run):
    ladder = step_mod.slot_buckets(BATCH)
    for info in port_run["infos"]:
        assert info.bucket in (0, *ladder)
    m = port_run["router"].metrics()
    assert set(m["bucket_steps"]) <= set(ladder)
    for i, r in enumerate(port_run["router"].replicas):
        fam = r.eng.decode_plans["layer_allreduce"]
        before = port_run["hits_before"][i]
        assert all(fam.hits[b] >= n for b, n in before.items())
        assert sum(fam.hits.values()) > sum(before.values())


def test_router_report_surface(port_run):
    """The reference's report keys: modes, requested modes, an empty
    ``degraded`` list and the summed guardrail counters, all at 0."""
    rep = port_run["router"].plan_report()
    assert rep["modes"] == rep["requested_modes"] == ["explicit"] * 2
    assert rep["degraded"] == []
    for k in ("retries", "fallbacks", "faults_detected", "timeouts"):
        assert rep["health"][k] == 0
    per = [r["health"] for r in rep["replicas"]]
    for k, v in rep["health"].items():
        assert v == sum(h[k] for h in per)
    sched = rep["replicas"][0]["scheduler"]
    assert sched["graphs"] == {} and sched["fused_prefill"] is False


def test_async_streaming_matches_sync(port_run):
    cfg, scfg = _cfg(), port_run["scfg"]
    base = build_replicas(cfg, scfg, n_replicas=1, tp=TP,
                          plan_dir=port_run["plan_dir"],
                          params=port_run["params"], mode="explicit",
                          device="cpu")
    eng = AsyncServeEngine(base.replicas[0], step_s=TRAFFIC["step_s"])
    trace = [dataclasses.replace(r, arrival_s=0.0)
             for r in port_run["trace"][:4]]

    async def collect(req):
        return [tok async for tok in eng.generate(req)]

    async def main():
        return await asyncio.gather(*(collect(r) for r in trace))

    for req, toks in zip(trace, asyncio.run(main())):
        assert toks == port_run["base"][req.rid]


def test_plan_set_without_seq_buckets_rejected(port_run, tmp_path):
    """A plan set exported without the prefill sequence buckets fails
    ``_check_plan_set`` and the engine, naming the missing bucket."""
    cfg = _cfg()
    plans = comm_lib.load_plan_set(port_run["plan_dir"], device="cpu")
    _check_plan_set(cfg, plans, tp=TP, batch_local=BATCH)
    with pytest.raises(ValueError, match="16-row bucket for prefill "
                                         "sequence bucket 4"):
        _check_plan_set(cfg, plans, tp=TP, batch_local=BATCH,
                        seq_buckets=(4, 8))
    # the engine rejects it as the reference's does: a warning naming
    # the bucket, then auto, counted as a fallback
    with pytest.warns(UserWarning, match="sequence bucket"):
        eng = Engine(cfg, port_run["params"], ServeConfig(
            batch=BATCH, max_kv=MAX_KV, prefill_seq_buckets=(4,)), tp=TP,
            device="cpu", mode="explicit", decode_plans=plans)
    assert (eng.mode, eng.requested_mode) == ("auto", "explicit")
    assert eng.health["fallbacks"] == 1 and eng.decode_plans == {}
    # the same set exported with them loads
    full = step_mod.compile_decode_plans(
        cfg, comm_lib.Communicator("model", n=TP, device="cpu"),
        batch_local=BATCH, tp=TP, seq_buckets=(4, 8))
    comm_lib.export_plan_set(full, tmp_path)
    _check_plan_set(cfg, comm_lib.load_plan_set(tmp_path, device="cpu"),
                    tp=TP, batch_local=BATCH, seq_buckets=(4, 8))


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------
def _engine(arch="qwen3-1.7b", mode="explicit", kv_quant=False,
            seq_buckets=None, max_kv=MAX_KV, tp=TP):
    cfg = _cfg(arch)
    params = tf.init_params(cfg, device="cpu", seed=1)
    return Engine(cfg, params, ServeConfig(
        batch=BATCH, max_kv=max_kv, mode=mode, kv_quant=kv_quant,
        prefill_seq_buckets=seq_buckets), tp=tp, device="cpu")


def _mixed_trace(vocab, *, seed=0, n=6, max_prompt=9, rid0=0):
    """Prompt lengths from 1 up past the chunk, every third request at a
    temperature, all arriving at 0 (the reference's fused-prefill
    trace)."""
    rng = np.random.default_rng(seed)
    trace = []
    for i in range(n):
        plen = [1, 2, max_prompt, 5, 3, max_prompt - 1][i % 6]
        trace.append(Request(
            rid=rid0 + i,
            prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 5)),
            temperature=0.8 if i % 3 == 2 else 0.0, seed=i))
    return trace


def _drain(eng, trace, **kw):
    sched = Scheduler(eng, **kw)
    for r in trace:
        sched.submit(r)
    sched.run_until_drained(step_s=0.05)
    return sched


@pytest.mark.parametrize("arch,mode,kv_quant", [
    ("qwen3-1.7b", "explicit", False), ("qwen3-1.7b", "auto", True),
    ("mixtral-8x22b", "explicit", False), ("hymba-1.5b", "explicit", False)])
def test_fused_and_batched_equal_sequential(arch, mode, kv_quant):
    """Fused prefill and token-by-token prefill, batched, against each
    request alone: every stream equal (f32)."""
    eng = _engine(arch, mode, kv_quant, seq_buckets=(4, 8))
    vocab = eng.cfg.vocab
    fused = _drain(eng, _mixed_trace(vocab), fused_prefill=True)
    assert fused.fused_prefill
    assert any(s > 1 for _, s in fused._prefill_bucket_steps)
    stepped = _drain(eng, _mixed_trace(vocab, rid0=100))
    alone = _drain(eng, [], max_slots=1)
    base = loadgen.sequential_baseline(alone, _mixed_trace(vocab, rid0=200),
                                       step_s=0.05)
    for i in range(6):
        assert fused.streams[i] == stepped.streams[100 + i] == base[200 + i]


def test_fused_prefill_across_ring_wrap():
    """Prompts longer than the window's ring: chunks cap at the ring's
    headroom, then the tail walks token by token."""
    eng = _engine("mixtral-8x22b", max_kv=8, seq_buckets=(4,))
    rng = np.random.default_rng(3)
    mk = [Request(rid=r, prompt=rng.integers(0, eng.cfg.vocab, 12).astype(
        np.int32), max_new_tokens=3) for r in range(2)]
    fused = _drain(eng, mk, fused_prefill=True)
    cold = _drain(eng, [dataclasses.replace(r, rid=r.rid + 10) for r in mk])
    for r in mk:
        assert fused.streams[r.rid] == cold.streams[r.rid + 10]


def test_explicit_equals_auto():
    trace = _mixed_trace(512, seed=4)
    ex = _drain(_engine(mode="explicit"), trace, fused_prefill=True)
    au = _drain(_engine(mode="auto"), trace, fused_prefill=True)
    assert ex.streams == au.streams
    assert ex.plan_report()["mode"] == "explicit"


@pytest.mark.parametrize("mode,kv_quant", [("explicit", False),
                                           ("auto", True)])
def test_prefix_cache_equals_cold(mode, kv_quant):
    """Shared-prefix traffic through a per-replica prefix cache (fused
    prefill on) emits the cold sequential streams, and hits."""
    eng = _engine(mode=mode, kv_quant=kv_quant, seq_buckets=(4, 8))
    tcfg = loadgen.TrafficConfig(seed=1, n_requests=12, prefix_pool=2,
                                 prefix_len=6, prefix_zipf_a=1.2,
                                 max_prompt=6, max_new=6, temperature=0.8)
    trace = loadgen.synth_trace(tcfg, eng.cfg.vocab)
    warm = Scheduler(eng, fused_prefill=True, prefix_cache=PrefixCache())
    loadgen.run_load(warm, trace, step_s=tcfg.step_s)
    cold = loadgen.sequential_baseline(Scheduler(eng), trace,
                                       step_s=tcfg.step_s)
    for r in trace:
        assert warm.streams[r.rid] == cold[r.rid]
    m = warm.metrics()
    assert m["prefix_hits"] > 0 and m["prefix_tokens_reused"] > 0
    stats = warm.plan_report()["scheduler"]["prefix"]
    assert stats["inserts"] > 0 and stats["pinned"] == 0


def test_prefix_cache_segments_round_trip_bf16():
    """A bf16 cache row travels to the trie as its uint16 bits and comes
    back bit for bit (every rank's row seeded, rank 0's snapshot)."""
    cfg = _cfg(dtype="bfloat16")
    eng = Engine(cfg, tf.init_params(cfg, device="cpu", seed=2),
                 ServeConfig(batch=BATCH, max_kv=MAX_KV), tp=TP,
                 device="cpu", mode="explicit")
    sched = Scheduler(eng, prefix_cache=PrefixCache())
    prompt = np.arange(3, 12, dtype=np.int32)
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    sched.run_until_drained()
    k0 = sched.cache["k"][0]
    assert k0.dtype == torch.bfloat16
    # row 0 still holds the prompt's entries it was snapshotted with
    snap = k0[0, :, 0, :, :len(prompt)].clone()
    # a request with the same prompt: its zeroed row seeded from the trie
    sched.submit(Request(rid=1, prompt=prompt, max_new_tokens=1))
    sched._admit(sched.now)
    L = len(prompt) - 1
    for r in range(TP):
        assert torch.equal(k0[r, :, 0, :, :L], snap[:, :, :L])
        assert not k0[r, :, 0, :, L:].any()
    assert sched._slots[0].pos == L


def test_vectorised_draw_equals_row_by_row():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy((rng.randn(6, 997) * 3).astype(np.float32))
    keys = [sampling.fold_in(sampling.key(s), e)
            for s, e in ((0, 0), (1, 3), (2 ** 31 + 5, 1), (7, 0), (7, 1),
                         (3, 9))]
    temps = torch.tensor([0.8, 0.5, 1.3, 0.8, 0.8, 2.0])
    got = sampling.categorical_rows(keys, logits / temps[:, None])
    want = torch.stack([sampling.categorical(k, logits[i] / float(temps[i]))
                        for i, k in enumerate(keys)])
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="f32"):
        sampling.categorical_rows(keys, logits.bfloat16())
    with pytest.raises(ValueError, match="keys"):
        sampling.categorical_rows(keys[:2], logits)


def test_replaced_cache_leaf_raises():
    eng = _engine(mode="auto")
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, prompt=np.asarray([1, 2], np.int32),
                         max_new_tokens=4))
    sched.tick()
    sched.cache["k"][0] = sched.cache["k"][0].clone()
    with pytest.raises(RuntimeError, match="replaced"):
        sched.tick()


def test_scheduler_serves_from_the_engine_cache():
    """One cache a replica: the scheduler's leaves are views of the
    engine's first ``max_slots`` rows; while a scheduler serves from it
    the engine does not step, a newer scheduler on the same engine takes
    the cache over (the older one raises), and once the scheduler is gone
    the engine steps again."""
    import gc
    eng = _engine(mode="explicit")
    sched = Scheduler(eng, max_slots=2)
    for name, leaves in sched.cache.items():
        for leaf, whole in zip(leaves, eng.cache[name]):
            assert leaf.data_ptr() == whole.data_ptr()
            axis = whole.dim() - (3 if name == "ssm" else 4)
            assert leaf.shape[axis] == 2 and whole.shape[axis] == BATCH
    prompts = np.zeros((BATCH, 1), np.int32)
    with pytest.raises(RuntimeError, match="Scheduler serves"):
        eng.prefill(prompts)
    sched.submit(Request(rid=0, prompt=np.asarray([1, 2], np.int32),
                         max_new_tokens=2))
    sched.tick()
    assert eng.cache["k"][0].any()
    newer = Scheduler(eng)
    newer.submit(Request(rid=0, prompt=np.asarray([1], np.int32),
                         max_new_tokens=1))
    newer.tick()
    with pytest.raises(RuntimeError, match="another Scheduler"):
        sched.tick()
    del sched, newer
    gc.collect()
    assert eng.prefill(prompts).shape == (BATCH, eng.cfg.vocab)


def test_positions_checked_on_the_host():
    """An active slot past a global layer's cache raises before any step;
    the check never reaches the device."""
    eng = _engine(mode="auto", max_kv=8)
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32),
                         max_new_tokens=8))
    with pytest.raises(ValueError, match="max_kv=8"):
        sched.run_until_drained()


def test_submit_and_clock_validation():
    eng = _engine(mode="auto")
    sched = Scheduler(eng, max_slots=2)
    with pytest.raises(ValueError, match="empty prompt"):
        sched.submit(Request(rid=0, prompt=np.asarray([], np.int32),
                             max_new_tokens=1))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(Request(rid=0, prompt=np.asarray([1], np.int32),
                             max_new_tokens=0))
    sched.submit(Request(rid=0, prompt=np.asarray([1], np.int32),
                         max_new_tokens=1))
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(Request(rid=0, prompt=np.asarray([2], np.int32),
                             max_new_tokens=1))
    sched.advance(5.0)
    with pytest.raises(ValueError, match="backwards"):
        sched.tick(1.0)
    with pytest.raises(ValueError, match="max_slots"):
        Scheduler(eng, max_slots=BATCH + 1)
    with pytest.raises(ValueError, match="prefill_chunk"):
        Scheduler(eng, prefill_chunk=0)


def test_bounded_queue_backpressure():
    eng = _engine(mode="auto")
    with pytest.raises(ValueError, match="queue_limit"):
        Scheduler(eng, queue_limit=0)

    def req(rid):
        return Request(rid=rid, prompt=np.asarray([1, 2], np.int32),
                       max_new_tokens=1)

    sched = Scheduler(eng, max_slots=2, queue_limit=2)
    assert sched.submit(req(0)) is True
    assert sched.submit(req(1)) is True
    assert sched.submit(req(2)) is False
    assert sched.metrics()["rejected"] == 1
    assert 2 not in sched.streams
    router = Router([Scheduler(eng, max_slots=2, queue_limit=1)])
    assert router.submit(req(10)) == 0
    assert router.submit(req(11)) is None
    assert 10 in router.routed and 11 not in router.routed
    assert router.metrics()["rejected"] == 1


def test_chunked_prefill_never_stalls_decode():
    eng = _engine(mode="auto")
    sched = Scheduler(eng, max_slots=2, prefill_chunk=3)
    sched.submit(Request(rid=1, prompt=np.asarray([7], np.int32),
                         max_new_tokens=8))
    sched.submit(Request(rid=0, prompt=np.arange(1, 10, dtype=np.int32),
                         max_new_tokens=3))
    infos = []
    while sched.outstanding():
        infos.append(sched.tick())
        sched.advance(1.0)
    done = next(i for i, info in enumerate(infos)
                if any(e.rid == 1 and e.done for e in info.emissions))
    for info in infos[:done + 1]:
        assert any(e.rid == 1 for e in info.emissions)
        assert info.micro_steps <= sched.prefill_chunk - 1
    assert len(sched.streams[1]) == 8


def test_engine_report_surface():
    eng = _engine(mode="explicit", seq_buckets=(4, 8))
    rep = eng.plan_report()
    assert rep["requested_mode"] == rep["mode"] == "explicit"
    assert rep["degraded"] is False
    assert {k: rep["health"][k] for k in ("retries", "fallbacks",
                                          "faults_detected", "timeouts")} \
        == dict.fromkeys(("retries", "fallbacks", "faults_detected",
                          "timeouts"), 0)
    ladder = eng.decode_plans["layer_allreduce"].buckets
    assert ladder == step_mod.seq_bucket_rows(BATCH, (1, 2, 4), (4, 8))
