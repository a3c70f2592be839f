"""The port's rwkv6 family (``repro_torch.models.rwkv6`` and its branches
of ``models/transformer.py``) against the reference's on rwkv6-reduced
(d 128, 2 heads of 64, 2 layers, vocab 512, f32), the reference's own
weights carried across with ``params_from_jax`` and inputs and states
from a numpy seed: the time mix, the channel mix and the layer's decode
step (output and state), the forward's logits, greedy decode over 8
steps (tokens equal, logits and the cache within the bar), the serving
``Engine`` (auto equal to the reference engine's; explicit warns and
serves auto, as the reference's does) and the ``Scheduler`` (streams
equal to the reference scheduler's and to the sequential run's, no
prefix cache). Then the port's own invariants: decode == forward, an
inactive row's state bit for bit, the cache converters, the WKV loop
under autograd, the launchers, and the refusals that stay (explicit
decode, decode plans, fused prefill). Last, one batch-axis rule for every
family's cache leaves.

The frameworks' f32 ``exp`` and matmul sums differ in the last place, so
the port is held to the reference within f32 1e-5, not bit for bit."""
import contextlib
import dataclasses
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from benchmarks import loadgen as ref_loadgen
from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.models import rwkv6 as ref_rwkv6
from repro.models import transformer as ref_tf
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.scheduler import Scheduler as RefScheduler
from repro_torch import configs
from repro_torch.core.comm import Communicator
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step as step_mod
from repro_torch.interop import (params_from_jax, rwkv_state_from_jax,
                                 rwkv_state_to_jax)
from repro_torch.mesh import RankAxis
from repro_torch.models import rwkv6
from repro_torch.models import transformer as tf
from repro_torch.serve import loadgen
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Request, Scheduler

torch.set_num_threads(1)

ARCH = "rwkv6-7b"
# f32 on both sides; the frameworks order their sums differently
RTOL = ATOL = 1e-5
B, S = 2, 7
BATCH, PROMPT, STEPS, MAX_KV = 4, 4, 8, 32
TRAFFIC = dict(seed=5, n_requests=6, rate_rps=5.0, max_prompt=9, max_new=5,
               step_s=0.05)


def _cfgs():
    return (ref_configs.reduced(ref_configs.get_config(ARCH)),
            configs.reduced(configs.get_config(ARCH)))


@pytest.fixture(scope="module")
def weights():
    """(reference params, the same as numpy, the port's params)."""
    rcfg, cfg = _cfgs()
    p = ref_tf.init_params(rcfg, jax.random.key(0))
    np_p = jax.tree.map(np.asarray, p)
    return p, np_p, params_from_jax(np_p, cfg, device="cpu")


def _layer(weights, g=0):
    """Group g's layer: the reference's dict and the port's."""
    p, _, port = weights
    return (jax.tree.map(lambda x: x[g], p["layers"][0]),
            {k: v[g] for k, v in port["layers"][0].items()})


def _state(seed):
    """A seeded, non-zero recurrent state of batch B (numpy f32)."""
    _, cfg = _cfgs()
    r = np.random.RandomState(seed)
    nh = cfg.d_model // rwkv6.HEAD
    return {"wkv": (r.randn(B, nh, 64, 64) * 0.3).astype(np.float32),
            "shift_t": r.randn(B, cfg.d_model).astype(np.float32),
            "shift_c": r.randn(B, cfg.d_model).astype(np.float32)}


def _x(seed, s=S):
    _, cfg = _cfgs()
    return np.random.RandomState(seed).randn(B, s, cfg.d_model).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _to_torch(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


def _prompts(vocab, batch=BATCH, plen=PROMPT):
    return np.random.RandomState(0).randint(
        0, vocab, (batch, plen)).astype(np.int32)


# ---------------------------------------------------------------------------
# the layer's functions against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["rwkv_time_mix", "rwkv_channel_mix"])
def test_mix_matches_reference(weights, fn):
    rp, p = _layer(weights, g=1)
    x, st = _x(1), _state(2)
    want, wstate = getattr(ref_rwkv6, fn)(rp, jnp.asarray(x),
                                          jax.tree.map(jnp.asarray, st))
    tstate = _to_torch(st)
    got, gstate = getattr(rwkv6, fn)(p, torch.from_numpy(x), tstate)
    _close(got, want)
    for name in rwkv6.STATE_NAMES:
        _close(gstate[name], wstate[name])
        assert gstate[name].dtype == torch.float32
    for name, v in st.items():                 # the state it was given
        assert np.array_equal(tstate[name].numpy(), v)


@pytest.mark.parametrize("s", [1, 5])
def test_decode_step_matches_reference(weights, s):
    rcfg, cfg = _cfgs()
    rp, p = _layer(weights)
    x, st = _x(3, s), _state(4)
    want, wstate = ref_rwkv6.rwkv_decode_step(
        rp, jnp.asarray(x), jax.tree.map(jnp.asarray, st), rcfg)
    got, gstate = rwkv6.rwkv_decode_step(p, torch.from_numpy(x),
                                         _to_torch(st), cfg)
    _close(got, want)
    for name in rwkv6.STATE_NAMES:
        _close(gstate[name], wstate[name])


def test_forward_logits_match_reference(weights):
    rcfg, cfg = _cfgs()
    p, _, port = weights
    toks = np.random.RandomState(5).randint(0, cfg.vocab, (B, 11)).astype(
        np.int32)
    want = ref_tf.logits_fn(p, rcfg, ref_tf.forward(p, rcfg, toks))
    got = tf.logits_fn(port, cfg, tf.forward(port, cfg,
                                             torch.from_numpy(toks)))
    assert got.shape == (B, 11, cfg.vocab)
    _close(got, want)


def test_greedy_decode_matches_reference(weights):
    """8 greedy steps through ``decode_step`` on both sides: tokens equal,
    logits and the final cache (through the converters) within the
    bar."""
    rcfg, cfg = _cfgs()
    p, _, port = weights
    rcache = ref_tf.init_cache(rcfg, B, MAX_KV)
    cache = tf.init_cache(cfg, B, MAX_KV, device="cpu")
    tok = _prompts(cfg.vocab, B, 1)[:, 0]
    rtok = tok.copy()
    toks, rtoks = [], []
    for t in range(8):
        rlogits, rcache = ref_tf.decode_step(p, rcfg, rcache,
                                             jnp.asarray(rtok), jnp.int32(t))
        logits, cache = tf.decode_step(port, cfg, cache,
                                       torch.from_numpy(tok).long(), t)
        _close(logits, rlogits)
        rtok = np.asarray(jnp.argmax(rlogits, -1)).astype(np.int32)
        tok = logits.argmax(-1).numpy().astype(np.int32)
        toks.append(tok)
        rtoks.append(rtok)
    assert np.array_equal(np.stack(toks), np.stack(rtoks))
    got = rwkv_state_to_jax(cache)
    for name in rwkv6.STATE_NAMES:
        np.testing.assert_allclose(got[name], np.asarray(rcache[name]),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------
def test_decode_equals_forward(weights):
    _, cfg = _cfgs()
    port = weights[2]
    toks = torch.from_numpy(_prompts(cfg.vocab, B, 9)).long()
    want = tf.logits_fn(port, cfg, tf.forward(port, cfg, toks))
    cache = tf.init_cache(cfg, B, MAX_KV, device="cpu")
    for t in range(toks.shape[1]):
        logits, _ = tf.decode_step(port, cfg, cache, toks[:, t], t)
        torch.testing.assert_close(logits, want[:, t], rtol=RTOL, atol=ATOL)


def test_inactive_row_passes_through_bit_for_bit(weights):
    """With per-row positions and ``active``, an inactive row's three
    state leaves are what they were, bit for bit, and an active row
    advances as it does alone."""
    _, cfg = _cfgs()
    port = weights[2]
    cache = tf.init_cache(cfg, 3, MAX_KV, device="cpu")
    g = torch.Generator().manual_seed(0)
    for leaves in cache.values():
        leaves[0].copy_(torch.randn(leaves[0].shape, generator=g))
    before = {k: v[0].clone() for k, v in cache.items()}
    tokens = torch.tensor([5, 9, 11])
    active = torch.tensor([True, False, True])
    alone = {k: [v[0].clone()] for k, v in cache.items()}
    want, _ = tf.decode_step(port, cfg, alone, tokens, torch.zeros(3))
    got, _ = tf.decode_step(port, cfg, cache, tokens,
                            torch.tensor([3, 7, 1]), active=active)
    assert torch.equal(got[active], want[active])
    for name, leaves in cache.items():
        assert torch.equal(leaves[0][:, 1], before[name][:, 1])
        assert torch.equal(leaves[0][:, [0, 2]], alone[name][0][:, [0, 2]])
        assert not torch.equal(leaves[0][:, 0], before[name][:, 0])


def test_cache_layout_and_converters(weights):
    """``init_cache``: one f32 leaf a name with a leading groups axis,
    whatever the dtype asked for (an int8 cache leaves rwkv6's state in
    f32, as the reference's); the converters carry the reference's cache
    across and back exactly."""
    rcfg, cfg = _cfgs()
    for dtype in (None, torch.int8):
        cache = tf.init_cache(cfg, 3, MAX_KV, device="cpu", dtype=dtype)
        ref = ref_tf.init_cache(rcfg, 3, MAX_KV)
        assert sorted(cache) == sorted(rwkv6.STATE_NAMES) == sorted(ref)
        for name, leaves in cache.items():
            assert len(leaves) == 1 and leaves[0].dtype == torch.float32
            assert tuple(leaves[0].shape) == ref[name].shape
    st = {name: np.stack([v] * cfg.n_layers)
          for name, v in _state(6).items()}
    port = rwkv_state_from_jax(st, device="cpu")
    back = rwkv_state_to_jax(port)
    for name in rwkv6.STATE_NAMES:
        assert np.array_equal(back[name], st[name])
    # the explicit->auto conversion passes the state through, as copies
    auto = shd.auto_decode_cache(port)
    for name in rwkv6.STATE_NAMES:
        assert torch.equal(auto[name][0], port[name][0])
        assert auto[name][0].data_ptr() != port[name][0].data_ptr()


def test_wkv_scan_under_autograd_equals_in_place():
    """Autograd records the loop out of place, with the same products
    and sums: its values are the in-place loop's bit for bit, the state
    it was given is untouched, and the gradient flows."""
    g = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn(2, 6, 3, 64, generator=g) for _ in range(3))
    w = torch.rand(2, 6, 3, 64, generator=g)
    u = torch.randn(3, 64, generator=g)
    wkv = torch.randn(2, 3, 64, 64, generator=g)
    keep = wkv.clone()
    want, want_state = rwkv6.wkv_scan(r, k, v, w, u, wkv)
    assert torch.equal(wkv, keep)
    rr = r.clone().requires_grad_()
    got, state = rwkv6.wkv_scan(rr, k, v, w, u, wkv)
    assert torch.equal(got, want) and torch.equal(state, want_state)
    (got.sum() + state.sum()).backward()
    assert torch.isfinite(rr.grad).all() and torch.equal(wkv, keep)


# ---------------------------------------------------------------------------
# serving: Engine and Scheduler against the reference's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_engine():
    """(numpy params, first logits, greedy tokens) of the reference
    Engine, auto, on a 1 x 1 mesh."""
    rcfg, _ = _cfgs()
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    params = ref_step.init_sharded(rcfg, mesh, ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    eng = RefEngine(rcfg, params, mesh,
                    RefServeConfig(batch=BATCH, max_kv=MAX_KV), mode="auto")
    logits = np.asarray(eng.prefill(_prompts(rcfg.vocab)))
    toks = eng.decode(logits, num_tokens=STEPS)
    return jax.tree.map(np.asarray, params), logits, toks


def _engine(np_params, *, tp=1, **kw):
    _, cfg = _cfgs()
    params = params_from_jax(np_params, cfg, device="cpu")
    return Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV, **kw),
                  tp=tp, device="cpu")


def test_engine_auto_matches_reference(ref_engine):
    np_params, want_logits, want = ref_engine
    eng = _engine(np_params)
    logits = eng.prefill(_prompts(eng.cfg.vocab))
    _close(logits, want_logits)
    assert np.array_equal(eng.decode(logits, num_tokens=STEPS), want)
    assert eng.mode == "auto" and eng.health["fallbacks"] == 0


def test_engine_int8_cache_leaves_the_state_alone(ref_engine):
    """``kv_quant`` asks for an int8 KV cache; rwkv6 has none: its f32
    state and its tokens are those of the plain engine."""
    np_params, _, want = ref_engine
    eng = _engine(np_params, kv_quant=True)
    assert all(leaf.dtype == torch.float32
               for leaves in eng.cache.values() for leaf in leaves)
    logits = eng.prefill(_prompts(eng.cfg.vocab))
    assert np.array_equal(eng.decode(logits, num_tokens=STEPS), want)


def test_engine_explicit_falls_back_to_auto(ref_engine):
    """As the reference (``test_explicit_falls_back_gracefully_for_
    unsupported_family``): explicit asked for at TP 2 warns "falling back
    to auto", counts one fallback and serves the auto engine's tokens."""
    np_params, _, want = ref_engine
    with pytest.warns(UserWarning, match="falling back to auto"):
        eng = _engine(np_params, tp=2, mode="explicit")
    assert eng.mode == "auto" and eng.requested_mode == "explicit"
    # the plans are compiled, as the reference's are; nothing replays them
    assert eng.health["fallbacks"] == 1
    assert set(eng.decode_plans) == {"layer_allreduce", "logits_allgather"}
    assert eng.plan_report()["degraded"]
    logits = eng.prefill(_prompts(eng.cfg.vocab))
    assert np.array_equal(eng.decode(logits, num_tokens=STEPS), want)


def _trace(vocab):
    return loadgen.synth_trace(loadgen.TrafficConfig(**TRAFFIC), vocab)


def test_scheduler_matches_reference_and_sequential(ref_engine):
    """The reference scheduler's greedy streams on the same trace and
    weights; the port's equal them, equal its own sequential run's, and
    drop nothing. Asked for fused prefill, rwkv6 prefills token by token
    (as the reference's)."""
    np_params, _, _ = ref_engine
    rcfg, _ = _cfgs()
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    params = jax.tree.map(jnp.asarray, np_params)
    ref = RefScheduler(RefEngine(rcfg, params, mesh,
                                 RefServeConfig(batch=BATCH,
                                                max_kv=MAX_KV)),
                       max_slots=BATCH, prefill_chunk=3)
    for r in ref_loadgen.synth_trace(ref_loadgen.TrafficConfig(**TRAFFIC),
                                     rcfg.vocab):
        ref.submit(r)
    ref.run_until_drained(step_s=TRAFFIC["step_s"])
    sched = Scheduler(_engine(np_params), max_slots=BATCH, prefill_chunk=3,
                      fused_prefill=True)
    assert not sched.fused_prefill
    trace = _trace(rcfg.vocab)
    for r in trace:
        sched.submit(r)
    sched.run_until_drained(step_s=TRAFFIC["step_s"])
    m = sched.metrics()
    assert m["completed"] == len(trace) and m["dropped"] == 0
    streams = dict(sched.streams)
    assert streams == {rid: list(map(int, s))
                       for rid, s in ref.streams.items()}
    base = loadgen.sequential_baseline(
        sched, [dataclasses.replace(r, rid=r.rid + 1000) for r in trace],
        step_s=TRAFFIC["step_s"])
    assert {rid - 1000: s for rid, s in base.items()} == streams


def test_scheduler_holds_no_prefix_cache(ref_engine):
    """The reference's gate: a recurrent cache is no per-token tape, so a
    scheduler over rwkv6 given a PrefixCache holds none, and a repeated
    prompt is prefilled again."""
    sched = Scheduler(_engine(ref_engine[0]), max_slots=2,
                      prefix_cache=PrefixCache(capacity_tokens=256))
    assert sched.prefix_cache is None
    prompt = np.arange(1, 7, dtype=np.int32)
    for rid in range(2):
        sched.submit(Request(rid, prompt, 2))
    sched.run_until_drained()
    m = sched.metrics()
    assert m["prefix_hits"] == m["prefix_misses"] == 0
    assert sched.streams[0] == sched.streams[1]


# ---------------------------------------------------------------------------
# the data-parallel trainer
# ---------------------------------------------------------------------------
TRAIN = dict(steps=3, global_batch=4, seq_len=16, log_every=100)
# tests/test_train_integration.py's bar, explicit against auto
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 1e-4


def test_explicit_dp_trainer_matches_reference_and_auto(weights):
    """Explicit DP 2 (one flat AllReduce plan a gradient leaf, on
    ``TorchExecutor``) from the reference's weights: losses within the
    reference test's bar of the reference's explicit DP 2 run and of the
    port's auto run; each step replays one plan for each of rwkv6's 24
    leaves (21 a layer, ``embed``, ``ln_f``, ``unembed``)."""
    from repro.train import loop as ref_loop
    from repro_torch.train import loop
    rcfg, cfg = _cfgs()
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                ("data", "model"))
    want = ref_loop.run(rcfg, mesh, ref_loop.TrainConfig(mode="explicit",
                                                         **TRAIN))
    np_p = weights[1]
    runs = {mode: loop.run(
        cfg, (RankAxis("data", 2, "cpu"),) if mode == "explicit" else (),
        loop.TrainConfig(mode=mode, **TRAIN),
        params=params_from_jax(np_p, cfg, device="cpu"), device="cpu",
        log_fn=lambda line: None) for mode in ("auto", "explicit")}
    got = runs["explicit"]
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    np.testing.assert_allclose(got["losses"], runs["auto"]["losses"],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    stats = got["plan_stats"]["flat"]
    assert stats["compiles"] + stats["hits"] == 24 * TRAIN["steps"]
    # one plan a distinct (shape, dtype), as the reference's
    assert stats["plans"] == want["plan_stats"]["flat"]["plans"]


# ---------------------------------------------------------------------------
# the launchers, in-process
# ---------------------------------------------------------------------------
def test_serve_launcher_runs_rwkv6():
    from repro_torch.launch import serve as launch
    buf = io.StringIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with contextlib.redirect_stdout(buf):
            rc = launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--tp", "2", "--batch", "2", "--prompt-len",
                              "3", "--tokens", "4", "--mode", "explicit"])
    lines = buf.getvalue().strip().splitlines()
    assert rc == 0
    assert lines[0] == "note: mode=explicit unavailable, running auto"
    assert lines[1].startswith(f"arch={ARCH}-reduced mode=auto")
    assert lines[2].startswith("seq0: [")


def test_train_launcher_runs_rwkv6(capsys):
    from repro_torch.launch import train as launch
    assert launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "8",
                        "--dp", "2", "--mode", "explicit"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith(f"arch={ARCH}-reduced") and "explicit" in out[0]
    assert out[-1].startswith("final loss ")


# ---------------------------------------------------------------------------
# what stays refused, as in the reference
# ---------------------------------------------------------------------------
def _plan_keys(plans):
    """Each plan family's collective, axis size, per-rank columns, dtype
    and bucket ladder (the reference's and the port's spell the same)."""
    return {name: (p.collective, p.n, p.cols, str(p.dtype),
                   tuple(p.buckets)) for name, p in plans.items()}


def test_explicit_paths_and_fused_prefill_refuse_rwkv6(weights):
    """The decode plans are compiled as the reference compiles them (the
    same families, shapes and buckets); the explicit step, the
    rank-stacked cache and fused prefill stay refused."""
    rcfg, cfg = _cfgs()
    port = weights[2]
    comm = Communicator("model", n=2, device="cpu")
    got = step_mod.compile_decode_plans(cfg, comm, batch_local=2, tp=2,
                                        seq_buckets=(4,))
    from repro.core import comm as ref_comm
    want = ref_step.compile_decode_plans(
        rcfg, ref_comm.Communicator("model", n=2), batch_local=2, tp=2,
        seq_buckets=(4,))
    assert set(got) == {"layer_allreduce", "logits_allgather"}
    assert _plan_keys(got) == _plan_keys(want)
    axis = RankAxis("model", 2, "cpu")
    ok, why = shd.explicit_decode_supported(cfg, 2)
    assert not ok and "rwkv6" in why
    with pytest.raises(ValueError, match="unsupported"):
        step_mod.make_serve_step(cfg, axis, batch=2, max_kv=8,
                                 mode="explicit", plans={})
    cache = tf.init_cache(cfg, 2, 8, device="cpu")
    toks = torch.zeros(2, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="explicit decode"):
        tf.decode_step(port, cfg, cache, toks, 0, comms=object())
    with pytest.raises(NotImplementedError, match="rank-stacked"):
        tf.init_cache(cfg, 2, 8, device="cpu", ranks=2)
    with pytest.raises(NotImplementedError, match="fused prefill"):
        tf.prefill_step(port, cfg, cache,
                        torch.zeros((2, 4), dtype=torch.long),
                        torch.zeros(2, dtype=torch.long),
                        torch.ones(2, dtype=torch.long))
    with pytest.raises(ValueError, match="token by token"):
        step_mod.make_prefill_sched_step(cfg, RankAxis("model", 1, "cpu"),
                                         batch=2, seq=4, max_kv=8)


def test_router_serves_rwkv6_as_the_reference(tmp_path):
    """``build_replicas`` over rwkv6-reduced (2 replicas x TP 2, auto,
    one exported plan set): the reference router's greedy streams on the
    same trace and weights, nothing dropped, no warning."""
    from repro.serve.router import build_replicas as ref_build_replicas
    from repro_torch.serve.router import build_replicas
    rcfg, cfg = _cfgs()
    ref = ref_build_replicas(rcfg, RefServeConfig(batch=BATCH, max_kv=MAX_KV),
                             n_replicas=2, tp=2, plan_dir=tmp_path / "ref",
                             mode="auto")
    ref_loadgen.run_load(ref, ref_loadgen.synth_trace(
        ref_loadgen.TrafficConfig(**TRAFFIC), rcfg.vocab),
        step_s=TRAFFIC["step_s"])
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                ("data", "model"))
    np_params = jax.tree.map(np.asarray, ref_step.init_sharded(
        rcfg, mesh, ref_shd.MeshAxes(), jax.random.key(0))[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        router = build_replicas(
            cfg, ServeConfig(batch=BATCH, max_kv=MAX_KV), n_replicas=2,
            tp=2, plan_dir=tmp_path / "port",
            params=params_from_jax(np_params, cfg, device="cpu"),
            mode="auto", device="cpu")
    trace = _trace(cfg.vocab)
    loadgen.run_load(router, trace, step_s=TRAFFIC["step_s"])
    assert all(r.eng.mode == "auto" and r.eng.decode_plans
               and not r.eng.plan_report()["degraded"]
               for r in router.replicas)
    assert router.metrics()["dropped"] == 0
    assert dict(router.streams) == {rid: list(map(int, s))
                                    for rid, s in ref.streams.items()}
    assert router.routed == dict(ref.routed)


def test_position_limit_is_the_context_only():
    """rwkv6 keeps no KV: an engine steps past ``max_kv``."""
    _, cfg = _cfgs()
    assert tf.position_limit(cfg, 16) == cfg.max_seq
    qwen = configs.reduced(configs.get_config("qwen3-1.7b"))
    assert tf.position_limit(qwen, 16) == 16
    eng = Engine(cfg, tf.init_params(cfg, device="cpu"),
                 ServeConfig(batch=2, max_kv=2), device="cpu")
    logits = eng.prefill(_prompts(cfg.vocab, 2, 3))
    assert eng.decode(logits, num_tokens=2).shape == (2, 2)


# ---------------------------------------------------------------------------
# one batch-axis rule for every family's cache leaves
# ---------------------------------------------------------------------------
# (arch, layout): every decode family's auto and int8 caches, and the
# rank-stacked one where the family has an explicit layout
_LAYOUTS = [(a, layout) for a in sorted(configs._MODULES)
            for layout in ("auto", "int8", "ranks")
            if configs.get_config(a).family in tf.DECODE_FAMILIES
            and (layout != "ranks"
                 or configs.get_config(a).family in tf.EXPLICIT_FAMILIES)]


@pytest.mark.parametrize("arch,layout", _LAYOUTS)
def test_cache_batch_rows_lie_where_batch_axis_says(arch, layout):
    """Every leaf of ``init_cache`` holds its batch rows on
    ``step.batch_axis``: a row written through ``cache_rows``' view of
    that axis is that row of the leaf's batch and nothing else."""
    cfg = configs.reduced(configs.get_config(arch))
    batch = 5
    kw = dict(dtype=torch.int8) if layout == "int8" else (
        dict(ranks=2) if layout == "ranks" else {})
    cache = tf.init_cache(cfg, batch, 8, device="cpu", **kw)
    rows = step_mod.cache_rows(cache, 3)
    for name, leaves in cache.items():
        for leaf, view in zip(leaves, rows[name]):
            axis = step_mod.batch_axis(name, leaf)
            assert leaf.shape[axis] == batch
            view.select(axis, 2).fill_(1)
            assert leaf.select(axis, 2).eq(1).all()
            assert leaf.count_nonzero() == leaf.select(axis, 2).numel()
