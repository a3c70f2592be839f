"""The port's expert-parallel MoE decode slice against the reference, at
``reduced()`` sizes: the dense ``moe_layer`` oracle, ``moe_layer_ep``
through a port ``BucketedPlan`` against the reference ``moe_layer_ep`` in
``shard_map``, top-k tie-breaking, the ``"blocks"`` bucket padding and a
reference-exported MoE plan set, and greedy decode of the explicit
``Engine`` against the reference's explicit ``Engine`` and the port's
auto path, for phi3.5-moe and mixtral."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro import configs as ref_configs
from repro.compat import shard_map
from repro.core import comm as ref_comm
from repro.distributed import moe_parallel as ref_moe
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.models import blocks as ref_blocks
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch import configs
from repro_torch.core import selector
from repro_torch.core.comm import BucketedPlan, Communicator, load_plan_set
from repro_torch.core.executor import CudaExecutor
from repro_torch.distributed.moe_parallel import ep_capacity, moe_layer_ep
from repro_torch.distributed.step import TPDecodeComms
from repro_torch.interop import params_from_jax
from repro_torch.mesh import RankAxis
from repro_torch.models import blocks
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

ARCHS = ("phi3.5-moe-42b-a6.6b", "mixtral-8x22b")
BATCH, PROMPT, STEPS, MAX_KV = 4, 4, 16, 64
# tolerances relative to the output's largest magnitude: f32 differs only
# in the frameworks' summation orders; bf16 also rounds the expert
# products' outputs (one bf16 ulp is 2**-8 relative) where XLA and torch
# place their f32 accumulations differently
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _cfg(arch="phi3.5-moe-42b-a6.6b"):
    return configs.reduced(configs.get_config(arch))


def _ref_cfg(dtype="float32", arch="phi3.5-moe-42b-a6.6b"):
    return dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch)), dtype=dtype)


def _moe_params(cfg, seed):
    """Seeded numpy MoE weights at the reference's init scales."""
    r = np.random.RandomState(seed)
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.d_ff
    return {"router": r.randn(d, e).astype(np.float32) * d ** -0.5,
            "w_gate": r.randn(e, d, f).astype(np.float32) * e ** -0.5,
            "w_up": r.randn(e, d, f).astype(np.float32) * e ** -0.5,
            "w_down": r.randn(e, f, d).astype(np.float32) * f ** -0.5}


def _to_torch(tree, dtype):
    return {k: torch.from_numpy(v).to(getattr(torch, dtype))
            for k, v in tree.items()}


def _to_jax(tree, dtype):
    return {k: jnp.asarray(v, JDT[dtype]) for k, v in tree.items()}


def _f32(y):
    return np.asarray(y.float() if isinstance(y, torch.Tensor)
                      else jnp.asarray(y, jnp.float32))


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def test_moe_layer_matches_reference():
    cfg = _cfg()
    p = _moe_params(cfg, 0)
    x = np.random.RandomState(1).randn(3, 2, cfg.d_model).astype(np.float32)
    want = ref_blocks.moe_layer(_to_jax(p, "float32"), jnp.asarray(x),
                                _ref_cfg())
    got = blocks.moe_layer(_to_torch(p, "float32"), torch.from_numpy(x), cfg)
    _close(got, want, "float32")


def _ep_inputs(cfg, seed):
    p = _moe_params(cfg, seed)
    x = np.random.RandomState(seed + 1).randn(
        BATCH, 1, cfg.d_model).astype(np.float32)
    return p, x


def _ref_moe_ep(p, x, ep, dtype):
    """The reference layer in shard_map over ep devices, dispatching
    through its own capacity-bucketed plan; (ep, b, s, d) output."""
    cfg = _ref_cfg(dtype)
    mesh = Mesh(np.asarray(jax.devices()[:ep]), ("model",))
    rcomm = ref_comm.Communicator("model", n=ep, backend="xla")
    plans = ref_step.compile_decode_plans(cfg, rcomm, batch_local=BATCH,
                                          tp=ep)
    bp = plans["moe_alltoall"]

    def body(pp, xx):
        return ref_moe.moe_layer_ep(pp, xx, cfg, axis="model",
                                    capacity_factor=None, plan=bp)[None]

    pspec = {"router": P(), "w_gate": P("model"), "w_up": P("model"),
             "w_down": P("model")}
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(pspec, P()),
                          out_specs=P("model"), check_vma=False))
    return f(_to_jax(p, dtype), jnp.asarray(x, JDT[dtype]))


def _port_moe_ep(cfg, p, x, ep, dtype, *, comm=None):
    axis = RankAxis("model", ep, "cpu")
    tp_ = _to_torch(p, dtype)
    lp = {"router": axis.replicate(tp_["router"]),
          **{k: axis.shard(tp_[k], 0) for k in ("w_gate", "w_up", "w_down")}}
    xs = axis.replicate(torch.from_numpy(x).to(getattr(torch, dtype)))
    comm = comm or Communicator("model", n=ep, device="cpu")
    e_local = cfg.moe.num_experts // ep
    caps = sorted({e_local * ep_capacity(b, cfg.moe.top_k)
                   for b in (1, 2, 4)})
    bp = comm.plan_for("all_to_all", (ep * caps[-1], cfg.d_model), dtype,
                       buckets=caps)
    return moe_layer_ep(lp, xs, cfg, plan=bp), bp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ep", [2, 4])
def test_moe_layer_ep_matches_reference(ep, dtype):
    cfg = _cfg()
    p, x = _ep_inputs(cfg, seed=10 * ep)
    got, bp = _port_moe_ep(cfg, p, x, ep, dtype)
    assert bp.pad_strategy == "blocks"
    assert bp.hits[bp.buckets[-1]] == 2          # dispatch + combine
    _close(got, _ref_moe_ep(p, x, ep, dtype), dtype)


def test_moe_layer_ep_without_a_plan_compiles_once():
    """``plan=None`` goes through ``Communicator.all_to_all``: the first
    call compiles, the combine and later calls hit the cache."""
    cfg = _cfg()
    ep = 2
    p, x = _ep_inputs(cfg, seed=3)
    want, _ = _port_moe_ep(cfg, p, x, ep, "float32")
    axis = RankAxis("model", ep, "cpu")
    tp_ = _to_torch(p, "float32")
    lp = {"router": axis.replicate(tp_["router"]),
          **{k: axis.shard(tp_[k], 0) for k in ("w_gate", "w_up", "w_down")}}
    comm = Communicator("model", n=ep, device="cpu")
    xs = axis.replicate(torch.from_numpy(x))
    for _ in range(2):
        got = moe_layer_ep(lp, xs, cfg, comm=comm)
        assert torch.equal(got, want)
    assert comm.stats == {"compiles": 1, "hits": 3}
    with pytest.raises(ValueError, match="plan= .* or comm="):
        moe_layer_ep(lp, xs, cfg)


def test_top_k_breaks_ties_toward_the_lower_index():
    """Forced ties: the port's top_k picks what ``jax.lax.top_k`` picks,
    and a router whose tied columns are hit exactly routes every token
    the same way in both packages."""
    r = np.random.RandomState(7)
    logits = r.randint(0, 3, (64, 8)).astype(np.float32)   # many ties
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(logits), k)
        gv, gi = blocks.top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    cfg = _cfg()
    p = _moe_params(cfg, 8)
    # experts 1, 2, 3 tie exactly above expert 0: every token has one
    # nonzero feature, so each logit is one product, no sum to reorder
    p["router"][:, 0] = -1.0
    p["router"][:, 1:] = 1.0
    x = np.zeros((2, 2, cfg.d_model), np.float32)
    x[0, 0, 3], x[0, 1, 7], x[1, 0, 11], x[1, 1, 100] = 1.0, 2.0, 0.5, 3.0
    logits = torch.einsum("bsd,de->bse", torch.from_numpy(x),
                          torch.from_numpy(p["router"]))
    _, idx = blocks.top_k(logits, cfg.moe.top_k)
    assert (idx == torch.tensor([1, 2])).all()     # not 3: lower wins
    want = ref_blocks.moe_layer(_to_jax(p, "float32"), jnp.asarray(x),
                                _ref_cfg())
    got = blocks.moe_layer(_to_torch(p, "float32"), torch.from_numpy(x), cfg)
    _close(got, want, "float32")
    xb = x.reshape(BATCH, 1, cfg.d_model)
    got_ep, _ = _port_moe_ep(cfg, p, xb, 2, "float32")
    _close(got_ep, _ref_moe_ep(p, xb, 2, "float32"), "float32")


# ---------------------------------------------------------------------------
# the "blocks" bucket padding and reference plan files
# ---------------------------------------------------------------------------
def _x(n, rows, cols, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, rows, cols).astype(np.float32))


def test_bucketed_alltoall_pads_per_block():
    """Buckets count rows per per-rank block, each block pads on its own
    and the padding leaves every received block; the reference's hit
    counts (tests/test_explicit_decode.py)."""
    n = 4
    c = Communicator("model", n=n, device="cpu")
    bp = c.plan_for("all_to_all", (n * 8, 16), torch.float32,
                    buckets=(2, 4, 8))
    assert bp.pad_strategy == "blocks" and c.stats["compiles"] == 3
    for rows in (1, 2, 3, 5, 8):
        x = _x(n, n * rows, 16, seed=rows)
        y = bp(x)
        assert y.shape == x.shape
        want = x.reshape(n, n, rows, 16).transpose(0, 1)
        assert torch.equal(y.reshape(n, n, rows, 16), want)
    assert c.stats["compiles"] == 3
    assert bp.hits == {2: 2, 4: 1, 8: 2}


def test_bucketed_reduce_scatter_blocks():
    n = 4
    c = Communicator("model", n=n, device="cpu")
    bp = c.plan_for("reduce_scatter", (n * 4, 8), torch.float32,
                    buckets=(2, 4))
    for rows in (1, 3, 4):
        x = _x(n, n * rows, 8, seed=rows)
        y = bp(x)
        want = x.reshape(n, n, rows, 8).sum(0)
        assert y.shape == (n, rows, 8)
        torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    assert bp.hits == {2: 1, 4: 2}


def _ref_replay(plan, x):
    mesh = Mesh(np.asarray(jax.devices()[:plan.n]), (plan.axis,))
    spec = P(plan.axis, None, None)
    f = jax.jit(shard_map(lambda xs: plan(xs[0])[None], mesh=mesh,
                          in_specs=spec, out_specs=spec, check_vma=False))
    return np.asarray(f(x))


@pytest.mark.parametrize("tp", [2, 4])
def test_reference_moe_plan_set_loads_and_replays(tmp_path, tp):
    """The reference's MoE decode plan set loads in the port (its
    ``"blocks"`` family included), every bucket replays bit-equal, the
    bucketed plan pads like the reference's, and an Engine serves it."""
    cfg_ref = _ref_cfg()
    rcomm = ref_comm.Communicator("model", n=tp, backend="xla")
    ref_plans = ref_step.compile_decode_plans(cfg_ref, rcomm,
                                              batch_local=BATCH, tp=tp)
    ref_comm.export_plan_set(ref_plans, tmp_path)
    plans = load_plan_set(tmp_path, device="cpu")
    assert set(plans) == set(ref_plans)
    a2a, ra2a = plans["moe_alltoall"], ref_plans["moe_alltoall"]
    assert a2a.pad_strategy == ra2a.pad_strategy == "blocks"
    assert a2a.buckets == ra2a.buckets
    for b, plan in a2a.plans.items():
        x = _x(tp, tp * b, plan.shape[1], seed=b)
        np.testing.assert_array_equal(
            plan(x).numpy(), _ref_replay(ra2a.plans[b], x.numpy()))
    rows = a2a.buckets[0] + 1                 # pads inside every block
    x = _x(tp, tp * rows, a2a.cols, seed=99)
    np.testing.assert_array_equal(a2a(x).numpy(), _ref_replay(ra2a, x.numpy()))
    cfg = _cfg()
    eng = Engine(cfg, tf.init_params(cfg, device="cpu"),
                 ServeConfig(batch=BATCH, max_kv=16), tp=tp, device="cpu",
                 mode="explicit", decode_plans=plans)
    logits = eng.prefill(np.zeros((BATCH, 2), np.int32))
    assert logits.shape == (BATCH, cfg.vocab) and torch.isfinite(logits).all()
    assert eng.comm.stats["compiles"] == 0
    assert a2a.hits[a2a.buckets[-1]] == 2 * 2 * cfg.n_layers
    del plans["moe_alltoall"]
    with pytest.raises(ValueError, match="moe_alltoall"):
        Engine(cfg, tf.init_params(cfg, device="cpu"),
               ServeConfig(batch=BATCH, max_kv=16), tp=tp, device="cpu",
               mode="explicit", decode_plans=plans)


# ---------------------------------------------------------------------------
# explicit MoE decode
# ---------------------------------------------------------------------------
def _prompts(vocab):
    return np.random.RandomState(0).randint(
        0, vocab, (BATCH, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(arch, tp):
    """(params as numpy, greedy tokens) of the reference explicit Engine
    on a (1, tp) data×model mesh."""
    cfg = ref_configs.reduced(ref_configs.get_config(arch))
    mesh = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = ref_step.init_sharded(cfg, mesh, ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    eng = RefEngine(cfg, params, mesh,
                    RefServeConfig(batch=BATCH, max_kv=MAX_KV),
                    mode="explicit")
    assert eng.mode == "explicit"
    toks = eng.decode(eng.prefill(_prompts(cfg.vocab)), num_tokens=STEPS)
    return jax.tree.map(np.asarray, params), toks


def _port(arch, tp, mode, np_params):
    cfg = _cfg(arch)
    params = params_from_jax(np_params, cfg, device="cpu")
    comm = Communicator("model", n=tp, device="cpu", link=selector.ICI)
    eng = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV),
                 tp=tp, device="cpu", mode=mode, comm=comm)
    return eng, eng.decode(eng.prefill(_prompts(cfg.vocab)),
                           num_tokens=STEPS)


def test_params_carry_moe_leaves_across():
    np_params = _reference(ARCHS[0], 2)[0]
    params = params_from_jax(np_params, _cfg(), device="cpu")
    for got, want in zip(params["layers"], np_params["layers"]):
        assert "mlp" not in got and set(got["moe"]) == set(want["moe"])
        for k, v in want["moe"].items():
            np.testing.assert_array_equal(got["moe"][k].numpy(), v)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_explicit_matches_jax_explicit(arch, tp):
    """Greedy tokens over 16 steps equal the reference explicit Engine's,
    and the port's explicit tokens equal its auto tokens; the CPU path
    never reaches the kernel."""
    np_params, ref_toks = _reference(arch, tp)
    eng, toks = _port(arch, tp, "explicit", np_params)
    assert isinstance(eng.decode_plans["moe_alltoall"], BucketedPlan)
    np.testing.assert_array_equal(toks, ref_toks)
    _, auto_toks = _port(arch, tp, "auto", np_params)
    np.testing.assert_array_equal(toks, auto_toks)
    assert CudaExecutor.launches == 0


def test_explicit_moe_replays_not_recompiles():
    """Plans exist before the first token; every step replays the
    all_to_all twice per layer (dispatch and combine) and the
    AllReduce once per layer plus the embedding."""
    cfg = _cfg()
    eng = Engine(cfg, tf.init_params(cfg, device="cpu", seed=3),
                 ServeConfig(batch=BATCH, max_kv=MAX_KV), tp=2, device="cpu",
                 mode="explicit")
    compiles = eng.comm.stats["compiles"]
    a2a = eng.decode_plans["moe_alltoall"]
    e_local = cfg.moe.num_experts // 2
    assert a2a.buckets == tuple(e_local * ep_capacity(b, cfg.moe.top_k)
                                for b in (1, 2, 4))
    eng.decode(eng.prefill(_prompts(cfg.vocab)), num_tokens=2)
    eng.decode(eng.prefill(_prompts(cfg.vocab)), num_tokens=2)
    assert eng.comm.stats["compiles"] == compiles
    steps = 2 * (PROMPT + 2)
    assert a2a.hits[a2a.buckets[-1]] == steps * 2 * cfg.n_layers
    assert eng.decode_plans["layer_allreduce"].hits[BATCH] == \
        steps * (cfg.n_layers + 1)
    report = eng.plan_report()
    assert report["plans"]["moe_alltoall"]["pad_strategy"] == "blocks"
    assert report["predicted_comm_us_per_token"] > 0


def test_explicit_moe_rejects_without_plan():
    cfg = _cfg()
    axis = RankAxis("model", 2, "cpu")
    comms = TPDecodeComms(cfg, axis, hidden_plan=None, moe_plan=None)
    cache = tf.init_cache(cfg, 2, 8, device="cpu", ranks=2)
    with pytest.raises(NotImplementedError, match="moe_alltoall"):
        tf.decode_step({}, cfg, cache, torch.zeros(2, dtype=torch.long), 0,
                       comms=comms)


@pytest.mark.parametrize("n_tok,k", [(1, 2), (8, 2), (16, 1), (32, 4)])
def test_ep_capacity_is_the_reference_lossless_capacity(n_tok, k):
    assert ep_capacity(n_tok, k) == ref_moe.ep_capacity(n_tok, k, 16, None)


def test_expert_shards_split_whole_and_lie_contiguous_per_layer():
    """Rank r holds experts r*e_local ... of every layer group, the router
    replicated; a layer's expert slice is contiguous, so the batched
    expert matmuls read the weights in place."""
    from repro_torch.distributed.sharding import explicit_decode_params
    cfg = dataclasses.replace(_cfg(), n_layers=4)
    params = tf.init_params(cfg, device="cpu", seed=4)
    axis = RankAxis("model", 2, "cpu")
    ex = explicit_decode_params(params, cfg, axis)
    moe, emoe = params["layers"][0]["moe"], ex["layers"][0]["moe"]
    e_local = cfg.moe.num_experts // 2
    for g in range(cfg.n_layers):
        for k in ("w_gate", "w_up", "w_down"):
            leaf = emoe[k][:, g]
            assert leaf.is_contiguous()
            for r in range(2):
                assert torch.equal(leaf[r],
                                   moe[k][g, r * e_local:(r + 1) * e_local])
        assert torch.equal(emoe["router"][1, g], moe["router"][g])

