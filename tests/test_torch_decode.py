"""The port's dense decode slice against the reference on qwen3-reduced:
the reference's own ``init_params`` weights carried across with
``params_from_jax``, then port auto vs JAX auto (logits), port explicit
vs the JAX explicit ``Engine`` (greedy tokens over 16 steps, logits),
and port explicit vs port auto (tokens)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch import configs
from repro_torch.core import selector
from repro_torch.core.comm import BucketedPlan, Communicator
from repro_torch.core.executor import CudaExecutor
from repro_torch.distributed.step import compile_decode_plans
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

ARCH = "qwen3-1.7b"
BATCH, PROMPT, STEPS, MAX_KV = 4, 4, 16, 64
# f32 on both sides; the frameworks order their matmul and softmax sums
# differently, so logits agree to rounding, not bit for bit
RTOL = ATOL = 1e-4


def _cfg():
    return configs.reduced(configs.get_config(ARCH))


def _prompts(vocab):
    return np.random.RandomState(0).randint(
        0, vocab, (BATCH, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(tp, mode):
    """(params as numpy, first logits, greedy tokens, plan algos) of the
    reference Engine on a (1, tp) data×model mesh."""
    cfg = ref_configs.reduced(ref_configs.get_config(ARCH))
    mesh = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = ref_step.init_sharded(cfg, mesh, ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    eng = RefEngine(cfg, params, mesh,
                    RefServeConfig(batch=BATCH, max_kv=MAX_KV), mode=mode)
    assert eng.mode == mode
    logits = np.asarray(eng.prefill(_prompts(cfg.vocab)))
    toks = eng.decode(logits, num_tokens=STEPS)
    algos = {name: {b: p.algo for b, p in plan.plans.items()}
             for name, plan in eng.decode_plans.items()}
    return jax.tree.map(np.asarray, params), logits, toks, algos


def _port(tp, mode):
    cfg = _cfg()
    np_params = _reference(tp, "auto")[0]
    params = params_from_jax(np_params, cfg, device="cpu")
    comm = Communicator("model", n=tp, device="cpu", link=selector.ICI)
    eng = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV),
                 tp=tp, device="cpu", mode=mode, comm=comm)
    logits = eng.prefill(_prompts(cfg.vocab))
    first = logits.numpy().copy()
    toks = eng.decode(logits, num_tokens=STEPS)
    return eng, first, toks


def test_params_carry_across():
    cfg = _cfg()
    np_params = _reference(2, "auto")[0]
    params = params_from_jax(np_params, cfg, device="cpu")
    assert params["layers"][0]["attn"]["wq"].shape == \
        np_params["layers"][0]["attn"]["wq"].shape
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np_params["embed"])


@pytest.mark.parametrize("tp", [2, 4])
def test_port_auto_matches_jax_auto(tp):
    _, ref_logits, ref_toks, _ = _reference(tp, "auto")
    _, logits, toks = _port(tp, "auto")
    np.testing.assert_allclose(logits, ref_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(toks, ref_toks)


@pytest.mark.parametrize("tp", [2, 4])
def test_port_explicit_matches_jax_explicit(tp):
    """Greedy tokens equal over 16 steps; both engines replay plans of
    the same algorithms (the port is given the reference's link)."""
    _, ref_logits, ref_toks, ref_algos = _reference(tp, "explicit")
    eng, logits, toks = _port(tp, "explicit")
    algos = {name: {b: p.algo for b, p in plan.plans.items()}
             for name, plan in eng.decode_plans.items()}
    assert algos == ref_algos
    np.testing.assert_allclose(logits, ref_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(toks, ref_toks)


@pytest.mark.parametrize("tp", [2, 4])
def test_port_explicit_matches_port_auto(tp):
    _, _, auto_toks = _port(tp, "auto")
    eng, _, toks = _port(tp, "explicit")
    np.testing.assert_array_equal(toks, auto_toks)
    # the plain path on the CPU never reaches the kernel
    assert all(p.backend == "torch" for plan in eng.decode_plans.values()
               for p in plan.plans.values())
    assert CudaExecutor.launches == 0


def test_windowed_explicit_matches_auto():
    """gemma3-reduced (5 local : 1 global layers) with a window shorter
    than the sequence, so the windowed layers' ring buffer wraps."""
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config("gemma3-12b")), window=4)
    params = tf.init_params(cfg, device="cpu", seed=5)
    prompts = np.random.RandomState(5).randint(0, cfg.vocab, (BATCH, 6))
    toks = {}
    for mode in ("auto", "explicit"):
        eng = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=32), tp=2,
                     device="cpu", mode=mode)
        toks[mode] = eng.decode(eng.prefill(prompts), num_tokens=8)
    np.testing.assert_array_equal(toks["explicit"], toks["auto"])


def test_explicit_replays_not_recompiles():
    """Plans exist before the first token; decode replays them (compile
    counters flat, the full-batch bucket's hit counter advancing by 2 per
    layer + the embedding per step)."""
    cfg = _cfg()
    params = tf.init_params(cfg, device="cpu", seed=3)
    eng = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV),
                 tp=2, device="cpu", mode="explicit")
    compiles = eng.comm.stats["compiles"]
    assert compiles > 0
    ar = eng.decode_plans["layer_allreduce"]
    assert isinstance(ar, BucketedPlan)
    logits = eng.prefill(_prompts(cfg.vocab))
    eng.decode(logits, num_tokens=2)
    assert eng.comm.stats["compiles"] == compiles
    steps = PROMPT + 2
    assert ar.hits[BATCH] == steps * (2 * cfg.n_layers + 1)
    assert eng.decode_plans["logits_allgather"].hits[BATCH] == steps
    report = eng.plan_report()
    assert report["mode"] == "explicit"
    assert report["predicted_comm_us_per_token"] > 0


def test_unported_family_raises():
    """rwkv6 has no explicit decode, as in the reference: the step with
    ``comms`` raises (its auto path is tests/test_torch_rwkv6.py's). Its
    decode plans compile, as the reference's do, though nothing replays
    them (held against the reference's in tests/test_torch_rwkv6.py)."""
    cfg = configs.reduced(configs.get_config("rwkv6-7b"))
    params = tf.init_params(cfg, device="cpu")
    cache = tf.init_cache(cfg, BATCH, MAX_KV, device="cpu")
    with pytest.raises(NotImplementedError, match="explicit decode"):
        tf.decode_step(params, cfg, cache, torch.zeros(BATCH,
                                                       dtype=torch.long),
                       0, comms=object())
    comm = Communicator("model", n=2, device="cpu")
    assert set(compile_decode_plans(cfg, comm, batch_local=BATCH, tp=2)) \
        == {"layer_allreduce", "logits_allgather"}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b"])
def test_every_sharded_leaf_lies_contiguous_per_layer(arch):
    """Dense leaves share the experts' layout (the MoE case is in
    tests/test_torch_moe.py) whichever dim they split: ``wq``,
    ``w_gate`` and ``w_up`` on dim 2, ``wo`` and ``w_down`` on dim 1.
    Rank r holds its block along the split dim, and each layer's slice
    is contiguous."""
    from repro_torch.distributed.sharding import (SHARD_DIMS,
                                                  explicit_decode_params)
    from repro_torch.mesh import RankAxis
    cfg = configs.reduced(configs.get_config(arch))
    params = tf.init_params(cfg, device="cpu", seed=5)
    tp = 2
    ex = explicit_decode_params(params, cfg, RankAxis("model", tp, "cpu"))
    seen = 0
    for slot, eslot in zip(params["layers"], ex["layers"]):
        for (part, name), dim in SHARD_DIMS.items():
            if name not in slot.get(part, {}):
                continue
            v, ev = slot[part][name], eslot[part][name]
            for g in range(v.shape[0]):
                assert ev[:, g].is_contiguous()
                for r, want in enumerate(v[g].chunk(tp, dim - 1)):
                    assert torch.equal(ev[r, g], want)
            seen += 1
    assert seen == 5 * len(params["layers"])  # wq, wo and 3 MLP
