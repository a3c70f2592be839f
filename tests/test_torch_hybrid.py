"""The port's hybrid (attention+SSM) family against the reference on
hymba-reduced, the reference's own weights carried across with
``params_from_jax``: ``forward``, and greedy decode of the port's
explicit ``Engine`` against the reference's explicit ``Engine`` at TP 2
and 4 with the f32 and the int8 KV cache; then, inside the port,
explicit against auto, plan replay (3 replays a layer, compile counters
flat), ``plan_report``'s accounting, the explicit cache layout (SSM
state rank-sharded, KV replicated) and a padded-heads explicit run."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.models import transformer as ref_tf
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch import configs
from repro_torch.core import selector
from repro_torch.core.comm import BucketedPlan, Communicator
from repro_torch.distributed import sharding as shd
from repro_torch.interop import params_from_jax
from repro_torch.mesh import RankAxis
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

ARCH = "hymba-1.5b"
BATCH, PROMPT, STEPS, MAX_KV = 4, 4, 16, 64
# f32 on both sides (tests/test_torch_decode.py's bar)
RTOL = ATOL = 1e-4


def _cfg(**kw):
    return dataclasses.replace(configs.reduced(configs.get_config(ARCH)),
                               **kw)


def _prompts(vocab):
    return np.random.RandomState(0).randint(0, vocab, (BATCH, PROMPT))


@functools.lru_cache(maxsize=None)
def _reference(tp, kv_quant=False, pad_heads_to=0):
    """(params as numpy, first logits, greedy tokens) of the reference
    explicit Engine on a (1, tp) data×model mesh."""
    cfg = dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(ARCH)),
        pad_heads_to=pad_heads_to)
    mesh = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = ref_step.init_sharded(cfg, mesh, ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    eng = RefEngine(cfg, params, mesh,
                    RefServeConfig(batch=BATCH, max_kv=MAX_KV,
                                   kv_quant=kv_quant), mode="explicit")
    assert eng.mode == "explicit"
    logits = np.asarray(eng.prefill(_prompts(cfg.vocab).astype(np.int32)))
    toks = eng.decode(logits, num_tokens=STEPS)
    return jax.tree.map(np.asarray, params), logits, toks


def _engine(cfg, params, tp, mode, kv_quant=False, comm=None):
    return Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV,
                                           kv_quant=kv_quant),
                  tp=tp, device="cpu", mode=mode, comm=comm)


def _serve(eng):
    logits = eng.prefill(_prompts(eng.cfg.vocab))
    first = logits.numpy().copy()
    return first, eng.decode(logits, num_tokens=STEPS)


def test_forward_matches_reference():
    """The full-sequence forward (attention and the SSM scan averaged in
    every layer) within RTOL/ATOL of the reference's, and the weights
    carried across exactly (``a_log`` in f32 among them)."""
    ref_cfg = ref_configs.reduced(ref_configs.get_config(ARCH))
    cfg = _cfg()
    ref_params = ref_tf.init_params(ref_cfg, jax.random.key(1))
    np_params = jax.tree.map(np.asarray, ref_params)
    params = params_from_jax(np_params, cfg, device="cpu")
    for slot, np_slot in zip(params["layers"], np_params["layers"]):
        assert set(slot["ssm"]) == set(np_slot["ssm"])
        for k, v in np_slot["ssm"].items():
            np.testing.assert_array_equal(slot["ssm"][k].numpy(), v)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (2, 24))
    want = ref_tf.forward(ref_params, ref_cfg, jnp.asarray(tokens,
                                                           jnp.int32))
    got = tf.forward(params, cfg, torch.as_tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_port_explicit_matches_reference_explicit(tp, kv_quant):
    """Greedy tokens of the port's explicit Engine equal the reference
    explicit Engine's over 16 steps, with the f32 and the int8 KV cache
    (both engines replay plans of the same algorithms: the port is given
    the reference's link); the last prefill logits within RTOL/ATOL."""
    np_params, ref_logits, ref_toks = _reference(tp, kv_quant)
    cfg = _cfg()
    comm = Communicator("model", n=tp, device="cpu", link=selector.ICI)
    eng = _engine(cfg, params_from_jax(np_params, cfg, device="cpu"), tp,
                  "explicit", kv_quant, comm)
    assert ("k_scale" in eng.cache) == kv_quant
    logits, toks = _serve(eng)
    np.testing.assert_allclose(logits, ref_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(toks, ref_toks)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_port_explicit_matches_port_auto(tp, kv_quant):
    cfg = _cfg()
    params = tf.init_params(cfg, device="cpu", seed=11)
    toks = {mode: _serve(_engine(cfg, params, tp, mode, kv_quant))[1]
            for mode in ("auto", "explicit")}
    np.testing.assert_array_equal(toks["explicit"], toks["auto"])


def test_explicit_replays_three_a_layer():
    """Plans exist before the first token and decode replays them:
    compile counters flat, and with a vocab that does not divide the
    axis (hymba-1.5b's 32001 over 4) the full-batch bucket serves
    exactly 3 replays a layer a step (attention, SSM, MLP) — no
    embedding replay and no logits AllGather plan."""
    cfg = _cfg(vocab=513)
    params = tf.init_params(cfg, device="cpu", seed=3)
    eng = _engine(cfg, params, 2, "explicit")
    assert set(eng.decode_plans) == {"layer_allreduce"}
    compiles = eng.comm.stats["compiles"]
    assert compiles > 0
    ar = eng.decode_plans["layer_allreduce"]
    assert isinstance(ar, BucketedPlan)
    eng.decode(eng.prefill(_prompts(cfg.vocab)), num_tokens=2)
    assert eng.comm.stats["compiles"] == compiles
    steps = PROMPT + 2
    assert ar.hits[BATCH] == steps * (3 * cfg.n_layers)


@pytest.mark.parametrize("vocab", [512, 513])
def test_plan_report_counts_three_allreduces_a_layer(vocab):
    cfg = _cfg(vocab=vocab)
    eng = _engine(cfg, tf.init_params(cfg, device="cpu", seed=3), 2,
                  "explicit")
    ar = eng.decode_plans["layer_allreduce"]
    ar_us = ar.plans[ar.buckets[-1]].estimate_us
    want = 3 * cfg.n_layers * ar_us
    if "logits_allgather" in eng.decode_plans:
        ag = eng.decode_plans["logits_allgather"]
        want += ar_us + ag.plans[ag.buckets[-1]].estimate_us
    assert eng.plan_report()["predicted_comm_us_per_token"] == \
        round(want, 2)


def test_explicit_cache_shards_the_ssm_state_and_replicates_kv():
    """The explicit cache: every rank holds every KV head (replicas equal
    after decode), and rank r holds rows [r·d/tp, (r+1)·d/tp) of the SSM
    state, which track auto's state rows."""
    tp = 2
    cfg = _cfg()
    params = tf.init_params(cfg, device="cpu", seed=5)
    auto, explicit = (_engine(cfg, params, tp, mode)
                      for mode in ("auto", "explicit"))
    d_local = cfg.d_model // tp
    for st in explicit.cache["ssm"]:
        assert st.shape == (tp, tf.n_groups(cfg), BATCH, d_local,
                            cfg.ssm.state_dim)
        assert st.dtype == torch.float32
    for eng in (auto, explicit):
        _serve(eng)
    for k in explicit.cache["k"] + explicit.cache["v"]:
        assert k.shape[0] == tp and torch.equal(k[0], k[1])
    for st, want in zip(explicit.cache["ssm"], auto.cache["ssm"]):
        assert bool(st.abs().sum() > 0)
        torch.testing.assert_close(st.movedim(0, -3).flatten(-3, -2), want,
                                   rtol=RTOL, atol=ATOL)


def test_sharded_ssm_leaves_lie_contiguous_per_layer():
    """``w_dt`` on its last dim, ``a_log``/``d_skip``/``w_out`` on their
    ``d_inner`` dim, each layer's slice contiguous; ``w_in`` and
    ``w_bcdt`` replicated."""
    tp = 4
    cfg = _cfg()
    params = tf.init_params(cfg, device="cpu", seed=5)
    ex = shd.explicit_decode_params(params, cfg, RankAxis("model", tp,
                                                          "cpu"))
    for slot, eslot in zip(params["layers"], ex["layers"]):
        for name, v in slot["ssm"].items():
            ev = eslot["ssm"][name]
            dim = shd.SHARD_DIMS.get(("ssm", name))
            for g in range(v.shape[0]):
                want = ([v[g]] * tp if dim is None
                        else v[g].chunk(tp, dim - 1))
                for r in range(tp):
                    assert torch.equal(ev[r, g], want[r]), name
                if dim is not None:
                    assert ev[:, g].is_contiguous()
    assert shd.explicit_decode_supported(_cfg(d_model=130, n_heads=4), 4) \
        == (False, "SSM inner dim d_model 130 not divisible by TP=4")


def test_padded_heads_explicit_matches_reference():
    """pad_heads_to=8 at TP=4 (hymba-reduced's 4 heads over 1 KV head
    become 8 over 2, the padded heads masked): the port's explicit
    tokens equal its auto ones and the reference explicit Engine's."""
    tp = 4
    np_params, _, ref_toks = _reference(tp, pad_heads_to=8)
    cfg = _cfg(pad_heads_to=8)
    params = params_from_jax(np_params, cfg, device="cpu")
    assert params["layers"][0]["attn"]["wq"].shape[-2] == 8
    comm = Communicator("model", n=tp, device="cpu", link=selector.ICI)
    explicit = _serve(_engine(cfg, params, tp, "explicit", comm=comm))[1]
    auto = _serve(_engine(cfg, params, tp, "auto"))[1]
    np.testing.assert_array_equal(explicit, auto)
    np.testing.assert_array_equal(explicit, ref_toks)
