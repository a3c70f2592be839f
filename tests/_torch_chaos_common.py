"""Shared helpers of the chaos tests (``tests/test_torch_chaos.py``,
``tests/test_torch_chaos_families.py``): the families' configs on both
sides, the reference's engines (clean auto, and explicit under each
runtime fault of ``tests/test_chaos.py``) and the port's, and the
bodies of the reference test's cases for one family at one TP."""
import functools
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from benchmarks.llm_inference import _bench_cfg
from repro import configs as ref_configs
from repro.core import faults as ref_faults
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch import configs
from repro_torch.core import faults
from repro_torch.interop import params_from_jax
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

BATCH, PROMPT, TOKENS, MAX_KV = 2, 3, 4, 32
TPS = (2, 4)
COUNTERS = ("retries", "fallbacks", "faults_detected", "timeouts")
#: the reference test's specs and the serve knobs each is run under
CASES = {
    "fail_call": (dict(kind="fail_call", count=1), {}),
    "persistent": (dict(kind="fail_call", count=100), {}),
    "corrupt_chunk": (dict(kind="corrupt_chunk", count=1),
                      dict(guard_numerics=True)),
    "stall_rank": (dict(kind="stall_rank", count=1, delay_s=5.0),
                   dict(plan_timeout_s=0.75)),
}


def _ref_cfg(family):
    if family in ("dense", "int8"):
        return _bench_cfg()
    arch = {"moe": "phi3.5-moe-42b-a6.6b", "hybrid": "hymba-1.5b"}[family]
    return ref_configs.reduced(ref_configs.get_config(arch))


def _cfg(family):
    if family in ("dense", "int8"):
        ref = _bench_cfg()
        return ModelConfig(name=ref.name, family="dense",
                           n_layers=ref.n_layers, d_model=ref.d_model,
                           n_heads=ref.n_heads, n_kv_heads=ref.n_kv_heads,
                           head_dim=ref.head_dim, d_ff=ref.d_ff,
                           vocab=ref.vocab, max_seq=ref.max_seq,
                           dtype=ref.dtype)
    arch = {"moe": "phi3.5-moe-42b-a6.6b", "hybrid": "hymba-1.5b"}[family]
    return configs.reduced(configs.get_config(arch))


def _prompts(vocab):
    return np.random.RandomState(0).randint(
        0, vocab, (BATCH, PROMPT)).astype(np.int32)


def _ref_decode(eng, prompts):
    return np.asarray(eng.decode(eng.prefill(prompts), num_tokens=TOKENS))


@functools.lru_cache(maxsize=None)
def _ref_params(family, tp):
    """(mesh, params) of the reference on a (1, tp) mesh, made once: every
    case of a family and TP serves the same weights."""
    mesh = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    return mesh, ref_step.init_sharded(_ref_cfg(family), mesh,
                                       ref_shd.MeshAxes(),
                                       jax.random.key(0))[0]


@functools.lru_cache(maxsize=None)
def _reference(family, tp, case=None):
    """(params as numpy, greedy tokens, health) of the reference engine
    on a (1, tp) mesh: clean auto (``case=None``) or explicit under the
    case's fault."""
    cfg = _ref_cfg(family)
    mesh, params = _ref_params(family, tp)
    spec, kw = CASES[case] if case else ({}, {})
    eng = RefEngine(cfg, params, mesh, RefServeConfig(
        batch=BATCH, max_kv=MAX_KV, mode="explicit" if case else "auto",
        kv_quant=family == "int8", **kw))
    prompts = _prompts(cfg.vocab)
    if case is None:
        toks = _ref_decode(eng, prompts)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with ref_faults.inject(ref_faults.FaultSpec(**spec)):
                toks = _ref_decode(eng, prompts)
    return (jax.tree.map(np.asarray, params), toks,
            {k: eng.health[k] for k in COUNTERS})


def _ref_health(family, tp, case):
    """The reference engine's counters under ``case`` at this TP."""
    return _reference(family, tp, case)[2]


@functools.lru_cache(maxsize=None)
def _params(family, tp):
    return params_from_jax(_reference(family, tp)[0], _cfg(family),
                           device="cpu")


def _engine(family, tp, mode, **kw):
    return Engine(_cfg(family), _params(family, tp),
                  ServeConfig(batch=BATCH, max_kv=MAX_KV,
                              kv_quant=family == "int8", **kw),
                  tp=tp, device="cpu", mode=mode)


def _decode(eng):
    return eng.decode(eng.prefill(_prompts(eng.cfg.vocab)),
                      num_tokens=TOKENS)


def _snapshot(cache):
    return {k: [leaf.clone() for leaf in v] for k, v in cache.items()}


def _same(a, b):
    return all(torch.equal(x, y) for k in a for x, y in zip(a[k], b[k]))


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_chaos.py), one family at one TP
# ---------------------------------------------------------------------------
def guardrails_do_not_perturb_clean_decode(family, tp):
    """Every guardrail armed and no fault: explicit stays explicit, its
    tokens equal the reference's clean auto ones, the decode loop is
    pure plan replay (compile counters flat) and every counter is 0."""
    _, ref_toks, _ = _reference(family, tp)
    eng = _engine(family, tp, "explicit", guard_numerics=True,
                  plan_timeout_s=30.0)
    assert eng.mode == "explicit"
    logits = eng.prefill(_prompts(eng.cfg.vocab))
    compiles = eng.comm.stats["compiles"]
    toks = eng.decode(logits, num_tokens=TOKENS)
    assert eng.comm.stats["compiles"] == compiles, "decode recompiled"
    assert eng.mode == "explicit"
    np.testing.assert_array_equal(toks, ref_toks)
    health = eng.plan_report()["health"]
    assert all(health[k] == 0 for k in COUNTERS)
    assert health["verified"] > 0 and health["verify_failures"] == 0
    assert eng.abandoned == []


def transient_failure_recovers_by_retry(family, tp):
    _, ref_toks, _ = _reference(family, tp)
    eng = _engine(family, tp, "explicit")
    with faults.inject(faults.FaultSpec("fail_call", count=1)) as inj:
        toks = _decode(eng)
    assert inj.fired == 1
    assert eng.mode == "explicit", "a transient must not cost the fast path"
    assert eng.health["retries"] >= 1 and eng.health["fallbacks"] == 0
    np.testing.assert_array_equal(toks, ref_toks)
    assert eng.health == _ref_health(family, tp, "fail_call")


def persistent_failure_falls_back_to_auto(family, tp):
    """Retries exhausted: a loud, permanent fallback to auto; the failed
    step re-runs there, so no token is lost."""
    _, ref_toks, _ = _reference(family, tp)
    eng = _engine(family, tp, "explicit")
    with pytest.warns(UserWarning, match="falling back to auto"):
        with faults.inject(faults.FaultSpec("fail_call", count=100)):
            toks = _decode(eng)
    assert (eng.mode, eng.requested_mode) == ("auto", "explicit")
    assert eng.plan_report()["degraded"] is True
    assert eng.health["retries"] == eng.scfg.max_retries
    assert eng.health["fallbacks"] >= 1
    np.testing.assert_array_equal(toks, ref_toks)
    assert eng.health == _ref_health(family, tp, "persistent")


def numeric_guard_detects_corruption(family, tp):
    _, ref_toks, _ = _reference(family, tp)
    eng = _engine(family, tp, "explicit", guard_numerics=True)
    with pytest.warns(UserWarning, match="non-finite"):
        with faults.inject(faults.FaultSpec("corrupt_chunk",
                                            count=1)) as inj:
            toks = _decode(eng)
    assert inj.fired == 1
    assert eng.mode == "auto"
    assert eng.health["faults_detected"] >= 1
    np.testing.assert_array_equal(toks, ref_toks)
    assert eng.health == _ref_health(family, tp, "corrupt_chunk")


def watchdog_times_out_stalled_rank(family, tp):
    """The watchdog gives the stalled step up, the engine falls back and
    re-runs it; the abandoned worker, when it wakes, leaves the engine's
    cache bit-equal."""
    _, ref_toks, _ = _reference(family, tp)
    want = _ref_health(family, tp, "stall_rank")
    eng = _engine(family, tp, "explicit", plan_timeout_s=0.75)
    with pytest.warns(UserWarning, match="plan_timeout_s"):
        with faults.inject(
                faults.FaultSpec("stall_rank", count=1, delay_s=3.0)) as inj:
            toks = _decode(eng)
    assert inj.fired == 1
    assert eng.mode == "auto"
    assert eng.health["timeouts"] >= 1
    np.testing.assert_array_equal(toks, ref_toks)
    assert eng.health == want
    (worker,) = eng.abandoned
    if family in ("dense", "hybrid"):
        saved = _snapshot(eng.cache)
        assert not worker.done(), "the stalled worker woke before the check"
        worker.exception(timeout=30)        # wait for it to wake and end
        assert _same(eng.cache, saved), \
            "the abandoned worker wrote the engine's cache"
