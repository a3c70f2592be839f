"""The port's int8 KV cache against the reference: the port of
``tests/test_kv_quant.py`` (int8 decode tracks the fp cache on
internvl2-reduced), greedy tokens of the port's ``Engine(kv_quant=True)``
against the reference ``Engine``'s at TP 2 and 4 on the reference's own
weights, and the port's explicit int8 decode against its auto one."""
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
from repro_torch.core.comm import Communicator
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

BATCH, PROMPT, STEPS, MAX_KV = 4, 4, 16, 64
# where the frameworks' f32 q·k sums round a q element to the other side
# of a bf16 step (or a value to the other int8 level), a near-tie of the
# argmax can split: the logits of that step still agree this closely
NEAR_TIE_REL_L2 = 1e-2


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_int8_kv_decode_tracks_fp():
    """The reference test's bar on the port, on the reference's weights:
    after 10 steps the int8 cache's logits lie within 5 % (max abs over
    max abs) of the fp cache's, with the same argmax on at least half the
    rows; and within 1e-2 (relative L2) of the reference's int8 logits."""
    ref_cfg = ref_configs.reduced(ref_configs.get_config("internvl2-76b"))
    cfg = configs.reduced(configs.get_config("internvl2-76b"))
    ref_params = ref_tf.init_params(ref_cfg, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    b, s = 2, 10
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (b, s))
    cache_fp = tf.init_cache(cfg, b, 16, device="cpu")
    cache_q = tf.init_cache(cfg, b, 16, device="cpu", dtype=torch.int8)
    ref_q = ref_tf.init_cache(ref_cfg, b, max_kv=16, dtype=jnp.int8)
    assert "k_scale" in cache_q
    pos = torch.zeros((), dtype=torch.long)
    with torch.inference_mode():
        for t in range(s):
            tok = torch.as_tensor(tokens[:, t], dtype=torch.long)
            pos.fill_(t)
            lg_fp, _ = tf.decode_step(params, cfg, cache_fp, tok, pos)
            lg_q, _ = tf.decode_step(params, cfg, cache_q, tok, pos)
            ref_lg, ref_q = ref_tf.decode_step(
                ref_params, ref_cfg, ref_q, jnp.asarray(tokens[:, t],
                                                        jnp.int32),
                jnp.int32(t))
    lg_fp, lg_q = lg_fp.numpy(), lg_q.numpy()
    rel = np.abs(lg_q - lg_fp).max() / np.abs(lg_fp).max()
    assert rel < 0.05, f"relative logit error {rel:.4f}"
    assert (lg_q.argmax(-1) == lg_fp.argmax(-1)).mean() >= 0.5
    assert _rel_l2(lg_q, np.asarray(ref_lg)) < NEAR_TIE_REL_L2


def _prompts(vocab):
    return np.random.RandomState(0).randint(0, vocab, (BATCH, PROMPT))


def _greedy(run, prompts, steps):
    """Feed the prompts, then ``steps`` greedy tokens: (tokens (b,
    steps), the logits each token was taken from, the last prompt
    step's first)."""
    for t in range(prompts.shape[1]):
        logits = run(prompts[:, t])
    seen, toks = [logits], []
    for _ in range(steps):
        toks.append(logits.argmax(-1))
        logits = run(toks[-1])
        seen.append(logits)
    return np.stack(toks, axis=1), seen


@functools.lru_cache(maxsize=None)
def _reference(arch, tp):
    """(params as numpy, tokens, logits) of the reference explicit Engine
    with an int8 KV cache on a (1, tp) data×model mesh, run as the
    reference's own int8 tests run it."""
    cfg = ref_configs.reduced(ref_configs.get_config(arch))
    mesh = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = ref_step.init_sharded(cfg, mesh, ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    eng = RefEngine(cfg, params, mesh,
                    RefServeConfig(batch=BATCH, max_kv=MAX_KV,
                                   kv_quant=True), mode="explicit")
    assert eng.mode == "explicit" and "k_scale" in eng.cache

    def run(tok):
        logits, eng.cache = eng._run_step(jnp.asarray(tok, jnp.int32))
        eng.pos += 1
        return np.asarray(logits)

    toks, seen = _greedy(run, _prompts(cfg.vocab), STEPS)
    return jax.tree.map(np.asarray, params), toks, seen


def _engine_run(cfg, params, tp, mode, max_kv=32, comm=None):
    """Greedy decode of the port's int8 Engine on the CPU (see
    :func:`_greedy`)."""
    eng = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=max_kv,
                                          kv_quant=True),
                 tp=tp, device="cpu", mode=mode, comm=comm)
    assert eng.cache["k"][0].dtype == torch.int8

    def run(tok):
        logits = eng._run_step(torch.as_tensor(tok, dtype=torch.long))
        eng.pos += 1
        return logits.numpy()

    return _greedy(run, _prompts(cfg.vocab), STEPS)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x22b"])
def test_port_int8_tokens_match_reference(arch, tp):
    """The port's explicit int8 Engine against the reference's, greedy
    over 16 steps: tokens equal, and every step's logits within 1e-2
    (relative L2). Should a near-tie split at some step, the tokens are
    held equal up to it and its logits within that bound."""
    np_params, ref_toks, ref_seen = _reference(arch, tp)
    cfg = configs.reduced(configs.get_config(arch))
    # the reference's link, so both engines replay the same algorithms
    comm = Communicator("model", n=tp, device="cpu", link=selector.ICI)
    toks, seen = _engine_run(cfg, params_from_jax(np_params, cfg,
                                                  device="cpu"),
                             tp, "explicit", MAX_KV, comm)
    differ = np.flatnonzero((toks != ref_toks).any(axis=0))
    last = differ[0] if differ.size else STEPS
    for t in range(last + 1):
        rel = _rel_l2(seen[t], ref_seen[t])
        assert rel < NEAR_TIE_REL_L2, (arch, tp, t, rel)
    np.testing.assert_array_equal(toks[:, :last], ref_toks[:, :last])
    assert not differ.size, (
        f"{arch} tp={tp}: tokens first differ at step {last} (logits there "
        f"within {NEAR_TIE_REL_L2} relative L2)")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x22b"])
def test_port_int8_explicit_matches_auto(arch, tp):
    """Explicit int8 decode equals auto int8 decode over 16 steps: every
    rank quantizes the same token against the same scale, and each head's
    scales are gathered beside its KV head."""
    cfg = configs.reduced(configs.get_config(arch))
    params = tf.init_params(cfg, device="cpu", seed=11)
    auto, _ = _engine_run(cfg, params, tp, "auto")
    explicit, _ = _engine_run(cfg, params, tp, "explicit")
    np.testing.assert_array_equal(explicit, auto)


@pytest.mark.parametrize("tp", [2, 4])
def test_port_int8_windowed_explicit_tracks_auto(tp):
    """gemma3-reduced with a window of 4 (the windowed layers' ring
    wraps), int8, explicit against auto over 16 steps. The port's TP
    partial sums round in another f32 order than auto's matmuls (the
    reference pins both), and an int8 level turns on that rounding
    where a value lies at a half step: here the greedy tokens split at a
    near-tie. So: tokens equal up to the first step that differs, every
    step's logits up to it within 1e-2 (relative L2), and the split a
    near-tie (auto's top-2 gap within the logits' largest difference)."""
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config("gemma3-12b")), window=4)
    params = tf.init_params(cfg, device="cpu", seed=11)
    auto, auto_seen = _engine_run(cfg, params, tp, "auto")
    explicit, seen = _engine_run(cfg, params, tp, "explicit")
    differ = np.flatnonzero((explicit != auto).any(axis=0))
    last = differ[0] if differ.size else STEPS
    for t in range(last + 1):
        assert _rel_l2(seen[t], auto_seen[t]) < NEAR_TIE_REL_L2, t
    np.testing.assert_array_equal(explicit[:, :last], auto[:, :last])
    for r in np.flatnonzero(explicit[:, last] != auto[:, last]) \
            if differ.size else ():
        top = np.sort(auto_seen[last][r])[::-1]
        shift = np.abs(seen[last][r] - auto_seen[last][r]).max()
        assert top[0] - top[1] <= shift, (tp, last, r, top[:2], shift)
