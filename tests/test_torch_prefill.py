"""The port's full-sequence forward and prefill step against the
reference's, on ``reduced()`` qwen3-1.7b, gemma3-12b (window 4, so the
local layers' window is shorter than the sequence), hubert-xlarge (the
encoder: bidirectional, float frame inputs), phi3.5-moe, llama3.2-3b
with padded heads and hymba-1.5b (window 4; attention and the SSM scan): the reference's own ``init_params`` weights carried
across with ``params_from_jax``, the same seeded inputs, hidden states
and logits within the f32 tolerance of ``tests/test_torch_decode.py``. Both branches
of the plain attention core (materialized and KV-chunked) run on both
sides. Inside the port, the fused prefill step against the engine's
token-by-token prefill. The flash-attention kernel that the forward runs
on the card is held against this plain path by ``chip_smoke.py`` phase
10."""
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
from repro.models import blocks as ref_blocks
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.distributed.step import make_prefill_step
from repro_torch.interop import params_from_jax
from repro_torch.models import blocks
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

B, S = 2, 16
# f32 on both sides; the frameworks order their matmul and softmax sums
# differently, so outputs agree to rounding, not bit for bit
RTOL = ATOL = 1e-4
# arch -> config overrides on top of reduced(); llama3.2's heads padded
# from 4 to 8 (the padded heads hard-masked to zero)
ARCHS = {"qwen3-1.7b": {}, "gemma3-12b": dict(window=4),
         "hubert-xlarge": {}, "phi3.5-moe-42b-a6.6b": {},
         "llama3.2-3b": dict(pad_heads_to=8),
         "hymba-1.5b": dict(window=4)}


def _cfgs(arch, **extra):
    """(reference config, port config), reduced, with the same overrides."""
    over = dict(ARCHS[arch], **extra)
    return (dataclasses.replace(
                ref_configs.reduced(ref_configs.get_config(arch)), **over),
            dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                **over))


def _inputs(cfg):
    """Token ids, or float frame embeddings for a frontend arch."""
    r = np.random.RandomState(0)
    if cfg.frontend != "none":
        return r.randn(B, S, cfg.d_model).astype(np.float32)
    return r.randint(0, cfg.vocab, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(arch, chunk=None):
    """(params as numpy, hidden, full-sequence logits, last-position
    logits of the reference's ``make_prefill_step``) on ``_inputs``;
    ``chunk`` sets ``attn_chunk`` (no step then)."""
    cfg, _ = _cfgs(arch, **({} if chunk is None else dict(attn_chunk=chunk)))
    params = ref_tf.init_params(cfg, jax.random.key(0))
    toks = _inputs(cfg)

    @jax.jit
    def run(p, t):
        h = ref_tf.forward(p, cfg, t)
        return h, ref_tf.logits_fn(p, cfg, h)

    hidden, logits = run(params, jnp.asarray(toks))
    last = None
    if chunk is None:
        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        step, _ = ref_step.make_prefill_step(cfg, mesh, ref_shd.MeshAxes(),
                                             global_batch=B, seq_len=S)
        last = np.asarray(step(params, toks))
    return (jax.tree.map(np.asarray, params), np.asarray(hidden),
            np.asarray(logits), last)


def _port_params(arch, cfg):
    return params_from_jax(_reference(arch)[0], cfg, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_prefill_step_match_reference(arch):
    _, ref_hidden, ref_logits, ref_last = _reference(arch)
    _, cfg = _cfgs(arch)
    params = _port_params(arch, cfg)
    hidden = tf.forward(params, cfg, torch.as_tensor(_inputs(cfg)))
    _close(hidden, ref_hidden)
    _close(tf.logits_fn(params, cfg, hidden), ref_logits)
    last = make_prefill_step(cfg, device="cpu")(params, _inputs(cfg))
    assert last.dtype == torch.float32 and last.shape == (B, cfg.vocab)
    _close(last, ref_last)
    np.testing.assert_array_equal(last.argmax(-1).numpy(),
                                  ref_last.argmax(-1))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b",
                                  "hubert-xlarge"])
def test_chunked_attention_matches_reference(arch, monkeypatch):
    """``attn_chunk`` 4 < s = 16: both sides take the online-softmax chunk
    loop in every layer (the port's is counted), agree with each other,
    and with the materialized branch."""
    _, ref_hidden, _, _ = _reference(arch, chunk=4)
    _, cfg = _cfgs(arch, attn_chunk=4)
    params = _port_params(arch, cfg)
    calls = []
    chunked = blocks._chunked_attn

    def counted(*a, **kw):
        calls.append(kw["chunk"])
        return chunked(*a, **kw)

    monkeypatch.setattr(blocks, "_chunked_attn", counted)
    hidden = tf.forward(params, cfg, torch.as_tensor(_inputs(cfg)))
    assert calls == [4] * cfg.n_layers
    _close(hidden, ref_hidden)
    _close(hidden, _reference(arch)[1])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b",
                                  "phi3.5-moe-42b-a6.6b", "hymba-1.5b"])
def test_fused_prefill_matches_token_by_token(arch):
    """The port's own invariant: the fused step's last-position logits
    equal the engine's token-by-token prefill (gemma3's ring buffers of 4
    slots wrap)."""
    _, cfg = _cfgs(arch)
    params = tf.init_params(cfg, device="cpu", seed=7)
    prompts = np.random.RandomState(7).randint(0, cfg.vocab, (B, S))
    fused = make_prefill_step(cfg, device="cpu")(params, prompts)
    eng = Engine(cfg, params, ServeConfig(batch=B, max_kv=32), device="cpu")
    stepwise = eng.prefill(prompts)
    _close(fused, stepwise.numpy())
    np.testing.assert_array_equal(fused.argmax(-1).numpy(),
                                  stepwise.argmax(-1).numpy())


def test_encoder_runs_forward_and_refuses_decode():
    _, cfg = _cfgs("hubert-xlarge")
    params = tf.init_params(cfg, device="cpu", seed=1)
    frames = torch.randn(B, S, cfg.d_model)
    assert tf.forward(params, cfg, frames).shape == (B, S, cfg.d_model)
    with pytest.raises(NotImplementedError, match="encoder"):
        tf.init_cache(cfg, B, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder"):
        tf.decode_step(params, cfg, None, torch.zeros(B, dtype=torch.long), 0)
    with pytest.raises(NotImplementedError, match="encoder"):
        Engine(cfg, params, ServeConfig(batch=B, max_kv=8), device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6-7b"])
def test_unported_families_refuse_forward(arch):
    """rwkv6 has a forward but no fused prefill, as in the reference: it
    prefills token by token through the decode step, and
    ``prefill_step`` raises."""
    cfg = configs.reduced(configs.get_config(arch))
    params = tf.init_params(cfg, device="cpu")
    tokens = torch.zeros(B, S, dtype=torch.long)
    assert tf.forward(params, cfg, tokens).shape == (B, S, cfg.d_model)
    cache = tf.init_cache(cfg, B, S, device="cpu")
    with pytest.raises(NotImplementedError, match="token by token"):
        tf.prefill_step(params, cfg, cache, tokens,
                        torch.zeros(B, dtype=torch.long),
                        torch.full((B,), S, dtype=torch.long))


@pytest.mark.parametrize("q_len,kv_len,causal,window,q_offset", [
    (8, 8, True, None, 0), (8, 8, False, None, 0), (8, 8, True, 3, 0),
    (8, 8, False, 3, 0), (4, 12, True, 5, 8)])
def test_attention_mask_matches_reference(q_len, kv_len, causal, window,
                                          q_offset):
    got = blocks._attn_mask(q_len, kv_len, causal=causal, window=window,
                            q_offset=q_offset)
    want = ref_blocks._attn_mask(q_len, kv_len, causal=causal,
                                 window=window, q_offset=q_offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rope_positions_match_reference():
    """A vector of positions gathers the reference's host table rows (the
    table grows past its 4096-row floor), the same rows as one position
    at a time; past ``max_pos`` or below 0 it raises."""
    pos = np.array([0, 3, 5000, 17])
    cos, sin = blocks.rope(torch.as_tensor(pos), 32, 1e6, "cpu")
    want_cos, want_sin = ref_blocks.rope(jnp.asarray(pos), 32, 1e6)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(want_cos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(want_sin))
    for i, p in enumerate(pos):
        c1, s1 = blocks.rope(int(p), 32, 1e6, "cpu")
        assert torch.equal(c1, cos[i]) and torch.equal(s1, sin[i])
    with pytest.raises(ValueError, match="max_pos"):
        blocks.rope(torch.arange(10), 32, 1e4, "cpu", max_pos=8)
    with pytest.raises(ValueError, match="negative"):
        blocks.rope(torch.tensor([2, -1]), 32, 1e4, "cpu")


def test_prefill_step_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_prefill_step(_cfgs("qwen3-1.7b")[1])


def test_forward_on_cpu_never_reaches_the_kernel():
    """A CPU tensor runs the plain core; asking it for the kernel
    raises instead of falling back."""
    _, cfg = _cfgs("qwen3-1.7b")
    params = tf.init_params(cfg, device="cpu", seed=2)
    toks = torch.zeros(B, S, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tf.forward(params, cfg, toks, backend="cuda")
