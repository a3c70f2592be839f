"""The port's temperature sampling (``repro_torch.serve.sampling``)
against ``jax.random`` under its defaults: keys, ``split`` and
``fold_in`` word for word, the random bits and the Gumbel sampler's
uniform draw bit for bit, ``categorical`` token for token up to a stated
near-tie margin, and the port's ``Engine.decode`` at a temperature
against the reference ``Engine.decode`` on qwen3-reduced."""
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
from repro_torch.core.comm import Communicator
from repro_torch.interop import params_from_jax
from repro_torch.serve import sampling
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

SEEDS = (0, 1, 2 ** 31 + 5, 2 ** 32 + 7)
# qwen3-1.7b's and hymba-1.5b's vocab at a serving batch of 8
SHAPES = ((8, 32001), (8, 151936))
# torch's f32 log and XLA's differ in the last place on about a fifth of
# the Gumbel draws (at most 1 ulp of values below 16 here), so the
# perturbed logits of a row can order two entries within this margin
# differently; outside it the tokens are equal
NEAR_TIE = 1e-5
ARCH = "qwen3-1.7b"
BATCH, PROMPT, STEPS, MAX_KV, TP, TEMPERATURE = 4, 4, 16, 64, 2, 0.7


def _words(jax_key) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(jax_key)))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    """``key``, ``split`` (three deep) and ``fold_in`` give jax's words."""
    k, kj = sampling.key(seed), jax.random.key(seed)
    assert k == _words(kj)
    for _ in range(3):
        (k, sub), (kj, subj) = sampling.split(k), jax.random.split(kj)
        assert (k, sub) == (_words(kj), _words(subj))
    for data in (0, 1, 12345, 2 ** 32 - 1):
        assert sampling.fold_in(k, data) == _words(jax.random.fold_in(kj,
                                                                      data))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bits_and_uniform_match_jax(shape):
    """The random bits and the Gumbel sampler's uniform draw (``minval``
    the f32 ``tiny``) bit-equal to jax's."""
    seed = 7
    k, kj = sampling.split(sampling.key(seed))[1], \
        jax.random.split(jax.random.key(seed))[1]
    got = sampling.bits(k, shape).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jax.random.bits(kj,
                                                                   shape)))
    u = sampling.gumbel_uniform(k, shape).numpy()
    uj = np.asarray(jax.random.uniform(
        kj, shape, minval=np.finfo(np.float32).tiny, maxval=1.0))
    np.testing.assert_array_equal(u.view(np.uint32), uj.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", [0, 3])
def test_categorical_matches_jax(seed, shape):
    """Tokens equal to ``jax.random.categorical``'s on every row whose
    perturbed logits (the reference's) have their top two more than
    NEAR_TIE apart; a near-tie row is counted, and its token must be one
    of the tied entries."""
    rng = np.random.RandomState(seed)
    k, kj = sampling.key(seed), jax.random.key(seed)
    near_ties, rows = 0, 0
    for _ in range(4):
        (k, sub), (kj, subj) = sampling.split(k), jax.random.split(kj)
        logits = (rng.randn(*shape) * 4).astype(np.float32)
        got = sampling.categorical(sub, torch.from_numpy(logits)).numpy()
        want = np.asarray(jax.random.categorical(subj, logits))
        perturbed = logits + np.asarray(jax.random.gumbel(subj, shape))
        top2 = np.sort(perturbed, axis=-1)[:, -2:]
        tied = top2[:, 1] - top2[:, 0] <= NEAR_TIE
        near_ties += int(tied.sum())
        rows += shape[0]
        np.testing.assert_array_equal(got[~tied], want[~tied])
        for r in np.flatnonzero(tied):
            assert perturbed[r, got[r]] >= top2[r, 1] - NEAR_TIE
    assert near_ties <= rows // 16, f"{near_ties} near-tie rows of {rows}"


def test_categorical_takes_f32_logits():
    with pytest.raises(TypeError, match="f32"):
        sampling.categorical(sampling.key(0),
                             torch.zeros(2, 8, dtype=torch.bfloat16))


def _prompts(vocab):
    return np.random.RandomState(0).randint(0, vocab, (BATCH, PROMPT))


@functools.lru_cache(maxsize=None)
def _reference_params():
    cfg = ref_configs.reduced(ref_configs.get_config(ARCH))
    mesh = Mesh(np.asarray(jax.devices()[:TP]).reshape(1, TP),
                ("data", "model"))
    params = ref_step.init_sharded(cfg, mesh, ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    return cfg, mesh, params


@pytest.mark.parametrize("seed", [0, 3])
def test_engine_temperature_tokens_match_reference(seed):
    """The port's explicit ``Engine.decode`` at T = 0.7 draws the
    reference explicit ``Engine``'s tokens over 16 steps (f32, TP=2, the
    reference's weights and link)."""
    ref_cfg, mesh, ref_params = _reference_params()
    scfg = dict(batch=BATCH, max_kv=MAX_KV, temperature=TEMPERATURE)
    ref = RefEngine(ref_cfg, ref_params, mesh, RefServeConfig(**scfg),
                    mode="explicit")
    assert ref.mode == "explicit"
    want = ref.decode(ref.prefill(_prompts(ref_cfg.vocab).astype(np.int32)),
                      num_tokens=STEPS, seed=seed)
    cfg = configs.reduced(configs.get_config(ARCH))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    eng = Engine(cfg, params, ServeConfig(**scfg), tp=TP, device="cpu",
                 mode="explicit", comm=Communicator(
                     "model", n=TP, device="cpu", link=selector.ICI))
    got = eng.decode(eng.prefill(_prompts(cfg.vocab)), num_tokens=STEPS,
                     seed=seed)
    np.testing.assert_array_equal(got, want)
    # the draw is not greedy: some token differs from the argmax path's
    greedy = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV),
                    tp=TP, device="cpu", mode="explicit")
    assert not np.array_equal(
        greedy.decode(greedy.prefill(_prompts(cfg.vocab)), STEPS), got)
