"""The port's model examples (``examples_torch/serve_llm.py``,
``prefix_serve.py``, ``train_llm.py``) against the reference's, with
``--device cpu`` and ``scripts/check.sh``'s fast arguments, the
reference's own weights carried across (``interop.params_from_jax`` of
its ``init_params`` from ``jax.random.key(0)``):

* serve_llm: the sampled continuation (T = 0.8, seed 1, 4 tokens, every
  sequence) equal to the reference ``Engine``'s on the example's (2, 4)
  mesh, in explicit and in auto mode; compiles flat across decode;
* prefix_serve: ``micro_steps``, ``prefix_hits``/``prefix_misses`` and
  ``prefill_bucket_steps`` of the warm and the cold run equal to the
  reference's ``benchmarks/loadgen.run_serve_load`` on the same
  ``TrafficConfig``, both runs bit-identical to the sequential baseline;
* train_llm: ``--tiny`` losses within the reference test's ``rtol 2e-3,
  atol 1e-4`` of the reference's ``train.loop.run`` (auto: explicit needs
  partial-manual ``shard_map``), the port in both modes; a second run on
  the same ``--ckpt-dir`` resumes from the first's checkpoint."""
import dataclasses
import functools
import importlib.util
import pathlib
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from benchmarks import loadgen as ref_loadgen
from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.models import transformer as ref_tf
from repro.models.config import ModelConfig as RefModelConfig
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch.interop import params_from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# tests/test_train_integration.py's bar
RTOL, ATOL = 2e-3, 1e-4


def example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_cfg(cfg):
    """The reference's ModelConfig with the port config's fields."""
    return RefModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(RefModelConfig)})


def _mesh(shape, names):
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)


# -- serve_llm -----------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _serve_params():
    cfg = _ref_cfg(example("serve_llm").serve_demo())
    return cfg, ref_step.init_sharded(cfg, _mesh((2, 4), ("data", "model")),
                                      ref_shd.MeshAxes(),
                                      jax.random.key(0))[0]


def _ref_serve(mode, tokens):
    """``examples/serve_llm.py``'s run on the reference."""
    mod = example("serve_llm")
    cfg, params = _serve_params()
    eng = RefEngine(cfg, params, _mesh((2, 4), ("data", "model")),
                    RefServeConfig(batch=8, max_kv=256,
                                   temperature=mod.TEMPERATURE, mode=mode))
    assert eng.mode == mode
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (8, mod.PROMPT)).astype(np.int32)
    return eng.decode(eng.prefill(prompts), num_tokens=tokens,
                      seed=mod.SEED)


@pytest.mark.parametrize("mode", ["explicit", "auto"])
def test_serve_llm_continuation_matches_reference(mode):
    mod = example("serve_llm")
    _, ref_params = _serve_params()
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             mod.serve_demo(), device="cpu")
    res = mod.main(["--device", "cpu", "--tokens", "4", "--mode", mode],
                   params=params)
    assert res["mode"] == mode and res["graph"] is False
    assert res["compiles_after_decode"] == res["compiles_before_decode"]
    want = _ref_serve(mode, 4)
    np.testing.assert_array_equal(np.asarray(res["tokens"]), want)
    assert res["continuation"] == want[0][:16].tolist()
    if mode == "explicit":
        # 4 layers x 2 AllReduces, and the embedding's, a step: 9 a step
        # over 12 prompt + 4 decode steps, at the full bucket
        assert res["hits"]["layer_allreduce"][8] == 9 * 16
        assert res["hits"]["logits_allgather"][8] == 16


# -- prefix_serve --------------------------------------------------------------
def _tcfg(requests=8):
    return ref_loadgen.TrafficConfig(
        seed=1, n_requests=requests, prefix_pool=2, prefix_len=6,
        max_prompt=6, max_new=6, temperature=0.8)


def test_prefix_serve_matches_reference():
    cfg = ref_configs.reduced(ref_configs.get_config("qwen3-1.7b"))
    from repro_torch import configs
    params = params_from_jax(
        jax.tree.map(np.asarray, ref_tf.init_params(cfg,
                                                    jax.random.key(0))),
        configs.reduced(configs.get_config("qwen3-1.7b")), device="cpu")
    res = example("prefix_serve").main(["--device", "cpu", "--requests",
                                        "8"], params=params)
    plan_dir = tempfile.mkdtemp(prefix="ref_prefix_serve_")
    want = dict(
        warm=ref_loadgen.run_serve_load(
            _tcfg(), fused_prefill=True, prefill_seq_buckets=(4, 8),
            prefix_cache_tokens=0, plan_dir=plan_dir),
        cold=ref_loadgen.run_serve_load(_tcfg(), plan_dir=plan_dir))
    for run in ("warm", "cold"):
        got, ref = res[run], want[run]
        assert got["bit_identical"] and ref["bit_identical"]
        for key in ("requests", "completed", "dropped", "micro_steps",
                    "prefix_hits", "prefix_misses", "prefix_tokens_reused",
                    "prefill_bucket_steps", "tokens", "modes"):
            assert got[key] == ref[key], (run, key)
    assert res["warm"]["prefix_hits"] > 0


# -- train_llm -----------------------------------------------------------------
TRAIN_ARGS = ["--steps", "2", "--tiny"]


@functools.lru_cache(maxsize=None)
def _ref_train():
    """``examples/train_llm.py --steps 2 --tiny`` on the reference, in
    auto mode (explicit needs partial-manual ``shard_map``), and its
    initial weights (``init_sharded`` from ``jax.random.key(0)``)."""
    mod = example("train_llm")
    cfg = _ref_cfg(mod.tiny(mod.model_100m()))
    res = ref_loop.run(
        cfg, _mesh((2, 4), ("data", "model")),
        ref_loop.TrainConfig(steps=2, global_batch=8, seq_len=256,
                             ckpt_every=50, log_every=10, mode="auto"),
        opt_cfg=ref_opt.AdamWConfig(lr=3e-4, total_steps=2,
                                    warmup_steps=1))
    init = jax.tree.map(np.asarray, ref_tf.init_params(cfg,
                                                       jax.random.key(0)))
    return res["losses"], init


@pytest.mark.parametrize("mode", ["explicit", "auto"])
def test_train_llm_losses_match_reference(mode, tmp_path):
    mod = example("train_llm")
    want, init = _ref_train()
    cfg = mod.tiny(mod.model_100m())
    res = mod.main(["--device", "cpu", *TRAIN_ARGS, "--mode", mode,
                    "--ckpt-dir", str(tmp_path)],
                   params=params_from_jax(init, cfg, device="cpu"))
    np.testing.assert_allclose(res["losses"], want, rtol=RTOL, atol=ATOL)
    assert res["resumed_from"] is None and res["saved"] == 2
    if mode == "explicit":
        # every gradient shape planned once, then replayed
        (stats,) = res["plan_stats"].values()
        assert stats["compiles"] == stats["plans"] and stats["hits"] > 0
    else:
        assert res["plan_stats"] == {}


def test_train_llm_resumes_from_its_checkpoint(tmp_path):
    mod = example("train_llm")
    args = ["--device", "cpu", "--tiny", "--ckpt-dir", str(tmp_path)]
    first = mod.main(args + ["--steps", "2"])
    again = mod.main(args + ["--steps", "3"])
    assert first["saved"] == 2
    assert again["resumed_from"] == 2 and len(again["losses"]) == 1
    assert again["saved"] == 3
