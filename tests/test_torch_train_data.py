"""The port's training utilities against the reference's, on the same
seeded numpy inputs: the data pipeline (``repro_torch.train.data``: the
synthetic stream bit for bit, the frontend stream within its f32 bar,
the memmap shards equal), AdamW and its schedule
(``repro_torch.train.optimizer``, f32 1e-6 relative), the wire
compression (``repro_torch.train.compression``: the reference's two
tests on the port, the int8 payload bit for bit) and the checkpoints
(``repro_torch.train.checkpoint``: the reference's own ``save`` restored
in the port, a bf16 leaf round-tripped bit for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_comp
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch import configs, prng, tree
from repro_torch.interop import params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import data
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

# the frontend stream's normal draws: torch's erfinv against XLA's, in f32
NORMAL_RTOL = NORMAL_ATOL = 2e-5
# AdamW over three steps, f32 state: the frameworks' pow and cos may
# differ in the last place
OPT_RTOL = 1e-6


@pytest.mark.parametrize("vocab", [512, 151936])
@pytest.mark.parametrize("step", [0, 1, 17])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_stream_bit_equal(seed, step, vocab):
    """tokens and labels of ``batch_at(step)`` equal the reference's;
    151936 and 512 are spans the modulo fold reaches differently (the
    uint32 multiplier wraps to 0 above 2**16)."""
    kw = dict(vocab=vocab, batch=4, seq_len=33, seed=seed)
    want = ref_data.SyntheticLM(ref_data.DataConfig(**kw)).batch_at(step)
    got = data.SyntheticLM(data.DataConfig(**kw)).batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("span", [(0, 1), (0, 7), (-5, 2 ** 16 + 1),
                                  (3, 2 ** 31 - 1)])
def test_randint_spans(span):
    lo, hi = span
    k = prng.fold_in(prng.key(11), 5)
    want = jax.random.randint(jax.random.fold_in(jax.random.key(11), 5),
                              (3, 37), lo, hi, jnp.int32)
    np.testing.assert_array_equal(prng.randint(k, (3, 37), lo, hi).numpy(),
                                  np.asarray(want))


def test_embedded_stream_within_f32():
    kw = dict(vocab=512, batch=2, seq_len=16, seed=1, embedded_dim=64)
    for step in (0, 5):
        want = ref_data.SyntheticLM(ref_data.DataConfig(**kw)).batch_at(step)
        got = data.SyntheticLM(data.DataConfig(**kw)).batch_at(step)
        assert got["tokens"].dtype == torch.float32
        np.testing.assert_allclose(got["tokens"].numpy(),
                                   np.asarray(want["tokens"]),
                                   rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))


def test_memmap_tokens_equal(tmp_path):
    r = np.random.RandomState(0)
    for i in range(3):
        r.randint(0, 60000, 500).astype(np.uint16).tofile(
            tmp_path / f"shard_{i}.bin")
    kw = dict(vocab=1000, batch=4, seq_len=24, seed=2, path=str(tmp_path))
    src = data.make_pipeline(data.DataConfig(**kw))
    assert isinstance(src, data.MemmapTokens)
    ref = ref_data.make_pipeline(ref_data.DataConfig(**kw))
    for step in (0, 4):
        got, want = src.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _tree(r, dtype):
    """A small tree of nested dicts and a list, in insertion order that
    is not the sorted one."""
    return {"c": r.randn(6, 5).astype(dtype),
            "b": [{"w": r.randn(4, 3, 2).astype(dtype)},
                  {"w": r.randn(7).astype(dtype)}],
            "a": r.randn(3).astype(dtype)}


def _to_torch(t, dtype):
    return tree.map_leaves(lambda x: torch.from_numpy(
        np.asarray(x, np.float32)).to(dtype), t)


def _to_jax(t, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32).astype(dtype), t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(dtype, clip):
    """Three steps from zeros: params, mu, nu, count, the grad norm and the
    learning rate. In bf16 the clipped grads are cast back to bf16 before
    the update reads them, as in the reference."""
    r = np.random.RandomState(0)
    cfg = dict(lr=1e-2, clip_norm=clip, warmup_steps=2, total_steps=5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = _tree(r, np.float32)
    jp, tp = _to_jax(params, jdt), _to_torch(params, tdt)
    js = ref_opt.adamw_init(jp)
    ts = opt.adamw_init(tp)
    for _ in range(3):
        grads = _tree(r, np.float32)
        jp, js, jm = ref_opt.adamw_update(ref_opt.AdamWConfig(**cfg), jp,
                                          _to_jax(grads, jdt), js)
        tp, ts, tm = opt.adamw_update(opt.AdamWConfig(**cfg), tp,
                                      _to_torch(grads, tdt), ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=OPT_RTOL)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
    for got, want in zip(tree.leaves(tp) + tree.leaves(ts["mu"])
                         + tree.leaves(ts["nu"]),
                         jax.tree.leaves(jp) + jax.tree.leaves(js["mu"])
                         + jax.tree.leaves(js["nu"])):
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=OPT_RTOL, atol=1e-7)


def test_adamw_donate_is_the_same_update():
    r = np.random.RandomState(1)
    p0, g = _tree(r, np.float32), _tree(r, np.float32)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    a, sa, _ = opt.adamw_update(cfg, _to_torch(p0, torch.float32),
                                _to_torch(g, torch.float32),
                                opt.adamw_init(_to_torch(p0, torch.float32)))
    p = _to_torch(p0, torch.float32)
    s = opt.adamw_init(p)
    b, sb, _ = opt.adamw_update(cfg, p, _to_torch(g, torch.float32), s,
                                donate=True)
    # the same tensors, updated in place
    assert all(x is y for x, y in zip(tree.leaves([b, sb]),
                                      tree.leaves([p, s])))
    for x, y in zip(tree.leaves([a, sa]), tree.leaves([b, sb])):
        assert torch.equal(x, y)


def test_cosine_schedule_whole_range():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40)
    steps = np.arange(0, 46, dtype=np.int32)
    want = ref_opt.cosine_schedule(ref_opt.AdamWConfig(**cfg),
                                   jnp.asarray(steps))
    got = opt.cosine_schedule(opt.AdamWConfig(**cfg), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OPT_RTOL,
                               atol=1e-12)


def test_clip_by_global_norm_matches_reference():
    r = np.random.RandomState(2)
    g = _tree(r, np.float32)
    jc, jn = ref_opt.clip_by_global_norm(_to_jax(g, jnp.bfloat16), 0.5)
    tc, tn = opt.clip_by_global_norm(_to_torch(g, torch.bfloat16), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    for x, y in zip(tree.leaves(tc), jax.tree.leaves(jc)):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y, np.float32))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def test_compression_error_feedback():
    """The reference's test on the port: over steps, the accumulated
    transmitted value tracks the accumulated true gradient."""
    g = torch.from_numpy(np.random.RandomState(0).randn(64, 33)
                         .astype(np.float32))
    r = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(20):
        wire, r = comp.ef_roundtrip(g, r, method="int8")
        total = total + wire
    np.testing.assert_allclose((total / 20).numpy(), g.numpy(), rtol=0.02,
                               atol=0.02)


def test_compression_bf16_wire_dtype():
    g = torch.ones((8, 8))
    payload, meta = comp.compress(g, "bf16")
    assert payload.dtype == torch.bfloat16
    np.testing.assert_allclose(comp.decompress(payload, meta, "bf16").numpy(),
                               g.numpy())


@pytest.mark.parametrize("shape", [(64, 33), (256,), (3, 5, 7)])
def test_int8_payload_bit_equal(shape):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32) * 4
    q, (scale, shp, pad) = comp.compress(torch.from_numpy(x), "int8")
    rq, (rscale, rshp, rpad) = ref_comp.compress(jnp.asarray(x), "int8")
    assert q.dtype == torch.int8 and (shp, pad) == (tuple(rshp), rpad)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    np.testing.assert_array_equal(
        comp.decompress(q, (scale, shp, pad), "int8").numpy(),
        np.asarray(ref_comp.decompress(rq, (rscale, rshp, rpad), "int8")))
    assert comp.init_residuals({"x": torch.zeros(shape)})["x"].dtype \
        == torch.float32


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A reduced f32 model's params and AdamW state written by the
    reference's ``save`` restore in the port equal to ``params_from_jax``
    (leaf i is jax.tree's leaf i)."""
    cfg = ref_configs.reduced(ref_configs.get_config("qwen3-1.7b"))
    assert cfg.dtype == "float32"
    params = ref_tf.init_params(cfg, jax.random.key(0))
    state = ref_opt.adamw_init(params)
    state["count"] = jnp.asarray(7, jnp.int32)
    ref_ckpt.save(tmp_path, 7, {"params": params, "opt": state})
    pcfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    want = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                           device="cpu")
    like = {"params": tree.map_leaves(torch.zeros_like, want),
            "opt": opt.adamw_init(want)}
    got, step = ckpt.restore(tmp_path, like)
    assert step == 7 and int(got["opt"]["count"]) == 7
    assert got["opt"]["count"].dtype == torch.int32
    for x, y in zip(tree.leaves(got["params"]), tree.leaves(want)):
        assert torch.equal(x, y)
    for x, y in zip(tree.leaves(got["opt"]["mu"]),
                    jax.tree.leaves(state["mu"])):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    t = {"b": torch.arange(6.0).reshape(2, 3), "a": [torch.ones(4),
                                                      torch.tensor(3)]}
    ckpt.save(tmp_path, 2, t)
    like = {"b": jnp.zeros((2, 3)), "a": [jnp.zeros(4), jnp.int32(0)]}
    got, step = ref_ckpt.restore(tmp_path, like)
    assert step == 2
    np.testing.assert_array_equal(np.asarray(got["b"]), t["b"].numpy())
    np.testing.assert_array_equal(np.asarray(got["a"][0]), np.ones(4))


def test_bf16_leaf_round_trips_bit_exact(tmp_path):
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    x[0, 0] = float("inf")
    x[0, 1] = -0.0
    ckpt.save(tmp_path, 1, {"x": x, "n": torch.zeros((), dtype=torch.int32)})
    import json
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == ["int32", "bfloat16"]
    got, _ = ckpt.restore(tmp_path, {"x": torch.zeros_like(x),
                                     "n": torch.zeros((), dtype=torch.int32)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def test_keep_n_async_and_shape_check(tmp_path):
    for s in range(5):
        ckpt.save_async(tmp_path, s, {"w": torch.full((3,), float(s))},
                        keep_n=2)
        ckpt.wait_pending()
    assert ckpt.latest_steps(tmp_path) == [3, 4]
    assert ckpt.latest_step(tmp_path) == 4
    got, step = ckpt.restore(tmp_path, {"w": torch.zeros(3)})
    assert step == 4 and torch.equal(got["w"], torch.full((3,), 4.0))
    with pytest.raises(ValueError, match="leaf 0"):
        ckpt.restore(tmp_path, {"w": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", {"w": torch.zeros(3)})
