"""The port's scheduler steps against the reference on reduced configs,
the reference's own weights carried across with ``params_from_jax`` and
every other input from a numpy seed:

* ``blocks.decode_attention`` with a ``(b,)`` position vector — f32 and
  bf16, the int8 cache, a windowed layer whose ring wraps, the explicit
  ``head_offset`` shards — and its ``active`` mask (masked rows bit-equal
  to before, active rows bit-equal to the unmasked call);
* ``make_sched_step`` (logits of the active rows and every cache leaf
  over three masked steps, auto and explicit, dense, MoE and hybrid,
  the int8 cache), masked rows bit-equal to before each step;
* ``blocks.prefill_attention``, ``ssm.ssm_prefill_scan`` and
  ``make_prefill_sched_step`` (``prefill_step``), and, inside the port,
  a fused chunk against the same tokens stepped one at a time;
* ``seq_bucket_rows`` and the plan ladders of
  ``compile_decode_plans(seq_buckets=)``.

f32 is held within the port's 1e-4 (tests/test_torch_decode.py); bf16
within a relative L2 error of 1e-2 (the frameworks round their sums
differently); int8 cache entries within one quantization level (a value
on a rounding boundary may round either way)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as ref_configs
from repro.core.comm import Communicator as RefCommunicator
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.models import blocks as ref_blocks
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.core import selector
from repro_torch.core.comm import Communicator
from repro_torch.distributed import step as step_mod
from repro_torch.interop import params_from_jax
from repro_torch.mesh import RankAxis
from repro_torch.models import blocks, ssm

torch.set_num_threads(1)

B, MAX_KV, S = 4, 16, 4
RTOL = ATOL = 1e-4
BF16_REL = 1e-2


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch)), dtype=dtype),
        dataclasses.replace(configs.reduced(configs.get_config(arch)),
                            dtype=dtype))


def _torch(a, dtype=None):
    """numpy (bf16 included) -> torch, keeping int8 as int8."""
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(dtype) if dtype is not None else t


def _np(t):
    return t.float().numpy() if t.dtype != torch.int8 else t.numpy()


def _close(got, want, dtype="float32"):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "bfloat16":
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel < BF16_REL, rel
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _close_leaf(name, got, want, dtype):
    if np.asarray(want).dtype == np.int8:
        assert np.abs(got.astype(np.int32)
                      - np.asarray(want).astype(np.int32)).max() <= 1
    elif name.endswith("scale"):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), rtol=1e-2)
    else:
        _close(got, want, dtype)


# ---------------------------------------------------------------------------
# decode_attention with per-row positions
# ---------------------------------------------------------------------------
def _attn_case(dtype, window, quant, seed=0):
    ref_cfg, cfg = _cfgs("qwen3-1.7b", dtype)
    np_p = jax.tree.map(np.asarray,
                        ref_blocks.init_attn(jax.random.key(seed), ref_cfg))
    rng = np.random.RandomState(seed)
    kv = window or MAX_KV
    _, nkv = blocks.padded_heads(cfg)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    if quant:
        ck = rng.randint(-127, 128, (B, nkv, kv, cfg.hd)).astype(np.int8)
        cv = rng.randint(-127, 128, (B, nkv, kv, cfg.hd)).astype(np.int8)
        ks = (rng.rand(B, nkv, kv, 1) * 0.05 + 0.01).astype(np.float32)
        vs = (rng.rand(B, nkv, kv, 1) * 0.05 + 0.01).astype(np.float32)
    else:
        ck = rng.randn(B, nkv, kv, cfg.hd).astype(np.float32)
        cv = rng.randn(B, nkv, kv, cfg.hd).astype(np.float32)
        ks = vs = None
    # a windowed layer wraps its ring (positions past kv), a global one
    # stays inside its cache
    pos = np.array([3, 13, 9, 0] if window else [3, 15, 9, 0], np.int32)
    return ref_cfg, cfg, np_p, x, ck, cv, ks, vs, pos


def _ref_attention(ref_cfg, np_p, x, ck, cv, ks, vs, pos, window, tp):
    """Reference out (per rank's partial under tp) and new cache."""
    jd = ref_cfg.jdtype
    args = (jnp.asarray(x, jd), jnp.asarray(ck) if ck.dtype == np.int8
            else jnp.asarray(ck, jd),
            jnp.asarray(cv) if cv.dtype == np.int8 else jnp.asarray(cv, jd))
    kw = {}
    if ks is not None:
        kw = dict(k_scale=jnp.asarray(ks, jnp.bfloat16),
                  v_scale=jnp.asarray(vs, jnp.bfloat16))
    p = jax.tree.map(lambda a: jnp.asarray(a, jd), np_p)
    if not tp:
        res = ref_blocks.decode_attention(p, args[0], args[1], args[2],
                                          jnp.asarray(pos), ref_cfg,
                                          window=window, **kw)
        return [np.asarray(res[0], np.float32)], res[1:]
    nl = p["wq"].shape[1] // tp
    outs = []
    for r in range(tp):
        pr = dict(p, wq=p["wq"][:, r * nl:(r + 1) * nl],
                  wo=p["wo"][r * nl:(r + 1) * nl])
        res = ref_blocks.decode_attention(pr, args[0], args[1], args[2],
                                          jnp.asarray(pos), ref_cfg,
                                          window=window, head_offset=r * nl,
                                          **kw)
        outs.append(np.asarray(res[0], np.float32))
    return outs, res[1:]


def _port_attention(cfg, np_p, x, ck, cv, ks, vs, pos, window, tp,
                    active=None):
    dt = cfg.tdtype
    p = params_from_jax(np_p, cfg, device="cpu")
    caches = [_torch(ck, None if ck.dtype == np.int8 else dt),
              _torch(cv, None if cv.dtype == np.int8 else dt)]
    if ks is not None:
        caches += [_torch(ks, torch.bfloat16), _torch(vs, torch.bfloat16)]
    xt = _torch(x, dt)
    ho = None
    if tp:
        nl = p["wq"].shape[1] // tp
        p = {k: (torch.stack(v.chunk(tp, dim=1)) if k == "wq" else
                 torch.stack(v.chunk(tp, dim=0)) if k == "wo" else
                 v.expand((tp,) + v.shape).clone()) for k, v in p.items()}
        caches = [c.expand((tp,) + c.shape).clone() for c in caches]
        xt = xt.expand((tp,) + xt.shape).clone()
        ho = torch.arange(tp) * nl
    kw = dict(k_scale=caches[2], v_scale=caches[3]) if ks is not None else {}
    out = blocks.decode_attention(p, xt, caches[0], caches[1],
                                  torch.as_tensor(pos, dtype=torch.long),
                                  cfg, window=window, head_offset=ho,
                                  active=active, **kw)
    return out, caches


CASES = [("float32", None, False, 0), ("bfloat16", None, False, 0),
         ("float32", 8, False, 0), ("float32", None, True, 0),
         ("bfloat16", 8, True, 0), ("float32", None, False, 2),
         ("float32", 8, True, 2), ("bfloat16", None, False, 2)]


@pytest.mark.parametrize("dtype,window,quant,tp", CASES)
def test_decode_attention_vector_pos_matches_reference(dtype, window, quant,
                                                       tp):
    ref_cfg, cfg, np_p, x, ck, cv, ks, vs, pos = _attn_case(dtype, window,
                                                            quant)
    want, want_cache = _ref_attention(ref_cfg, np_p, x, ck, cv, ks, vs, pos,
                                      window, tp)
    out, caches = _port_attention(cfg, np_p, x, ck, cv, ks, vs, pos, window,
                                  tp)
    got = [out] if not tp else list(out)
    for g, w in zip(got, want):
        _close(g.float().numpy(), w, dtype)
    names = ("k", "v", "k_scale", "v_scale")
    for name, c, w in zip(names, caches, want_cache):
        _close_leaf(name, _np(c[0] if tp else c), np.asarray(
            w, np.float32) if w.dtype != jnp.int8 else np.asarray(w), dtype)


@pytest.mark.parametrize("dtype,window,quant,tp", CASES[:5] + CASES[6:7])
def test_decode_attention_active_mask(dtype, window, quant, tp):
    """Inactive rows keep their cache rows bit for bit; active rows get
    exactly the unmasked call's write and output."""
    _, cfg, np_p, x, ck, cv, ks, vs, pos = _attn_case(dtype, window, quant,
                                                      seed=1)
    active = torch.tensor([True, False, True, False])
    full, full_caches = _port_attention(cfg, np_p, x, ck, cv, ks, vs, pos,
                                        window, tp)
    out, caches = _port_attention(cfg, np_p, x, ck, cv, ks, vs, pos, window,
                                  tp, active=active)
    _, idle = _port_attention(cfg, np_p, x, ck, cv, ks, vs, pos, window, tp,
                              active=torch.zeros(B, dtype=torch.bool))
    axis = 1 if tp else 0
    for c, f, c0, a in zip(caches, full_caches, idle, (ck, cv, ks, vs)):
        start = _torch(a, None if c.dtype == torch.int8 else c.dtype)
        start = start.expand(c.shape) if tp else start
        assert torch.equal(c0, start)          # nothing active: untouched
        for r in range(B):
            want = f if active[r] else start
            assert torch.equal(c.select(axis, r), want.select(axis, r))
    rows = active.nonzero()[:, 0]
    assert torch.equal(out.index_select(axis, rows),
                       full.index_select(axis, rows))


def test_vector_rope_is_read_on_the_device():
    """A position vector with ``on_device=True`` takes the 0-d path's
    table rows, and the host-checked int rows, without a host read."""
    pos = torch.tensor([0, 7, 4095, 12])
    cos, sin = blocks.rope(pos, 32, 1e6, "cpu", max_pos=4096, on_device=True)
    for i, p in enumerate(pos.tolist()):
        c, s = blocks.rope(p, 32, 1e6, "cpu")
        assert torch.equal(cos[i], c) and torch.equal(sin[i], s)
    with pytest.raises(ValueError, match="max_pos"):
        blocks.rope(pos, 32, 1e6, "cpu", on_device=True)


# ---------------------------------------------------------------------------
# make_sched_step and make_prefill_sched_step against the reference
# ---------------------------------------------------------------------------
def _mesh(tp):
    return Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype):
    ref_cfg, _ = _cfgs(arch, dtype)
    params = ref_step.init_sharded(ref_cfg, _mesh(2), ref_shd.MeshAxes(),
                                   jax.random.key(0))[0]
    return jax.tree.map(np.asarray, params)


def _init_cache(ref_cfg, kv_quant, seed):
    """Random reference-layout cache contents (numpy)."""
    from repro.models import transformer as ref_tf
    cache = ref_tf.init_cache(ref_cfg, B, MAX_KV,
                              dtype=jnp.int8 if kv_quant else None)
    rng = np.random.RandomState(seed)
    out = {}
    for name, leaves in cache.items():
        out[name] = []
        for a in leaves:
            shape = a.shape
            if a.dtype == jnp.int8:
                v = rng.randint(-127, 128, shape).astype(np.int8)
            elif name.endswith("scale"):
                v = (rng.rand(*shape) * 0.05 + 0.01).astype(np.float32)
            else:
                v = (rng.randn(*shape) * (0.5 if name == "ssm" else 1.0)
                     ).astype(np.float32)
            out[name].append(v)
    return out


def _ref_cache(ref_cfg, np_cache):
    def conv(name, a):
        if a.dtype == np.int8:
            return jnp.asarray(a)
        if name.endswith("scale"):
            return jnp.asarray(a, jnp.bfloat16)
        return jnp.asarray(a, jnp.float32 if name == "ssm"
                           else ref_cfg.jdtype)
    return {k: [conv(k, a) for a in v] for k, v in np_cache.items()}


def _port_cache(cfg, np_cache, tp):
    out = {}
    for name, leaves in np_cache.items():
        dt = (None if leaves[0].dtype == np.int8 else torch.bfloat16
              if name.endswith("scale") else torch.float32 if name == "ssm"
              else cfg.tdtype)
        conv = []
        for a in leaves:
            t = _torch(a, dt)
            if tp:
                t = (torch.stack(t.chunk(tp, dim=-2)) if name == "ssm"
                     else t.expand((tp,) + t.shape).clone())
            conv.append(t.contiguous())
        out[name] = conv
    return out


def _unstack(name, t, tp):
    """A port cache leaf in the reference layout (rank 0's KV; the SSM
    state's rank rows joined)."""
    if not tp:
        return t
    return torch.cat(list(t), dim=-2) if name == "ssm" else t[0]


def _steps(arch, dtype, mode, kv_quant, tp):
    ref_cfg, cfg = _cfgs(arch, dtype)
    np_params = _ref_params(arch, dtype)
    axis = RankAxis("model", tp, "cpu")
    kw = {}
    if mode == "explicit":
        kw = dict(comm=Communicator("model", n=tp, device="cpu",
                                    link=selector.ICI))
    return ref_cfg, cfg, np_params, axis, kw


SCHED = [("qwen3-1.7b", "float32", "auto", False, 2),
         ("qwen3-1.7b", "float32", "explicit", False, 2),
         ("qwen3-1.7b", "float32", "explicit", False, 4),
         ("qwen3-1.7b", "float32", "explicit", True, 2),
         ("qwen3-1.7b", "bfloat16", "explicit", False, 2),
         ("mixtral-8x22b", "float32", "explicit", False, 2),
         ("hymba-1.5b", "float32", "auto", False, 2),
         ("hymba-1.5b", "float32", "explicit", True, 2)]


@pytest.mark.parametrize("arch,dtype,mode,kv_quant,tp", SCHED)
def test_sched_step_matches_reference(arch, dtype, mode, kv_quant, tp):
    """Three masked steps from a random cache: the active rows' logits
    and every cache leaf against the reference's ``make_sched_step``,
    and each inactive row's cache (SSM state included) bit-equal to
    before its step."""
    ref_cfg, cfg, np_params, axis, kw = _steps(arch, dtype, mode, kv_quant,
                                               tp)
    ref_fn, _ = ref_step.make_sched_step(
        ref_cfg, _mesh(tp), ref_shd.MeshAxes(), batch=B, max_kv=MAX_KV,
        kv_quant=kv_quant, mode=mode)
    step, layout = step_mod.make_sched_step(cfg, axis, batch=B,
                                            max_kv=MAX_KV, kv_quant=kv_quant,
                                            mode=mode, **kw)
    params = layout.params(params_from_jax(np_params, cfg, device="cpu"))
    np_cache = _init_cache(ref_cfg, kv_quant, seed=2)
    ref_cache = _ref_cache(ref_cfg, np_cache)
    cache = _port_cache(cfg, np_cache, tp if mode == "explicit" else 0)
    rng = np.random.RandomState(3)
    base = np.array([0, 5, 2, 9], np.int32)
    for t, act in enumerate(([1, 1, 1, 1], [1, 0, 1, 0], [0, 1, 1, 1])):
        act = np.array(act, bool)
        tokens = rng.randint(0, cfg.vocab, B).astype(np.int32)
        pos = base + t
        ref_logits, ref_cache = ref_fn(
            jax.tree.map(jnp.asarray, np_params), ref_cache,
            jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(act))
        before = {k: [c.clone() for c in v] for k, v in cache.items()}
        logits, cache = step(params, cache, torch.as_tensor(tokens).long(),
                             torch.as_tensor(pos).long(),
                             torch.as_tensor(act))
        _close(logits[torch.as_tensor(act)].numpy(),
               np.asarray(ref_logits)[act], dtype)
        lead = 1 if mode == "explicit" else 0
        for name, leaves in cache.items():
            for leaf, old, want in zip(leaves, before[name],
                                       ref_cache[name]):
                ax = leaf.dim() - (3 if name == "ssm" else 4)
                for r in np.flatnonzero(~act):
                    assert torch.equal(leaf.select(ax, r),
                                       old.select(ax, r)), (name, r)
                got = _unstack(name, leaf, tp if lead else 0)
                _close_leaf(name, _np(got), np.asarray(want, np.float32)
                            if want.dtype != jnp.int8 else np.asarray(want),
                            dtype)


PREFILL = [("qwen3-1.7b", "float32", "auto", False, 2),
           ("qwen3-1.7b", "float32", "explicit", False, 2),
           ("qwen3-1.7b", "float32", "explicit", False, 4),
           ("qwen3-1.7b", "float32", "explicit", True, 2),
           ("mixtral-8x22b", "float32", "explicit", False, 2),
           ("hymba-1.5b", "float32", "explicit", False, 4)]


def _chunk(cfg, seed=4):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    pos = np.array([0, 5, 7, 2], np.int32)
    n_tok = np.array([3, 0, 1, 4], np.int32)
    return tokens, pos, n_tok


@pytest.mark.parametrize("arch,dtype,mode,kv_quant,tp", PREFILL)
def test_prefill_sched_step_matches_reference(arch, dtype, mode, kv_quant,
                                              tp):
    """One fused chunk (rows of 3, 0, 1 and 4 real tokens) from a random
    cache: every cache leaf against the reference's
    ``make_prefill_sched_step``; the row of 0 tokens bit-equal to before."""
    ref_cfg, cfg, np_params, axis, kw = _steps(arch, dtype, mode, kv_quant,
                                               tp)
    ref_fn, _ = ref_step.make_prefill_sched_step(
        ref_cfg, _mesh(tp), ref_shd.MeshAxes(), batch=B, seq=S,
        max_kv=MAX_KV, kv_quant=kv_quant, mode=mode)
    step, layout = step_mod.make_prefill_sched_step(
        cfg, axis, batch=B, seq=S, max_kv=MAX_KV, kv_quant=kv_quant,
        mode=mode, **kw)
    params = layout.params(params_from_jax(np_params, cfg, device="cpu"))
    np_cache = _init_cache(ref_cfg, kv_quant, seed=5)
    cache = _port_cache(cfg, np_cache, tp if mode == "explicit" else 0)
    before = {k: [c.clone() for c in v] for k, v in cache.items()}
    tokens, pos, n_tok = _chunk(cfg)
    want = ref_fn(jax.tree.map(jnp.asarray, np_params),
                  _ref_cache(ref_cfg, np_cache), jnp.asarray(tokens),
                  jnp.asarray(pos), jnp.asarray(n_tok))
    got = step(params, cache, torch.as_tensor(tokens).long(),
               torch.as_tensor(pos).long(), torch.as_tensor(n_tok).long())
    lead = tp if mode == "explicit" else 0
    for name, leaves in got.items():
        for leaf, old, w in zip(leaves, before[name], want[name]):
            ax = leaf.dim() - (3 if name == "ssm" else 4)
            assert torch.equal(leaf.select(ax, 1), old.select(ax, 1))
            _close_leaf(name, _np(_unstack(name, leaf, lead)),
                        np.asarray(w, np.float32) if w.dtype != jnp.int8
                        else np.asarray(w), dtype)


@pytest.mark.parametrize("window,quant", [(None, False), (8, False),
                                          (None, True)])
def test_prefill_attention_matches_reference(window, quant):
    ref_cfg, cfg = _cfgs("qwen3-1.7b")
    np_p = jax.tree.map(np.asarray,
                        ref_blocks.init_attn(jax.random.key(6), ref_cfg))
    rng = np.random.RandomState(6)
    kv = window or MAX_KV
    _, nkv = blocks.padded_heads(cfg)
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.array([0, 4, 3, 2], np.int32)
    n_tok = np.array([4, 0, 1, 3], np.int32)
    if quant:
        ck = rng.randint(-127, 128, (B, nkv, kv, cfg.hd)).astype(np.int8)
        cv = rng.randint(-127, 128, (B, nkv, kv, cfg.hd)).astype(np.int8)
        ks = (rng.rand(B, nkv, kv, 1) * 0.05 + 0.01).astype(np.float32)
        vs = (rng.rand(B, nkv, kv, 1) * 0.05 + 0.01).astype(np.float32)
        ref_kw = dict(k_scale=jnp.asarray(ks, jnp.bfloat16),
                      v_scale=jnp.asarray(vs, jnp.bfloat16))
        caches = [torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
                  _torch(ks, torch.bfloat16), _torch(vs, torch.bfloat16)]
        kw = dict(k_scale=caches[2], v_scale=caches[3])
    else:
        ck = rng.randn(B, nkv, kv, cfg.hd).astype(np.float32)
        cv = rng.randn(B, nkv, kv, cfg.hd).astype(np.float32)
        ref_kw, kw = {}, {}
        caches = [torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())]
    res = ref_blocks.prefill_attention(
        np_p, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), jnp.asarray(n_tok), ref_cfg, window=window,
        **ref_kw)
    out = blocks.prefill_attention(
        params_from_jax(np_p, cfg, device="cpu"), torch.from_numpy(x),
        caches[0], caches[1], torch.as_tensor(pos).long(),
        torch.as_tensor(n_tok).long(), cfg, window=window, **kw)
    real = np.arange(S)[None] < n_tok[:, None]
    _close(out.numpy()[real], np.asarray(res[0])[real])
    for name, c, w in zip(("k", "v", "k_scale", "v_scale"), caches, res[1:]):
        _close_leaf(name, _np(c), np.asarray(w, np.float32)
                    if w.dtype != jnp.int8 else np.asarray(w), "float32")


def test_ssm_prefill_scan_matches_reference():
    ref_cfg, cfg = _cfgs("hymba-1.5b")
    np_p = jax.tree.map(np.asarray, ref_ssm.init_ssm_head(
        jax.random.key(7), ref_cfg, d_inner=ref_cfg.d_model))
    p = params_from_jax(np_p, cfg, device="cpu")
    rng = np.random.RandomState(7)
    x = rng.randn(B, 5, cfg.d_model).astype(np.float32)
    state = (rng.randn(B, cfg.d_model, cfg.ssm.state_dim) * 0.5).astype(
        np.float32)
    n_tok = np.array([5, 0, 2, 1], np.int32)
    want_out, want_state = ref_ssm.ssm_prefill_scan(
        np_p, jnp.asarray(x), jnp.asarray(state), ref_cfg,
        jnp.asarray(n_tok))
    out, new = ssm.ssm_prefill_scan(p, torch.from_numpy(x),
                                    torch.from_numpy(state), cfg,
                                    torch.as_tensor(n_tok).long())
    _close(out.numpy(), want_out)
    _close(new.numpy(), want_state)
    assert torch.equal(new[1], torch.from_numpy(state)[1])
    # the explicit path: each rank's d_inner rows, bit-equal to the whole
    tp = 2
    sh = {k: (torch.stack(v.chunk(tp, dim={"w_dt": 1}.get(k, 0)))
              if k in ("w_dt", "a_log", "d_skip", "w_out")
              else v.expand((tp,) + v.shape)) for k, v in p.items()}
    xs = torch.from_numpy(x).expand((tp, B, 5, cfg.d_model))
    st = torch.stack(torch.from_numpy(state).chunk(tp, dim=-2))
    _, new_sh = ssm.ssm_prefill_scan(sh, xs, st, cfg,
                                     torch.as_tensor(n_tok).long(),
                                     d_offset=torch.arange(tp)
                                     * (cfg.d_model // tp))
    assert torch.equal(torch.cat(list(new_sh), dim=-2), new)


@pytest.mark.parametrize("arch,mode,kv_quant", [
    ("qwen3-1.7b", "explicit", False), ("qwen3-1.7b", "auto", True),
    ("mixtral-8x22b", "explicit", False), ("hymba-1.5b", "explicit", False)])
def test_fused_chunk_matches_token_by_token(arch, mode, kv_quant):
    """Inside the port: one fused chunk and the same tokens through the
    scheduler's decode step one at a time (rows masked off past their
    count) leave the same cache within f32 rounding, and the next
    decode step's logits agree."""
    tp = 2
    ref_cfg, cfg, np_params, axis, kw = _steps(arch, "float32", mode,
                                               kv_quant, tp)
    pre, layout = step_mod.make_prefill_sched_step(
        cfg, axis, batch=B, seq=S, max_kv=MAX_KV, kv_quant=kv_quant,
        mode=mode, **kw)
    dec, _ = step_mod.make_sched_step(cfg, axis, batch=B, max_kv=MAX_KV,
                                      kv_quant=kv_quant, mode=mode, **kw)
    params = layout.params(params_from_jax(np_params, cfg, device="cpu"))
    np_cache = _init_cache(ref_cfg, kv_quant, seed=8)
    lead = tp if mode == "explicit" else 0
    fused = _port_cache(cfg, np_cache, lead)
    stepped = _port_cache(cfg, np_cache, lead)
    tokens, pos, n_tok = (torch.as_tensor(a).long() for a in _chunk(cfg))
    pre(params, fused, tokens, pos, n_tok)
    for j in range(S):
        dec(params, stepped, tokens[:, j], pos + j, j < n_tok)
    for name in fused:
        for a, b in zip(fused[name], stepped[name]):
            if a.dtype == torch.int8:
                assert (a.int() - b.int()).abs().max() <= 1
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    nxt = torch.as_tensor([5, 6, 7, 8])
    act = torch.ones(B, dtype=torch.bool)
    la, _ = dec(params, fused, nxt, pos + n_tok, act)
    lb, _ = dec(params, stepped, nxt, pos + n_tok, act)
    torch.testing.assert_close(la, lb, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the sequence-bucketed plan ladders
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch,seq_buckets", [(4, (4, 8)), (8, (16, 64,
                                                                  256)),
                                               (3, None), (2, (1,))])
def test_seq_bucket_rows_match_reference(batch, seq_buckets):
    buckets = step_mod.slot_buckets(batch)
    assert buckets == ref_step.slot_buckets(batch)
    assert (step_mod.seq_bucket_rows(batch, buckets, seq_buckets)
            == ref_step.seq_bucket_rows(batch, buckets, seq_buckets))
    with pytest.raises(ValueError, match=">= 1"):
        step_mod.seq_bucket_rows(batch, buckets, (0,))


@pytest.mark.parametrize("arch,tp", [("qwen3-1.7b", 2), ("qwen3-1.7b", 4),
                                     ("mixtral-8x22b", 2),
                                     ("hymba-1.5b", 2)])
def test_seq_bucketed_plan_ladders_match_reference(arch, tp):
    ref_cfg, cfg = _cfgs(arch)
    want = ref_step.compile_decode_plans(
        ref_cfg, RefCommunicator("model", n=tp), batch_local=B, tp=tp,
        seq_buckets=(4, 8))
    got = step_mod.compile_decode_plans(
        cfg, Communicator("model", n=tp, device="cpu", link=selector.ICI),
        batch_local=B, tp=tp, seq_buckets=(4, 8))
    assert {k: p.buckets for k, p in got.items()} == \
        {k: tuple(p.buckets) for k, p in want.items()}
    assert {k: p.pad_strategy for k, p in got.items()} == \
        {k: p.pad_strategy for k, p in want.items()}


def test_local_batch_is_the_identity():
    assert step_mod.local_batch(RankAxis("model", 2, "cpu"), 8) == (8, False)


def test_prefill_sched_step_refuses_wide_chunks_and_encoders():
    _, cfg = _cfgs("gemma3-12b")
    axis = RankAxis("model", 2, "cpu")
    with pytest.raises(ValueError, match="kv_len"):
        step_mod.make_prefill_sched_step(cfg, axis, batch=B, seq=65,
                                         max_kv=512)
    _, enc = _cfgs("hubert-xlarge")
    with pytest.raises(ValueError, match="fused prefill"):
        step_mod.make_prefill_sched_step(enc, axis, batch=B, seq=4,
                                         max_kv=MAX_KV)
