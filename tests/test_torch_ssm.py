"""The port's SSM head block (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on hymba-reduced, the reference's own
weights carried across with ``params_from_jax`` and inputs from a numpy
seed: the input-dependent parameters, the decode step (whole, and on
the rank-stacked TP shards' ``d_inner`` rows at TP 2 and 4), and the
full-sequence scan from a zero and from a given state; then the port's
log-depth scan against its own decode steps.

The frameworks' f32 ``exp``/``log1p`` and matmul sums differ in the last
place, so the port is held to the reference within RTOL/ATOL, not bit
for bit; within the port, a shard's state rows are bit-equal to the
whole step's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.models import ssm

torch.set_num_threads(1)

ARCH = "hymba-1.5b"
# the decode tests' f32 bar (tests/test_torch_decode.py)
RTOL = ATOL = 1e-4
B, S = 2, 37
# the SSM leaves split on d_inner (sharding.SHARD_DIMS less the groups
# axis); w_in and w_bcdt stay whole
SHARDED = {"w_dt": 1, "a_log": 0, "d_skip": 0, "w_out": 0}


def _cfgs():
    return (ref_configs.reduced(ref_configs.get_config(ARCH)),
            configs.reduced(configs.get_config(ARCH)))


def _weights():
    ref_cfg, cfg = _cfgs()
    p = ref_ssm.init_ssm_head(jax.random.key(0), ref_cfg,
                              d_inner=ref_cfg.d_model)
    np_p = jax.tree.map(np.asarray, p)
    return np_p, params_from_jax(np_p, cfg, device="cpu")


def _inputs(seed, s=S):
    _, cfg = _cfgs()
    rng = np.random.RandomState(seed)
    x = rng.randn(B, s, cfg.d_model).astype(np.float32)
    state = (rng.randn(B, cfg.d_model, cfg.ssm.state_dim) * 0.5).astype(
        np.float32)
    return x, state


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _shard(np_p, r, tp):
    """Rank r's leaves, as the reference's explicit shard_map hands them."""
    out = dict(np_p)
    for name, dim in SHARDED.items():
        out[name] = np.split(np_p[name], tp, axis=dim)[r]
    return out


def test_ssm_params_match_reference():
    ref_cfg, cfg = _cfgs()
    np_p, p = _weights()
    x, _ = _inputs(0)
    want = ref_ssm._ssm_params(np_p, jnp.asarray(x), ref_cfg)
    got = ssm.ssm_params(p, torch.from_numpy(x), cfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w)


def test_decode_step_matches_reference():
    ref_cfg, cfg = _cfgs()
    np_p, p = _weights()
    x, state = _inputs(1)
    want_out, want_h = ref_ssm.ssm_decode_step(
        np_p, jnp.asarray(x[:, :1]), jnp.asarray(state), ref_cfg)
    st = torch.from_numpy(state)
    got_out, got_h = ssm.ssm_decode_step(p, torch.from_numpy(x[:, :1]), st,
                                         cfg)
    assert torch.equal(st, torch.from_numpy(state))   # left as it was
    _close(got_out, want_out)
    _close(got_h, want_h)


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_step_on_shards_matches_reference(tp):
    """The port's rank-stacked call (``d_offset`` the ``(tp,)`` offsets,
    rows taken as a diagonal): rank r's partial output and state rows
    against the reference's ``ssm_decode_step(d_offset=r * d_local)`` on
    rank r's shard; the state rows bit-equal to the whole step's, and
    the partials summing to its output."""
    ref_cfg, cfg = _cfgs()
    np_p, p = _weights()
    x, state = _inputs(2)
    xt = torch.from_numpy(x[:, :1])
    d_local = cfg.d_model // tp
    whole_out, whole_h = ssm.ssm_decode_step(p, xt, torch.from_numpy(state),
                                             cfg)
    stacked = {k: torch.stack([params_from_jax(_shard(np_p, r, tp), cfg,
                                               device="cpu")[k]
                               for r in range(tp)]) for k in np_p}
    x_ranks = xt.expand(tp, *xt.shape)
    st_ranks = torch.from_numpy(state).unflatten(1, (tp, d_local)) \
        .movedim(1, 0)
    out, h = ssm.ssm_decode_step(stacked, x_ranks, st_ranks, cfg,
                                 d_offset=torch.arange(tp) * d_local)
    for r in range(tp):
        rows = slice(r * d_local, (r + 1) * d_local)
        want_out, want_h = ref_ssm.ssm_decode_step(
            _shard(np_p, r, tp), jnp.asarray(x[:, :1]),
            jnp.asarray(state[:, rows]), ref_cfg, d_offset=r * d_local)
        _close(out[r], want_out)
        _close(h[r], want_h)
        assert torch.equal(h[r], whole_h[:, rows])
    torch.testing.assert_close(out.sum(0), whole_out, rtol=RTOL, atol=ATOL)


def test_rank_stacked_offsets_must_split_the_rows():
    _, cfg = _cfgs()
    _, p = _weights()
    x = torch.zeros(2, B, 1, cfg.d_model)
    stacked = {k: torch.stack([v, v]) for k, v in p.items()}
    with pytest.raises(ValueError, match="do not split"):
        ssm.ssm_params(stacked, x, cfg, d_offset=torch.arange(3))


@pytest.mark.parametrize("from_state", [False, True],
                         ids=["zero", "state"])
def test_forward_matches_reference(from_state):
    """The log-depth scan against ``jax.lax.associative_scan``: output
    and final state within RTOL/ATOL, from a zero and from a given
    state."""
    ref_cfg, cfg = _cfgs()
    np_p, p = _weights()
    x, state = _inputs(3)
    want_out, want_h = ref_ssm.ssm_forward(
        np_p, jnp.asarray(x), ref_cfg,
        jnp.asarray(state) if from_state else None)
    got_out, got_h = ssm.ssm_forward(
        p, torch.from_numpy(x), cfg,
        torch.from_numpy(state) if from_state else None)
    _close(got_out, want_out)
    _close(got_h, want_h)


@pytest.mark.parametrize("s", [1, 2, 37, 64])
def test_scan_matches_sequential_decode_steps(s):
    """The port's scan against its own decode step run position by
    position from the same state: every output and the final state."""
    _, cfg = _cfgs()
    _, p = _weights()
    x, state = _inputs(4, s)
    xt = torch.from_numpy(x)
    out, final = ssm.ssm_forward(p, xt, cfg, torch.from_numpy(state))
    h = torch.from_numpy(state)
    for t in range(s):
        step_out, h = ssm.ssm_decode_step(p, xt[:, t:t + 1], h, cfg)
        torch.testing.assert_close(out[:, t:t + 1], step_out, rtol=RTOL,
                                   atol=ATOL)
    torch.testing.assert_close(final, h, rtol=RTOL, atol=ATOL)


def test_init_matches_reference_layout():
    """Seeded init: the reference's shapes and dtypes, ``dt_rank`` from
    ``d_model // 16``, the ``a_log`` table ``log(1..state)`` on every row
    and ``d_skip`` ones."""
    ref_cfg, cfg = _cfgs()
    np_p, _ = _weights()
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_ssm_head(gen, cfg, cfg.d_model, lead=(3,), device="cpu")
    for k, v in np_p.items():
        assert tuple(p[k].shape) == (3,) + v.shape, k
        assert p[k].dtype == cfg.tdtype, k
    assert p["w_dt"].shape[1] == cfg.d_model // 16
    np.testing.assert_allclose(p["a_log"][0].numpy(), np_p["a_log"],
                               rtol=1e-7)
    assert torch.equal(p["d_skip"], torch.ones(3, cfg.d_model))
    assert torch.equal(ssm.init_ssm_state(cfg, B, 8, device="cpu"),
                       torch.zeros(B, 8, cfg.ssm.state_dim))
