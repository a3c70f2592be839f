"""FSDP in the port's trainer and prefill step (``repro_torch.distributed.
fsdp``) against the reference's ``fsdp=True`` steps and the port's own
non-FSDP explicit step.

* The explicit FSDP trainer on DP 4 against the reference's explicit
  ``fsdp=True`` step on a ``(data 4, model 1)`` mesh, from the same
  weights, at qwen3-reduced and phi3.5-moe-reduced: losses and grad norms
  within the bars ``tests/test_torch_train_loop.py`` holds the non-FSDP
  explicit step to (rtol 2e-3, atol 1e-4), and the prefill step's logits
  against the reference's ``make_prefill_step(fsdp=True)`` within
  ``tests/test_torch_prefill.py``'s 1e-4.
* Against the port's non-FSDP explicit step after 2 steps, with both
  kinds of sharded dim (an inner dim at qwen3-reduced on DP 4 and at 3
  layers on 2 x 2, whole groups at 4 layers on DP 4 and at 2 on 2 x 2):
  losses, grad norms and params within f32 1e-6.
* The reduction: a reduce-scatter plan's shards bit-equal to the
  all-reduce plan's output sliced (the reference's AllReduce-then-slice;
  the port's all-reduce plan is held bit-equal to the reference's in
  ``tests/test_torch_comm.py``).
* What a rank holds: no gathered tensor of an earlier group (or of the
  embedding) is alive when the next group is gathered, in the forward
  and in the backward; the plan replays a step equal
  ``FsdpLayout.predicted_launches``.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch import configs, tree
from repro_torch.core.comm import Communicator
from repro_torch.distributed import fsdp
from repro_torch.distributed import step as st
from repro_torch.interop import params_from_jax
from repro_torch.mesh import RankAxis
from repro_torch.models import transformer as tf
from repro_torch.train import data
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

BATCH, SEQ, STEPS, NDP = 8, 16, 3, 4
# tests/test_torch_train_loop.py's bar, explicit against the reference
RTOL, ATOL = 2e-3, 1e-4
PREFILL_TOL = 1e-4          # tests/test_torch_prefill.py's
# FSDP against the port's non-FSDP explicit step, f32 (different fold
# groupings of the same sums: one leaf at a time vs a group at a time)
SELF_TOL = 1e-6
ARCHS = ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b"]


def _cfgs(arch, **over):
    return (dataclasses.replace(
                ref_configs.reduced(ref_configs.get_config(arch)), **over),
            dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                **over))


def _mesh():
    return Mesh(np.asarray(jax.devices()[:NDP]).reshape(NDP, 1),
                ("data", "model"))


def _axes(*sizes):
    names = ("pod", "data")[-len(sizes):]
    return tuple(RankAxis(n, s, "cpu") for n, s in zip(names, sizes))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(numpy params, losses, grad norms, numpy prefill logits) of the
    reference's explicit ``fsdp=True`` steps on (data 4, model 1)."""
    cfg, _ = _cfgs(arch)
    mesh, ax = _mesh(), ref_shd.MeshAxes()
    oc = ref_opt.AdamWConfig(total_steps=STEPS, warmup_steps=1)
    step, _ = ref_step.make_train_step(
        cfg, mesh, ax, oc, mode="explicit", global_batch=BATCH,
        seq_len=SEQ, fsdp=True, donate=False)
    # numpy in: the FSDP steps place it under their own shardings
    np_params = jax.tree.map(np.asarray, ref_step.init_sharded(
        cfg, mesh, ax, jax.random.key(0))[0])
    params, state = np_params, ref_opt.adamw_init(np_params)
    pipe = ref_data.SyntheticLM(ref_data.DataConfig(
        vocab=cfg.vocab, batch=BATCH, seq_len=SEQ))
    prefill, _ = ref_step.make_prefill_step(cfg, mesh, ax, global_batch=BATCH,
                                            seq_len=SEQ, fsdp=True)
    logits = np.asarray(prefill(params, pipe.batch_at(0)["tokens"]))
    losses, norms = [], []
    for i in range(STEPS):
        params, state, m = step(params, state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np_params, losses, norms, logits


def _run(cfg, params, axes, *, fsdp_on, steps):
    oc = opt.AdamWConfig(total_steps=STEPS, warmup_steps=1)
    step = st.make_train_step(cfg, axes, oc, mode="explicit",
                              global_batch=BATCH, seq_len=SEQ,
                              fsdp=fsdp_on, device="cpu")
    held = step.shard(params)
    state = opt.adamw_init(held)
    pipe = data.SyntheticLM(data.DataConfig(vocab=cfg.vocab, batch=BATCH,
                                            seq_len=SEQ))
    losses, norms = [], []
    for i in range(steps):
        held, state, m = step(held, state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = step.fsdp.layout.unshard(held) if fsdp_on else held
    return step, out, losses, norms


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_trainer_matches_reference(arch):
    np_params, losses, norms, _ = _reference(arch)
    _, cfg = _cfgs(arch)
    step, _, got_l, got_n = _run(cfg, params_from_jax(np_params, cfg,
                                                      device="cpu"),
                                 _axes(NDP), fsdp_on=True, steps=STEPS)
    assert any(d is not None for d in tree.leaves(step.fsdp.layout.dims))
    np.testing.assert_allclose(got_l, losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_n, norms, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_prefill_matches_reference(arch):
    np_params, _, _, want = _reference(arch)
    _, cfg = _cfgs(arch)
    prefill = st.make_prefill_step(cfg, device="cpu", dp_axes=_axes(NDP),
                                   fsdp=True)
    held = prefill.fsdp.layout.shard(params_from_jax(np_params, cfg,
                                                     device="cpu"))
    toks = data.SyntheticLM(data.DataConfig(
        vocab=cfg.vocab, batch=BATCH, seq_len=SEQ)).batch_at(0)["tokens"]
    got = prefill(held, toks)
    assert got.shape == (BATCH, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)


@pytest.mark.parametrize("layers,sizes,kind", [
    (None, (4,), "inner"), (4, (4,), "groups"), (3, (2, 2), "inner"),
    (None, (2, 2), "groups")])
def test_fsdp_matches_the_explicit_step(layers, sizes, kind):
    over = {} if layers is None else dict(n_layers=layers)
    _, cfg = _cfgs("qwen3-1.7b", **over)
    params = tf.init_params(cfg, device="cpu", seed=0)
    step, got, gl, gn = _run(cfg, params, _axes(*sizes), fsdp_on=True,
                             steps=2)
    _, want, wl, wn = _run(cfg, params, _axes(*sizes), fsdp_on=False,
                           steps=2)
    dims = step.fsdp.layout.dims["layers"][0]["mlp"]["w_gate"]
    assert dims == (0 if kind == "groups" else 1)
    # with a pod axis (2 x 2) every reduction is two replays
    assert step.fsdp.comms.replays == 2 * step.fsdp.layout.predicted_launches(
        backward=True)
    np.testing.assert_allclose(gl, wl, rtol=SELF_TOL, atol=SELF_TOL)
    np.testing.assert_allclose(gn, wn, rtol=SELF_TOL, atol=SELF_TOL)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SELF_TOL,
                                   atol=SELF_TOL)


@pytest.mark.parametrize("rows,cols", [(64, 32), (256, 128), (12, 40)])
def test_reduce_scatter_is_all_reduce_sliced(rows, cols):
    comm = Communicator("data", n=NDP, device="cpu")
    x = torch.from_numpy(np.random.RandomState(rows).randn(
        NDP, NDP * rows, cols).astype(np.float32))
    rs = comm.compile("reduce_scatter", (NDP * rows, cols), torch.float32)(x)
    ar = comm.compile("all_reduce", (NDP * rows, cols), torch.float32)(x)
    for r in range(NDP):
        assert torch.equal(rs[r], ar[r, r * rows:(r + 1) * rows])


def test_layout_round_trip_and_held_bytes():
    _, cfg = _cfgs("qwen3-1.7b", n_layers=4)
    params = tf.init_params(cfg, device="cpu", seed=0)
    grid = fsdp.dp_grid(_axes(NDP))
    lay = fsdp.FsdpLayout(cfg, grid)
    held = lay.shard(params)
    back = lay.unshard(held)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                 tree.leaves(params)))
    for p, h, d in zip(tree.leaves(params), tree.leaves(held),
                       tree.leaves(lay.dims)):
        if d is not None:
            assert h.shape[0] == NDP and h[0].numel() * NDP == p.numel()
    one = fsdp.FsdpLayout(cfg, grid, local=1).empty("meta")
    assert all(h.shape[0] == 1 for h, d in zip(tree.leaves(one),
                                               tree.leaves(lay.dims))
               if d is not None)


@pytest.mark.parametrize("layers", [None, 4])
def test_a_rank_holds_one_gathered_group(monkeypatch, layers):
    """Wrap the gathers: when a group (or the embedding) is gathered, no
    earlier gathered tensor lives — forward, head and backward — and the
    plan replays a step are the count the layout predicts."""
    over = {} if layers is None else dict(n_layers=layers)
    _, cfg = _cfgs("qwen3-1.7b", **over)
    live = {}
    order = []

    def track(t, tag):
        s = t.untyped_storage()
        live[id(s)] = tag
        weakref.finalize(s, live.pop, id(s), None)

    def wrap(name):
        orig = getattr(fsdp.FsdpPass, name)

        def gather(self, held, what):
            assert not live, (f"{name}({what}) while gathered "
                              f"{sorted(set(live.values()))} live")
            out = orig(self, held, what)
            order.append((name, what))
            if name == "gather_group":
                for i, path, d in self.layout.group_leaves():
                    if d is not None:
                        track(fsdp._get(out[i], path), what)
            elif self.layout.dims[what] is not None:
                track(out, what)
            return out
        monkeypatch.setattr(fsdp.FsdpPass, name, gather)

    wrap("gather_group")
    wrap("gather_root")
    params = tf.init_params(cfg, device="cpu", seed=0)
    step, _, _, _ = _run(cfg, params, _axes(NDP), fsdp_on=True, steps=1)
    G = tf.n_groups(cfg)
    head = "embed" if cfg.tie_embeddings else "unembed"
    assert order == ([("gather_root", "embed")]
                     + [("gather_group", g) for g in range(G)]
                     + [("gather_root", head)]
                     + [("gather_group", g) for g in reversed(range(G))])
    assert step.fsdp.comms.replays == step.fsdp.layout.predicted_launches(
        backward=True)
    order.clear()
    prefill = st.make_prefill_step(cfg, device="cpu", dp_axes=_axes(NDP),
                                   fsdp=True)
    prefill(prefill.fsdp.layout.shard(params),
            torch.zeros((BATCH, SEQ), dtype=torch.long))
    assert len(order) == G + 2
    assert prefill.fsdp.comms.replays == \
        prefill.fsdp.layout.predicted_launches(backward=False)


def test_auto_mode_ignores_fsdp():
    """Auto has no ranks: ``fsdp=True`` computes as the auto step."""
    _, cfg = _cfgs("qwen3-1.7b")
    step = st.make_train_step(cfg, (), opt.AdamWConfig(), global_batch=2,
                              seq_len=4, fsdp=True, device="cpu")
    assert step.fsdp is None and step.mode == "auto"
