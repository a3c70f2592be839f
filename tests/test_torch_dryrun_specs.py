"""The port's sharding specs, production grids and dry-run inputs against
the reference's.

``param_pspecs``/``batch_pspec``/``cache_pspecs``/``apply_fsdp`` of
``repro_torch.distributed.sharding`` over a ``NamedGrid`` against
``repro.distributed.sharding``'s over a ``jax.sharding.AbstractMesh`` of
the same shape (no devices needed), for every arch of
``configs.ARCHS`` and ``llama2-70b`` on both production grids, FSDP off
and on: the port's spec tuples equal the reference's ``PartitionSpec``
entries. The port's leaf shapes come from its ``init_params`` on the
``meta`` device, the reference's from ``jax.eval_shape``. Then
``mesh_axes_for``, ``model_flops`` for every ``(arch, cell)`` and the
shapes of ``input_specs``.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.launch import mesh as ref_mesh
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import transformer as tf

ARCHS = list(configs.ARCHS) + ["llama2-70b"]
GRIDS = {"16x16": ((16, 16), ("data", "model")),
         "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _as_tuple(sp):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in sp)


def _ref_tree(tree):
    """The reference's spec tree with every PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: _ref_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_ref_tree(v) for v in tree]
    assert isinstance(tree, P), tree
    return _as_tuple(tree)


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_tree(v) for v in tree]
    assert isinstance(tree, tuple), tree
    return _as_tuple(tree)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference ShapeDtypeStructs, the port's meta tensors)."""
    ref = jax.eval_shape(functools.partial(
        ref_tf.init_params, ref_configs.get_config(arch)), jax.random.key(0))
    port = tf.init_params(configs.get_config(arch), device="meta")
    return ref, port


def _grids(name):
    sizes, names = GRIDS[name]
    mesh = AbstractMesh(sizes, names)
    grid = port_mesh.make_production_mesh(multi_pod=name == "2x16x16")
    assert grid.shape == dict(mesh.shape)
    return mesh, grid, ref_mesh.mesh_axes_for(mesh), port_mesh.mesh_axes_for(
        grid)


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_mesh_axes_for(grid_name):
    _, grid, rax, pax = _grids(grid_name)
    assert (pax.data, pax.model) == (tuple(rax.data), rax.model)
    assert grid.size == int(np.prod(list(grid.shape.values())))


def test_named_grid_groups():
    grid = port_mesh.make_production_mesh(multi_pod=True)
    model = grid.group_ranks(("model",))
    assert len(model) == 32 and model[0] == list(range(16))
    data = grid.group_ranks(("data",))
    assert data[0] == list(range(0, 256, 16)) and data[1][0] == 1
    both = grid.group_ranks(("pod", "data"))
    assert len(both) == 16 and both[0][:2] == [0, 16] and both[0][16] == 256


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, grid_name, fsdp):
    mesh, grid, rax, pax = _grids(grid_name)
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    want = ref_shd.param_pspecs(rcfg, mesh, rax)
    got = shd.param_pspecs(cfg, grid, pax)
    if fsdp:
        ref_shapes, port_shapes = _shapes(arch)
        want = ref_shd.apply_fsdp(want, ref_shapes, mesh, rax)
        got = shd.apply_fsdp(got, port_shapes, grid, pax)
    assert _port_tree(got) == _ref_tree(want)


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_match_reference(arch, grid_name):
    mesh, grid, rax, pax = _grids(grid_name)
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    for gb in (1, 32, 128, 256):
        for emb in (False, True):
            assert _as_tuple(shd.batch_pspec(
                cfg, grid, pax, global_batch=gb, embedded=emb)) == _as_tuple(
                ref_shd.batch_pspec(rcfg, mesh, rax, global_batch=gb,
                                    embedded=emb))
    if cfg.family == "encoder":
        return
    wins = tf.layer_windows(cfg)
    for batch, max_kv in ((128, 32768), (1, 524288), (8, 1000)):
        kv_lens = [min(w, max_kv) if w is not None else max_kv
                   for w in wins]
        for lens in (None, kv_lens):
            got = shd.cache_pspecs(cfg, grid, pax, batch=batch, kv_lens=lens)
            want = ref_shd.cache_pspecs(rcfg, mesh, rax, batch=batch,
                                        kv_lens=lens)
            assert _port_tree(got) == _ref_tree(want)


def test_logical_rules_match_reference():
    cfg = configs.get_config("qwen3-1.7b")
    assert shd.logical_rules(cfg) == ref_shd.logical_rules(
        ref_configs.get_config("qwen3-1.7b"))


def test_fsdp_shards_both_kinds_of_dim():
    """qwen3-1.7b's 28 groups: a DP 4 axis owns whole groups, a DP 8 axis
    shards an inner dim (``d_model``), as the dry run's trainer sees."""
    from repro_torch.mesh import NamedGrid
    cfg = configs.get_config("qwen3-1.7b")
    shapes = tf.init_params(cfg, device="meta")
    for n, dim in ((4, 0), (8, 1)):
        grid = NamedGrid(("data",), (n,))
        specs = shd.apply_fsdp(shd.param_pspecs(cfg, grid), shapes, grid)
        assert specs["layers"][0]["attn"]["wq"].index("data") == dim
        assert specs["layers"][0]["ln_attn"] == (None, None)
        assert specs["embed"] == ("data", None)


def _ref_dryrun():
    """``repro.launch.dryrun``, imported with the process's ``XLA_FLAGS``
    put back (the module sets a 512-device flag for its own process)."""
    import os
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


@pytest.mark.parametrize("arch,cell", ref_configs.all_cells())
def test_model_flops_and_input_specs_match_reference(arch, cell):
    from repro_torch.launch import dryrun
    ref = _ref_dryrun()
    rcfg, rspecs = ref.input_specs(arch, cell)
    cfg, specs = dryrun.input_specs(arch, cell)
    for kind in ("train", "prefill", "decode"):
        assert dryrun.model_flops(cfg, kind, specs["batch"], specs["seq"]) \
            == ref.model_flops(rcfg, kind, rspecs["batch"], rspecs["seq"])
    for k in ("tokens", "labels"):
        assert tuple(specs[k].shape) == tuple(rspecs[k].shape)
        assert str(specs[k].dtype).split(".")[-1] == str(rspecs[k].dtype)
    assert [tuple(x.shape) for x in _leaves(specs["params"])] == \
        [tuple(x.shape) for x in jax.tree.leaves(rspecs["params"])]
    assert (specs["batch"], specs["seq"], specs["kind"]) == (
        rspecs["batch"], rspecs["seq"], rspecs["kind"])


def test_optimization_bundles_match_reference():
    """The same bundles, each field one the port's config, serve step or
    train step takes."""
    import dataclasses as dc
    import inspect
    from repro_torch.distributed import step as step_mod
    from repro_torch.launch import dryrun
    assert dryrun.OPTIMIZATIONS == _ref_dryrun().OPTIMIZATIONS
    fields = {f.name for f in dc.fields(configs.get_config("qwen3-1.7b"))}
    serve = set(inspect.signature(step_mod.make_serve_step).parameters)
    train = set(inspect.signature(step_mod.make_train_step).parameters)
    for bundle in dryrun.OPTIMIZATIONS.values():
        for k in bundle:
            assert k in fields | serve | train, k


def _leaves(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.leaves(tree)
