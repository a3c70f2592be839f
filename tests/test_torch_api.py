"""The port's collective API (``repro_torch.core.api``) and its tuning
layer against the reference's: every collective bit-equal in f32 and
int32 at n in {2, 4, 8} (the reference's ``api`` under ``shard_map``,
the port's on rank-stacked tensors, both costed on ``sel.ICI`` so they
choose alike), each registry candidate forced, the ``torch_native``
baseline, pytree bucket fusion over a qwen3 parameter tree, the plan
cache's counters, the tuning tables and link fits from the repository's
``BENCH_collectives.json``, ``register_algorithm``, plan files exported
by the reference, and the algorithms the decode plans choose."""
import copy
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro import configs as ref_configs
from repro.compat import shard_map
from repro.core import api as ref_api
from repro.core import comm as ref_comm
from repro.core import selector as ref_sel
from repro.models import transformer as ref_tf
from repro_torch import configs, interop
from repro_torch.core import algorithms as algos
from repro_torch.core import api, comm
from repro_torch.core import selector as sel
from repro_torch.distributed.step import compile_decode_plans

torch.set_num_threads(1)

BENCH = pathlib.Path(__file__).resolve().parents[1] / "BENCH_collectives.json"
AXIS = "x"


@pytest.fixture(autouse=True)
def fresh_defaults():
    """Both packages' process-default communicators start empty and are
    dropped after each test (a test may install a table on one)."""
    ref_comm.reset_default_communicators()
    comm.reset_default_communicators()
    yield
    ref_comm.reset_default_communicators()
    comm.reset_default_communicators()


@pytest.fixture
def restore_registry():
    """Undo ``register_algorithm``: the candidate lists, the predicates
    and the algorithm registry."""
    saved = (copy.deepcopy(sel.CANDIDATES), dict(sel._SUPPORTS),
             dict(algos.REGISTRY))
    yield
    sel.CANDIDATES.clear()
    sel.CANDIDATES.update(saved[0])
    sel._SUPPORTS.clear()
    sel._SUPPORTS.update(saved[1])
    algos.REGISTRY.clear()
    algos.REGISTRY.update(saved[2])


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), (AXIS,))


def _ref(fn, x):
    """The reference: ``fn`` on each rank's shard under shard_map over
    the leading axis of ``x`` (numpy), stacked back."""
    n = x.shape[0]
    f = jax.jit(shard_map(lambda xs: fn(xs[0])[None], mesh=_mesh(n),
                          in_specs=P(AXIS, None, None),
                          out_specs=P(AXIS, None, None), check_vma=False))
    return np.asarray(f(x))


def _data(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    if dtype == "int32":
        return rs.randint(-1000, 1000, shape).astype(np.int32)
    return rs.randn(*shape).astype(np.float32)


# per-rank input rows of each collective, n ranks (the all_reduce's 5 and
# 3 rows do not divide the chunk grid: the padding path)
def _shape(collective, n):
    return {"all_reduce": (n, 5, 24), "all_gather": (n, 3, 16),
            "reduce_scatter": (n, n * 2, 16), "all_to_all": (n, n * 2, 8),
            "broadcast": (n, 3, 16)}[collective]


def _port_call(collective, x, **kw):
    if collective == "broadcast":
        return getattr(api, collective)(x, AXIS, root=1, **kw)
    return getattr(api, collective)(x, AXIS, **kw)


def _ref_call(collective, **kw):
    if collective == "broadcast":
        return lambda s: ref_api.broadcast(s, AXIS, root=1, **kw)
    return lambda s: getattr(ref_api, collective)(s, AXIS, **kw)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("collective", ["all_reduce", "all_gather",
                                        "reduce_scatter", "all_to_all",
                                        "broadcast"])
def test_api_bit_equal_to_reference(collective, n, dtype):
    x = _data(_shape(collective, n), dtype, seed=n)
    want = _ref(_ref_call(collective, link=ref_sel.ICI), x)
    got = _port_call(collective, torch.from_numpy(x), link=sel.ICI)
    np.testing.assert_array_equal(got.numpy(), want)
    plan = next(iter(api.communicator(AXIS).plans().values()))
    ref_plan = next(iter(ref_api.communicator(AXIS).plans().values()))
    assert (plan.algo, plan.opt_level, plan.pad) == \
        (ref_plan.algo, ref_plan.opt_level, ref_plan.pad)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("collective,algo", [
    (c, a) for c in ("all_reduce", "all_gather", "reduce_scatter",
                     "all_to_all") for a in ref_sel.CANDIDATES[c]])
def test_api_forced_algorithm_bit_equal(collective, algo, n):
    x = _data(_shape(collective, n), "float32", seed=3 * n)
    want = _ref(_ref_call(collective, algo=algo), x)
    got = _port_call(collective, torch.from_numpy(x), algo=algo)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("collective", ["all_reduce", "all_gather",
                                        "reduce_scatter", "all_to_all",
                                        "broadcast"])
def test_torch_native_matches_xla_native(collective):
    n = 4
    x = _data(_shape(collective, n), "float32", seed=11)
    want = _ref(_ref_call(collective, backend="xla_native"), x)
    got = _port_call(collective, torch.from_numpy(x), backend="torch_native")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    # no plan: the native backend compiles nothing
    assert api.communicator(AXIS).stats == {"compiles": 0, "hits": 0}


def test_tree_all_reduce_qwen3_params_bit_equal():
    """A reduced qwen3 parameter tree, each rank's copy perturbed: one
    fused all_reduce, bit-equal to the reference's leaf by leaf."""
    n = 4
    ref_cfg = ref_configs.reduced(ref_configs.get_config("qwen3-1.7b"))
    base = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref_tf.init_params(ref_cfg, jax.random.key(0)))
    rs = np.random.RandomState(0)
    stacked = jax.tree.map(
        lambda a: np.stack([a + rs.randn(*a.shape).astype(np.float32)
                            for _ in range(n)]), base)
    leaves, treedef = jax.tree.flatten(stacked)
    mesh = _mesh(n)
    specs = jax.tree.unflatten(treedef, [P(AXIS)] * len(leaves))
    f = jax.jit(shard_map(
        lambda t: jax.tree.map(
            lambda a: a[None],
            ref_api.tree_all_reduce(jax.tree.map(lambda a: a[0], t), AXIS)),
        mesh=mesh, in_specs=(specs,), out_specs=specs, check_vma=False))
    want = jax.tree.map(np.asarray, f(stacked))

    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    cfg = dataclasses.replace(cfg, dtype="float32")
    port_tree = interop.params_from_jax(stacked, cfg, device="cpu")
    got = api.tree_all_reduce(port_tree, AXIS, link=sel.ICI)
    assert api.communicator(AXIS).stats["compiles"] == 1   # one buffer
    got_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    assert len(got_leaves) == len(leaves)
    for g, w in zip(got_leaves, jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_compile_counters_equal_reference():
    """The same call sequence hits and compiles the same plans."""
    n = 4
    x = _data((n, 8, 16), "float32", seed=0)
    seq = ["all_reduce", "all_reduce", "all_gather", "all_reduce",
           "all_gather", "broadcast"]

    def ref_body(s):
        for c in seq:
            _ref_call(c)(s)
        return s

    _ref(ref_body, x)
    xt = torch.from_numpy(x)
    for c in seq:
        _port_call(c, xt)
    assert api.communicator(AXIS).stats == \
        ref_api.communicator(AXIS).stats == {"compiles": 3, "hits": 3}


def test_set_tuning_table_clears_cache_and_retunes():
    c = api.communicator(AXIS)
    x = torch.from_numpy(_data((4, 8, 16), "float32", seed=1))
    y0 = api.all_reduce(x, AXIS)
    c.plan_for("all_reduce", (8, 16), torch.float32, buckets=(4, 8), n=4,
               device="cpu")
    assert c.plans() and c._bucketed
    first = next(iter(c.plans().values())).algo
    other = next(a for a in sel.CANDIDATES["all_reduce"] if a != first)
    c.set_tuning_table(sel.TuningTable([("all_reduce", 1 << 20, other)]))
    assert not c.plans() and not c._bucketed
    y1 = api.all_reduce(x, AXIS)
    assert next(iter(c.plans().values())).algo == other
    torch.testing.assert_close(y1, y0, rtol=1e-6, atol=1e-5)
    assert c.stats["compiles"] == 3


def test_tuning_from_bench_payload_matches_reference():
    bench = json.loads(BENCH.read_text())
    assert sel.TuningTable.from_bench(bench).entries == \
        ref_sel.TuningTable.from_bench(bench).entries
    for base in (sel.ICI, sel.UNFITTED):
        ref_base = ref_sel.LinkModel(**base.__dict__)
        got = sel.fit_link_model(bench, base=base)
        want = ref_sel.fit_link_model(bench, base=ref_base)
        assert got.torus == want.torus and got.sync_us == want.sync_us
        for k in ("alpha_us", "beta_GBps"):
            assert getattr(got, k) == pytest.approx(getattr(want, k),
                                                    rel=1e-12)
    port = comm.Communicator("x", n=8, device="cpu", link=sel.ICI)
    ref = ref_comm.Communicator("x", n=8, link=ref_sel.ICI)
    port.load_bench_tuning(str(BENCH))
    ref.load_bench_tuning(str(BENCH))
    assert port.table.entries == ref.table.entries
    assert port.link.alpha_us == pytest.approx(ref.link.alpha_us, rel=1e-12)
    assert port.link.beta_GBps == pytest.approx(ref.link.beta_GBps, rel=1e-12)
    # the installed table decides the port's choices as the reference's
    for coll, nbytes, _ in ref.table.entries:
        assert sel.choose(coll, n=8, nbytes=nbytes, link=port.link,
                          table=port.table) == \
            ref_sel.choose(coll, n=8, nbytes=nbytes, link=ref.link,
                           table=ref.table)


def test_bench_payload_errors():
    for fn in (sel.fit_link_model, sel.TuningTable.from_bench):
        with pytest.raises(ValueError, match="has no 'points' field"):
            fn({"n": 8})
        with pytest.raises(ValueError, match="empty 'points' list"):
            fn({"n": 8, "points": []})
        with pytest.raises(ValueError, match="expects the parsed"):
            fn([1, 2, 3])
    with pytest.raises(ValueError, match="usable point"):
        sel.fit_link_model({"n": 8, "points": [{"bench": "weird"}]})


def test_candidates_in_reference_order():
    assert sel.CANDIDATES == ref_sel.CANDIDATES
    for name in algos.REGISTRY:
        for n in (2, 3, 4, 6, 8):
            assert sel.supports(name, n) == ref_sel.supports(name, n)


def test_register_algorithm_contracts(restore_registry):
    with pytest.raises(ValueError, match="not in algorithms.REGISTRY"):
        sel.register_algorithm("all_reduce", "no_such_algorithm")
    before = list(sel.CANDIDATES["all_reduce"])
    sel.register_algorithm("all_reduce", "allreduce_ring")      # idempotent
    assert sel.CANDIDATES["all_reduce"] == before
    # a new builder, offered only at even n
    sel.register_algorithm("all_reduce", "ring_even",
                           algos.REGISTRY["allreduce_ring"],
                           supports=lambda n: n % 2 == 0)
    assert sel.CANDIDATES["all_reduce"] == before + ["ring_even"]
    assert sel.supports("ring_even", 4) and not sel.supports("ring_even", 3)
    with pytest.raises(ValueError, match="does not support n=3"):
        sel.estimate_us("ring_even", 3, 4096)
    assert "ring_even" not in [
        a for a in sel.CANDIDATES["all_reduce"] if sel.supports(a, 3)]
    x = torch.from_numpy(_data((4, 8, 16), "float32", seed=2))
    torch.testing.assert_close(api.all_reduce(x, AXIS, algo="ring_even"),
                               api.all_reduce(x, AXIS,
                                              algo="allreduce_ring"))


def test_load_and_verify_reference_plan_files(tmp_path):
    """Plan files of every kind exported by the reference load through
    ``api.load_plan``, verify clean and replay as the reference's."""
    n = 4
    rc = ref_comm.Communicator("x", n=n)
    plans = {
        "ar": rc.compile("all_reduce", (8, 16), jnp.float32),
        "ag_fam": rc.plan_for("all_gather", (4, 16), jnp.float32,
                              buckets=(2, 4)),
        "hier": ref_comm.HierarchicalCommunicator(
            "local", "node", local_n=2, node_n=2).compile((8, 16),
                                                          jnp.float32),
    }
    ref_comm.export_plan_set(plans, tmp_path)
    for name in plans:
        path = tmp_path / f"{name}.json"
        loaded = api.load_plan(str(path), device="cpu")
        again = api.load_plan(path.read_text(), device="cpu")
        assert type(loaded).__name__ == type(plans[name]).__name__
        assert type(again) is type(loaded)
        report = api.verify_plan(loaded)
        assert report.ok and not report.findings
        assert report.summary() == ref_api.verify_plan(plans[name]).summary()
    x = _data((n, 8, 16), "float32", seed=5)
    got = api.load_plan(str(tmp_path / "ar.json"), device="cpu")(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _ref(plans["ar"], x))
    with pytest.raises(ValueError, match="version"):
        api.load_plan('{"kind": "bucketed_plan"}', device="cpu")


# the decode plans' algorithms (every plan family, every bucket), as the
# selector chose them on the UNFITTED link before the API and the tuning
# layer came in: qwen3 / phi3.5-moe / hymba, reduced and at full width
_AR = "allreduce_1pa"


def _expect(arch, tp, full):
    slots = {1: _AR, 2: _AR, 4: _AR, 8: _AR}
    if full:
        big = "allreduce_2pa" if tp == 4 else _AR
        ar = {**slots, 128: big, 512: big, 2048: big}
    else:
        ar = {**slots, 32: _AR, 128: _AR}
    want = {"layer_allreduce": ar,
            "logits_allgather": {b: "allpairs_ag" for b in (1, 2, 4, 8)}}
    if arch == "hymba-1.5b" and full:
        del want["logits_allgather"]
    if arch.startswith("phi3.5"):
        caps = ((16, 32, 64, 128, 2048, 8192, 32768) if tp == 2 else
                (8, 16, 32, 64, 1024, 4096, 16384)) if full else \
            ((4, 8, 16, 32, 128, 512) if tp == 2 else (2, 4, 8, 16, 64, 256))
        want["moe_alltoall"] = {c: "alltoall" for c in caps}
    return want


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b",
                                  "hymba-1.5b"])
def test_decode_plans_choose_as_before(arch, tp, full):
    cfg = configs.get_config(arch)
    if not full:
        cfg = configs.reduced(cfg)
    c = comm.Communicator("model", n=tp, device="cpu")
    assert c.link == sel.UNFITTED and c.table is None
    plans = compile_decode_plans(cfg, c, batch_local=8, tp=tp,
                                 seq_buckets=(16, 64, 256) if full
                                 else (4, 16))
    got = {name: {b: p.algo for b, p in bp.plans.items()}
           for name, bp in plans.items()}
    assert got == _expect(arch, tp, full)
    assert all(p.opt_level == 2 for bp in plans.values()
               for p in bp.plans.values())
