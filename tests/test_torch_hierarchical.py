"""The port's hierarchical AllReduce against the reference, on the same
numpy-seeded inputs: the 2PH kernel's plain version (``repro_torch.
kernels.allreduce_2ph``) bit-equal in f32 and bf16 to the reference Pallas
kernel run as ``tests/test_kernels_hierarchical.py`` runs it (``shard_map``
over a 2 x 4 mesh, interpret mode); ``HierarchicalCommunicator`` choosing
the reference's phase algorithms and cost cards under the reference's
ICI/DCN links, with the same plan JSON; a reference-exported hierarchical
plan replaying bit-equal; hierarchical against flat on integer payloads;
the fallback, the cache, plan sets, and the Communicator's collective
methods against the reference's. The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py`` phase 11."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro import compat
from repro.compat import shard_map
from repro.core import comm as ref_comm
from repro.core import selector as ref_sel
from repro.kernels import ref as jax_ref
from repro.kernels.allreduce_2ph import all_reduce_2ph as jax_ar_2ph
from repro_torch.core import selector as sel
from repro_torch.core.comm import (Communicator, ExecutionPlan,
                                   HierarchicalCommunicator,
                                   HierarchicalPlan, export_plan_set,
                                   hierarchical_all_reduce, load_plan_set,
                                   plan_from_json)
from repro_torch.core.executor import TorchExecutor
from repro_torch.kernels import allreduce_2ph, build, comm_utils, ops, ref
from repro_torch.kernels.allreduce_2ph import all_reduce_2ph_plain
from repro_torch.mesh import RankGrid, group_ranks

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

NN, L = 2, 4                        # the reference's mesh2x4: node x local
COLS = 128
# (rows a chunk, dtype) of each reference kernel case, run in one jit
CASES_2PH = ((8, "float32"), (16, "float32"), (8, "bfloat16"),
             (16, "bfloat16"))
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mesh(nn, ln):
    return Mesh(np.asarray(jax.devices()[:nn * ln]).reshape(nn, ln),
                ("node", "local"))


def _np(y):
    return np.asarray(y.astype(jnp.float32) if y.dtype == jnp.bfloat16
                      else y)


def _tnp(y):
    return (y.float() if y.dtype == torch.bfloat16 else y).numpy()


def _input_2ph(i, rows):
    """Rank-stacked node-major (nn*L, L*rows, cols), f32 values."""
    return np.random.RandomState(i).randn(NN * L, L * rows,
                                          COLS).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_2ph():
    """Every reference 2PH case in one jitted shard_map (interpret mode),
    plus the twice case (the reference's kernel applied to its own
    output) on the first: numpy outputs, bf16 as f32."""
    def run(*xs):
        outs = []
        for x, (_, dt) in zip(xs, CASES_2PH):
            outs.append(jax_ar_2ph(x[0, 0].astype(JDT[dt]), local_axis="local",
                                   local_size=L, node_axis="node",
                                   node_size=NN)[None, None])
        outs.append(jax_ar_2ph(outs[0][0, 0], local_axis="local",
                               local_size=L, node_axis="node",
                               node_size=NN)[None, None])
        return tuple(outs)

    spec = P("node", "local", None, None)
    f = jax.jit(shard_map(run, mesh=_mesh(NN, L),
                          in_specs=(spec,) * len(CASES_2PH),
                          out_specs=(spec,) * (len(CASES_2PH) + 1),
                          check_vma=False))
    xs = [_input_2ph(i, rows).reshape(NN, L, L * rows, COLS)
          for i, (rows, _) in enumerate(CASES_2PH)]
    return [_np(o).reshape(NN * L, -1, COLS) for o in f(*xs)]


_needs_multiaxis = pytest.mark.skipif(
    not compat.HAS_MULTIAXIS_REMOTE_DMA,
    reason="the reference's pallas interpreter cannot emulate multi-axis "
           "remote DMA on this jax")


# ---------------------------------------------------------------------------
# the 2PH kernel's plain version against the reference kernel
# ---------------------------------------------------------------------------
@_needs_multiaxis
@pytest.mark.parametrize("case", range(len(CASES_2PH)),
                         ids=[f"rows{r}-{d}" for r, d in CASES_2PH])
def test_2ph_plain_bit_equal_to_jax_kernel(case):
    rows, dt = CASES_2PH[case]
    x = torch.from_numpy(_input_2ph(case, rows)).to(TDT[dt])
    got = ops.all_reduce(x, algo="2ph", node_size=NN)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(_tnp(got), _ref_2ph()[case])


@_needs_multiaxis
def test_2ph_twice_bit_equal_to_jax_kernel():
    """Back-to-back calls, each on the other's output (the reference's
    test_all_reduce_2ph_twice)."""
    x = torch.from_numpy(_input_2ph(0, CASES_2PH[0][0]))
    got = all_reduce_2ph_plain(all_reduce_2ph_plain(x, node_size=NN),
                               node_size=NN)
    np.testing.assert_array_equal(got.numpy(), _ref_2ph()[-1])


@pytest.mark.parametrize("nn,ln", [(2, 2), (2, 4), (4, 4), (1, 4), (4, 1)])
def test_2ph_plain_sums_integer_payloads(nn, ln):
    """Exact on integer values (any fold order), every grid the kernel
    takes; the fold is not torch.sum's order (bf16 differs)."""
    x = torch.from_numpy(np.random.RandomState(nn * 10 + ln).randint(
        -8, 8, (nn * ln, ln * 3, 5)).astype(np.float32))
    assert torch.equal(all_reduce_2ph_plain(x, node_size=nn),
                       ref.hierarchical_all_reduce_ref(x))


def test_2ph_geometry_errors():
    x = torch.zeros(8, 8, 4)
    with pytest.raises(ValueError, match="needs node_size"):
        ops.all_reduce(x, algo="2ph")
    with pytest.raises(ValueError, match="does not divide the 8 ranks"):
        ops.all_reduce(x, algo="2ph", node_size=3)
    with pytest.raises(ValueError, match="do not split into 4 chunks"):
        ops.all_reduce(x[:, :6], algo="2ph", node_size=2)


@pytest.mark.parametrize("nn,ln,count,esz,cap", [
    (2, 4, 512, 2, 264), (2, 4, 37, 4, 264), (2, 2, 1031 * 2048, 4, 264),
    (2, 4, 1031 * 2048, 2, 264), (4, 4, 1031 * 2048, 4, 264),
    (2, 4, 151936 * 2048 // 4, 2, 264), (2, 4, 151936 * 2048 // 4, 2, 8)])
def test_2ph_scratch_geometry(nn, ln, count, esz, cap):
    """The 2PH kernel's scratch is one chunk a rank (D/L, D a rank's
    input) for the phase-1 partial and the flags: entry and done one a
    block, ready one a sub-tile; no D-sized slots. Blocks keep to the
    resident cap, sub-tiles are 16-byte multiples and cover a block's
    tile as ``primitives.cuh:tile`` cuts it."""
    geo = allreduce_2ph.scratch_geometry(nn, ln, count, esz, cap)
    total, rank_bytes = nn * ln, ln * count * esz
    assert geo.partial * esz * ln == rank_bytes          # D / L a rank
    assert geo.flags == total * geo.blocks * (geo.subtiles + 2)
    assert 1 <= geo.blocks and total * geo.blocks <= max(cap, total)
    assert geo.sub * esz == allreduce_2ph.SUB_BYTES and geo.sub * esz % 16 == 0
    align = 16 // esz
    per = -(-(-(-count // align)) // geo.blocks) * align
    assert (geo.subtiles - 1) * geo.sub < max(per, 1) <= geo.subtiles * geo.sub
    # the same geometry again from the blocks it chose, as the wrapper
    # rebuilds it at every launch
    assert allreduce_2ph.scratch_geometry(
        nn, ln, count, esz, geo.blocks * total) == geo


@pytest.mark.parametrize("nn,ln", [(2, 2), (2, 4), (4, 4), (4, 2)])
def test_2ph_traffic_is_under_the_staged_design(nn, ln):
    """By its own count a rank reads D + nn D/L and writes D/L + D: at 2 x 4
    that is 2.75 D, against the bound's 2 D and the 5.5 D of a design
    that puts phase 1 through slots and stages the chunk in the output."""
    d = ln * 4096
    read, written = allreduce_2ph.traffic_bytes(nn, ln, d)
    assert (read, written) == (d + nn * d // ln, d // ln + d)
    assert 2 * d < read + written < 5.5 * d
    if (nn, ln) == (2, 4):
        assert read + written == 2.75 * d


def test_2ph_wrapper_allocates_partials_and_flags_only(monkeypatch):
    """The wrapper, on a stand-in library, hands the kernel its payload's
    scratch_geometry (blocks, sub-tile, sub-tiles a block) and allocates
    no scratch beyond the partials (one chunk a rank) and the flags."""
    calls, scratch = [], []

    class Lib:
        def allreduce_2ph_max_blocks(self, code, threads):
            return 264

        def allreduce_2ph_launch(self, *args):
            calls.append(args)
            return 0

        def allreduce_2ph_error_string(self, rc):
            return b""

    def spy(make):
        def alloc(*a, **k):
            t = make(*a, **k)
            scratch.append(t.numel() * t.element_size())
            return t
        return alloc

    monkeypatch.setattr(build, "allreduce_2ph_library", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(comm_utils, "_WORKSPACES", {})
    monkeypatch.setattr(comm_utils, "LAUNCHES", comm_utils.LAUNCHES.copy())
    nn, ln, rows, cols = 2, 4, 37, 2048
    x = torch.zeros(nn * ln, ln * rows, cols, dtype=torch.bfloat16)
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", spy(torch.empty))
        m.setattr(torch, "zeros", spy(torch.zeros))
        out = allreduce_2ph._launch(x, nn)
        out = allreduce_2ph._launch(x, nn)     # the flags are made once
    geo = allreduce_2ph.scratch_geometry(nn, ln, rows * cols, 2, 264)
    assert out.shape == x.shape and comm_utils.LAUNCHES["all_reduce_2ph"] == 2
    count, blocks, sub, ksub = calls[0][7:11]
    assert (count, blocks, sub, ksub) == (rows * cols, geo.blocks, geo.sub,
                                          geo.subtiles)
    part = nn * ln * rows * cols * 2                     # D / L a rank
    assert sorted(scratch) == sorted([geo.flags * 4, part, part])


# ---------------------------------------------------------------------------
# the plan layer against the reference's
# ---------------------------------------------------------------------------
def _no_backend(d):
    """A plan dict or cost card without its backend fields (the
    reference's is "xla", the port's "torch")."""
    if isinstance(d, dict):
        return {k: _no_backend(v) for k, v in d.items() if k != "backend"}
    return d


@pytest.mark.parametrize("nn,ln", [(2, 4), (4, 4)])
@pytest.mark.parametrize("shape,dtype", [
    ((8, 128), "float32"), ((13, 64), "float32"), ((1024, 256), "float32"),
    ((4096, 2048), "bfloat16"), ((28, 2048), "bfloat16")])
def test_hierarchical_communicator_matches_reference(nn, ln, shape, dtype):
    """Same phase algorithms, cost card and plan JSON (backend aside) as
    the reference's with its ICI/DCN links, passed explicitly."""
    rhc = ref_comm.HierarchicalCommunicator(
        "local", "node", local_n=ln, node_n=nn, local_link=ref_sel.ICI,
        node_link=ref_sel.DCN)
    hc = HierarchicalCommunicator("local", "node", local_n=ln, node_n=nn,
                                  device="cpu", local_link=sel.ICI,
                                  node_link=sel.DCN)
    rplan = rhc.compile(shape, JDT[dtype])
    plan = hc.compile(shape, TDT[dtype])
    assert plan.algo == rplan.algo
    assert _no_backend(plan.cost_card()) == _no_backend(rplan.cost_card())
    assert _no_backend(plan.to_dict()) == _no_backend(rplan.to_dict())


def test_defaults_are_not_tpu_constants():
    hc = HierarchicalCommunicator("local", "node", local_n=4, node_n=2,
                                  device="cpu")
    assert hc.local.link is sel.UNFITTED and hc.node.link is sel.UNFITTED


def _ref_hier_replay(plan, x, nn, ln):
    f = jax.jit(shard_map(lambda xs: plan(xs[0, 0])[None, None],
                          mesh=_mesh(nn, ln),
                          in_specs=P("node", "local", None, None),
                          out_specs=P("node", "local", None, None),
                          check_vma=False))
    return np.asarray(f(x.reshape((nn, ln) + x.shape[1:]))).reshape(x.shape)


@pytest.mark.parametrize("rows", [8, 13])     # 13: the pad path
def test_reference_exported_plan_replays_bit_equal(rows):
    """A plan exported by the reference loads through the port's
    plan_from_json and replays bit-equal in f32 (random values, so the
    fold order shows)."""
    rhc = ref_comm.HierarchicalCommunicator("local", "node", local_n=L,
                                            node_n=NN, backend="xla")
    rplan = rhc.compile((rows, 32), jnp.float32)
    plan = plan_from_json(rplan.to_json(), device="cpu")
    assert isinstance(plan, HierarchicalPlan)
    assert plan.algo == rplan.algo and plan.pad == rplan.pad == (-rows) % L
    assert sorted(plan.phases) == ["ag", "ar", "rs"]
    assert (plan.rs_plan.groups, plan.ar_plan.groups, plan.ar_plan.stride) \
        == (NN, L, L)
    x = np.random.RandomState(rows).randn(NN * L, rows, 32).astype(
        np.float32)
    want = _ref_hier_replay(rplan, x, NN, L)
    np.testing.assert_array_equal(plan(torch.from_numpy(x)).numpy(), want)


def test_hierarchical_all_reduce_matches_reference():
    """The function form (no plan object), bit-equal in f32."""
    rows, cols = 16, 32
    rl = ref_comm.Communicator("local", n=L, backend="xla")
    rn = ref_comm.Communicator("node", n=NN, backend="xla")
    f = jax.jit(shard_map(
        lambda xs: ref_comm.hierarchical_all_reduce(
            xs[0, 0], local=rl, node=rn)[None, None],
        mesh=_mesh(NN, L), in_specs=P("node", "local", None, None),
        out_specs=P("node", "local", None, None), check_vma=False))
    x = np.random.RandomState(3).randn(NN * L, rows, cols).astype(np.float32)
    want = np.asarray(f(x.reshape(NN, L, rows, cols))).reshape(x.shape)
    got = hierarchical_all_reduce(
        torch.from_numpy(x), local=Communicator("local", n=L, device="cpu"),
        node=Communicator("node", n=NN, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def _int_payload(ranks, rows, cols, seed=7):
    """Integer-valued f32: sums are exact, so the fold order cannot blur
    the bit-for-bit comparison."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -8, 8, (ranks, rows, cols)).astype(np.float32))


@pytest.mark.parametrize("nn,ln", [(2, 4), (4, 4)])
@pytest.mark.parametrize("rows", [8, 13])
def test_hierarchical_matches_flat(nn, ln, rows):
    """Hierarchical == flat over nn*L ranks == the sum, bit for bit (the
    reference's test_hierarchical_matches_flat_single_axis)."""
    cols = 32
    plan = HierarchicalCommunicator("local", "node", local_n=ln, node_n=nn,
                                    device="cpu").compile((rows, cols),
                                                          torch.float32)
    x = _int_payload(nn * ln, rows, cols)
    got = plan(x)
    assert torch.equal(got, ref.hierarchical_all_reduce_ref(x))
    assert plan.pad == (-rows) % ln
    flat = Communicator("x", n=nn * ln, device="cpu").compile(
        "all_reduce", (rows, cols), torch.float32)
    assert torch.equal(got, flat(x))


def test_single_axis_fallback_is_flat_plan():
    """node_axis=None and node_n=1 degrade to one flat plan on the local
    communicator, which round-trips through JSON."""
    plan = HierarchicalCommunicator("local", local_n=L,
                                    device="cpu").compile((8, 16),
                                                          torch.float32)
    assert list(plan.phases) == ["flat"] and plan.pad == 0
    one = HierarchicalCommunicator("local", "node", local_n=L, node_n=1,
                                   device="cpu")
    assert list(one.compile((8, 16), torch.float32).phases) == ["flat"]
    loaded = plan_from_json(plan.to_json(), device="cpu")
    assert list(loaded.phases) == ["flat"]
    x = _int_payload(L, 8, 16, seed=3)
    assert torch.equal(loaded(x), ref.all_reduce_ref(x))
    with pytest.raises(ValueError, match="needs its size"):
        HierarchicalCommunicator("local", "node", local_n=L, device="cpu")


def test_compile_once_cache_and_shape_guard():
    hc = HierarchicalCommunicator("local", "node", local_n=L, node_n=NN,
                                  device="cpu")
    p1 = hc.compile((8, 16), torch.float32)
    p2 = hc.compile((8, 16), "float32")
    assert p1 is p2
    assert hc.stats == {"compiles": 1, "hits": 1}
    assert hc.local.stats["compiles"] == 2 and hc.node.stats["compiles"] == 1
    with pytest.raises(ValueError, match="compiled for shape"):
        p1(torch.zeros(NN * L, 4, 16))
    with pytest.raises(ValueError, match="compiled for shape"):
        p1(torch.zeros(L, 8, 16))
    assert hc.all_reduce(_int_payload(NN * L, 8, 16)).shape == (NN * L, 8, 16)
    assert hc.stats["hits"] == 2


def test_plan_set_with_a_hierarchical_entry(tmp_path):
    hc = HierarchicalCommunicator("local", "node", local_n=L, node_n=NN,
                                  device="cpu")
    flat = Communicator("x", n=NN * L, device="cpu")
    plans = {"grad": hc.compile((13, 16), torch.bfloat16),
             "flat": flat.compile("all_reduce", (8, 16), torch.float32)}
    export_plan_set(plans, tmp_path)
    back = load_plan_set(tmp_path, device="cpu")
    assert isinstance(back["grad"], HierarchicalPlan)
    assert isinstance(back["flat"], ExecutionPlan)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        NN * L, 13, 16).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(back["grad"](x), plans["grad"](x))
    with pytest.raises(TypeError, match="no to_json"):
        export_plan_set({"bad": object()}, tmp_path / "bad")


# ---------------------------------------------------------------------------
# the Communicator's collectives and the group view
# ---------------------------------------------------------------------------
def test_communicator_collectives_match_reference():
    """all_reduce / all_gather / reduce_scatter / broadcast on rank-stacked
    tensors, bit-equal in f32 to the reference's inside shard_map."""
    n, rows, cols = 4, 8, 32
    rc = ref_comm.Communicator("x", n=n, backend="xla")
    c = Communicator("x", n=n, device="cpu")
    r = np.random.RandomState(5)
    xs = [r.randn(n, rows * k, cols).astype(np.float32) for k in (1, 1, n, 1)]

    def run(a, b, d, e):
        return (rc.all_reduce(a[0])[None], rc.all_gather(b[0])[None],
                rc.reduce_scatter(d[0])[None], rc.broadcast(e[0], 2)[None])

    spec = P("x", None, None)
    f = jax.jit(shard_map(run, mesh=Mesh(np.asarray(jax.devices()[:n]), ("x",)),
                          in_specs=(spec,) * 4, out_specs=(spec,) * 4,
                          check_vma=False))
    want = [np.asarray(o) for o in f(*xs)]
    t = [torch.from_numpy(a) for a in xs]
    got = [c.all_reduce(t[0]), c.all_gather(t[1]), c.reduce_scatter(t[2]),
           c.broadcast(t[3], 2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(
        ref.broadcast_ref(t[3], 2).numpy(),
        np.asarray(jax_ref.broadcast_ref(jnp.asarray(xs[3]), 2)))
    assert c.stats["compiles"] == 4


@pytest.mark.parametrize("groups,n,stride", [(2, 4, 1), (4, 2, 4), (4, 4, 4),
                                             (4, 2, 2)])
def test_group_view_runs_each_group_alone(groups, n, stride):
    """A plan over groups of a (groups*n, ...) tensor equals the plan on
    each group's ranks gathered by group_ranks."""
    c = Communicator("x", n=n, device="cpu")
    x = torch.from_numpy(np.random.RandomState(groups).randn(
        groups * n, 8, 16).astype(np.float32))
    got = c.compile("all_reduce", (8, 16), torch.float32, groups=groups,
                    stride=stride)(x)
    plan = c.compile("all_reduce", (8, 16), torch.float32)
    for members in group_ranks(groups, n, stride):
        assert torch.equal(got[members], plan(x[members]))
    assert torch.equal(TorchExecutor(plan.program).prepare(n)(
        x, groups=groups, stride=stride), got)


def test_rank_grid():
    g = RankGrid(2, 4)
    assert g.size == 8 and g.rank(1, 2) == 6
    assert g.local_groups() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert g.node_groups() == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert RankGrid(4, 4).node_groups()[1] == [1, 5, 9, 13]
    assert (g.local_view, g.node_view) == ((2, 1), (4, 4))
    with pytest.raises(ValueError, match="multiple of the stride"):
        group_ranks(3, 2, 2)
    with pytest.raises(ValueError, match="group count"):
        Communicator("x", n=2, device="cpu").compile(
            "all_reduce", (2, 2), torch.float32, groups=3, stride=2)
