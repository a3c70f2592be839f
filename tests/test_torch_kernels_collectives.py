"""The port's collective library (``repro_torch.kernels.ops``) against the
reference Pallas kernels: each plain version, on the same seeded inputs,
bit-equal to its JAX kernel run as ``tests/test_kernels_collectives.py``
runs it (``shard_map`` over ``jax.devices()[:n]``, interpret mode), in
f32, bf16 and int32. Also the LL packet layout, the channel model, the
dispatch rules of ``ops`` and the kernels' host-side bookkeeping; the
CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` phases 8 and 9."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.compat import shard_map
from repro.kernels.allgather_ring import all_gather_ring as jax_ag_ring
from repro.kernels.allreduce_1pa import all_reduce_1pa as jax_ar_1pa
from repro.kernels.alltoall import all_to_all_pallas as jax_a2a
from repro.kernels.reducescatter_2pa import all_gather_2pa as jax_ag_2pa
from repro.kernels.reducescatter_2pa import all_reduce_2pa as jax_ar_2pa
from repro.kernels.reducescatter_2pa import \
    reduce_scatter_2pa as jax_rs_2pa
from repro_torch.core.channels import (MemoryChannel, Protocol, pack_ll,
                                       unpack_ll)
from repro_torch.kernels import build, comm_utils, ops, ref

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

ROWS, COLS = 8, 128
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}

# name -> (port call on (n, rows, cols), reference call on one shard,
# whether the per-rank input holds one chunk per rank)
KERNELS = {
    "all_reduce_1pa_ll": (
        lambda x: ops.all_reduce(x, algo="1pa"),
        lambda xs, n: jax_ar_1pa(xs, axis="x", axis_size=n, use_ll=True),
        False),
    "all_reduce_1pa_hb": (
        lambda x: ops.all_reduce(x, algo="1pa", use_ll=False),
        lambda xs, n: jax_ar_1pa(xs, axis="x", axis_size=n, use_ll=False),
        False),
    "reduce_scatter_2pa": (
        ops.reduce_scatter,
        lambda xs, n: jax_rs_2pa(xs, axis="x", axis_size=n), True),
    "all_gather_2pa": (
        lambda x: ops.all_gather(x, algo="allpairs"),
        lambda xs, n: jax_ag_2pa(xs, axis="x", axis_size=n), False),
    "all_gather_ring": (
        ops.all_gather,
        lambda xs, n: jax_ag_ring(xs, axis="x", axis_size=n), False),
    "all_reduce_2pa": (
        ops.all_reduce,
        lambda xs, n: jax_ar_2pa(xs, axis="x", axis_size=n), True),
}
NAMES = sorted(KERNELS)
CASES = [(name, n, dt) for n in (2, 4) for dt in DTYPES for name in NAMES] \
    + [(name, 8, "bfloat16") for name in NAMES]


def _input(name, n, dtype_name):
    per_chunk = KERNELS[name][2]
    shape = (n, ROWS * (n if per_chunk else 1), COLS)
    r = np.random.RandomState(NAMES.index(name) * 100 + n * 10
                              + list(DTYPES).index(dtype_name))
    if dtype_name == "int32":
        return r.randint(-100, 100, size=shape).astype(np.int32)
    return r.randn(*shape).astype(np.float32)


def _torch(x, dtype_name):
    return torch.from_numpy(x).to(DTYPES[dtype_name][1])


def _numpy(y):
    return (y.float() if y.dtype == torch.bfloat16 else y).numpy()


def _run_jax(fns, xs, n, dtype_name):
    """``fns[i]`` on shard ``i`` of every rank, all in ONE jitted
    shard_map (interpret mode) -> numpy outputs (bf16 as f32)."""
    jdt = DTYPES[dtype_name][0]

    def run(*shards):
        return tuple(f(s[0].astype(jdt), n)[None] for f, s in zip(fns, shards))

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    spec = (P("x", None, None),) * len(fns)
    f = jax.jit(shard_map(run, mesh=mesh, in_specs=spec, out_specs=spec,
                          check_vma=False))
    return [np.asarray(o.astype(jnp.float32) if o.dtype == jnp.bfloat16
                       else o) for o in f(*xs)]


@functools.lru_cache(maxsize=None)
def _jax_outputs(n, dtype_name):
    """Every reference kernel at (n, dtype) in one compile and run."""
    outs = _run_jax([KERNELS[k][1] for k in NAMES],
                    [_input(k, n, dtype_name) for k in NAMES], n, dtype_name)
    return dict(zip(NAMES, outs))


@pytest.mark.parametrize("name,n,dtype_name", CASES)
def test_plain_bit_equal_to_jax_kernel(name, n, dtype_name):
    """Exact (tolerance 0) in every dtype: the same puts and the same
    rotated fold, rounded after each add."""
    got = KERNELS[name][0](_torch(_input(name, n, dtype_name), dtype_name))
    want = _jax_outputs(n, dtype_name)[name]
    assert got.device.type == "cpu"
    assert got.shape == want.shape
    np.testing.assert_array_equal(_numpy(got), want)


A2A_SHAPES = ((8, 128), (16, 256))     # tests/test_kernels_hierarchical.py


@functools.lru_cache(maxsize=None)
def _a2a_inputs(n, dtype_name):
    r = np.random.RandomState(1000 + n * 10 + list(DTYPES).index(dtype_name))
    out = []
    for rows, cols in A2A_SHAPES:
        shape = (n, n * rows, cols)
        out.append(r.randint(-100, 100, size=shape).astype(np.int32)
                   if dtype_name == "int32"
                   else r.randn(*shape).astype(np.float32))
    return out


@functools.lru_cache(maxsize=None)
def _jax_a2a_outputs(n, dtype_name):
    """The reference all_to_all_pallas (interpret mode) on both shapes."""
    return _run_jax([lambda xs, n: jax_a2a(xs, axis="x", axis_size=n)] * 2,
                    _a2a_inputs(n, dtype_name), n, dtype_name)


@pytest.mark.parametrize("shape_i", range(len(A2A_SHAPES)))
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_all_to_all_plain_bit_equal_to_jax_kernel(n, dtype_name, shape_i):
    """A pure copy: exact in every dtype, block ``c`` of rank ``d`` landing
    as block ``d`` of rank ``c``."""
    x = _torch(_a2a_inputs(n, dtype_name)[shape_i], dtype_name)
    got = ops.all_to_all(x)
    want = _jax_a2a_outputs(n, dtype_name)[shape_i]
    assert got.device.type == "cpu" and got.dtype == x.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(_numpy(got), want)


def test_chained_steps_bit_equal_to_jax_kernel():
    """test_all_reduce_1pa_distinct_steps of the reference, exact: a
    second call on the first one's output with the next step."""
    n, dtype_name = 4, "bfloat16"
    x = _input("all_reduce_1pa_ll", n, dtype_name)

    def chained(xs, n):
        y = jax_ar_1pa(xs, axis="x", axis_size=n, use_ll=True, step=0)
        return jax_ar_1pa(y, axis="x", axis_size=n, use_ll=True, step=1)

    (want,) = _run_jax([chained], [x], n, dtype_name)
    y = ops.all_reduce(_torch(x, dtype_name), algo="1pa", step=0)
    got = ops.all_reduce(y, algo="1pa", step=1)
    np.testing.assert_array_equal(_numpy(got), want)


def test_rotated_fold_is_not_sum_order():
    """The finding behind the rotated fold: in bf16 at n=8 ranks disagree
    in the last bit, and ``torch.sum``'s order (``kernels/ref.py``) agrees
    with the kernels only within bf16 rounding."""
    x = _torch(_input("all_reduce_1pa_ll", 8, "bfloat16"), "bfloat16")
    got = ops.all_reduce(x, algo="1pa").float()
    oracle = ref.all_reduce_ref(x).float()
    assert not torch.equal(got, oracle)
    assert not torch.equal(got[0], got[1])
    torch.testing.assert_close(got, oracle, atol=0.1, rtol=0.02)


# ---------------------------------------------------------------------------
# LL packets and the channel model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,count", [
    (torch.float32, 384), (torch.int32, 7), (torch.bfloat16, 384),
    (torch.bfloat16, 387), (torch.float16, 129)])
def test_pack_ll_round_trip(dtype, count):
    r = np.random.RandomState(count)
    x = torch.from_numpy(r.randn(count).astype(np.float32) * 50).to(dtype)
    pk = pack_ll(x, 77)
    words = -(-count * x.element_size() // 4)
    assert pk.dtype == torch.int32 and pk.shape == (words, 2)
    assert bool((pk[:, 1] == 77).all())
    if x.element_size() == 2:      # element 2w in the low half of word w
        lo = (pk[:, 0] & 0xFFFF).to(torch.int32)
        assert torch.equal(lo, x[0::2].view(torch.int16).to(torch.int32)
                           & 0xFFFF)
        if count % 2:              # the odd tail's high half is zero
            assert int((pk[-1, 0] >> 16) & 0xFFFF) == 0
    back = unpack_ll(pk, 77, dtype=dtype, shape=(count,))
    assert back.dtype == dtype and torch.equal(back, x)


def test_unpack_ll_refuses_a_stale_epoch():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    pk = pack_ll(x, 5)
    with pytest.raises(RuntimeError, match="stale"):
        unpack_ll(pk, 6, dtype=torch.float32, shape=(2, 3))
    pk[3, 1] = 4                   # one packet of an earlier launch
    with pytest.raises(RuntimeError, match="1 LL packet"):
        unpack_ll(pk, 5, dtype=torch.float32, shape=(2, 3))
    with pytest.raises(ValueError, match="2- or 4-byte"):
        pack_ll(x.double(), 5)


def test_memory_channel_model():
    n = 4
    me = torch.arange(n)
    peer = (me + 1) % n
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 1, 3)
    slots = torch.zeros(n, n, 1, 3)
    MemoryChannel(peer).put(x, slots, me)
    for r in range(n):             # rank r's buffer lands in peer's slot r
        assert torch.equal(slots[(r + 1) % n, r], x[r])
    with pytest.raises(ValueError, match="LL-protocol"):
        MemoryChannel(peer).put_ll(x, slots, me, 1)
    pk = torch.zeros(n, n, 3, 2, dtype=torch.int32)
    chan = MemoryChannel(peer, Protocol.LL)
    chan.put_ll(x, pk, me, 9)
    prev = (me - 1) % n
    got = chan.read_ll(pk, prev, 9, dtype=torch.float32, shape=(1, 3))
    assert torch.equal(got, x[prev])
    with pytest.raises(RuntimeError, match="stale"):
        chan.read_ll(pk, me, 9, dtype=torch.float32, shape=(1, 3))


def test_ring_neighbors():
    prev, nxt = comm_utils.ring_neighbors(4)
    assert prev.tolist() == [3, 0, 1, 2] and nxt.tolist() == [1, 2, 3, 0]


# ---------------------------------------------------------------------------
# ops dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("call,exc,match", [
    (lambda x: ops.all_gather(x, algo="tree"), ValueError,
     "unknown all_gather algo 'tree'"),
    (lambda x: ops.all_reduce(x, algo="ring"), ValueError,
     "unknown all_reduce algo 'ring'"),
    (lambda x: ops.all_reduce(x, algo="2ph"), NotImplementedError,
     "item 10"),
    (lambda x: ops.all_to_all(x[:, :3]), ValueError,
     "do not split into 4 blocks"),
    (lambda x: ops.fused_allgather_matmul(x, x), NotImplementedError,
     "item 9"),
    (lambda x: ops.flash_attention(x, x, x), NotImplementedError, "item 8"),
    (lambda x: ops.all_reduce(x, backend="triton"), ValueError,
     "unknown backend"),
    (lambda x: ops.all_gather(x[0]), ValueError, "2D"),
    (lambda x: ops.reduce_scatter(x[:, :3]), ValueError,
     "do not split into 4 chunks"),
], ids=["ag-algo", "ar-algo", "2ph", "all_to_all", "ag_matmul", "flash",
        "backend", "not-stacked", "rs-rows"])
def test_ops_error_routes(call, exc, match):
    with pytest.raises(exc, match=match):
        call(torch.zeros(4, 8, 16))


def test_cpu_tensor_never_reaches_a_cuda_library(monkeypatch):
    """A CPU tensor runs the plain version without building or loading a
    kernel, and asking a CPU tensor for the kernel raises."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA library was built or loaded")

    monkeypatch.setattr(build, "_load", refuse)
    monkeypatch.setattr(build, "nvcc", refuse)
    monkeypatch.setattr(comm_utils, "LAUNCHES", comm_utils.LAUNCHES.copy())
    comm_utils.LAUNCHES.clear()
    x = torch.randn(4, 8, 16)
    for name in NAMES:
        KERNELS[name][0](x)
    ops.all_to_all(x)
    assert not comm_utils.LAUNCHES
    for call in (lambda: ops.all_reduce(x, algo="1pa", backend="cuda"),
                 lambda: ops.all_reduce(x, algo="1pa", use_ll=False,
                                        backend="cuda"),
                 lambda: ops.all_reduce(x, backend="cuda"),
                 lambda: ops.reduce_scatter(x, backend="cuda"),
                 lambda: ops.all_gather(x, algo="allpairs", backend="cuda"),
                 lambda: ops.all_gather(x, backend="cuda"),
                 lambda: ops.all_to_all(x, backend="cuda")):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()


# ---------------------------------------------------------------------------
# the kernels' host-side bookkeeping
# ---------------------------------------------------------------------------
def test_blocks_per_rank_keeps_every_block_resident():
    for n in (1, 2, 4, 8):
        last = 0
        for nbytes in (2, 1024, 32 << 10, 1 << 20, 64 << 20):
            b = comm_utils.blocks_per_rank(nbytes, n)
            assert 1 <= b and n * b <= comm_utils.MAX_BLOCKS and b >= last
            last = b
    assert comm_utils.blocks_per_rank(32 << 10, 4) == 4
    assert comm_utils.blocks_per_rank(8192, 4, comm_utils.THREADS) == 16


def test_workspace_epoch_never_repeats_or_hits_zero():
    ws = comm_utils.Workspace(1, ())
    assert [ws.next_epoch() for _ in range(3)] == [1, 2, 3]
    ws.epoch = comm_utils.EPOCH_MAX - 1
    assert [ws.next_epoch() for _ in range(3)] == [comm_utils.EPOCH_MAX, 1, 2]


def test_kernel_input_checks():
    assert comm_utils.check_kernel_input(torch.zeros(8, 1, 1)) == 0
    assert comm_utils.check_kernel_input(
        torch.zeros(2, 1, 1, dtype=torch.int32)) == 3
    with pytest.raises(ValueError, match="take"):
        comm_utils.check_kernel_input(torch.zeros(2, 1, 1,
                                                  dtype=torch.float64))
    with pytest.raises(ValueError, match="1 to 8 ranks"):
        comm_utils.check_kernel_input(torch.zeros(9, 1, 1))
