"""The rest of the port's channel layer (``repro_torch.core.channels``:
``Channel``, ``PortChannel``, ``FusedReduceChannel``/``SwitchChannel``)
against the reference's, and the host side of their check kernels
(``repro_torch.kernels.channels``).

* the surface: the reference's six channel names, ``SwitchChannel`` the
  paper's name for ``FusedReduceChannel``;
* the plain ``PortChannel`` put equals ``MemoryChannel``'s, and a
  missing signal makes ``wait`` raise (the card would spin);
* ``broadcast`` then ``reduce`` bit-equal, in f32 and bf16 at n = 2, 4
  and 8, to the reference's own ``FusedReduceChannel`` run in a small
  ``pl.pallas_call`` in interpret mode over ``jax.devices()[:n]`` (as
  ``tests/test_torch_kernels_collectives.py`` runs the reference
  kernels), and to a numpy fold in the reference's order;
* ``kernels/channels.py``: the plain result on a CPU tensor, and its
  launches' host side with a stand-in library — arguments, grid,
  workspace, counts, and a refused launch raising uncounted.

The CUDA kernels themselves are held against the plain models on the
card by ``chip_smoke.py`` phase 19."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

from repro import compat
from repro.compat import shard_map
from repro.core import channels as ref_channels
from repro.core import primitives as prim
from repro.kernels import comm_utils as ref_comm_utils
from repro_torch.core import channels
from repro_torch.core.channels import (Channel, FusedReduceChannel,
                                       MemoryChannel, PortChannel,
                                       SwitchChannel)
from repro_torch.kernels import build, comm_utils
from repro_torch.kernels import channels as kch

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

ROWS, COLS = 8, 128
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _x(n, dtype_name, seed=0, shape=(ROWS, COLS)):
    return np.random.RandomState(seed * 10 + n).randn(n, *shape).astype(
        np.float32)


def _torch(x, dtype_name):
    return torch.from_numpy(x).to(DTYPES[dtype_name][1])


def test_surface_is_the_references():
    names = ("Protocol", "Channel", "MemoryChannel", "PortChannel",
             "FusedReduceChannel", "SwitchChannel")
    assert set(names) == set(ref_channels.__all__)
    assert set(channels.__all__) == set(names) | {"pack_ll", "unpack_ll"}
    assert SwitchChannel is FusedReduceChannel
    assert issubclass(MemoryChannel, Channel)
    assert issubclass(PortChannel, Channel)
    for m in ("put", "put_with_signal", "signal", "wait", "flush"):
        assert callable(getattr(PortChannel, m))
        assert callable(getattr(ref_channels.PortChannel, m))
    for m in ("broadcast", "recv", "reduce"):
        assert callable(getattr(FusedReduceChannel, m))
        assert callable(getattr(ref_channels.FusedReduceChannel, m))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,shift", [(2, 1), (4, 1), (4, 3), (8, 5)])
def test_port_put_equals_memory_channel_put(n, shift, dtype_name):
    if dtype_name == "int32":
        x = torch.from_numpy(np.random.RandomState(n).randint(
            -100, 100, (n, ROWS, COLS)).astype(np.int32))
    else:
        x = _torch(_x(n, dtype_name), dtype_name)
    me = torch.arange(n)
    peer = (me + shift) % n
    got = torch.zeros((n, 2, ROWS, COLS), dtype=x.dtype)
    want = torch.zeros_like(got)
    slot = me % 2
    PortChannel(peer).put(x, got, slot)
    MemoryChannel(peer).put(x, want, slot)
    assert torch.equal(got, want)
    PortChannel(peer).put_with_signal(x, got, slot)
    assert torch.equal(got, want)
    # the check kernel's plain version: out[(r + 1) % n] = x[r]
    assert torch.equal(kch.port_put_plain(x), torch.roll(x, 1, 0))


def test_signal_then_wait_and_a_missing_signal_raises():
    n = 4
    me = torch.arange(n)
    chan = PortChannel((me + 1) % n)
    flags = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="signal is missing"):
        chan.wait(flags, 1)
    chan.flush()
    chan.signal(flags, 1)
    chan.wait(flags, 1)
    with pytest.raises(RuntimeError, match="epoch 2"):
        chan.wait(flags, 2)                   # a stale flag
    # one rank's signal missing: only its receiver's wait fails
    flags[2] = 0
    with pytest.raises(RuntimeError, match="1 channel flag"):
        chan.wait(flags, 1)


def test_fused_recv_and_reduce_wait_for_every_sender():
    n = 4
    chan = FusedReduceChannel(n)
    x = torch.randn(n, 3, 5)
    slots = torch.zeros((n, n, 3, 5))
    flags = torch.zeros((n, n), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="slot flag"):
        chan.reduce(x, slots, flags, 1)
    chan.broadcast(x, slots, flags, 1)
    chan.recv(flags, 1, (torch.arange(n) + 1) % n)
    assert torch.equal(slots[torch.arange(n), torch.arange(n)],
                       torch.zeros(n, 3, 5))  # no rank writes its own slot
    flags[1, 3] = 0                           # rank 3's push to rank 1 lost
    with pytest.raises(RuntimeError, match="slot flag"):
        chan.reduce(x, slots, flags, 1)


# -- the reference's FusedReduceChannel in interpret mode --------------------
def _ref_kernel(x_ref, out_ref, slots, send_sem, recv_sem, bar_sem, *,
                axis):
    prim.start_barrier(axis)
    chan = ref_channels.FusedReduceChannel(axis, send_sem, recv_sem)
    chan.broadcast(x_ref, slots)
    chan.reduce(out_ref, x_ref, slots)
    prim.device_barrier(bar_sem, axis)


def _ref_fused(x, n):
    rows, cols = x.shape
    return pl.pallas_call(
        functools.partial(_ref_kernel, axis="x"),
        out_shape=jax.ShapeDtypeStruct((rows, cols), x.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((n, rows, cols), x.dtype),
                        pltpu.SemaphoreType.DMA, pltpu.SemaphoreType.DMA,
                        pltpu.SemaphoreType.REGULAR],
        interpret=ref_comm_utils.interpret_mode(),
        compiler_params=compat.CompilerParams(collective_id=7))(x)


@functools.lru_cache(maxsize=None)
def _ref_fn(n):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    return jax.jit(shard_map(lambda xs: _ref_fused(xs[0], n)[None],
                             mesh=mesh, in_specs=P("x", None, None),
                             out_specs=P("x", None, None), check_vma=False))


def _numpy_fold(x):
    """The reference's order (``channels.py:198-205``): ``local`` then
    ``fori_loop(1, n)`` over ``(me + i) % n``, rounded after every add."""
    n = x.shape[0]
    out = []
    for me in range(n):
        acc = x[me]
        for i in range(1, n):
            acc = (acc + x[(me + i) % n]).astype(x.dtype)
        out.append(acc)
    return np.stack(out)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_reduce_bit_equal_to_reference(n, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    x = _x(n, dtype_name, seed=1)
    want = np.asarray(_ref_fn(n)(jnp.asarray(x, jdt)).astype(jnp.float32))
    chan = FusedReduceChannel(n)
    xt = _torch(x, dtype_name)
    slots = torch.zeros((n, n, ROWS, COLS), dtype=tdt)
    chan.broadcast(xt, slots)
    got = chan.reduce(xt, slots)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    # and the numpy fold in the same order, in the element type
    fold = _numpy_fold(np.asarray(jnp.asarray(x, jdt)))
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(fold).astype(jnp.float32)), want)
    # the check kernel's plain version is this model
    assert torch.equal(kch.fused_reduce_plain(xt), got)


# -- kernels/channels.py -------------------------------------------------------
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int32"])
def test_wrappers_on_cpu_tensors_run_the_plain_models(dtype_name):
    n = 4
    x = (torch.from_numpy(np.random.RandomState(0).randint(
        -9, 9, (n, 3, 129)).astype(np.int32)) if dtype_name == "int32"
        else _torch(_x(n, dtype_name, shape=(3, 129)), dtype_name))
    assert torch.equal(kch.port_put(x), torch.roll(x, 1, 0))
    assert torch.equal(kch.port_put(x, tma=False), torch.roll(x, 1, 0))
    assert torch.equal(kch.fused_reduce(x), kch.fused_reduce_plain(x))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kch.fused_reduce(x, backend="cuda")
    with pytest.raises(ValueError, match="2D"):
        kch.port_put(x[0])


@pytest.mark.parametrize("count,esize", [(1, 4), (257, 4), (255, 2),
                                         (1024, 2), (1 << 22, 4)])
def test_slot_stride_holds_a_misaligned_payload(count, esize):
    """A slot is a multiple of 16 bytes and holds the payload at any
    offset modulo 16 (the sender's misalignment)."""
    s = kch.slot_stride(count, esize)
    assert s % 16 == 0
    assert s >= count * esize + 15


class _FakeLibrary:
    """The C interface of ``csrc/channels.cu`` without a card: records
    each call and answers with the code it is given."""

    def __init__(self, rc=0):
        self.rc, self.puts, self.reduces = rc, [], []

    def port_put_launch(self, *args):
        self.puts.append(args)
        return self.rc

    def fused_reduce_launch(self, *args):
        self.reduces.append(args)
        return self.rc

    @staticmethod
    def channels_error_string(rc):
        return f"error {rc}".encode()


class _Stream:
    cuda_stream = 0


@pytest.fixture
def fake(monkeypatch):
    """The channels' CUDA route on CPU tensors: a stand-in library and
    stream; the epoch must never be drawn on the host."""
    def refuse(*a, **k):
        raise AssertionError("a channel kernel drew a host epoch")

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "channels_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(comm_utils.Workspace, "next_epoch", refuse)
    monkeypatch.setattr(comm_utils, "LAUNCHES", comm_utils.LAUNCHES.copy())
    monkeypatch.setattr(comm_utils, "_WORKSPACES", {})
    comm_utils.LAUNCHES.clear()
    return lib


@pytest.mark.parametrize("dtype_name,n,rows,cols", [
    ("bfloat16", 4, 8, 2048), ("float32", 2, 3, 129), ("int32", 8, 1, 1),
    ("float16", 8, 512, 2048)])
@pytest.mark.parametrize("tma", [True, False])
def test_port_put_launch_host_side(fake, dtype_name, n, rows, cols, tma):
    x = torch.zeros(n, rows, cols, dtype=getattr(torch, dtype_name))
    for _ in range(2):
        out = kch._launch_put(x, tma)
        assert out.shape == x.shape and out.dtype == x.dtype
    count = rows * cols
    blocks = comm_utils.blocks_per_rank(count * x.element_size(), n)
    name = "port_put" if tma else "port_put_sm"
    ws = comm_utils.workspace(name, x)
    slots, flags, epochs = ws.tensors
    stride = kch.slot_stride(count, x.element_size())
    assert ws.blocks == blocks and n * blocks <= comm_utils.MAX_BLOCKS
    assert slots.numel() == n * stride and flags.numel() == n * blocks
    assert epochs.numel() == n * blocks and not epochs.any()
    assert len(fake.puts) == 2
    for a in fake.puts:
        assert a[0] == x.data_ptr() and a[2] == slots.data_ptr()
        assert a[4] == flags.data_ptr() and a[5] == epochs.data_ptr()
        assert a[3:4] + a[6:] == (stride, comm_utils.DTYPE_CODES[x.dtype],
                                  n, count, blocks, int(tma),
                                  comm_utils.THREADS, 0)
    assert comm_utils.LAUNCHES[name] == 2 and not fake.reduces


@pytest.mark.parametrize("n,rows,cols", [(2, 8, 128), (8, 5, 1021),
                                         (4, 4096, 2048)])
def test_fused_reduce_launch_host_side(fake, n, rows, cols):
    x = torch.zeros(n, rows, cols, dtype=torch.bfloat16)
    kch._launch_reduce(x)
    count = rows * cols
    ws = comm_utils.workspace("fused_reduce", x)
    slots, flags, epochs = ws.tensors
    stride = kch.slot_stride(count, 2)
    assert slots.numel() == n * n * stride
    assert flags.numel() == n * n * ws.blocks
    assert epochs.numel() == n * ws.blocks
    (a,) = fake.reduces
    assert a[3] == stride and a[6:] == (1, n, count, ws.blocks,
                                        comm_utils.THREADS, 0)
    assert comm_utils.LAUNCHES["fused_reduce"] == 1


def test_refused_launch_raises_and_is_not_counted(fake):
    fake.rc = 2
    x = torch.zeros(4, 8, 128, dtype=torch.float32)
    with pytest.raises(build.KernelLaunchError, match="error 2"):
        kch._launch_put(x, True)
    with pytest.raises(build.KernelLaunchError, match="error 2"):
        kch._launch_reduce(x)
    assert not comm_utils.LAUNCHES


def test_kernel_input_is_checked(fake):
    with pytest.raises(ValueError, match="take"):
        kch._launch_reduce(torch.zeros(4, 2, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="1 to 8 ranks"):
        kch._launch_put(torch.zeros(9, 2, 2), True)
    assert not fake.puts and not fake.reduces
