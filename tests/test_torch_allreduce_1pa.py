"""The cluster 1PA AllReduce's host side: its launch geometry (one
thread-block cluster of n blocks per tile, n slots in each block's shared
memory) over n = 1..8, every element type and counts from one element to
1 MiB a rank, and its CUDA route, driven with a stand-in library: it asks
for no workspace and no epoch, launches once per call with the geometry's
numbers, and raises where the card refuses the cluster or the launch. The
kernel itself is held against the plain version on the card by
``chip_smoke.py`` phase 8; the plain version against the reference Pallas
kernel by ``tests/test_torch_kernels_collectives.py``."""
import ctypes

import pytest
import torch

from repro_torch.kernels import allreduce_1pa as ap
from repro_torch.kernels import build, comm_utils

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}
MIB = 1 << 20


def _counts(esz):
    """One element to 1 MiB a rank: odd counts, the decode size, and counts
    just off the tile and shared-memory limits."""
    full = MIB // esz
    return sorted({1, 2, 3, 7, 129, 387, 1023, 1024 // esz, 2047,
                   16384, 8 * 2048 - 1, 5115, 65535, 128 * 2048,
                   full // 2 + 1, full - 1, full})


@pytest.mark.parametrize("use_ll", [True, False], ids=["ll", "hb"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("n", range(1, 9))
def test_geometry_tiles_every_element_once(n, dtype_name, use_ll):
    """Every tile but the last is a multiple of 16 bytes (what a bulk copy
    moves), the tiles cover each element of a rank exactly once, the grid
    is n x tiles in clusters of n, and the n slots fit one block's shared
    memory (227 KB)."""
    esz = torch.empty((), dtype=DTYPES[dtype_name]).element_size()
    for count in _counts(esz):
        geo = ap.geometry(n, count, esz, use_ll)
        assert geo.cluster == n and geo.grid == n * geo.tiles
        assert geo.tile_bytes % 16 == 0
        assert geo.tile_elems * esz == geo.tile_bytes
        assert geo.smem_bytes == ap.SLOT0 + n * geo.slot_bytes
        assert geo.smem_bytes <= ap.SMEM_MAX == 232448
        assert geo.slot_bytes % 16 == 0
        covered = 0
        for t in range(geo.tiles):
            lo = t * geo.tile_elems
            hi = min(count, lo + geo.tile_elems)   # the kernel's bounds
            assert lo == covered and hi > lo      # contiguous, none empty
            nbytes = (hi - lo) * esz
            if t < geo.tiles - 1:
                assert nbytes == geo.tile_bytes
            # the slot holds the tile: its bytes, or its 4-byte words as
            # 8-byte packets
            need = -(-nbytes // 4) * 8 if use_ll else nbytes
            assert need <= geo.slot_bytes
            covered = hi
        assert covered == count


@pytest.mark.parametrize("use_ll,rank_bytes,tiles", [
    (True, 1024, 1), (False, 1024, 1), (True, 32 << 10, 16),
    (False, 32 << 10, 16), (True, 512 << 10, 128), (False, 512 << 10, 64),
    (True, MIB, 128), (False, MIB, 64)],
    ids=["ll-1KiB", "hb-1KiB", "ll-decode", "hb-decode", "ll-512KiB",
         "hb-512KiB", "ll-1MiB", "hb-1MiB"])
def test_geometry_at_the_timed_sizes(use_ll, rank_bytes, tiles):
    """bf16 at n = 4, the sizes phase 8 times: the decode AllReduce of
    qwen3-1.7b at TP=4 (32 KiB a rank) in 2 KiB tiles, one packet word a
    thread; larger inputs in about TARGET_BLOCKS / n tiles."""
    geo = ap.geometry(4, rank_bytes // 2, 2, use_ll)
    assert geo.tiles == tiles
    assert geo.tile_bytes >= ap.MIN_TILE
    if rank_bytes == 32 << 10:
        assert geo.tile_bytes // 4 == comm_utils.THREADS


def test_geometry_fills_shared_memory_at_8_ranks():
    """1 MiB a rank at n = 8: the LL packets, twice the data, still fit
    one block's shared memory, in tiles of at least MIN_TILE."""
    for esz in (2, 4):
        for use_ll in (True, False):
            geo = ap.geometry(8, MIB // esz, esz, use_ll)
            assert geo.smem_bytes <= ap.SMEM_MAX
            assert geo.tile_bytes >= ap.MIN_TILE


class _FakeLibrary:
    """The C interface of ``csrc/allreduce_1pa.cu`` without a card: it
    records each call and answers with the codes it is given."""

    def __init__(self, clusters=16, prepare_rc=0, launch_rc=0):
        self.clusters, self.prepare_rc = clusters, prepare_rc
        self.launch_rc = launch_rc
        self.prepared, self.launched = [], []

    def allreduce_1pa_prepare(self, *args):
        self.prepared.append(args[:-1])
        args[-1]._obj.value = self.clusters
        return self.prepare_rc

    def allreduce_1pa_launch(self, *args):
        self.launched.append(args)
        return self.launch_rc

    @staticmethod
    def allreduce_1pa_error_string(rc):
        return f"error {rc}".encode()


class _Stream:
    cuda_stream = 0


@pytest.fixture
def fake(monkeypatch):
    """The 1PA's CUDA route on CPU tensors: a stand-in library and stream;
    asking for a workspace or an epoch fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the 1PA asked for a workspace or an epoch")

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "allreduce_1pa_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(comm_utils, "workspace", refuse)
    monkeypatch.setattr(comm_utils.Workspace, "next_epoch", refuse)
    monkeypatch.setattr(comm_utils, "LAUNCHES", comm_utils.LAUNCHES.copy())
    monkeypatch.setattr(ap, "_PREPARED", set())
    comm_utils.LAUNCHES.clear()
    return lib


@pytest.mark.parametrize("use_ll", [True, False], ids=["ll", "hb"])
@pytest.mark.parametrize("dtype_name,n,rows,cols", [
    ("bfloat16", 4, 8, 2048), ("float32", 3, 3, 129),
    ("float16", 8, 1, 1), ("int32", 1, 5, 1023)])
def test_cuda_route_takes_no_workspace_and_no_epoch(fake, use_ll, dtype_name,
                                                    n, rows, cols):
    """Two calls: one cluster query for the shape, then one launch a call,
    whose arguments are the buffers and the geometry and nothing else (no
    slots, no flags, no epoch), with PDL; each launch is counted."""
    x = torch.zeros(n, rows, cols, dtype=DTYPES[dtype_name])
    for _ in range(2):
        out = ap._launch(x, use_ll)
        assert out.shape == x.shape and out.dtype == x.dtype
    geo = ap.geometry(n, rows * cols, x.element_size(), use_ll)
    code = comm_utils.DTYPE_CODES[x.dtype]
    assert fake.prepared == [(code, int(use_ll), n, geo.smem_bytes,
                              comm_utils.THREADS)]
    assert len(fake.launched) == 2
    for args in fake.launched:
        assert args[2:] == (code, n, rows * cols, geo.tile_elems, geo.tiles,
                            geo.slot_bytes, geo.smem_bytes, int(use_ll),
                            comm_utils.THREADS, 0, 1)
    assert comm_utils.LAUNCHES[ap.KERNEL] == 2


def test_refused_cluster_shape_raises(fake):
    """A cluster shape the card cannot hold raises before any launch; so
    does an error of the query, with the runtime's message."""
    x = torch.zeros(8, 8, 2048, dtype=torch.bfloat16)
    fake.clusters = 0
    with pytest.raises(RuntimeError, match="not schedulable"):
        ap._launch(x, True)
    fake.clusters, fake.prepare_rc = 16, 98
    with pytest.raises(RuntimeError, match="error 98"):
        ap._launch(x, False)
    assert not fake.launched and not comm_utils.LAUNCHES


def test_refused_launch_raises_and_is_not_counted(fake):
    x = torch.zeros(4, 8, 2048, dtype=torch.bfloat16)
    fake.launch_rc = 1
    with pytest.raises(RuntimeError, match="error 1"):
        ap._launch(x, True)
    assert not comm_utils.LAUNCHES


def test_pdl_is_asked_for_unless_switched_off(fake):
    x = torch.zeros(2, 4, 128, dtype=torch.float32)
    ap._launch(x, True)
    ap._launch(x, True, pdl=False)
    assert [a[-1] for a in fake.launched] == [1, 0]


def test_empty_input_launches_nothing(fake):
    x = torch.zeros(4, 0, 128, dtype=torch.bfloat16)
    assert ap._launch(x, True).shape == x.shape
    assert not fake.launched and not fake.prepared


def test_prepare_passes_a_pointer_for_the_cluster_count(fake):
    """The query's last argument is a pointer the library writes the
    cluster count through (``ctypes.byref``), as its argtypes say."""
    x = torch.zeros(4, 8, 2048, dtype=torch.bfloat16)
    seen = []
    real = fake.allreduce_1pa_prepare

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    fake.allreduce_1pa_prepare = spy
    ap._launch(x, True)
    assert len(seen) == 1 and isinstance(seen[0]._obj, ctypes.c_int)
