"""The executor kernel's tiling, checked without a GPU.

``csrc/executor.cu`` runs ``nb`` blocks a rank; block ``b`` owns tile
``b`` of every chunk (``csrc/primitives.cuh:tile``, mirrored here by
:func:`tile_bounds`) and walks the rank's row of the ``encode()`` table on
that tile alone, with flags and barriers per tile. This holds the tiles
and the launch size (``core/executor.py:blocks_per_rank``), and shows the
decomposition is exact: an interpreter of the table that runs every
(rank, tile) pair as its own unit, in random interleavings, with per-tile
flags and per-tile barriers, is bit-equal to ``TorchExecutor`` for every
registry entry × n ∈ {2, 4, 8} × O0–O3 in f32 and bf16.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms, passes
from repro_torch.core.executor import (MAX_RANKS, OPCODES, TILE_BYTES,
                                       TorchExecutor, encode,
                                       blocks_per_rank)

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

NAMES = sorted(algorithms.REGISTRY)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRID = [(name, n, lvl, dt) for name in NAMES for n in (2, 4, 8)
        for lvl in range(4) for dt in DTYPES]
# a chunk of 3 x 7 = 21 elements: 6 16-byte units in f32, 3 in bf16, so
# NB = 4 cuts f32 into tiles of 8, 8, 5 and an empty one, bf16 into 8, 8, 5
# and an empty one (ragged tails, 21 not a multiple of 8 nb)
ROWS, COLS, NB = 3, 7, 4
CHUNKS = (1, 7, 8, 13, 21, 1000, 1003, 37111, 65536)


def tile_bounds(chunk_elems, esize, nb):
    """Element bounds ``[lo, hi)`` of the ``nb`` tiles of a chunk, as the
    kernel cuts them (``csrc/primitives.cuh:tile`` with ``align`` one
    16-byte vector): contiguous tiles whose bounds are multiples of 16
    bytes, the last one taking the tail; a tile may be empty when ``nb``
    exceeds the 16-byte units."""
    v = max(1, 16 // esize)
    units = -(-chunk_elems // v)
    per = -(-units // nb)
    return [(min(chunk_elems, b * per * v), min(chunk_elems, (b + 1) * per * v))
            for b in range(nb)]


@pytest.mark.parametrize("count", CHUNKS)
@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("nb", [1, 2, 3, 7, 64])
def test_tiles_cover_each_element_once(count, esize, nb):
    """Contiguous tiles in block order, each starting on a 16-byte
    boundary, the last ending at the chunk's end: every element once."""
    bounds = tile_bounds(count, esize, nb)
    assert len(bounds) == nb
    seen = np.zeros(count, int)
    prev = 0
    for lo, hi in bounds:
        assert lo == prev and lo <= hi
        assert (lo * esize) % 16 == 0 or lo == count
        seen[lo:hi] += 1
        prev = hi
    assert prev == count and (seen == 1).all()


@pytest.mark.parametrize("count", CHUNKS)
@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("ranks,cap", [(2, 1056), (4, 528), (8, 264),
                                       (16, 1056), (8, 8), (4, 5)])
def test_geometry_respects_residency(count, esize, ranks, cap):
    """Every block of the launch resident (ranks * nb <= cap), about one
    block per TILE_BYTES of a chunk, no empty tile."""
    nb = blocks_per_rank(count, esize, ranks, cap)
    assert 1 <= nb and ranks * nb <= cap
    assert nb <= max(1, -(-count * esize // TILE_BYTES))
    assert all(hi > lo for lo, hi in tile_bounds(count, esize, nb))
    if count * esize >= TILE_BYTES * 4 and cap // ranks >= 4:
        assert nb > 1


def test_geometry_refuses_what_cannot_be_resident():
    with pytest.raises(ValueError, match="1 to 16 ranks"):
        blocks_per_rank(1024, 4, MAX_RANKS + 1, 10 ** 6)
    with pytest.raises(RuntimeError, match="fewer than one per rank"):
        blocks_per_rank(1024, 4, 8, 7)
    nb = blocks_per_rank(1 << 30, 2, MAX_RANKS, 10 ** 6)
    assert 10 ** 6 // MAX_RANKS // 2 < nb <= 10 ** 6 // MAX_RANKS


def _interpret_tiles(enc, prog, x, nb, rng):
    """Run the encoded table as the kernel's blocks do: unit (r, b) walks
    rank r's row on tile b of every chunk; a put copies tile b and sets
    flag [peer][slot][b]; a wait blocks on [r][slot][b]; a barrier is a
    rendezvous of tile b's units of every rank. The next op comes from a
    random runnable unit. Output and scratch start as NaN, so an element
    the table forgets shows up."""
    n = enc.n
    n_in = prog.chunks[prog.in_buffer]
    rows, cols = x.shape[1] // n_in, x.shape[2]
    ce = rows * cols
    bounds = tile_bounds(ce, x.element_size(), nb)
    bufs = [x.clone().reshape(n, n_in, ce)]
    for name in enc.buffers[1:]:
        bufs.append(torch.full((n, prog.chunks[name], ce), float("nan"),
                               dtype=x.dtype))
    flags = np.zeros((n, max(enc.n_flags, 1), nb), bool)
    arrived = np.zeros((max(enc.n_barriers, 1), n, nb), bool)
    n_ops = enc.ops.shape[1]
    pc = {(r, b): 0 for r in range(n) for b in range(nb)}
    while True:
        runnable = []
        for (r, b), i in pc.items():
            if i >= n_ops:
                continue
            f = enc.ops[r, i]
            if f[0] == OPCODES["wait"] and not flags[r, f[7], b]:
                continue
            if f[0] == OPCODES["barrier"] and arrived[f[7], r, b] \
                    and not arrived[f[7], :, b].all():
                continue
            runnable.append((r, b))
        if not runnable:
            assert all(i == n_ops for i in pc.values()), f"deadlock {pc}"
            break
        r, b = rng.choice(runnable)
        lo, hi = bounds[b]
        f = enc.ops[r, pc[(r, b)]]
        op = f[0]
        if op == OPCODES["put"]:
            sb, s0, db, d0, peer, k, fl = f[1:8]
            bufs[db][peer, d0:d0 + k, lo:hi] = bufs[sb][r, s0:s0 + k, lo:hi]
            flags[peer, fl, b] = True
        elif op == OPCODES["copy"]:
            sb, s0, db, d0, k = f[1], f[2], f[3], f[4], f[6]
            bufs[db][r, d0:d0 + k, lo:hi] = bufs[sb][r, s0:s0 + k, lo:hi]
        elif op == OPCODES["reduce"]:
            start, cnt, db, d0 = f[1], f[2], f[3], f[4]
            vals = [bufs[ob][r, oc, lo:hi]
                    for ob, oc in enc.operands[r, start:start + cnt]]
            acc = vals[0]
            for v in vals[1:]:
                acc = acc + v
            bufs[db][r, d0, lo:hi] = acc
        elif op == OPCODES["zero"]:
            bufs[f[3]][r, f[4]:f[4] + f[6], lo:hi] = 0
        elif op == OPCODES["barrier"] and not arrived[f[7], r, b]:
            arrived[f[7], r, b] = True
            continue          # arrive now, leave once every rank's tile b has
        pc[(r, b)] += 1
    return bufs[1].reshape(n, -1, cols)


@pytest.mark.parametrize("name,n,lvl,dt", GRID)
def test_tiled_table_matches_torch_executor(name, n, lvl, dt):
    """Tile by tile, the table gives TorchExecutor's result bit for bit:
    the per-tile flags and barriers suffice, and no instruction moves an
    element to another tile."""
    prog = passes.optimize(algorithms.REGISTRY[name](n), lvl, n)
    enc = encode(prog, n)
    n_in = prog.chunks[prog.in_buffer]
    seed = NAMES.index(name) * 100 + n * 10 + lvl
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        n, n_in * ROWS, COLS).astype(np.float32)).to(DTYPES[dt])
    want = TorchExecutor(prog).prepare(n)(x)
    got = _interpret_tiles(enc, prog, x, NB, random.Random(seed))
    assert torch.equal(got, want)
