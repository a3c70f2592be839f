"""Port executors against the reference: ``TorchExecutor`` bit-equal in
f32 to the JAX ``XlaExecutor`` under ``shard_map`` over every registry
entry × opt level × n, and the CUDA kernel's instruction table checked
without a GPU by a small interpreter of ``encode()`` that runs the rank
blocks in random interleavings."""
import functools
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.compat import shard_map
from repro.core import algorithms as ref_algos
from repro.core import passes as ref_passes
from repro.core.executor import PallasExecutor, XlaExecutor
from repro_torch.core import algorithms, passes
from repro_torch.core.executor import (OPCODES, CudaExecutor, TorchExecutor,
                                       encode, execute)
from repro_torch.kernels import ref

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

NAMES = sorted(algorithms.REGISTRY)
GRID = [(name, n, lvl) for name in NAMES for n in (2, 4, 8)
        for lvl in range(4)]
ROWS, COLS = 2, 8


def _input(name, n, lvl, prog):
    n_in = prog.chunks[prog.in_buffer]
    seed = NAMES.index(name) * 100 + n * 10 + lvl
    return np.random.RandomState(seed).randn(
        n, n_in * ROWS, COLS).astype(np.float32)


def _port_program(name, n, lvl):
    return passes.optimize(algorithms.REGISTRY[name](n), lvl, n)


@functools.lru_cache(maxsize=None)
def _jax_outputs(n, lvl):
    """Every registry program at (n, lvl) through the reference
    XlaExecutor in ONE jitted shard_map (one compile per grid column)."""
    progs = [ref_passes.optimize(ref_algos.REGISTRY[nm](n), lvl, n)
             for nm in NAMES]
    xs = [_input(nm, n, lvl, p) for nm, p in zip(NAMES, progs)]
    execs = [XlaExecutor(p, "x", vectorize=lvl > 0).prepare(n) for p in progs]

    def run(*shards):
        return tuple(ex(s[0])[None] for ex, s in zip(execs, shards))

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    spec = (P("x", None, None),) * len(progs)
    f = jax.jit(shard_map(run, mesh=mesh, in_specs=spec, out_specs=spec,
                          check_vma=False))
    return dict(zip(NAMES, (np.asarray(o) for o in f(*xs))))


@pytest.mark.parametrize("name,n,lvl", GRID)
def test_torch_executor_bit_equal_to_jax(name, n, lvl):
    """f32, exact: same puts, same left-fold order."""
    prog = _port_program(name, n, lvl)
    x = torch.from_numpy(_input(name, n, lvl, prog))
    got = TorchExecutor(prog, vectorize=lvl > 0).prepare(n)(x)
    want = _jax_outputs(n, lvl)[name]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the kernel's encoding, checked by interpretation
# ---------------------------------------------------------------------------
def _interpret(enc, prog, x, rng):
    """Run the encoded table the way the kernel does: each rank block
    walks its row in order, puts store into the peer's slot and set its
    flag, waits block until the flag is set, barriers rendezvous — with
    the next op taken from a random runnable rank. Output and scratch
    start as NaN (uninitialized device memory), so a slot the table
    forgets to write or zero shows up."""
    n = enc.n
    n_in = prog.chunks[prog.in_buffer]
    rows = x.shape[1] // n_in
    cols = x.shape[2]
    bufs = [x.clone().reshape(n, n_in, rows, cols)]
    for name in enc.buffers[1:]:
        bufs.append(torch.full((n, prog.chunks[name], rows, cols),
                               float("nan"), dtype=x.dtype))
    flags = np.zeros((n, max(enc.n_flags, 1)), bool)
    arrived = np.zeros((max(enc.n_barriers, 1), n), bool)
    pc = [0] * n
    n_ops = enc.ops.shape[1]
    while True:
        runnable = []
        for r in range(n):
            if pc[r] >= n_ops:
                continue
            f = enc.ops[r, pc[r]]
            if f[0] == OPCODES["wait"] and not flags[r, f[7]]:
                continue
            if f[0] == OPCODES["barrier"] and arrived[f[7], r] \
                    and not arrived[f[7]].all():
                continue
            runnable.append(r)
        if not runnable:
            assert all(p == n_ops for p in pc), f"deadlock at {pc}"
            break
        r = rng.choice(runnable)
        f = enc.ops[r, pc[r]]
        op = f[0]
        if op == OPCODES["put"]:
            sb, s0, db, d0, peer, k, fl = f[1:8]
            bufs[db][peer, d0:d0 + k] = bufs[sb][r, s0:s0 + k]
            flags[peer, fl] = True
        elif op == OPCODES["copy"]:
            sb, s0, db, d0, k = f[1], f[2], f[3], f[4], f[6]
            bufs[db][r, d0:d0 + k] = bufs[sb][r, s0:s0 + k]
        elif op == OPCODES["reduce"]:
            start, cnt, db, d0 = f[1], f[2], f[3], f[4]
            vals = [bufs[b][r, c] for b, c in enc.operands[r, start:start + cnt]]
            acc = vals[0]
            for v in vals[1:]:
                acc = acc + v
            bufs[db][r, d0] = acc
        elif op == OPCODES["zero"]:
            bufs[f[3]][r, f[4]:f[4] + f[6]] = 0
        elif op == OPCODES["barrier"] and not arrived[f[7], r]:
            arrived[f[7], r] = True
            continue          # arrive now, leave once everyone has arrived
        pc[r] += 1
    return bufs[1].reshape(n, -1, cols)


@pytest.mark.parametrize("name,n,lvl", GRID)
def test_encoded_table_matches_torch_executor(name, n, lvl):
    """The table the kernel walks gives TorchExecutor's result, bit for
    bit in f32 and bf16, under several random rank interleavings; its
    put count equals the reference Pallas kernel's descriptor count."""
    prog = _port_program(name, n, lvl)
    enc = encode(prog, n)
    ref_prog = ref_passes.optimize(ref_algos.REGISTRY[name](n), lvl, n)
    assert enc.puts_per_rank() == PallasExecutor(ref_prog, "x") \
        .descriptor_count(n)
    x32 = torch.from_numpy(_input(name, n, lvl, prog))
    for x in (x32, x32.to(torch.bfloat16)):
        want = TorchExecutor(prog).prepare(n)(x)
        for seed in range(3):
            got = _interpret(enc, prog, x, random.Random(seed))
            assert torch.equal(got, want), (x.dtype, seed)


def test_encode_resolves_one_phase_allreduce():
    """1PA at n=4, O2: three puts to ranks +1..+3 with distinct flags,
    one wait per incoming put, one 4-operand left fold input-first."""
    n = 4
    enc = encode(passes.optimize(algorithms.allreduce_1pa(n), 2, n), n)
    ops = enc.ops[1]
    puts = ops[ops[:, 0] == OPCODES["put"]]
    assert sorted(puts[:, 5].tolist()) == [0, 2, 3]          # peers of rank 1
    assert len(set(puts[:, 7].tolist())) == 3                # own flag each
    assert (ops[:, 0] == OPCODES["wait"]).sum() == 3
    red = ops[ops[:, 0] == OPCODES["reduce"]][0]
    operands = enc.operands[1, red[1]:red[1] + red[2]].tolist()
    assert operands[0] == [0, 0]                              # input first
    assert [c for _, c in operands[1:]] == [2, 3, 0]          # scratch +1..+3
    assert enc.n_barriers == 0 and not enc.writes_input


# ---------------------------------------------------------------------------
# oracles and the device contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4, 8])
def test_torch_executor_matches_oracles(n):
    rs = np.random.RandomState(n)
    x = torch.from_numpy(rs.randn(n, n * 3, 5).astype(np.float32))
    chunks = x.reshape(n, n, 3, 5)
    got = execute(algorithms.allpairs_rs(n), x, opt_level=2)
    torch.testing.assert_close(got.reshape(n, 3, 5),
                               ref.reduce_scatter_ref(chunks),
                               rtol=1e-6, atol=1e-6)   # sum order differs
    got = execute(algorithms.alltoall(n), x, opt_level=2)
    assert torch.equal(got.reshape(n, n, 3, 5), ref.all_to_all_ref(chunks))
    y = x[:, :3]
    got = execute(algorithms.ring_ag(n), y, opt_level=2)
    assert torch.equal(got.reshape(n, n, 3, 5), ref.all_gather_ref(y))
    got = execute(algorithms.allreduce_1pa(n), y, opt_level=2)
    torch.testing.assert_close(got, ref.all_reduce_ref(y),
                               rtol=1e-6, atol=1e-6)


def test_cuda_executor_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper raises on a CPU tensor, and its
    device state cannot be bound to the CPU."""
    n = 4
    ex = CudaExecutor(algorithms.allreduce_1pa(n)).prepare(n)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ex(torch.zeros(n, 2, 8))
    with pytest.raises(ValueError, match="CUDA devices only"):
        ex.bind(2, 8, torch.float32, "cpu")
    assert CudaExecutor.launches == 0
