"""The port's AllGather-matmul (``repro_torch.kernels.collective_matmul``,
``ops.fused_allgather_matmul``) against the reference Pallas kernel run as
``tests/test_kernels_collective_matmul.py`` runs it (``shard_map``,
interpret mode), on the same numpy-seeded inputs; the plain version's
ring schedule, per-rank weights, two calls in a row, shape errors, and the
matmul oracles of ``kernels/ref.py``. The CUDA kernel is held against the
plain version on the card by ``chip_smoke.py`` phase 11.

Tolerances, each for its reason:
* f32 in, f32 out: rtol 1e-5 — the same products summed in another
  order by XLA-CPU's dot and torch's matmul; an entry that cancels to
  near 0 keeps the rounding of its K terms, so atol is 1e-5 times the
  outputs' scale, sqrt(K) (each sums K products of unit normals);
* bf16 in, f32 out: the same bound — both multiply the bf16 values
  exactly and accumulate in f32;
* bf16 out: atol = rtol = 1e-2 — the f32 results differ in their last
  bits, which can round to neighbouring bf16 values (one bf16 step is
  2^-8 relative); tighter than the reference test's atol 0.2, rtol 0.02.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.compat import shard_map
from repro.kernels import ref as jax_ref
from repro.kernels.collective_matmul import allgather_matmul as jax_agmm
from repro_torch.kernels import comm_utils, ops, ref
from repro_torch.kernels.collective_matmul import allgather_matmul_plain

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(out_dtype, k):
    if out_dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5 * k ** 0.5)
    return dict(rtol=1e-2, atol=1e-2)


# (n, rows, K, F, in dtype, out dtype, per-rank w): the reference test's
# shapes on mesh8 and mesh4, each in/out pair, one per-rank weight
CASES = (
    (8, 8, 128, 128, "float32", "float32", False),
    (8, 16, 256, 384, "bfloat16", "float32", False),
    (8, 8, 128, 128, "bfloat16", "bfloat16", False),
    (4, 16, 256, 384, "float32", "float32", False),
    (4, 8, 128, 128, "bfloat16", "bfloat16", False),
    (4, 8, 128, 128, "float32", "float32", True),
)
IDS = [f"n{c[0]}-r{c[1]}-k{c[2]}-f{c[3]}-{c[4]}-{c[5]}"
       + ("-per_rank" if c[6] else "") for c in CASES]


def _inputs(i):
    n, rows, k, f, _, _, per_rank = CASES[i]
    r = np.random.RandomState(i)
    x = r.randn(n, rows, k).astype(np.float32)
    w = r.randn(*((n,) if per_rank else ()), k, f).astype(np.float32)
    return x, w


def _np(y):
    return np.asarray(y.astype(jnp.float32) if y.dtype == jnp.bfloat16
                      else y)


@functools.lru_cache(maxsize=None)
def _ref_outputs(n):
    """Every reference case on ``n`` devices in ONE jitted shard_map
    (interpret mode), plus the reference's twice case on mesh8: numpy
    outputs, bf16 as f32."""
    idx = [i for i, c in enumerate(CASES) if c[0] == n]

    def run(*args):
        outs = []
        for j, i in enumerate(idx):
            _, _, _, _, dt, odt, per_rank = CASES[i]
            x, w = args[2 * j], args[2 * j + 1]
            w = w[0] if per_rank else w
            outs.append(jax_agmm(x[0].astype(JDT[dt]), w.astype(JDT[dt]),
                                 axis="x", axis_size=n,
                                 out_dtype=JDT[odt])[None])
        if n == 8:      # tests/test_kernels_collective_matmul.py's twice
            x, w = args[0][0], args[1]
            y1 = jax_agmm(x, w, axis="x", axis_size=n)
            outs.append(jax_agmm(y1[:x.shape[0]], w, axis="x",
                                 axis_size=n)[None])
        return tuple(outs)

    in_specs, xs = [], []
    for i in idx:
        x, w = _inputs(i)
        xs += [x, w]
        in_specs += [P("x", None, None),
                     P("x", None, None) if CASES[i][6] else P(None, None)]
    n_out = len(idx) + (n == 8)
    f = jax.jit(shard_map(run, mesh=Mesh(np.asarray(jax.devices()[:n]),
                                         ("x",)),
                          in_specs=tuple(in_specs),
                          out_specs=(P("x", None, None),) * n_out,
                          check_vma=False))
    outs = [_np(o) for o in f(*xs)]
    return dict(zip(idx + (["twice"] if n == 8 else []), outs))


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_plain_matches_jax_kernel(case):
    n, rows, k, f, dt, odt, per_rank = CASES[case]
    x, w = _inputs(case)
    got = ops.fused_allgather_matmul(torch.from_numpy(x).to(TDT[dt]),
                                     torch.from_numpy(w).to(TDT[dt]),
                                     out_dtype=TDT[odt])
    assert got.shape == (n, n * rows, f) and got.dtype == TDT[odt]
    np.testing.assert_allclose(got.float().numpy(), _ref_outputs(n)[case],
                               **_tol(odt, k))


def test_twice_matches_jax_kernel():
    """Two calls in a row, the second on every rank's first row block of
    the first (the reference's test_allgather_matmul_twice)."""
    n, rows = 8, CASES[0][1]
    x, w = (torch.from_numpy(a) for a in _inputs(0))
    y1 = ops.fused_allgather_matmul(x, w)
    y2 = ops.fused_allgather_matmul(y1[:, :rows].contiguous(), w)
    np.testing.assert_allclose(y2.numpy(), _ref_outputs(8)["twice"],
                               rtol=1e-4, atol=1e-4)
    full1 = ref.allgather_matmul_ref(x, w)[0]
    want = torch.cat([full1[:rows]] * n) @ w
    np.testing.assert_allclose(y2[0].numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("per_rank", [False, True])
def test_ring_schedule_equals_gathered_product(per_rank):
    """Every rank's rows in all-gather order, against one product of the
    gathered shards (bf16 in, exact f32 products)."""
    n, rows, k, f = 4, 3, 32, 24
    r = np.random.RandomState(1)
    x = torch.from_numpy(r.randn(n, rows, k).astype(np.float32)).bfloat16()
    w = torch.from_numpy(r.randn(*((n,) if per_rank else ()), k, f).astype(
        np.float32)).bfloat16()
    got = allgather_matmul_plain(x, w, out_dtype=torch.float32)
    full = x.float().reshape(n * rows, k)
    for rank in range(n):
        want = full @ (w[rank] if per_rank else w).float()
        torch.testing.assert_close(got[rank], want, rtol=1e-5, atol=1e-5)


def test_shape_errors():
    x = torch.zeros(4, 2, 16)
    with pytest.raises(ValueError, match="K = 16 does not match"):
        ops.fused_allgather_matmul(x, torch.zeros(8, 4))
    with pytest.raises(ValueError, match=r"\(n, K, F\) per rank"):
        ops.fused_allgather_matmul(x, torch.zeros(2, 16, 4))
    with pytest.raises(ValueError, match="share one of"):
        ops.fused_allgather_matmul(x, torch.zeros(16, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="stacked as"):
        ops.fused_allgather_matmul(x[0], torch.zeros(16, 4))
    with pytest.raises(ValueError, match="out_dtype"):
        ops.fused_allgather_matmul(x, torch.zeros(16, 4),
                                   out_dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.fused_allgather_matmul(x, torch.zeros(16, 4), backend="cuda")
    assert not comm_utils.LAUNCHES["allgather_matmul"]


def test_matmul_oracles_match_reference():
    r = np.random.RandomState(2)
    x = r.randn(4, 8, 16).astype(np.float32)
    w = r.randn(16, 12).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(
        ref.allgather_matmul_ref(tx, tw).numpy(),
        np.asarray(jax_ref.allgather_matmul_ref(jnp.asarray(x),
                                                jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ref.matmul_reducescatter_ref(tx, tw).numpy(),
        np.asarray(jax_ref.matmul_reducescatter_ref(jnp.asarray(x),
                                                    jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ref.hierarchical_all_reduce_ref(tx).numpy(),
        np.asarray(jax_ref.hierarchical_all_reduce_ref(jnp.asarray(x))))
