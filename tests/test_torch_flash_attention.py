"""The port's flash attention (``repro_torch.kernels.flash_attention`` and
``ops.flash_attention``) on CPU tensors, where it runs its plain version,
against the reference: the Pallas kernel run as
``tests/test_flash_attention.py`` runs it (interpret mode on the CPU) and
the naive oracles (the reference's and the port's ``flash_attention_ref``),
on the same numpy-seeded inputs. Then what the reference kernel does not
take: grouped KV heads read in place, and ragged sequence lengths. The
CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py`` phase 10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import build, comm_utils, ops, ref
from repro_torch.kernels import flash_attention as fa

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

# the reference test's tolerances: f32 agrees to rounding of the sums'
# order; bf16 rounds the output (and, in the reference kernel, its inputs)
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shapes, dtype, seed=0):
    """numpy arrays for ``shapes``, rounded to ``dtype`` (bf16 through
    jax), as (jax arrays, torch tensors)."""
    r = np.random.RandomState(seed)
    jdt, tdt = DTYPES[dtype]
    js = [jnp.asarray(r.randn(*shape), jdt) for shape in shapes]
    ts = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in js]
    return js, ts


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _check_against_reference(b, h, s, hd, dtype, causal, window,
                             seed=0, **blocks):
    (jq, jk, jv), (q, k, v) = _inputs([(b, h, s, hd)] * 3, dtype, seed)
    want_kernel = jax_flash(jq, jk, jv, causal=causal, window=window,
                            **blocks)
    want_oracle = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                              window=window)
    got = {"plain": fa.flash_attention_plain(q, k, v, causal=causal,
                                             window=window),
           "ops": ops.flash_attention(q, k, v, causal=causal, window=window,
                                      **blocks),
           "oracle": ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)}
    for name, out in got.items():
        assert out.dtype == q.dtype and out.shape == q.shape, name
        np.testing.assert_allclose(_np(out), _np(want_kernel),
                                   **TOL[dtype], err_msg=name)
        np.testing.assert_allclose(_np(out), _np(want_oracle),
                                   **TOL[dtype], err_msg=name)


@pytest.mark.parametrize("s,hd", [(256, 64), (512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference_kernel(s, hd, dtype, causal):
    _check_against_reference(1, 2, s, hd, dtype, causal, None,
                             block_q=128, block_kv=128)


@pytest.mark.parametrize("window", [128, 256])
def test_flash_sliding_window_matches_reference_kernel(window):
    _check_against_reference(1, 2, 512, 64, "float32", True, window)


def test_flash_block_sparsity_matches_reference_kernel():
    """A tiny window at s = 1024: most KV blocks are skipped by the block
    range on both sides."""
    _check_against_reference(2, 1, 1024, 64, "float32", True, 128, seed=3,
                             block_kv=128)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_kv_heads_match_the_broadcast_oracle(group, dtype):
    """Query head i reads KV head i // group: the same as the oracles on
    pre-broadcast K/V."""
    b, h, s, hd = 2, 8, 256, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, h, s, hd), (b, h // group, s, hd), (b, h // group, s, hd)],
        dtype, seed=group)
    want = jax_ref.flash_attention_ref(
        jq, jnp.repeat(jk, group, axis=1), jnp.repeat(jv, group, axis=1))
    oracle = ref.flash_attention_ref(q, k.repeat_interleave(group, 1),
                                     v.repeat_interleave(group, 1))
    got = fa.flash_attention(q, k, v)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(oracle), _np(want), **TOL[dtype])


@pytest.mark.parametrize("s", [12, 200])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_sequence_matches_oracle(s, causal, window, dtype):
    """Any s: the last block of the recurrence is short (the kernel masks
    the keys past s)."""
    b, h, hkv, hd = 2, 4, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)], dtype, seed=s)
    want = jax_ref.flash_attention_ref(
        jq, jnp.repeat(jk, 2, axis=1), jnp.repeat(jv, 2, axis=1),
        causal=causal, window=window)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 5, 64, 300])
@pytest.mark.parametrize("s,block_q,block_kv", [(200, 64, 32),
                                                (256, 128, 128),
                                                (77, 16, 64)])
def test_block_range_skips_only_fully_masked_blocks(s, block_q, block_kv,
                                                    causal, window):
    """Every KV block outside ``[lo, hi)`` is wholly masked for its q
    block (skipping it changes nothing), and the first block visited
    holds an unmasked pair."""
    pos = torch.arange(s)
    rel = pos[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    for q_start in range(0, s, block_q):
        lo, hi = fa.block_range(q_start, block_q, block_kv, s,
                                causal=causal, window=window)
        for kb in range(-(-s // block_kv)):
            tile = mask[q_start:q_start + block_q,
                        kb * block_kv:(kb + 1) * block_kv]
            if not lo <= kb < hi:
                assert not tile.any(), (q_start, kb, lo, hi)
        assert mask[q_start:q_start + block_q,
                    lo * block_kv:(lo + 1) * block_kv].any()


@pytest.mark.parametrize("causal,window", [
    (True, None), (False, None), (True, 1), (True, 64), (True, 300),
    (False, 5), (False, 64)])
@pytest.mark.parametrize("block_kv", sorted({fa.kv_tile(hd)
                                             for hd in fa.HEAD_DIMS}))
@pytest.mark.parametrize("s", [12, 128, 200, 333, 1024])
def test_tile_classes_match_the_dense_mask(s, block_kv, causal, window):
    """The bf16 kernel's tile classes (``tile_class``, mirrored from
    ``csrc/flash_attention.cu``) over its 128-row query blocks and each
    head dim's KV tile, against the dense mask: an interior tile is wholly
    kept (no key past s), a skipped tile wholly masked, and no visited
    tile wholly masked; causal without a window masks only the diagonal
    tiles of a full query block."""
    bq = fa.KERNEL_BLOCK_Q
    pos = torch.arange(s)
    rel = pos[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    for q_start in range(0, s, bq):
        masked = 0
        for kb in range(-(-s // block_kv)):
            k0 = kb * block_kv
            tile = mask[q_start:q_start + bq, k0:k0 + block_kv]
            cls = fa.tile_class(q_start, k0, s, block_q=bq,
                                block_kv=block_kv, causal=causal,
                                window=window)
            where = (q_start, k0, cls)
            if cls == "interior":
                assert tile.shape[1] == block_kv and bool(tile.all()), where
            elif cls == "skipped":
                assert not tile.any(), where
            else:
                assert cls == "masked" and tile.any(), where
                masked += 1
        if causal and window is None and q_start + bq <= s:
            assert masked == bq // block_kv, (q_start, masked)


def test_tile_geometry_mirrors_the_kernel():
    """The query block and the KV tiles that ``tile_class`` mirrors are
    the kernel's own (``WgCfg``)."""
    import re
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert int(re.search(r"constexpr int kBQ = (\d+);", src)[1]) \
        == fa.KERNEL_BLOCK_Q
    cut, wide, narrow = map(int, re.search(
        r"kBK = HD > (\d+) \? (\d+) : (\d+);", src).groups())
    for hd in fa.HEAD_DIMS:
        assert fa.kv_tile(hd) == (wide if hd > cut else narrow), hd


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    """A CPU tensor runs the plain version without building or loading
    the kernel, and asking a CPU tensor for the kernel raises."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA library was built or loaded")

    monkeypatch.setattr(build, "_load", refuse)
    monkeypatch.setattr(build, "nvcc", refuse)
    monkeypatch.setattr(comm_utils, "LAUNCHES", comm_utils.LAUNCHES.copy())
    comm_utils.LAUNCHES.clear()
    q = torch.randn(1, 2, 128, 32)
    fa.flash_attention(q, q, q)
    ops.flash_attention(q, q, q)
    assert not comm_utils.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(q, q, q, backend="cuda")


@pytest.mark.parametrize("args,match", [
    (((1, 2, 8, 16), (1, 2, 8)), "must be"),
    (((1, 2, 8, 16), (1, 2, 9, 16)), "do not match"),
    (((1, 3, 8, 16), (1, 2, 8, 16)), "do not group"),
], ids=["rank", "seq", "groups"])
def test_shape_checks(args, match):
    q, k = (torch.zeros(shape) for shape in args)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, k)


def test_dtype_and_window_checks():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="dtypes differ"):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="window must be"):
        fa.flash_attention(q, q, q, window=0)
