"""The port's training loss and its gradients against the reference's:
``transformer.loss_fn`` and every gradient leaf within f32 1e-5 of
``jax.value_and_grad`` of the reference's ``loss_fn``, on every reduced
arch (the reference's weights carried across with ``params_from_jax``);
the padded heads' ``wo`` gradient exactly 0;
``remat_policy="full"`` bit-equal to ``"none"``; the SSM scan under
autograd bit-equal to the in-place one. And the guards the trainer's
path needs: the flash-attention kernel refuses inputs that need a
gradient (its CUDA route on CPU tensors, with a stand-in library), and a
released executor binding allocates its scratch again at the next
launch (a stand-in library too)."""
import ctypes
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro_torch import configs, tree
from repro_torch.core import algorithms
from repro_torch.core.executor import CudaExecutor
from repro_torch.distributed import step as st
from repro_torch.interop import params_from_jax
from repro_torch.kernels import build, comm_utils
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

B, S = 2, 16
# f32 on both sides; the frameworks order their sums differently
RTOL = ATOL = 1e-5
# arch -> overrides on top of reduced(): gemma3's period of 6 cut to one
# windowed and one global layer (window 4 < S), so its compile stays short
OVERRIDES = {"gemma3-12b": dict(local_global_period=2, n_layers=2, window=4),
             "hymba-1.5b": dict(window=4)}
ARCHS = list(configs._MODULES)


def _cfgs(arch, **extra):
    over = dict(OVERRIDES.get(arch, {}), **extra)
    return (dataclasses.replace(
                ref_configs.reduced(ref_configs.get_config(arch)), **over),
            dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                **over))


def _batch(cfg):
    r = np.random.RandomState(0)
    if cfg.frontend != "none":
        toks = r.randn(B, S, cfg.d_model).astype(np.float32)
    else:
        toks = r.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    return dict(tokens=toks, labels=r.randint(0, cfg.vocab, (B, S))
                .astype(np.int32))


def _port_grads(params, cfg, batch, **kw):
    leaves = tree.leaves(params)
    xs = [x.detach().requires_grad_() for x in leaves]
    loss = tf.loss_fn(tree.unflatten(params, xs), cfg,
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      **kw)
    grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                materialize_grads=True)
    return loss, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    assert cfg.dtype == "float32"
    params = ref_tf.init_params(rcfg, jax.random.key(0))
    batch = _batch(rcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.loss_fn(p, rcfg, b)))(params, batch)
    port = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    got, pgrads = _port_grads(port, cfg, batch)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=RTOL)
    want = jax.tree.leaves(grads)
    assert len(want) == len(pgrads)
    for g, w in zip(pgrads, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_padded_heads_get_zero_wo_grad():
    """The port of ``test_head_padding.py``'s pad check: the padded heads'
    ``wo`` rows get an exactly zero gradient."""
    base = configs.reduced(configs.get_config("llama3.2-3b"))
    cfg = dataclasses.replace(base, pad_heads_to=2 * base.n_heads)
    params = tf.init_params(cfg, device="cpu")
    batch = dict(tokens=np.zeros((2, 8), np.int32),
                 labels=np.zeros((2, 8), np.int32))
    _, grads = _port_grads(params, cfg, batch)
    named = tree.unflatten(params, grads)
    for slot in named["layers"]:
        gwo = slot["attn"]["wo"]
        assert torch.all(gwo[:, base.n_heads:] == 0)
        assert torch.any(gwo[:, :base.n_heads] != 0)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_remat_full_bit_equal_none(arch):
    _, cfg = _cfgs(arch)
    params = tf.init_params(cfg, device="cpu")
    batch = _batch(cfg)
    l0, g0 = _port_grads(params, cfg, batch)
    l1, g1 = _port_grads(params, cfg, batch, remat_policy="full")
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat_policy"):
        tf.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int32),
                   remat_policy="dots")


def test_scan_under_autograd_equals_in_place():
    """Autograd records the scan out of place, with the same products and
    sums: its values are the in-place scan's bit for bit, and its
    gradient flows."""
    g = torch.Generator().manual_seed(0)
    dA = torch.rand((2, 13, 4, 3), generator=g)
    dBx = torch.randn((2, 13, 4, 3), generator=g)
    want = ssm.scan(dA.clone(), dBx.clone())
    a, b = dA.clone().requires_grad_(), dBx.clone().requires_grad_()
    got = ssm.scan(a, b)
    assert torch.equal(got, want)
    got.sum().backward()
    assert a.grad is not None and torch.isfinite(b.grad).all()
    assert torch.equal(a.detach(), dA) and torch.equal(b.detach(), dBx)


# ---------------------------------------------------------------------------
# the flash-attention kernel under autograd (its CUDA route, stand-in lib)
# ---------------------------------------------------------------------------
class _Stream:
    cuda_stream = 0


class _FlashLib:
    def __init__(self):
        self.launched = 0

    def flash_attention_launch(self, *args):
        self.launched += 1
        return 0

    def flash_attention_error_string(self, rc):
        return b""


def test_flash_kernel_refuses_grad_requiring_inputs(monkeypatch):
    """The kernel records no autograd node, so with grad mode on it raises
    for q, k or v that require a gradient instead of dropping their
    gradient; without grad mode, or on inputs that need none, it
    launches."""
    lib = _FlashLib()
    monkeypatch.setattr(build, "flash_attention_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(comm_utils, "LAUNCHES", comm_utils.LAUNCHES.copy())
    q = torch.randn(1, 2, 16, 32)
    for which in range(3):
        qkv = [q.clone() for _ in range(3)]
        qkv[which].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            fa._launch(*qkv, True, None)
    assert lib.launched == 0
    with torch.no_grad():
        fa._launch(q.clone().requires_grad_(), q, q, True, None)
    fa._launch(q, q, q, True, None)
    assert lib.launched == 2


def test_trainer_attention_is_the_plain_core(monkeypatch):
    """The loss names its core: it never reaches the kernel, whatever the
    device, and a forward that asks for the kernel under autograd
    raises."""
    def refuse(*a, **k):
        raise AssertionError("the trainer's loss reached the kernel")

    monkeypatch.setattr(fa, "_launch", refuse)
    _, cfg = _cfgs("qwen3-1.7b")
    params = tf.init_params(cfg, device="cpu")
    loss, _ = _port_grads(params, cfg, _batch(cfg))
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# executor bindings, released between leaves
# ---------------------------------------------------------------------------
class _ExecutorLib:
    """``csrc/executor.cu``'s C interface without a card: launches are
    recorded and bump the epoch words as the kernel does."""

    def __init__(self):
        self.launched = []

    def dsl_executor_max_blocks(self, dtype, threads):
        return 264

    def dsl_executor_launch(self, *args):
        self.launched.append(args)
        words = args[2] * args[3] * args[14]              # n * groups * nb
        arr = (ctypes.c_uint32 * words).from_address(args[12])
        for i in range(words):
            arr[i] += 1
        return 0


def test_executor_release_drops_only_the_scratch(monkeypatch):
    """A released binding gives its scratch back and keeps its flags,
    epoch words and table; the next launch allocates scratch anew and the
    epoch sequence goes on. A captured binding is never released."""
    lib = _ExecutorLib()
    monkeypatch.setattr(build, "executor_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(CudaExecutor, "launches", 0)
    n = 4
    kern = CudaExecutor(algorithms.REGISTRY["allreduce_2pa"](n)).prepare(n)
    x = torch.zeros(n, 8, 256)
    kern._launch(x)
    bound = kern._bound
    assert bound[5] and kern.release() == 1 and kern._bound[5] is None
    assert kern._bound[6] is bound[6] and kern.epochs is bound[11]
    assert kern.release() == 0
    kern._launch(x)
    assert [t.shape for t in kern._bound[5]] == [t.shape for t in bound[5]]
    assert kern.epochs is bound[11]
    assert kern.epochs.tolist() == [2] * kern.epochs.numel()
    assert len(lib.launched) == 2 and CudaExecutor.launches == 2
    kern._captured.add(next(iter(kern._bindings)))
    assert kern.release() == 0 and kern._bound[5] is not None


def test_train_step_refuses_fsdp_and_unknown_modes():
    """An unknown mode raises (``fsdp=True`` no longer does: its tests are
    in ``tests/test_torch_fsdp.py``)."""
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    with pytest.raises(ValueError, match="mode"):
        st.make_train_step(cfg, (), None, mode="pjit", global_batch=2,
                           seq_len=4, device="cpu")
