"""The decode step that the engine captures in a CUDA graph, held on the
CPU: a 0-d position tensor gives the int position's numbers bit for bit,
the step reads no tensor on the host, the executor kernel's wrapper
passes the card's epoch words and no host epoch (with a stand-in
library), a host-epoch kernel refuses a capture, and the engine's and
the capture's limits raise."""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core import algorithms
from repro_torch.core import executor as ex
from repro_torch.distributed import step as step_mod
from repro_torch.kernels import build, comm_utils
from repro_torch.mesh import RankAxis
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

BATCH, MAX_KV, STEPS, TP = 2, 32, 16, 2
ARCHS = ("qwen3-1.7b", "mixtral-8x22b", "gemma3-12b", "hymba-1.5b")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(arch, dtype="float32"):
    cfg = configs.reduced(configs.get_config(arch))
    if arch == "gemma3-12b":
        cfg = dataclasses.replace(cfg, window=4)    # the ring wraps
    return dataclasses.replace(cfg, dtype=dtype)


def _step(arch, mode, dtype, kv_quant=False):
    """(cfg, step, params, cache maker) of a reduced config on the
    CPU."""
    cfg = _cfg(arch, dtype)
    axis = RankAxis("model", TP, "cpu")
    step, layout = step_mod.make_serve_step(
        cfg, axis, batch=BATCH, max_kv=MAX_KV, mode=mode, kv_quant=kv_quant)
    params = layout.params(tf.init_params(cfg, device="cpu", seed=7))
    return cfg, step, params, layout.cache


def _tokens(cfg, steps):
    return torch.as_tensor(np.random.RandomState(7).randint(
        0, cfg.vocab, (steps, BATCH)), dtype=torch.long)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["auto", "explicit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_device_position_matches_int_position(arch, mode, dtype, kv_quant):
    """16 steps at one 0-d tensor position filled in place between steps,
    as the graph's position buffer is, against the same steps at an int
    position: logits and every cache leaf bit-equal at each step (on
    gemma3-reduced the windowed layers' ring of 4 wraps)."""
    cfg, step, params, make_cache = _step(arch, mode, dtype, kv_quant)
    toks = _tokens(cfg, STEPS)
    c_int, c_dev = make_cache(), make_cache()
    pos = torch.zeros((), dtype=torch.long)
    with torch.inference_mode():
        for t in range(STEPS):
            want, _ = step(params, c_int, toks[t], t)
            pos.fill_(t)
            got, _ = step(params, c_dev, toks[t], pos)
            assert torch.equal(got, want), (arch, mode, dtype, t)
    for name in c_int:
        for a, b in zip(c_int[name], c_dev[name]):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("arch,pos", [("qwen3-1.7b", MAX_KV),
                                      ("qwen3-1.7b", -1),
                                      ("gemma3-12b", MAX_KV)])
def test_int_position_is_range_checked_on_the_host(arch, pos):
    """An int position is checked before it becomes the step's device
    tensor: negative, or at a global layer's cache length, raises (the
    tensor path cannot check it)."""
    cfg, step, params, make_cache = _step(arch, "auto", "float32")
    with pytest.raises(ValueError, match=f"position {pos} outside"):
        step(params, make_cache(), _tokens(cfg, 1)[0], pos)


def test_int_position_is_checked_against_max_seq():
    """With a cache longer than the model, ``cfg.max_seq`` bounds an int
    position."""
    cfg = dataclasses.replace(_cfg("qwen3-1.7b"), max_seq=8)
    params = tf.init_params(cfg, device="cpu", seed=7)
    cache = tf.init_cache(cfg, BATCH, MAX_KV, device="cpu")
    toks = _tokens(cfg, 1)[0]
    tf.decode_step(params, cfg, cache, toks, 7)
    with pytest.raises(ValueError, match="outside \\[0, 8\\)"):
        tf.decode_step(params, cfg, cache, toks, 8)


def test_decode_attention_takes_an_int_or_a_tensor_position():
    """``decode_attention`` at an int position gives the 0-d tensor's
    numbers and cache, and checks the int against its own cache on a
    global layer."""
    from repro_torch.models import blocks
    cfg = _cfg("qwen3-1.7b")
    p = {k: w[0] for k, w in              # group 0 of layer slot 0
         tf.init_params(cfg, device="cpu", seed=7)["layers"][0]["attn"]
         .items()}
    x = torch.as_tensor(np.random.RandomState(3).randn(
        BATCH, 1, cfg.d_model), dtype=torch.float32)
    caches = [tf.init_cache(cfg, BATCH, 8, device="cpu") for _ in range(2)]
    outs = [blocks.decode_attention(p, x, c["k"][0][0], c["v"][0][0], pos,
                                    cfg, window=None)
            for c, pos in zip(caches, (5, torch.tensor(5)))]
    assert torch.equal(*outs)
    assert torch.equal(caches[0]["k"][0], caches[1]["k"][0])
    with pytest.raises(ValueError, match="position 8 outside"):
        blocks.decode_attention(p, x, caches[0]["k"][0][0],
                                caches[0]["v"][0][0], 8, cfg, window=None)


class _NoHostRead(TorchDispatchMode):
    """Fails on every op that reads a tensor on the host: ``.item()``,
    ``int()`` and ``bool()`` of a tensor (``_local_scalar_dense``) and
    ``nonzero`` (its output size)."""

    FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name.startswith(self.FORBIDDEN):
            raise AssertionError(f"host read inside the step: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("mode", ["auto", "explicit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_nothing_on_the_host(arch, mode, kv_quant):
    """One step at a 0-d position (after one outside the check, which
    builds the tables) dispatches no op that reads a tensor on the host:
    the model code, the plans' replays and the plain executor."""
    cfg, step, params, make_cache = _step(arch, mode, "bfloat16", kv_quant)
    toks = _tokens(cfg, 2)
    cache = make_cache()
    pos = torch.zeros((), dtype=torch.long)
    with torch.inference_mode():
        step(params, cache, toks[0], pos)
        pos.fill_(1)
        with _NoHostRead():
            logits, _ = step(params, cache, toks[1], pos)
    assert logits.shape == (BATCH, cfg.vocab)
    assert torch.isfinite(logits).all()


def test_the_check_sees_a_host_read():
    """The dispatch mode above fails on ``.item()`` and ``nonzero``."""
    x = torch.arange(4)
    for read in (lambda: x.sum().item(), lambda: int(x[1]),
                 lambda: x.nonzero()):
        with pytest.raises(AssertionError, match="host read"), _NoHostRead():
            read()


# ---------------------------------------------------------------------------
# the executor kernel's wrapper with a stand-in library: the epoch lives
# in device memory, one word per block
# ---------------------------------------------------------------------------
class _FakeExecutorLibrary:
    """The C interface of ``csrc/executor.cu`` without a card: each launch
    is recorded, and bumps the epoch words as the kernel does (on the CPU
    tensor behind the pointer)."""

    def __init__(self, max_blocks=264):
        self.max_blocks = max_blocks
        self.launched = []

    def dsl_executor_max_blocks(self, dtype, threads):
        return self.max_blocks

    def dsl_executor_launch(self, *args):
        self.launched.append(args)
        epochs_ptr, nb = args[12], args[14]
        words = args[2] * args[3] * nb                   # n * groups * nb
        arr = (ctypes.c_uint32 * words).from_address(epochs_ptr)
        for i in range(words):
            arr[i] = arr[i] % 0xFFFFFFFF + 1
        return 0

    @staticmethod
    def dsl_executor_error_string(rc):
        return f"error {rc}".encode()


class _Stream:
    cuda_stream = 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeExecutorLibrary()
    monkeypatch.setattr(build, "executor_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(ex.CudaExecutor, "launches", 0)
    return lib


def _executor(n=4):
    prog = algorithms.REGISTRY["allreduce_1pa"](n)
    return ex.CudaExecutor(prog).prepare(n)


@pytest.mark.parametrize("rows,cols", [(8, 2048), (3, 129)])
def test_executor_passes_epoch_words_and_no_host_epoch(fake, rows, cols):
    """Two calls at one shape pass the same epoch-word pointer (one word
    per block, n * blocks words) and the same arguments otherwise: the
    host draws no epoch. The kernel's bumps leave every word at 2."""
    kern = _executor()
    x = torch.zeros(4, rows, cols, dtype=torch.bfloat16)
    for _ in range(2):
        assert kern._launch(x).shape == x.shape
    a, b = fake.launched
    assert a[1:] == b[1:]                  # the buffer table aside
    words = kern.epochs
    assert a[12] == words.data_ptr()
    assert words.numel() == 4 * kern.blocks and words.dtype == torch.int32
    assert words.tolist() == [2] * words.numel()
    assert ex.CudaExecutor.launches == 2
    assert not hasattr(kern, "_epoch")


def test_executor_rebind_zeroes_the_epoch_words(fake):
    """A new shape re-binds the flags and starts new epoch words at 0;
    the kernel's first launch on them bumps them to 1."""
    kern = _executor()
    kern._launch(torch.zeros(4, 8, 2048, dtype=torch.float32))
    kern._launch(torch.zeros(4, 8, 2048, dtype=torch.float32))
    first = kern.epochs
    assert first.tolist() == [2] * first.numel()
    kern._bind(5, 64, torch.float32, torch.device("cpu"), 1)
    assert kern.epochs.tolist() == [0] * kern.epochs.numel()
    kern._launch(torch.zeros(4, 5, 64, dtype=torch.float32))
    assert kern.epochs.tolist() == [1] * kern.epochs.numel()
    assert fake.launched[-1][12] == kern.epochs.data_ptr()


def test_executor_keeps_a_captured_binding(fake, monkeypatch):
    """A call at another shape binds beside the shape a capture launched,
    never over it: the captured flags, epoch words and scratch stay
    alive and go on being launched; an explicit re-bind of the captured
    shape raises."""
    kern = _executor()
    x = torch.zeros(4, 8, 2048, dtype=torch.float32)
    kern._launch(x)                        # the warm-up binds
    first = kern._bound
    monkeypatch.setattr(ex, "_capturing", lambda: True)
    kern._launch(x)                        # launched into a capture
    monkeypatch.setattr(ex, "_capturing", lambda: False)
    kern._launch(torch.zeros(4, 5, 64, dtype=torch.float32))
    assert kern._bound is not first and len(kern._bindings) == 2
    kern._launch(x)
    assert kern._bound is first
    assert fake.launched[-1][12] == first[11].data_ptr()
    with pytest.raises(RuntimeError, match="captured"):
        kern._bind(8, 2048, torch.float32, torch.device("cpu"), 1)
    assert kern._bindings[(8, 2048, torch.float32, torch.device("cpu"),
                           1)] is first


def test_executor_epoch_words_wrap_past_zero(fake):
    """The kernel's bump skips 0, as the host counter did: the last
    word value 0xFFFFFFFF goes to 1."""
    kern = _executor()
    x = torch.zeros(4, 2, 64, dtype=torch.float32)
    kern._launch(x)
    kern.epochs.fill_(-1)                  # 0xFFFFFFFF as uint32
    kern._launch(x)
    assert kern.epochs.tolist() == [1] * kern.epochs.numel()


# ---------------------------------------------------------------------------
# host-epoch kernels refuse a capture
# ---------------------------------------------------------------------------
def test_host_epoch_refuses_a_capture(monkeypatch):
    """Inside a stream capture, a kernel that draws its epoch on the host
    raises, naming itself; outside one it draws as before."""
    x = torch.zeros(2, 1, 1)
    ws = comm_utils.workspace("all_gather_ring/test", x,
                              lambda: comm_utils.Workspace(1, ()))
    assert ws.next_epoch() == 1
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="all_gather_ring/test.*host"):
        ws.next_epoch()
    assert ws.epoch == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    assert ws.next_epoch() == 2


# ---------------------------------------------------------------------------
# the engine's and the capture's limits
# ---------------------------------------------------------------------------
def test_engine_refuses_a_position_past_a_global_cache():
    """The graph cannot bounds-check its position: the host raises
    ValueError at pos == max_kv on a model with a global layer, and
    keeps serving below it."""
    cfg = _cfg("qwen3-1.7b")
    eng = Engine(cfg, tf.init_params(cfg, device="cpu", seed=1),
                 ServeConfig(batch=BATCH, max_kv=4), device="cpu")
    prompts = np.zeros((BATCH, 4), np.int64)
    logits = eng.prefill(prompts)
    assert eng.pos == 4 and logits.shape == (BATCH, cfg.vocab)
    with pytest.raises(ValueError, match="max_kv=4"):
        eng.decode(logits, num_tokens=1)


def test_engine_windowed_only_model_wraps_past_max_kv():
    """A model whose every layer is windowed has no global cache: its
    ring wraps past ``max_kv`` and only ``max_seq`` bounds it."""
    cfg = dataclasses.replace(_cfg("qwen3-1.7b"), window=4)
    assert None not in tf.layer_windows(cfg)
    eng = Engine(cfg, tf.init_params(cfg, device="cpu", seed=1),
                 ServeConfig(batch=BATCH, max_kv=4), device="cpu")
    toks = eng.decode(eng.prefill(np.zeros((BATCH, 4), np.int64)), 4)
    assert toks.shape == (BATCH, 4) and eng.pos == 8
    eng.pos = cfg.max_seq
    with pytest.raises(ValueError, match="max_seq"):
        eng._run_step(torch.zeros(BATCH, dtype=torch.long))


def test_engine_on_the_cpu_runs_eagerly():
    """On the CPU there is no graph: the step runs op by op at the same
    0-d position tensor, which follows ``pos``."""
    cfg = _cfg("qwen3-1.7b")
    eng = Engine(cfg, tf.init_params(cfg, device="cpu", seed=1),
                 ServeConfig(batch=BATCH, max_kv=8, kv_quant=True),
                 device="cpu")
    assert eng.graph is None and "k_scale" in eng.cache
    eng.prefill(np.zeros((BATCH, 3), np.int64))
    assert eng._pos.dim() == 0 and int(eng._pos) == 2


def test_capture_refuses_a_cpu_device():
    _, step, params, make_cache = _step("qwen3-1.7b", "auto", "float32")
    with pytest.raises(ValueError, match="CUDA graphs"):
        step_mod.capture_serve_step(step, params, make_cache(),
                                    batch=BATCH, device="cpu")


def test_int8_cache_layout():
    """``init_cache(dtype=int8)`` adds bf16 per-token scales beside the
    int8 cache, replicated over the ranks on the explicit path."""
    cfg = _cfg("gemma3-12b")
    cache = tf.init_cache(cfg, BATCH, MAX_KV, device="cpu", dtype=torch.int8,
                          ranks=TP)
    assert set(cache) == {"k", "v", "k_scale", "v_scale"}
    for k, s in zip(cache["k"], cache["k_scale"]):
        assert k.dtype == torch.int8 and s.dtype == torch.bfloat16
        assert s.shape == k.shape[:-1] + (1,) and k.shape[0] == TP
    assert set(tf.init_cache(cfg, BATCH, MAX_KV, device="cpu")) == {"k", "v"}
