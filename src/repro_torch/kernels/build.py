"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``
(pointers and the stream travel as ``c_void_p``). Libraries go to
``build/`` at the repository root (``REPRO_TORCH_BUILD_DIR`` overrides
it), named by a hash of the sources, so an edited kernel is rebuilt and
an unchanged one is loaded as is. Nothing here runs at import time.

    python -c "from repro_torch.kernels import build; build.build_all()"
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Optional

__all__ = ["CSRC", "KernelBuildError", "KernelLaunchError", "build_dir",
           "nvcc", "build_all", "executor_library",
           "allreduce_1pa_library", "allpairs_2pa_library",
           "allgather_ring_library", "alltoall_library",
           "flash_attention_library", "allreduce_2ph_library",
           "collective_matmul_library", "channels_library", "spans_library",
           "last_build"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_REPO = pathlib.Path(__file__).resolve().parents[3]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: what the most recent build did: {source: {"seconds", "log", "path"}}
last_build: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_BOUND: Dict[str, ctypes.CDLL] = {}      # libraries whose argtypes are set


class KernelBuildError(RuntimeError):
    """A kernel library could not be built (no ``nvcc``, or ``nvcc``
    refused a source). Never transient: the serving guardrails re-raise
    it rather than retry it or fall back from the kernel."""


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's wrapper could not launch it: the runtime
    refused the launch (its ``cudaError_t`` is in the message), or the
    wrapper refused its input or its state. Never transient: the serving
    guardrails re-raise it rather than retry it or fall back from the
    kernel."""


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                                       _REPO / "build"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME); the CUDA "
                               "kernels build only on a machine with the "
                               "CUDA toolkit")
    return found


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cu*")):      # sources and shared headers
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(sources: Optional[List[str]] = None) -> Dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` (or the named stems) that has no
    up-to-date library, one ``nvcc`` per source, all started together.
    Raises :class:`KernelBuildError` with the compiler's output when one
    fails."""
    srcs = sorted(CSRC.glob("*.cu"))
    if sources is not None:
        srcs = [s for s in srcs if s.stem in sources]
    out: Dict[str, pathlib.Path] = {}
    procs = []
    build_dir().mkdir(parents=True, exist_ok=True)
    for src in srcs:
        target = _target(src)
        out[src.stem] = target
        if target.exists():
            last_build.setdefault(src.stem, dict(seconds=0.0, log="cached",
                                                 path=str(target)))
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, target, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    for src, target, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, target)
        last_build[src.stem] = dict(seconds=time.perf_counter() - t0,
                                    log=log, path=str(target))
    return out


def _load(stem: str) -> ctypes.CDLL:
    lib = _LIBS.get(stem)
    if lib is None:
        lib = _LIBS[stem] = ctypes.CDLL(str(build_all([stem])[stem]))
    return lib


def executor_library() -> ctypes.CDLL:
    """The DSL-executor kernel library, built at first use."""
    lib = _LIBS.get("executor")
    if lib is not None:
        return lib
    lib = _load("executor")
    c = ctypes
    lib.dsl_executor_launch.restype = c.c_int
    lib.dsl_executor_launch.argtypes = [
        c.c_void_p,            # host table of per-rank buffer pointers
        c.c_int,               # dtype code
        c.c_int,               # n ranks a group
        c.c_int, c.c_int,      # groups, rank stride of a group
        c.c_void_p, c.c_int,   # instruction table (device), ops per rank
        c.c_void_p, c.c_int,   # operand table (device), operands per rank
        c.c_void_p, c.c_int,   # flags (device), put flag slots per rank
        c.c_int,               # flag words a group
        c.c_void_p,            # epoch words (device), one a block
        c.c_longlong,          # elements per chunk
        c.c_int,               # blocks per rank
        c.c_int,               # threads per block
        c.c_void_p,            # stream
    ]
    # the traced launch: the same arguments and the stamps (device)
    lib.dsl_executor_launch_traced.restype = c.c_int
    lib.dsl_executor_launch_traced.argtypes = (
        lib.dsl_executor_launch.argtypes[:-1] + [c.c_void_p, c.c_void_p])
    for fn in (lib.dsl_executor_max_blocks, lib.dsl_executor_max_blocks_traced):
        fn.restype = c.c_int
        fn.argtypes = [c.c_int, c.c_int]
    lib.dsl_executor_timer_probe.restype = c.c_int
    lib.dsl_executor_timer_probe.argtypes = [c.c_longlong, c.c_void_p,
                                             c.c_void_p]
    lib.dsl_executor_error_string.restype = c.c_char_p
    lib.dsl_executor_error_string.argtypes = [c.c_int]
    lib.dsl_executor_graph_nodes.restype = c.c_int
    lib.dsl_executor_graph_nodes.argtypes = [
        c.c_void_p, c.POINTER(c.c_int), c.POINTER(c.c_int),
        c.POINTER(c.c_int)]
    return lib


_P, _I, _LL, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)


def _collective_library(stem: str, launchers: Dict[str, list]) -> ctypes.CDLL:
    """A kernel library with a plain C interface, built at first use:
    each launcher returns a cudaError_t, ``<stem>_error_string`` names
    it."""
    lib = _BOUND.get(stem)
    if lib is not None:
        return lib
    lib = _load(stem)
    for name, argtypes in launchers.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    err = getattr(lib, f"{stem}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    _BOUND[stem] = lib
    return lib


def allreduce_1pa_library() -> ctypes.CDLL:
    """``csrc/allreduce_1pa.cu``: ``allreduce_1pa_launch(x, out, dtype, n,
    count, tile_elems, tiles, slot_bytes, smem, use_ll, threads, stream,
    pdl)`` (one cluster of n blocks a tile), ``allreduce_1pa_prepare(dtype,
    use_ll, n, smem, threads, &clusters)`` (the shape's
    ``cudaOccupancyMaxActiveClusters``) and ``allreduce_1pa_empty_launch(n,
    tiles, smem, threads, stream)`` (an empty kernel of the same launch
    geometry)."""
    return _collective_library("allreduce_1pa", {
        "allreduce_1pa_launch": [_P, _P, _I, _I, _LL, _LL, _I, _I, _I, _I,
                                 _I, _P, _I],
        "allreduce_1pa_prepare": [_I, _I, _I, _I, _I,
                                  ctypes.POINTER(ctypes.c_int)],
        "allreduce_1pa_empty_launch": [_I, _I, _I, _I, _P]})


def allpairs_2pa_library() -> ctypes.CDLL:
    """``csrc/allpairs_2pa.cu``: ``reduce_scatter_2pa_launch(x, out,
    slots, flags, dtype, n, count, blocks, use_ll, epoch, threads,
    stream)`` and ``all_gather_2pa_launch(x, out, sync, dtype, n, count,
    blocks, use_ll, epoch, threads, stream)`` (``sync``: LL packets or HB
    flags)."""
    return _collective_library("allpairs_2pa", {
        "reduce_scatter_2pa_launch": [_P, _P, _P, _P, _I, _I, _LL, _I, _I,
                                      _U, _I, _P],
        "all_gather_2pa_launch": [_P, _P, _P, _I, _I, _LL, _I, _I, _U, _I,
                                  _P]})


def allgather_ring_library() -> ctypes.CDLL:
    """``csrc/allgather_ring.cu``: ``allgather_ring_launch(x, out, flags,
    dtype, n, count, blocks, epoch, threads, stream)``."""
    return _collective_library("allgather_ring", {
        "allgather_ring_launch": [_P, _P, _P, _I, _I, _LL, _I, _U, _I, _P]})


def alltoall_library() -> ctypes.CDLL:
    """``csrc/alltoall.cu``: ``all_to_all_launch(x, out, flags, dtype, n,
    count, blocks, epoch, threads, stream)``."""
    return _collective_library("alltoall", {
        "all_to_all_launch": [_P, _P, _P, _I, _I, _LL, _I, _U, _I, _P]})


def flash_attention_library() -> ctypes.CDLL:
    """``csrc/flash_attention.cu``: ``flash_attention_launch(q, k, v, out,
    dtype, b, h, h_kv, s, hd, causal, window, stream)`` (``window`` 0:
    none)."""
    return _collective_library("flash_attention", {
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P]})


def allreduce_2ph_library() -> ctypes.CDLL:
    """``csrc/allreduce_2ph.cu``: ``allreduce_2ph_launch(x, out, part,
    flags, dtype, nn, L, count, blocks, sub, ksub, epoch, threads,
    stream)`` and ``allreduce_2ph_max_blocks(dtype, threads)``."""
    return _collective_library("allreduce_2ph", {
        "allreduce_2ph_launch": [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _LL,
                                 _I, _U, _I, _P],
        "allreduce_2ph_max_blocks": [_I, _I]})


def collective_matmul_library() -> ctypes.CDLL:
    """``csrc/collective_matmul.cu``: ``ag_matmul_launch(x, w, out, xbuf,
    flags, part, counters, in_dtype, out_dtype, n, rows, K, F, w_per_rank,
    regime, splits, kt_split, epoch, stream)``. Its TMA descriptors come
    from the driver's
    ``cuTensorMapEncodeTiled``, which the library finds with ``dlopen`` /
    ``dlsym`` in ``libcuda.so.1`` at run time: nothing links ``libcuda``."""
    return _collective_library("collective_matmul", {
        "ag_matmul_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _U, _P]})


def channels_library() -> ctypes.CDLL:
    """``csrc/channels.cu``: ``port_put_launch(x, out, slots, stride,
    flags, epochs, dtype, n, count, blocks, tma, threads, stream)``
    and ``fused_reduce_launch(x, out, slots, stride, flags, epochs, dtype,
    n, count, blocks, threads, stream)`` (epochs on the card, one word a
    block)."""
    return _collective_library("channels", {
        "port_put_launch": [_P, _P, _P, _LL, _P, _P, _I, _I, _LL, _I, _I, _I,
                            _P],
        "fused_reduce_launch": [_P, _P, _P, _LL, _P, _P, _I, _I, _LL, _I,
                                _I, _P]})


def spans_library() -> ctypes.CDLL:
    """``csrc/spans.cu``: ``span_stamp_launch(ring, cursor, capacity, code,
    stream)`` (one device mark) and ``span_graph_nodes(graph, out,
    max_nodes, &count)`` (six words a node of a captured graph)."""
    return _collective_library("spans", {
        "span_stamp_launch": [_P, _P, _LL, _LL, _P],
        "span_graph_nodes": [_P, _P, _I, ctypes.POINTER(ctypes.c_int)]})
