#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                # every phase; needs one CUDA card
    python3 chip_smoke.py --phases 1,2,3 # device, build, kernel checks only
    python3 chip_smoke.py --phases 1,2,9 # build, then the MoE slice
    python3 chip_smoke.py --phases 1,2,10 # build, then the prefill slice
    python3 chip_smoke.py --phases 1,2,11 # build, then 2PH and AllGather-matmul

Phases, each printing one JSON line (any failure raises, exit != 0):

1. device — the card's name, and name + power limit from nvidia-smi;
2. build — compiles every kernel of ``src/repro_torch/csrc`` into
   ``build/`` (one nvcc per source, started together), and fails unless
   the AllGather-matmul library's SASS (``cuobjdump -sass``) holds wgmma
   (HGMMA) and TMA loads (UTMALDG) and no ``mma.sync`` (HMMA);
3. kernel vs plain — the DSL-executor kernel against ``TorchExecutor``
   on the card, bit-equal in f32 and bf16, over every registry entry ×
   n in {2, 4, 8} × O0-O3 at three sizes (the last several blocks a rank
   with a ragged last tile), and the decode plans of qwen3-1.7b and of
   phi3.5-moe (its ``moe_alltoall`` among them) at TP 2/4;
4. main path — full-width qwen3-1.7b (28 layers, seeded random bf16
   weights), TP=4 stacked on the card: 8 requests of 16-token prompts,
   then 32 greedy tokens, in auto and in explicit mode. Explicit must
   run on the kernel with exactly 58 launches per step and match auto's
   first-step logits within the stated bf16 tolerance;
5. f32 at full width, 4 layers: explicit and auto greedy tokens equal
   over 16 steps;
6. kernel time at each decode shape (the AllReduce and AllGather plans
   of qwen3-1.7b and of phi3.5-moe, and phi3.5-moe's all_to_all plans)
   beside its HBM bound, the plain version and a one-call PyTorch
   yardstick, with the launch's blocks a rank and threads, and the same
   program's time on 8 elements a chunk (launch and flags, no copies);
7. (opt-in, ``--phases 7``) a ``torch.profiler`` breakdown of one
   decode step in each mode, for the main paths of phases 4 and 9, and
   of one prefill forward of each phase-10 model: device busy share and
   the top kernels;
8. collective library — ``repro_torch.kernels.ops`` and its four
   kernels (1PA AllReduce LL/HB, all-pairs ReduceScatter and AllGather,
   ring AllGather): each op × algo × protocol bit-equal to its plain
   version over n in {2, 4, 8} × f32/bf16/int32 × the reference tests'
   shapes and an odd bf16 count, and at qwen3-1.7b's TP=4 serving sizes;
   the LL flag test (chained calls and a repeated ``step`` on one
   workspace); the main path — the collectives of serving qwen3-1.7b at
   TP=4 (a 57-AllReduce prefill of 8 × 16 tokens through 2PA, then
   decode steps of 57 1PA AllReduces and one ring logits AllGather),
   with every kernel's launches counted; and each kernel's device time
   at the serving sizes and over a per-rank size sweep at n=4, beside
   its HBM bound, its plain version and a one-call PyTorch yardstick;
9. expert-parallel MoE — the all_to_all kernel (``csrc/alltoall.cu``)
   bit-equal to its plain version over n in {2, 4, 8} ×
   f32/bf16/int32 × the reference test's shapes, an odd count, the MoE
   dispatch sizes and back-to-back calls on one workspace; the main
   path — phi3.5-moe at full width, depth cut to 8 of its 32 layers
   (32 do not fit one 80 GB card), TP=EP=4 stacked on the card, 8
   requests of 16-token prompts then 32 greedy tokens in auto and
   explicit mode: explicit runs on the executor kernel with exactly
   3L + 2 = 26 launches per step (embedding and attention AllReduces,
   dispatch and combine all_to_all per layer, logits AllGather) and
   matches auto's first-step logits within the bf16 tolerance with the
   routing pinned to auto's; unpinned, at most 2 of 8 rows route a
   token elsewhere, each first at a router near-tie that bf16 rounding
   explains, and the other rows hold the tolerance; f32 at
   full width, 2 layers: explicit and auto greedy tokens equal over 16
   steps; one full-width MoE layer through ``ops.all_to_all`` bit-equal
   to the same layer through the plan, then 4 decode steps' worth of
   those layers (64 kernel launches, counted); and the kernel's device
   time at the MoE sizes and over the per-rank sweep at n=4;
10. full-sequence prefill — the flash-attention kernel
   (``csrc/flash_attention.cu``) against its plain version within the
   reference's tolerances (f32 2e-5, bf16 3e-2) and a relative L2 error
   of 1e-5 (f32) or 1e-2 (bf16) over the reference tests' grid, ragged
   s, grouped KV heads, head dims 80 and 256 and the main path's shapes;
   the main path — ``make_prefill_step`` and ``forward`` of qwen3-1.7b
   (8 x 2048 tokens), gemma3-12b (2 x 4096, all 48 layers, 40 of them
   windowed) and hubert-xlarge (4 x 1024 float frames) at full width and
   depth on seeded random bf16 weights, each exactly one kernel launch
   per layer and no plain-core call, within a relative L2 error of 0.05
   of the same forward with the plain core, the first layer's core
   within 1e-2 on its own inputs, and two controls in plain torch (the
   kernel's rounding inside both limits, a skipped key tile past 1e-2);
   qwen3-1.7b's fused prefill against the engine's token by token (8 x
   128 tokens; bf16 within 0.05, f32 at 4 layers within 1e-4 with equal
   argmax); and the kernel's device time at each main-path shape beside
   its bound, its plain version and ``scaled_dot_product_attention``;
11. hierarchical 2PH and AllGather-matmul — the 2PH AllReduce kernel
   (``csrc/allreduce_2ph.cu``) bit-equal to its plain version over
   (nodes, local) in {(2, 2), (2, 4), (4, 4)} x rows a chunk in {1, 8,
   37} x cols in {1, 128, 2048} x f32/bf16, and two calls back to back;
   the AllGather-matmul kernel (``csrc/collective_matmul.cu``) within a
   relative L2 error of 1e-5 (f32 out) or 1e-2 (bf16 out) of its plain
   version over n in {2, 4, 8} x rows in {2, 64, 4096} x K in {128, 2048}
   x F in {128, 512, 1536} x shared and per-rank w x (bf16 -> f32, bf16
   -> bf16, f32 -> f32), at both sides of the bf16 regime threshold (n
   rows = 64) with K and F off the tile sizes, and two calls in a row;
   every bf16 -> bf16 result also bit-equal to the kernel's own f32 out
   rounded to bf16 (one main loop, two epilogues: a fault in the bf16
   epilogue's staging shows there, however few rows it touches); a
   fault control of each
   in plain torch, past its gate; on integer payloads at 2 x 4 and 4 x 4,
   the hierarchical plan replay loaded from its exported JSON, the 2PH
   kernel, the flat nn*L plan and the plain sum bit-equal; the main path
   — qwen3-1.7b's whole gradient as the explicit trainer hands it to the
   hierarchical AllReduce (14 leaves, bf16, 3.78 GiB a rank) on 2 nodes x
   4 local ranks, through the loaded plan set (3 executor launches a
   replay) and through ``ops.all_reduce(algo="2ph")`` (one launch a
   leaf), each within a relative L2 error of 1e-2 of the f64 sum, the
   plan replay bit-equal to the same plan files on ``TorchExecutor`` and
   the kernel to its plain version; then the AllGather-matmul at
   qwen3-1.7b's TP=4 projection shapes (prefill and decode into the
   w_gate and wq column shards, bf16 in, bf16 and f32 out, the bf16 out
   bit-equal to the f32 out rounded); and each
   kernel's device time per leaf or shape beside its bound, its plain
   version and a one-call PyTorch yardstick, the plan replay's time and
   the peak device memory.

The last lines are the card's nvidia-smi line, one ``{"kernels": [...]}``
JSON object, and ``{"ok": true, "device": {...}}``. The whole record,
the kernels line among it, also goes to ``chiprun_out/chip_smoke.json``.
The kernels line holds one entry per kernel. The executor's times are
the launch-weighted mean of both main paths' decode mixes, each path's
own under ``by_path`` and every shape's under ``per_shape``; its group
view on phase 11's hierarchical replays is an entry of its own
(``dsl_executor_group_view``: the replays' times over their launches,
each leaf's replay under ``per_shape``); flash
attention's are the mean over the layers of one forward of each phase-10
model, every shape's under ``per_shape``; the other kernels' per-shape
times are in the phase lines.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
ARCH = "qwen3-1.7b"
TP = 4
BATCH, PROMPT, DECODE = 8, 16, 32
MAX_KV = 1024
# bf16 first-step logits, explicit vs auto: TP partials are rounded to
# bf16 and summed in the plan's order, auto accumulates each matmul once
BF16_REL_TOL = 0.05                # ||explicit - auto|| / ||auto||
# MoE in bf16: at most this many of the batch's rows may route a token
# to other experts than auto (each at a router near-tie, see
# _moe_first_step)
MAX_REROUTED_ROWS = BATCH // 4
KERNEL_SOURCE = "src/repro_torch/csrc/executor.cu"
REPLACES = "src/repro/core/executor.py:702"
# phase 8: the collective library's kernels -> (source, TPU kernel body)
COLLECTIVES = {
    "all_reduce_1pa": ("src/repro_torch/csrc/allreduce_1pa.cu",
                       "src/repro/kernels/allreduce_1pa.py:35"),
    "reduce_scatter_2pa": ("src/repro_torch/csrc/allpairs_2pa.cu",
                           "src/repro/kernels/reducescatter_2pa.py:33"),
    "all_gather_2pa": ("src/repro_torch/csrc/allpairs_2pa.cu",
                       "src/repro/kernels/reducescatter_2pa.py:65"),
    "all_gather_ring": ("src/repro_torch/csrc/allgather_ring.cu",
                        "src/repro/kernels/allgather_ring.py:27"),
}
# (op, kwargs, kernels it launches, whether a rank's input holds one
# chunk per rank: n times the chunk's rows)
COLLECTIVE_OPS = (
    ("all_reduce", dict(algo="1pa"), ("all_reduce_1pa",), False),
    ("all_reduce", dict(algo="1pa", use_ll=False), ("all_reduce_1pa",),
     False),
    ("all_reduce", dict(algo="2pa"), ("reduce_scatter_2pa",
                                      "all_gather_2pa"), True),
    ("reduce_scatter", {}, ("reduce_scatter_2pa",), True),
    ("all_gather", dict(algo="ring"), ("all_gather_ring",), False),
    ("all_gather", dict(algo="allpairs"), ("all_gather_2pa",), False),
)
# tests/test_kernels_collectives.py's shapes and an odd bf16 count
GRID_SHAPES = ((8, 128), (16, 256), (8, 384), (3, 129))
MAIN_DECODE_STEPS = 4
# per-rank input sizes of the timing sweep at n=4, bf16 (rows, cols); 1PA
# stops at 1 MiB, only the AllGathers go to 64 MiB
SWEEP = {"1KiB": (4, 128), "32KiB": (8, 2048), "1MiB": (256, 2048),
         "16MiB": (4096, 2048), "64MiB": (16384, 2048)}
# phase 9: expert-parallel MoE decode. Full width; the depth is cut to
# 8 of phi3.5-moe's 32 layers: one layer holds about 1.30 G parameters
# (2.60 GB in bf16), so 32 layers and the embeddings (about 84 GB) do
# not fit one 80 GB card, and the auto and rank-stacked explicit copies
# of 8 layers take about 43 GB together
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS, MOE_F32_LAYERS = 8, 2
A2A_SOURCE = "src/repro_torch/csrc/alltoall.cu"
A2A_REPLACES = "src/repro/kernels/alltoall.py:26"
# phase 10: full-sequence prefill through the flash-attention kernel
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:37"
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
# kernel vs plain version: the reference test's tolerances (atol = rtol)
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# and a scale-free one, ||got - want|| / ||want||, at every case and on
# each model's own layer inputs: the late rows of a long softmax average
# many keys and are small, so an absolute tolerance sized for the early
# rows would pass a fault that touches only late rows
FA_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the control fault: for the second half of the queries, the key tile of
# this many keys holding the first key in reach is skipped (a ``lo`` off
# by one tile, touching only late rows)
FAULT_TILE = 64
# arch -> (batch, tokens) of its prefill; full width and depth, bf16
PREFILL = {"qwen3-1.7b": (8, 2048), "gemma3-12b": (2, 4096),
           "hubert-xlarge": (4, 1024)}
# the kernel's forward against the same forward with the plain attention
# core (the reference's chunked online softmax): bf16 activations, f32
# softmax in both, P rounded to bf16 only in the kernel
PREFILL_REL_TOL = 0.05
# fused prefill against the engine's token by token (auto mode)
FUSED_BATCH, FUSED_TOKENS = 8, 128
FUSED_F32_LAYERS, FUSED_F32_TOL = 4, 1e-4
PREFILL_REPEATS = 3
# phase 11: the hierarchical 2PH AllReduce and the AllGather-matmul
AR2PH_SOURCE = "src/repro_torch/csrc/allreduce_2ph.cu"
AR2PH_REPLACES = "src/repro/kernels/allreduce_2ph.py:36"
AGMM_SOURCE = "src/repro_torch/csrc/collective_matmul.cu"
AGMM_REPLACES = "src/repro/kernels/collective_matmul.py:41"
# kernel vs plain grids: 2PH (nodes, local), rows a chunk, cols; the
# AllGather-matmul's n, rows a rank, K, F
HIER_GRIDS = ((2, 2), (2, 4), (4, 4))
HIER_ROWS, HIER_COLS = (1, 8, 37), (1, 128, 2048)
AGMM_GRID = dict(n=(2, 4, 8), rows=(2, 64, 4096), k=(128, 2048),
                 f=(128, 512, 1536))
# the bf16 kernel's two regimes (kernels/collective_matmul.py:regime) on
# both sides of n * rows = 64, with K and F that are not multiples of the
# 64-deep k-tiles or the 64- and 256-wide column tiles: (n, rows, K, F)
AGMM_EDGES = ((4, 16, 136, 72), (4, 17, 136, 72), (2, 32, 200, 200),
              (2, 33, 200, 200), (8, 8, 2048, 1544), (8, 9, 2048, 1544))
HIER_NN, HIER_L = 2, 4                  # the main path: the reference's mesh2x4
# every leaf through the plan and the kernel, against the f64 sum: bf16
# wire values, each add rounded to bf16 in the fold
LEAF_REL_TOL = 1e-2
FAULT_LEAF = "ln_attn"
# kernel vs plain: the same f32 accumulation in another order (f32 out);
# and the f32 result rounded to bf16 (bf16 out)
AGMM_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
AGMM_PREFILL_TOKENS = 8 * 2048          # phase 10's qwen3-1.7b prefill

RECORD: dict = {}


def emit(phase: str, **kw) -> None:
    RECORD[phase] = kw
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------
def device_ms(fn, iters: int) -> tuple[float, bool]:
    """Device milliseconds per call of ``fn``: the calls are enqueued
    behind a device sleep long enough to cover the host's enqueue time,
    so the events between them see device execution only. Returns
    (ms per call, whether the sleep covered the enqueue)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    s0 = torch.cuda.Event(enable_timing=True)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(int(host_s * 3.0 * 2.0e9) + 2_000_000)
    e0.record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters, enqueue_ms < s0.elapsed_time(e0)


def wall_ms(fn, iters: int) -> float:
    """Milliseconds per call back to back (host enqueue included)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import build
    t = time.perf_counter()
    libs = build.build_all()
    build.executor_library()
    build.allreduce_1pa_library()
    build.allpairs_2pa_library()
    build.allgather_ring_library()
    build.alltoall_library()
    build.flash_attention_library()
    build.allreduce_2ph_library()
    build.collective_matmul_library()
    ptxas = [ln.strip() for b in build.last_build.values()
             for ln in b["log"].splitlines() if "registers" in ln]
    # the AllGather-matmul's bf16 product: wgmma (HGMMA) fed by TMA
    # (UTMALDG), and no mma.sync (HMMA) left
    sass = subprocess.run(
        [str(pathlib.Path(build.nvcc()).parent / "cuobjdump"), "-sass",
         str(libs["collective_matmul"])], capture_output=True, text=True,
        check=True, timeout=300).stdout
    agmm_sass = {op: len(re.findall(rf"\b{op}\b", sass))
                 for op in ("HGMMA", "UTMALDG", "HMMA")}
    emit("build", seconds=round(time.perf_counter() - t, 3),
         libraries=sorted(str(p.relative_to(ROOT)) if p.is_relative_to(ROOT)
                          else str(p) for p in libs.values()),
         ptxas=ptxas, collective_matmul_sass=agmm_sass)
    check(agmm_sass["HGMMA"] > 0 and agmm_sass["UTMALDG"] > 0
          and agmm_sass["HMMA"] == 0,
          f"collective_matmul SASS: {agmm_sass} (want HGMMA and UTMALDG, "
          f"no HMMA)")


def _decode_plans(device):
    """qwen3-1.7b's decode plans at TP 2 and 4 (batch_local 8), on the
    kernel backend."""
    from repro_torch import configs
    from repro_torch.core.comm import Communicator
    from repro_torch.distributed.step import compile_decode_plans
    cfg = configs.get_config(ARCH)
    out = {}
    for tp in (2, TP):
        comm = Communicator("model", n=tp, device=device)
        out[tp] = compile_decode_plans(cfg, comm, batch_local=BATCH, tp=tp)
    return out


def _moe_cfg(n_layers: int, dtype: str = "bfloat16"):
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(MOE_ARCH),
                               n_layers=n_layers, dtype=dtype)


def _moe_plans(device):
    """phi3.5-moe's decode plans at TP 2 and 4 (batch_local 8; the
    ``moe_alltoall`` family over capacity buckets of 2·b tokens per
    expert), on the kernel backend."""
    from repro_torch.core.comm import Communicator
    from repro_torch.distributed.step import compile_decode_plans
    cfg = _moe_cfg(MOE_LAYERS)
    return {tp: compile_decode_plans(
        cfg, Communicator("model", n=tp, device=device),
        batch_local=BATCH, tp=tp) for tp in (2, TP)}


def phase_kernel_vs_plain(device, gen):
    from repro_torch.core import algorithms, passes
    from repro_torch.core.executor import (OPCODES, THREADS, CudaExecutor,
                                           TorchExecutor)
    cases, max_err, blocks = 0, 0.0, set()
    for name in sorted(algorithms.REGISTRY):
        for n in (2, 4, 8):
            for lvl in range(4):
                prog = passes.optimize(algorithms.REGISTRY[name](n), lvl, n)
                n_in = prog.chunks[prog.in_buffer]
                kern = CudaExecutor(prog).prepare(n)
                plain = TorchExecutor(prog, vectorize=lvl > 0).prepare(n)
                # (2, 40): aligned 16-byte vector path; (1, 13): odd
                # chunk sizes, so later chunks take the scalar path;
                # (37, 1003): several blocks a rank, the last tile ragged
                # (37111 elements a chunk, not a multiple of 8 nb)
                for rows, cols in ((2, 40), (1, 13), (37, 1003)):
                    for dtype in (torch.float32, torch.bfloat16):
                        x = torch.randn(n, n_in * rows, cols, generator=gen,
                                        device=device).to(dtype)
                        got, want = kern(x), plain(x)
                        torch.cuda.synchronize()
                        max_err = max(max_err, (got.float() - want.float())
                                      .abs().max().item())
                        check(torch.equal(got, want),
                              f"kernel != plain: {name} n={n} O{lvl} "
                              f"{dtype} ({rows}x{cols}, {kern.blocks} "
                              f"blocks a rank)")
                        check(rows < 37 or kern.blocks > 1,
                              f"{name} n={n} {rows}x{cols}: one block a rank")
                        blocks.add(kern.blocks)
                        cases += 1
    shapes = []
    families = [(ARCH, tp, pname, bp)
                for tp, plans in _decode_plans(device).items()
                for pname, bp in plans.items()]
    families += [(MOE_ARCH, tp, pname, bp)
                 for tp, plans in _moe_plans(device).items()
                 for pname, bp in plans.items()]
    for arch, tp, pname, bp in families:
        for b, plan in bp.plans.items():
            plain = TorchExecutor(plan.program).prepare(tp)
            for rep in range(3):        # replays reuse flags + scratch
                x = torch.randn((tp,) + plan.shape, generator=gen,
                                device=device).to(plan.executor._bound[2])
                got, want = plan(x), plain(x)
                torch.cuda.synchronize()
                max_err = max(max_err, (got.float() - want.float())
                              .abs().max().item())
                check(torch.equal(got, want), f"kernel != plain: {arch} "
                      f"{pname} tp={tp} rows={b} rep={rep}")
                cases += 1
            enc = plan.executor.encoded
            shapes.append(dict(arch=arch, plan=pname, tp=tp, rows=b,
                               cols=plan.shape[1], dtype=plan.dtype,
                               algo=plan.algo, opt_level=plan.opt_level,
                               blocks_per_rank=plan.executor.blocks,
                               table=list(enc.ops.shape),
                               flag_slots=enc.n_flags,
                               puts_per_rank=int((enc.ops[0, :, 0]
                                                  == OPCODES["put"]).sum())))
    emit("kernel_vs_plain", cases=cases, max_abs_err=max_err,
         blocks_per_rank=sorted(blocks), threads=THREADS,
         decode_shapes=shapes)
    return max_err


def _run_engine(cfg, params, prompts, mode, n_decode, count_launches,
                keep_params=False):
    """Serve ``prompts`` then ``n_decode`` greedy tokens; returns the
    first step's logits, the last prefill logits, the tokens, ms/token
    of the decode loop, the kernel launches seen per step and, with
    ``keep_params``, the engine's params (rank-stacked when explicit)."""
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.serve.engine import Engine, ServeConfig
    eng = Engine(cfg, params, ServeConfig(batch=prompts.shape[0],
                                          max_kv=MAX_KV), tp=TP, mode=mode)
    if mode == "explicit":
        backends = {p.backend for bp in eng.decode_plans.values()
                    for p in bp.plans.values()}
        check(backends == {"cuda"}, f"explicit plans on {backends}")
    dev = eng.device
    torch.cuda.synchronize()
    if count_launches:
        CudaExecutor.launches = 0           # just before the main path
    first = eng._run_step(torch.as_tensor(prompts[:, 0], dtype=torch.long,
                                          device=dev))
    eng.pos += 1
    torch.cuda.synchronize()
    first_step_launches = CudaExecutor.launches
    logits = eng.prefill(prompts[:, 1:])
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    toks = eng.decode(logits, num_tokens=n_decode)
    e1.record()
    torch.cuda.synchronize()
    launches = CudaExecutor.launches        # read just after
    out = dict(first=first.float().cpu(), last=logits.float().cpu(),
               tokens=toks, ms_per_token=e0.elapsed_time(e1) / n_decode,
               launches=launches, first_step_launches=first_step_launches,
               plans={k: {b: p.algo for b, p in bp.plans.items()}
                      for k, bp in eng.decode_plans.items()})
    if keep_params:
        out["params"] = eng.params
    del eng
    torch.cuda.empty_cache()
    return out


def phase_main_path(device):
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(0)
    t = time.perf_counter()
    params = tf.init_params(cfg, gen, device=device)
    init_s = time.perf_counter() - t
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    auto = _run_engine(cfg, params, prompts, "auto", DECODE, False)
    explicit = _run_engine(cfg, params, prompts, "explicit", DECODE, True)
    steps = PROMPT + DECODE
    per_step = 2 * cfg.n_layers + 2           # layers, embed, logits
    check(explicit["first_step_launches"] == per_step,
          f"{explicit['first_step_launches']} launches in the first step")
    check(explicit["launches"] == per_step * steps,
          f"{explicit['launches']} launches in {steps} steps")
    for r in (auto, explicit):
        check(bool(torch.isfinite(r["first"]).all()
                   and torch.isfinite(r["last"]).all()), "non-finite logits")
        check(r["tokens"].shape == (BATCH, DECODE), "token shape")
    diff = (explicit["first"] - auto["first"])
    rel = (diff.norm() / auto["first"].norm()).item()
    check(rel <= BF16_REL_TOL, f"first-step logits differ: rel {rel}")
    agree = float((explicit["tokens"] == auto["tokens"]).mean())
    emit("main_path", arch=ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, dtype=cfg.dtype, tp=TP, batch=BATCH, prompt=PROMPT,
         decode=DECODE, init_params_s=round(init_s, 3),
         ms_per_token_auto=auto["ms_per_token"],
         ms_per_token_explicit=explicit["ms_per_token"],
         launches=explicit["launches"], launches_per_step=per_step,
         first_step_rel_err=rel, first_step_max_abs_err=diff.abs().max()
         .item(), bf16_rel_tol=BF16_REL_TOL, token_agreement=agree,
         plans=explicit["plans"])
    del params
    torch.cuda.empty_cache()
    return explicit["launches"]


def phase_f32_reduced_depth(device):
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config(ARCH), n_layers=4,
                              dtype="float32")
    gen = torch.Generator(device=device).manual_seed(1)
    params = tf.init_params(cfg, gen, device=device)
    prompts = np.random.RandomState(1).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    auto = _run_engine(cfg, params, prompts, "auto", 16, False)
    explicit = _run_engine(cfg, params, prompts, "explicit", 16, False)
    equal = bool(np.array_equal(auto["tokens"], explicit["tokens"]))
    rel = ((explicit["last"] - auto["last"]).norm()
           / auto["last"].norm()).item()
    emit("f32_reduced_depth", n_layers=cfg.n_layers, tokens_equal=equal,
         steps=16, last_prefill_rel_err=rel)
    check(equal, "f32 explicit and auto greedy tokens differ")
    del params
    torch.cuda.empty_cache()


def phase_kernel_time(device, gen):
    """Per decode shape of the TP=4 main paths (qwen3-1.7b's AllReduce
    and AllGather plans; phi3.5-moe's, and its ``moe_alltoall`` plans,
    whose ``rows`` count rows per per-rank block): the kernel's device
    time per launch, its HBM bound (each input read once, each output
    written once), the plain version and the one-call yardstick; the
    launch's blocks a rank and threads; and the same program's time on 8
    elements a chunk (one block a rank): the launch, the instruction walk
    and the flag round trips without the copies."""
    from repro_torch.core.executor import (THREADS, CudaExecutor,
                                           TorchExecutor)

    def library(pname, x):
        if pname == "layer_allreduce":
            return lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()
        if pname == "logits_allgather":
            return lambda: x.reshape(1, -1, x.shape[-1]).expand(
                TP, TP * x.shape[1], x.shape[-1]).contiguous()
        return lambda: x.view(TP, TP, x.shape[1] // TP, x.shape[-1]
                              ).transpose(0, 1).contiguous()

    families = [(ARCH, pname, bp)
                for pname, bp in _decode_plans(device)[TP].items()]
    families += [(MOE_ARCH, pname, bp)
                 for pname, bp in _moe_plans(device)[TP].items()]
    rows_out = []
    for arch, pname, bp in families:
        for b, plan in bp.plans.items():
            ex = plan.executor
            x = torch.randn((TP,) + plan.shape, generator=gen,
                            device=device).to(ex._bound[2])
            plain = TorchExecutor(plan.program).prepare(TP)
            prog = plan.program
            n_in, n_out = (prog.chunks[prog.in_buffer],
                           prog.chunks[prog.out_buffer])
            nbytes = x.numel() * x.element_size() * (1 + n_out / n_in)
            lib = library(pname, x)
            k_ms, k_cov = device_ms(lambda: ex(x), 200)
            p_ms, p_cov = device_ms(lambda: plain(x), 50)
            l_ms, l_cov = device_ms(lib, 200)
            tiny = CudaExecutor(prog).prepare(TP)
            xt = torch.randn((TP, n_in, 8), generator=gen,
                             device=device).to(ex._bound[2])
            f_ms, f_cov = device_ms(lambda: tiny(xt), 200)
            rows_out.append(dict(
                arch=arch, plan=pname, algo=plan.algo, rows=b,
                cols=plan.shape[1], dtype=plan.dtype, ms=k_ms,
                ms_wall=wall_ms(lambda: ex(x), 200), plain_ms=p_ms,
                library_ms=l_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bytes=nbytes, blocks_per_rank=ex.blocks, threads=THREADS,
                flags_only_ms=f_ms,
                sleep_covered=bool(k_cov and p_cov and l_cov and f_cov)))
    emit("kernel_time", shapes=rows_out)
    return rows_out


def _device_rows(prof, steps: int):
    """(device µs per step, launches per step, kernel name) of every
    device-side kernel in a profile, largest first: a CPU op's self
    device time repeats the kernels it launched, so only CUDA events."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total / steps, e.count // steps, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(rows, reverse=True)


def _profile_prefill(device):
    """Where one prefill forward's time goes, for each phase-10 model:
    ``torch.profiler`` over one ``make_prefill_step`` call after a warm
    one; device busy share with and without the profiler, the flash
    kernel's share, and the kernels that take most of the time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.distributed.step import make_prefill_step
    from repro_torch.models import transformer as tf
    out = {}
    for i, (arch, (b, s)) in enumerate(PREFILL.items()):
        cfg = configs.get_config(arch)
        gen = torch.Generator(device=device).manual_seed(10 + i)
        params = tf.init_params(cfg, gen, device=device)
        tokens = (torch.randn((b, s, cfg.d_model), generator=gen,
                              device=device) if cfg.frontend != "none" else
                  torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                device=device))
        step = make_prefill_step(cfg)
        step(params, tokens)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(params, tokens)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step(params, tokens)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rows = _device_rows(prof, 1)
        busy_ms = sum(r[0] for r in rows) / 1e3
        out[arch] = dict(
            batch=b, tokens=s, wall_ms=wall, wall_ms_unprofiled=bare_ms,
            device_busy_ms=busy_ms,
            device_busy_share_unprofiled=busy_ms / bare_ms,
            flash_ms=sum(r[0] for r in rows if "fa_" in r[2]) / 1e3,
            top_kernels=[dict(name=k[:90], us=us, launches=c)
                         for us, c, k in rows[:12]])
        del params, tokens, step
        torch.cuda.empty_cache()
    return out


def phase_profile(device):
    """Opt-in (``--phases 7``): where one decode step's time goes —
    ``torch.profiler`` over 4 steps of each mode at each main path's
    shape (qwen3-1.7b, phase 4; phi3.5-moe at 8 layers, phase 9); device
    busy share = summed kernel time over the steps' wall time, with and
    without the profiler, and the kernels that take most of it. Then the
    same for one prefill forward of each phase-10 model."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, ServeConfig
    tok = torch.zeros(BATCH, dtype=torch.long, device=device)
    steps = 4
    out = {}
    for arch, cfg in ((ARCH, configs.get_config(ARCH)),
                      (MOE_ARCH, _moe_cfg(MOE_LAYERS))):
        params = tf.init_params(cfg, torch.Generator(device=device)
                                .manual_seed(0), device=device)
        out[arch] = {}
        for mode in ("auto", "explicit"):
            eng = Engine(cfg, params, ServeConfig(batch=BATCH,
                                                  max_kv=MAX_KV),
                         tp=TP, mode=mode)
            for _ in range(PROMPT):            # warm, and fill the cache
                eng._run_step(tok)
                eng.pos += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                eng._run_step(tok)
                eng.pos += 1
            torch.cuda.synchronize()
            bare_ms = (time.perf_counter() - t) * 1e3 / steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for _ in range(steps):
                    eng._run_step(tok)
                    eng.pos += 1
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3 / steps
            rows = _device_rows(prof, steps)
            busy_ms = sum(r[0] for r in rows) / 1e3
            out[arch][mode] = dict(
                n_layers=cfg.n_layers, step_wall_ms=wall_ms,
                step_wall_ms_unprofiled=bare_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms if rows else None,
                device_busy_share_unprofiled=(busy_ms / bare_ms if rows
                                              else None),
                top_kernels=[dict(name=k[:90], us_per_step=us, launches=c)
                             for us, c, k in rows[:12]])
            del eng
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    emit("profile", note="profiler on: times include its overhead",
         prefill=_profile_prefill(device), **out)


def _rand(shape, dtype, gen, device):
    if dtype == torch.int32:
        return torch.randint(-100, 100, shape, generator=gen, device=device,
                             dtype=torch.int32)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _serving_sizes():
    """qwen3-1.7b at TP=4, batch 8: (label, per-rank input, dtype) of the
    decode and prefill (8 x 16 tokens) AllReduces and the logits shard."""
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    return dict(decode=((BATCH, cfg.d_model), torch.bfloat16),
                prefill=((BATCH * PROMPT, cfg.d_model), torch.bfloat16),
                logits=((BATCH, cfg.vocab // TP), torch.float32))


def _collectives_vs_plain(device, gen):
    """Every op x algo x protocol against its plain version, bit-equal."""
    from repro_torch.kernels import ops
    errs = {k: 0.0 for k in COLLECTIVES}
    cases = 0

    def held(op, kw, kernels, x, what):
        nonlocal cases
        got = getattr(ops, op)(x, **kw)
        want = getattr(ops, op)(x, backend="torch", **kw)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        for k in kernels:
            errs[k] = max(errs[k], err)
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"kernel != plain: {op} {kw} {what} (max |err| {err})")
        cases += 1

    for n in (2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for rows, cols in GRID_SHAPES:
                for op, kw, kernels, per_chunk in COLLECTIVE_OPS:
                    x = _rand((n, rows * (n if per_chunk else 1), cols),
                              dtype, gen, device)
                    held(op, kw, kernels, x, f"n={n} {dtype} {tuple(x.shape)}")
    sizes = _serving_sizes()
    for op, kw, kernels, _ in COLLECTIVE_OPS:
        labels = ("logits",) if op == "all_gather" else ("decode", "prefill")
        for label in labels:
            shape, dtype = sizes[label]
            x = _rand((TP,) + shape, dtype, gen, device)
            held(op, kw, kernels, x, f"{label} {dtype} {tuple(x.shape)}")

    # LL flag test: calls chained on one workspace, then fresh data with
    # the same step (the card's test_all_reduce_1pa_distinct_steps)
    shape, dtype = sizes["decode"]
    for use_ll in (True, False):
        x = _rand((TP,) + shape, dtype, gen, device)
        for step, fresh in ((0, False), (1, False), (1, True)):
            if fresh:
                x = _rand((TP,) + shape, dtype, gen, device)
            y = ops.all_reduce(x, algo="1pa", use_ll=use_ll, step=step)
            want = ops.all_reduce(x, algo="1pa", use_ll=use_ll, step=step,
                                  backend="torch")
            torch.cuda.synchronize()
            check(torch.equal(y, want), f"1PA use_ll={use_ll} step={step} "
                  f"fresh={fresh}: kernel != plain on a reused workspace")
            cases += 1
            x = y
    return cases, errs


def _collectives_main_path(device, gen):
    """The collectives of serving qwen3-1.7b at TP=4 through ``ops``, with
    the kernels' launch counts set to 0 just before and read just after;
    every output is then checked bit-equal to the plain version."""
    from repro_torch import configs
    from repro_torch.kernels import comm_utils, ops
    n_ar = 2 * configs.get_config(ARCH).n_layers + 1   # per forward step
    sizes = _serving_sizes()
    pools = {k: [_rand((TP,) + shape, dtype, gen, device) for _ in range(2)]
             for k, (shape, dtype) in sizes.items()}
    calls = (("prefill", "all_reduce", {}),
             ("decode", "all_reduce", dict(algo="1pa")),
             ("logits", "all_gather", {}))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def drive():
        outs = []
        events[0].record()
        for i in range(n_ar):                   # prefill of 8 x 16 tokens
            outs.append((0, i % 2, ops.all_reduce(pools["prefill"][i % 2])))
        events[1].record()
        for _ in range(MAIN_DECODE_STEPS):
            for i in range(n_ar):
                outs.append((1, i % 2, ops.all_reduce(pools["decode"][i % 2],
                                                      algo="1pa")))
            outs.append((2, 0, ops.all_gather(pools["logits"][0])))
        events[2].record()
        torch.cuda.synchronize()
        return outs

    drive()           # warm-up: the allocator's blocks for the outputs
    comm_utils.LAUNCHES.clear()                 # just before the main path
    outs = drive()
    launches = dict(comm_utils.LAUNCHES)        # read just after
    e0, e1, e2 = events
    want = {(c, j): getattr(ops, calls[c][1])(pools[calls[c][0]][j],
                                              backend="torch", **calls[c][2])
            for c in range(3) for j in range(2)}
    for c, j, got in outs:
        check(bool(torch.isfinite(got.float()).all())
              and torch.equal(got, want[(c, j)]),
              f"main path: {calls[c][1]} {calls[c][2]} output != plain")
    expect = {"all_reduce_1pa": n_ar * MAIN_DECODE_STEPS,
              "reduce_scatter_2pa": n_ar, "all_gather_2pa": n_ar,
              "all_gather_ring": MAIN_DECODE_STEPS}
    check(launches == expect, f"main-path launches {launches} != {expect}")
    return dict(launches=launches, allreduces_per_step=n_ar,
                decode_steps=MAIN_DECODE_STEPS,
                prefill_ms=e0.elapsed_time(e1),
                decode_ms_per_step=e1.elapsed_time(e2) / MAIN_DECODE_STEPS,
                outputs_checked=len(outs))


def _collectives_time(device, gen):
    """Device time of each kernel at the serving sizes and over a per-rank
    size sweep at n=4 (bf16), beside the HBM bound (each rank's input
    read once, each output written once, over all ranks), the plain
    version and a one-call PyTorch yardstick the port never calls."""
    from repro_torch.kernels import comm_utils, ops
    n = TP
    sizes = _serving_sizes()
    d = sizes["decode"][0][1]
    # kernel -> (op, kwargs, [(label, per-rank input, dtype)])
    plan = {
        "all_reduce_1pa": [
            ("all_reduce", dict(algo="1pa", use_ll=ll),
             [("decode",) + sizes["decode"], ("prefill",) + sizes["prefill"]]
             + [(k, v, torch.bfloat16) for k, v in SWEEP.items()
                if k in ("1KiB", "32KiB", "1MiB")])
            for ll in (True, False)],
        "reduce_scatter_2pa": [
            ("reduce_scatter", {},
             [("decode",) + sizes["decode"], ("prefill",) + sizes["prefill"]]
             + [(k, v, torch.bfloat16) for k, v in SWEEP.items()
                if k != "64MiB"])],
        "all_gather_2pa": [
            ("all_gather", dict(algo="allpairs"),
             [("decode_2pa_half", (BATCH // n, d), torch.bfloat16),
              ("prefill_2pa_half", (BATCH * PROMPT // n, d), torch.bfloat16),
              ("logits",) + sizes["logits"]]
             + [(k, v, torch.bfloat16) for k, v in SWEEP.items()])],
        "all_gather_ring": [
            ("all_gather", dict(algo="ring"),
             [("logits",) + sizes["logits"]]
             + [(k, v, torch.bfloat16) for k, v in SWEEP.items()])],
    }
    rows_out = {}
    for kernel, variants in plan.items():
        rows_out[kernel] = []
        for op, kw, shapes in variants:
            for label, shape, dtype in shapes:
                x = _rand((n,) + tuple(shape), dtype, gen, device)
                fn = getattr(ops, op)

                def kern(x=x, fn=fn, kw=kw):
                    return fn(x, **kw)

                def plain(x=x, fn=fn, kw=kw):
                    return fn(x, backend="torch", **kw)

                out = kern()
                rows, cols = x.shape[1], x.shape[2]
                if op == "all_reduce":
                    def lib(x=x):
                        return x.sum(0, keepdim=True).expand_as(x).contiguous()
                elif op == "reduce_scatter":
                    def lib(x=x, rows=rows, cols=cols):
                        return x.view(n, n, rows // n, cols).sum(0)
                else:
                    def lib(x=x, rows=rows, cols=cols):
                        return x.reshape(1, -1, cols).expand(
                            n, n * rows, cols).contiguous()
                nbytes = (x.numel() + out.numel()) * x.element_size()
                del out
                iters = max(3, min(200, int(4e9 // nbytes)))
                k_ms, k_cov = device_ms(kern, iters)
                p_ms, p_cov = device_ms(plain, max(3, iters // 4))
                l_ms, l_cov = device_ms(lib, iters)
                rows_out[kernel].append(dict(
                    op=op, **kw, size=label, n=n, rows=rows, cols=cols,
                    dtype=str(dtype).replace("torch.", ""),
                    rank_bytes=x[0].numel() * x.element_size(),
                    blocks_per_rank=comm_utils.workspace(
                        f"{kernel}/{'ll' if kw.get('use_ll', True) else 'hb'}"
                        if kernel == "all_reduce_1pa" else kernel, x).blocks,
                    ms=k_ms, ms_wall=wall_ms(kern, iters), plain_ms=p_ms,
                    library_ms=l_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bytes=nbytes, sleep_covered=dict(
                        kernel=k_cov, plain=p_cov, library=l_cov)))
                del x
                torch.cuda.empty_cache()
    return rows_out


def phase_collectives(device, gen):
    t = time.perf_counter()
    cases, errs = _collectives_vs_plain(device, gen)
    main = _collectives_main_path(device, gen)
    timing = _collectives_time(device, gen)
    emit("collectives", cases=cases, max_abs_err=errs, main_path=main,
         shapes=timing, seconds=round(time.perf_counter() - t, 3))
    return errs, main["launches"], timing


def _moe_caps():
    """Rows per per-rank block of phi3.5-moe's ``moe_alltoall`` buckets at
    TP=4, batch 8: ``e_local * ep_capacity(b)`` for each slot bucket."""
    from repro_torch.distributed.moe_parallel import ep_capacity
    from repro_torch.distributed.step import slot_buckets
    cfg = _moe_cfg(MOE_LAYERS)
    e = cfg.moe.num_experts
    return [e // TP * ep_capacity(b, cfg.moe.top_k)
            for b in slot_buckets(BATCH)]


def _a2a_vs_plain(device, gen):
    """The all_to_all kernel against its plain version, bit-equal (a pure
    copy): n in {2, 4, 8} × f32/bf16/int32 × the grid shapes, the MoE
    dispatch sizes, and back-to-back calls on one workspace whose round
    trip must give the input back (the epoch test)."""
    from repro_torch.kernels import ops
    err, cases = 0.0, 0

    def held(x, what):
        nonlocal err, cases
        got = ops.all_to_all(x)
        want = ops.all_to_all(x, backend="torch")
        torch.cuda.synchronize()
        err = max(err, (got.double() - want.double()).abs().max().item())
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"all_to_all kernel != plain: {what}")
        cases += 1
        return got

    for n in (2, 4, 8):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for rows, cols in GRID_SHAPES:
                x = _rand((n, n * rows, cols), dtype, gen, device)
                held(x, f"n={n} {dtype} {tuple(x.shape)}")
    d = _moe_cfg(MOE_LAYERS).d_model
    for c in _moe_caps():
        held(_rand((TP, TP * c, d), torch.bfloat16, gen, device),
             f"MoE dispatch, {c} rows per block")
    shape = (TP, TP * _moe_caps()[-1], d)
    for _ in range(3):
        x = _rand(shape, torch.bfloat16, gen, device)
        back = held(held(x, "reused workspace"), "reused workspace, back")
        check(torch.equal(back, x), "all_to_all round trip != input")
    return cases, err


@contextlib.contextmanager
def _routing(pin=None):
    """Record every MoE layer's top-k routing (router logits and chosen
    experts) while the block is open. With ``pin`` (a recording of the
    auto path), each explicit rank's choices are replaced by auto's for
    the same layer call, weighted by the rank's own router logits: the
    routing is held equal and everything else computed as it is."""
    from repro_torch.distributed import moe_parallel
    from repro_torch.models import blocks
    orig = blocks.top_k
    rec = []

    def spy(x, k):
        vals, idx = orig(x, k)
        if pin is not None:       # auto's (b, s, k) onto (tp, b*s, k)
            idx = pin[len(rec)][1].to(x.device).reshape(1, -1, k).expand(
                idx.shape).contiguous()
            vals = x.gather(-1, idx)
        rec.append((x.float().cpu(), idx.cpu()))
        return vals, idx

    blocks.top_k = moe_parallel.top_k = spy
    try:
        yield rec
    finally:
        blocks.top_k = moe_parallel.top_k = orig


def _moe_first_step(cfg, params, eparams, prompts, device):
    """The first decode step of auto and of explicit mode on the same
    weights and token, their routing recorded. In bf16 a router near-tie
    can route a token to another expert in the two modes (their hidden
    states differ by bf16 rounding: TP partial sums, and each rank's
    own fold order in the 1PA AllReduce), which changes that token's
    logits by O(1) — so the bf16 tolerance is held with the routing
    pinned to auto's, and, unpinned, on the rows whose routing agreed
    on every rank in every layer. Each row that diverges is recorded at
    its first divergence with auto's top-k gap and the router shift
    there, which the caller holds to a near-tie."""
    from repro_torch.distributed.step import make_serve_step
    from repro_torch.mesh import RankAxis
    axis = RankAxis("model", TP, device)
    tok = torch.as_tensor(prompts[:, 0], dtype=torch.long, device=device)
    out = {}
    for mode, p in (("auto", params), ("explicit", eparams),
                    ("pinned", eparams)):
        step, layout = make_serve_step(
            cfg, axis, batch=BATCH, max_kv=MAX_KV,
            mode="auto" if mode == "auto" else "explicit")
        with torch.inference_mode(), _routing(
                out["auto"][1] if mode == "pinned" else None) as rec:
            logits = step(p, layout.cache(), tok, 0)[0].float().cpu()
        out[mode] = (logits, rec)
    auto = out["auto"][0]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # tokens whose top-k set agrees with auto on every explicit rank in
    # every layer
    agreed = torch.ones(BATCH, dtype=torch.bool)
    flips = []
    k = cfg.moe.top_k
    for layer, ((la, ia), (le, ie)) in enumerate(zip(out["auto"][1],
                                                     out["explicit"][1])):
        # auto's (b, s, .) as one rank's (1, b*s, .); explicit's is
        # (tp, b*s, .)
        la, ia = la.reshape(1, -1, la.shape[-1]), ia.reshape(1, -1, k)
        same = (ia.sort(-1).values == ie.sort(-1).values).all(-1)  # (tp, T)
        for r, t in (~same).nonzero().tolist():
            if agreed[t]:        # the token's first divergence
                top = la[0, t].sort(descending=True).values
                flips.append(dict(layer=layer, token=t, rank=r,
                                  auto=ia[0, t].tolist(),
                                  explicit=ie[r, t].tolist(),
                                  gap=(top[k - 1] - top[k]).item(),
                                  router_diff=(la[0, t] - le[r, t]).abs()
                                  .max().item()))
        agreed &= same.all(0)
    row_rel = ((out["explicit"][0] - auto).norm(dim=1)
               / auto.norm(dim=1))
    return dict(explicit_logits=out["explicit"][0],
                rel_err=rel(out["explicit"][0], auto),
                pinned_rel_err=rel(out["pinned"][0], auto),
                rows_routed_alike=int(agreed.sum()),
                rows_routed_alike_max_rel_err=(
                    row_rel[agreed].max().item() if agreed.any() else None),
                row_rel_err=row_rel.tolist(), first_divergences=flips)


def _moe_main_path(device):
    """Full-width phi3.5-moe (8 layers) served in auto and explicit mode;
    returns the record, the explicit engine's rank-stacked params and
    the executor launches of the explicit run."""
    from repro_torch.models import transformer as tf
    cfg = _moe_cfg(MOE_LAYERS)
    t = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(2),
                            device=device)
    init_s = time.perf_counter() - t
    prompts = np.random.RandomState(2).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    auto = _run_engine(cfg, params, prompts, "auto", DECODE, False)
    explicit = _run_engine(cfg, params, prompts, "explicit", DECODE, True,
                           keep_params=True)
    first = _moe_first_step(cfg, params, explicit["params"], prompts, device)
    del params
    torch.cuda.empty_cache()
    steps = PROMPT + DECODE
    # embedding + per layer (attention AllReduce, dispatch, combine) +
    # logits gather
    per_step = 3 * cfg.n_layers + 2
    check(explicit["first_step_launches"] == per_step,
          f"{explicit['first_step_launches']} launches in the first step")
    check(explicit["launches"] == per_step * steps,
          f"{explicit['launches']} launches in {steps} steps")
    for r in (auto, explicit):
        check(bool(torch.isfinite(r["first"]).all()
                   and torch.isfinite(r["last"]).all()), "non-finite logits")
        check(r["tokens"].shape == (BATCH, DECODE), "token shape")
    diff = explicit["first"] - auto["first"]
    rel = (diff.norm() / auto["first"].norm()).item()
    rerun = first.pop("explicit_logits")
    check(torch.equal(explicit["first"], rerun),
          "the served first step differs from its routing-recorded rerun")
    check(first["pinned_rel_err"] <= BF16_REL_TOL,
          f"MoE first-step logits with auto's routing differ: rel "
          f"{first['pinned_rel_err']}")
    check(BATCH - first["rows_routed_alike"] <= MAX_REROUTED_ROWS,
          f"MoE routing: {BATCH - first['rows_routed_alike']} of {BATCH} "
          f"rows routed unlike auto: {first['first_divergences']}")
    check(first["rows_routed_alike_max_rel_err"] <= BF16_REL_TOL,
          f"MoE first-step logits of the rows routed alike differ: {first}")
    # a top-k set changes under a router shift of at most `router_diff`
    # per expert only where auto's k-th and (k+1)-th logits lie within
    # 2 * router_diff: anything wider is not rounding
    for f in first["first_divergences"]:
        check(f["gap"] <= 2 * f["router_diff"],
              f"MoE routing flip that rounding does not explain: {f}")
    record = dict(
        arch=MOE_ARCH, n_layers=cfg.n_layers, n_layers_published=32,
        d_model=cfg.d_model, experts=cfg.moe.num_experts,
        top_k=cfg.moe.top_k, d_ff=cfg.d_ff, vocab=cfg.vocab,
        dtype=cfg.dtype, tp=TP, batch=BATCH, prompt=PROMPT, decode=DECODE,
        init_params_s=init_s, ms_per_token_auto=auto["ms_per_token"],
        ms_per_token_explicit=explicit["ms_per_token"],
        launches=explicit["launches"], launches_per_step=per_step,
        first_step_rel_err=rel, first_step_max_abs_err=diff.abs().max()
        .item(), first_step=first, bf16_rel_tol=BF16_REL_TOL,
        token_agreement=float((explicit["tokens"] == auto["tokens"]).mean()),
        plans=explicit["plans"])
    return record, explicit["params"], explicit["launches"]


def _moe_layer_through_kernel(device, gen, eparams):
    """One full-width MoE layer on a (4, 8, 1, 4096) bf16 hidden state,
    dispatched through the ``moe_alltoall`` plan (executor kernel) and
    through ``ops.all_to_all`` (the all_to_all kernel): bit-equal, as
    the all_to_all only copies. Then 4 decode steps' worth of the 8
    layers through the kernel, with its launch count set to 0 just
    before and read just after."""
    from repro_torch.distributed.moe_parallel import moe_layer_ep
    from repro_torch.kernels import comm_utils, ops
    cfg = _moe_cfg(MOE_LAYERS)
    plan = _moe_plans(device)[TP]["moe_alltoall"]
    moe = eparams["layers"][0]["moe"]                # (tp, groups, ...)
    layers = [{k: v[:, g] for k, v in moe.items()}
              for g in range(cfg.n_layers)]
    # every rank holds the same batch, as in explicit decode
    h = _rand((BATCH, 1, cfg.d_model), torch.bfloat16, gen, device)
    h = h.expand((TP,) + tuple(h.shape)).contiguous()

    def kernel(buf):
        return ops.all_to_all(buf)

    def layer(lp, a2a):
        return moe_layer_ep(lp, h, cfg, plan=a2a)

    want = [layer(lp, plan) for lp in layers]
    got = layer(layers[0], kernel)
    torch.cuda.synchronize()
    check(torch.equal(got, want[0]),
          "MoE layer through ops.all_to_all != through the plan")
    check(plan.hits[plan.buckets[-1]] == 2 * cfg.n_layers,
          f"moe_alltoall bucket hits {plan.hits}")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    comm_utils.LAUNCHES.clear()                 # just before the main path
    e0.record()
    outs = [(g, layer(lp, kernel)) for _ in range(MAIN_DECODE_STEPS)
            for g, lp in enumerate(layers)]
    e1.record()
    torch.cuda.synchronize()
    launches = dict(comm_utils.LAUNCHES)        # read just after
    expect = {"all_to_all": 2 * cfg.n_layers * MAIN_DECODE_STEPS}
    check(launches == expect, f"MoE-layer launches {launches} != {expect}")
    for g, y in outs:
        check(torch.equal(y, want[g]),
              f"layer {g} through the kernel != through the plan")
    return dict(launches=launches, layers=cfg.n_layers,
                decode_steps=MAIN_DECODE_STEPS, outputs_checked=len(outs) + 1,
                ms_per_layer=e0.elapsed_time(e1) / len(outs))


def _moe_f32(device):
    """f32 at full width, 2 layers: explicit and auto greedy tokens equal
    over 16 steps."""
    from repro_torch.models import transformer as tf
    cfg = _moe_cfg(MOE_F32_LAYERS, "float32")
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(3),
                            device=device)
    prompts = np.random.RandomState(3).randint(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    auto = _run_engine(cfg, params, prompts, "auto", 16, False)
    explicit = _run_engine(cfg, params, prompts, "explicit", 16, False)
    del params
    torch.cuda.empty_cache()
    equal = bool(np.array_equal(auto["tokens"], explicit["tokens"]))
    rel = ((explicit["last"] - auto["last"]).norm()
           / auto["last"].norm()).item()
    check(equal, "MoE f32 explicit and auto greedy tokens differ")
    return dict(n_layers=cfg.n_layers, tokens_equal=equal, steps=16,
                last_prefill_rel_err=rel)


def _a2a_time(device, gen):
    """The kernel's device time at the MoE dispatch sizes and over the
    per-rank sweep at n=4 (bf16), beside the HBM bound (each rank's input
    read once and its output written once: 2·n·per-rank bytes), the plain
    version and the one-call yardstick the port never calls."""
    from repro_torch.kernels import comm_utils, ops
    n = TP
    d = _moe_cfg(MOE_LAYERS).d_model
    sizes = [(f"moe_c{c}", (n * c, d)) for c in _moe_caps()]
    sizes += list(SWEEP.items())
    rows_out = []
    for label, (rows, cols) in sizes:
        x = _rand((n, rows, cols), torch.bfloat16, gen, device)

        def kern(x=x):
            return ops.all_to_all(x)

        def plain(x=x):
            return ops.all_to_all(x, backend="torch")

        def lib(x=x, rows=rows, cols=cols):
            return x.view(n, n, rows // n, cols).transpose(0, 1).contiguous()

        nbytes = 2 * x.numel() * x.element_size()
        iters = max(3, min(200, int(4e9 // nbytes)))
        k_ms, k_cov = device_ms(kern, iters)
        p_ms, p_cov = device_ms(plain, max(3, iters // 4))
        l_ms, l_cov = device_ms(lib, iters)
        rows_out.append(dict(
            size=label, n=n, rows=rows, cols=cols, dtype="bfloat16",
            rank_bytes=x[0].numel() * x.element_size(),
            blocks_per_rank=comm_utils.workspace("all_to_all", x).blocks,
            ms=k_ms, ms_wall=wall_ms(kern, iters), plain_ms=p_ms,
            library_ms=l_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bytes=nbytes, sleep_covered=dict(kernel=k_cov, plain=p_cov,
                                             library=l_cov)))
        del x
        torch.cuda.empty_cache()
    return rows_out


def phase_moe(device, gen):
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cases, err = _a2a_vs_plain(device, gen)
    main, eparams, exec_launches = _moe_main_path(device)
    layer = _moe_layer_through_kernel(device, gen, eparams)
    del eparams
    torch.cuda.empty_cache()
    f32 = _moe_f32(device)
    timing = _a2a_time(device, gen)
    emit("moe", cases=cases, max_abs_err=err, main_path=main, f32=f32,
         layer_through_kernel=layer, shapes=timing,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=round(time.perf_counter() - t, 3))
    return err, layer["launches"]["all_to_all"], exec_launches, timing


def _fa_cases():
    """(b, h, h_kv, s, hd, dtype, causal, window, label) of the
    kernel-vs-plain grid: the reference tests' grid, its windows and
    block-skip case, ragged s, KV-head groups, head dims 80 and 256 (label
    None), and the main path's shapes (:func:`_fa_main_shapes`)."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = [(1, 2, 2, s, hd, dt, causal, None)
           for s, hd in ((256, 64), (512, 128)) for dt in (f32, bf16)
           for causal in (True, False)]
    out += [(1, 2, 2, 512, 64, f32, True, w) for w in (128, 256)]
    out.append((2, 1, 1, 1024, 64, f32, True, 128))
    out += [(2, 4, 2, s, 64, dt, causal, w) for s in (12, 200)
            for dt in (f32, bf16)
            for causal, w in ((True, None), (False, None), (True, 64),
                              (False, 64))]
    out += [(2, 8, 8 // r, 300, 128, dt, True, None) for r in (1, 2, 4)
            for dt in (f32, bf16)]
    out += [(2, 4, hkv, 333, hd, dt, causal, w) for hd in (80, 256)
            for dt in (f32, bf16)
            for hkv, causal, w in ((2, True, None), (4, False, None),
                                   (2, True, 100))]
    out = [case + (None,) for case in out]
    out += [shape[:9] for shape in _fa_main_shapes()]
    return out


def _fa_main_shapes():
    """The attention cores of phase 10's main path: (b, h, h_kv, s, hd,
    dtype, causal, window, label, layers per forward)."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    out = []
    for arch, (b, s) in PREFILL.items():
        cfg = configs.get_config(arch)
        wins = tf.layer_windows(cfg)
        for win in sorted(set(wins), key=lambda w: (w is None, w)):
            label = arch if len(set(wins)) == 1 else \
                f"{arch}-{'local' if win else 'global'}"
            out.append((b, cfg.n_heads, cfg.n_kv_heads, s, cfg.hd,
                        torch.bfloat16, cfg.causal, win, label,
                        wins.count(win) * cfg.n_layers // len(wins)))
    return out


def _fa_qkv(b, h, hkv, s, hd, dtype, gen, device):
    return (_rand((b, h, s, hd), dtype, gen, device),
            _rand((b, hkv, s, hd), dtype, gen, device),
            _rand((b, hkv, s, hd), dtype, gen, device))


def _fa_vs_plain(device, gen):
    """Every case of :func:`_fa_cases`, kernel against plain version on
    the same seeded inputs: within FA_TOL elementwise and FA_REL_TOL in
    relative L2. Returns the case count, the largest |err| and relative L2
    error of each dtype, and the relative L2 error of each main shape."""
    from repro_torch.kernels import flash_attention as fa
    errs = {"float32": 0.0, "bfloat16": 0.0}
    rels = dict(errs)
    main_rels = {}
    cases = _fa_cases()
    for b, h, hkv, s, hd, dt, causal, win, label in cases:
        q, k, v = _fa_qkv(b, h, hkv, s, hd, dt, gen, device)
        got = fa.flash_attention(q, k, v, causal=causal, window=win)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        name = str(dt).split(".")[-1]
        errs[name] = max(errs[name],
                         (got.float() - want.float()).abs().max().item())
        rel = _rel(got, want)
        rels[name] = max(rels[name], rel)
        if label is not None:
            main_rels[label] = rel
        tol = FA_TOL[dt]
        what = (f"b={b} h={h}/{hkv} s={s} hd={hd} {dt} causal={causal} "
                f"window={win}")
        check(got.dtype == dt and bool(torch.allclose(
            got.float(), want.float(), atol=tol, rtol=tol)),
            f"flash kernel != plain: {what}")
        check(rel <= FA_REL_TOL[dt],
              f"flash kernel != plain: relative L2 {rel} at {what}")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return len(cases), errs, rels, main_rels


@contextlib.contextmanager
def _plain_attention_calls():
    """Count calls of the plain attention cores (the flash kernel's plain
    version and the model's torch core) while the block runs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import blocks
    calls = {"flash_attention_plain": 0, "_plain_core": 0}
    saved = [(fa, "flash_attention_plain"), (blocks, "_plain_core")]
    originals = [getattr(mod, name) for mod, name in saved]

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for (mod, name), fn in zip(saved, originals):
        setattr(mod, name, counted(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)


@contextlib.contextmanager
def _first_cores():
    """Keep the q/k/v of the first kernel call of each window kind (layer
    0, and gemma3-12b's first global layer) while the block runs."""
    from repro_torch.models import blocks
    seen = {}
    launch = blocks.flash_attention

    def keep(q, k, v, *, causal, window, backend=None):
        seen.setdefault(window, (q, k, v, causal))
        return launch(q, k, v, causal=causal, window=window, backend=backend)

    blocks.flash_attention = keep
    try:
        yield seen
    finally:
        blocks.flash_attention = launch


@contextlib.contextmanager
def _plain_core_as(core):
    """The model's plain attention core replaced by ``core`` while the
    block runs."""
    from repro_torch.models import blocks
    plain = blocks._plain_core
    blocks._plain_core = core
    try:
        yield
    finally:
        blocks._plain_core = plain


def _fault_mask(s, window, device):
    """(s, s) True where the control fault skips a key: rows in the second
    half, in the FAULT_TILE-key tile holding the row's first key in reach
    (0, or the window's first)."""
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    lo = (q_pos - window + 1).clamp_min(0) if window else 0 * q_pos
    return (q_pos >= s // 2) & (k_pos // FAULT_TILE == lo // FAULT_TILE)


def _control_core(q, k, v, cfg, *, window, fault=False):
    """Controls for the model's plain attention core, in plain torch, one
    KV head at a time. The kernel's rounding: f32 logits and softmax, the
    unnormalised P rounded to q's dtype for P V, f32 accumulation, divided
    by the f32 row sum. With ``fault``, the same with the keys of
    :func:`_fault_mask` skipped. q (b, h, s, hd), k/v (b, h_kv, s, hd)."""
    from repro_torch.models import blocks
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    mask = blocks._attn_mask(s, s, causal=cfg.causal, window=window,
                             device=q.device)
    if fault:
        mask &= ~_fault_mask(s, window, q.device)
    out = torch.empty_like(q)
    for n in range(k.shape[1]):
        heads = slice(n * g, (n + 1) * g)
        logits = (q[:, heads].float() * hd ** -0.5) @ \
            k[:, n:n + 1].float().transpose(-1, -2)
        logits = torch.where(mask, logits, -1e30)
        pr = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        den = pr.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[:, heads] = ((pr.to(q.dtype).float() @ v[:, n:n + 1].float())
                         / den).to(q.dtype)
    return out


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _core_controls(cfg, first):
    """On the inputs the forward gave the first layer of each window kind:
    the kernel, the rounding control and the fault control
    (:func:`_control_core`) against the plain version, in relative L2."""
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for win, (q, k, v, causal) in first.items():
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
        got = fa.flash_attention(q, k, v, causal=causal, window=win)
        out[f"window={win}"] = dict(
            shape=list(q.shape), kv_heads=k.shape[1],
            kernel_rel_err=_rel(got, want),
            rounding_rel_err=_rel(_control_core(q, k, v, cfg, window=win),
                                  want),
            fault_rel_err=_rel(_control_core(q, k, v, cfg, window=win,
                                             fault=True), want))
    return out


def _prefill_main_path(device):
    """Each model at full width and depth on seeded random bf16 weights:
    ``make_prefill_step`` and ``forward`` each launch the kernel once per
    layer (counted from 0 around each) and never the plain core; the
    output within PREFILL_REL_TOL of the same forward with the plain core;
    the first layer's core within FA_REL_TOL on its own inputs; the
    controls (:func:`_control_core`): the kernel's rounding in plain torch
    within both limits, the fault past the core's (end to end, bf16
    rounding through the layers alone reads 0.02-0.03, so the fault's
    reading there is kept, not held); prefill ms per forward (median of
    PREFILL_REPEATS step calls)."""
    from repro_torch import configs
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.distributed.step import make_prefill_step
    from repro_torch.kernels import comm_utils
    from repro_torch.kernels.flash_attention import KERNEL
    from repro_torch.models import transformer as tf
    out, launches = {}, 0
    for i, (arch, (b, s)) in enumerate(PREFILL.items()):
        cfg = configs.get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(10 + i)
        params = tf.init_params(cfg, gen, device=device)
        if cfg.frontend != "none":
            tokens = torch.randn((b, s, cfg.d_model), generator=gen,
                                 device=device)
        else:
            tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                   device=device)
        step = make_prefill_step(cfg)
        torch.cuda.synchronize()
        counts = {}
        with _plain_attention_calls() as plain_calls, \
                _first_cores() as first:
            for name, run in (
                    ("step", lambda: step(params, tokens)),
                    ("forward", lambda: tf.forward(params, cfg, tokens))):
                comm_utils.LAUNCHES.clear()        # every count to 0
                CudaExecutor.launches = 0
                result = run()
                torch.cuda.synchronize()
                counts[name] = dict(comm_utils.LAUNCHES)   # read just after
                check(counts[name] == {KERNEL: cfg.n_layers},
                      f"{arch} {name}: launches {counts[name]}, want "
                      f"{cfg.n_layers} of {KERNEL}")
                check(CudaExecutor.launches == 0, "executor launched")
                if name == "step":
                    last = result
                else:
                    hidden = result
        check(not any(plain_calls.values()),
              f"{arch}: plain attention ran {plain_calls}")
        launches += sum(c[KERNEL] for c in counts.values())
        with torch.inference_mode():
            plain_hidden = tf.forward(params, cfg, tokens, backend="torch")
            plain_last = tf.logits_fn(params, cfg, plain_hidden[:, -1:])[:, 0]
        check(last.shape == (b, cfg.vocab) and last.dtype == torch.float32,
              f"{arch}: step output {tuple(last.shape)} {last.dtype}")
        check(hidden.shape == (b, s, cfg.d_model), f"{arch}: hidden shape")
        for t in (last, hidden):
            check(bool(torch.isfinite(t).all()), f"{arch}: non-finite")
        rec = dict(batch=b, tokens=s, n_layers=cfg.n_layers,
                   d_model=cfg.d_model, heads=cfg.n_heads,
                   kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                   causal=cfg.causal, window=cfg.window,
                   launches=counts, plain_calls=plain_calls,
                   hidden_rel_err=_rel(hidden, plain_hidden),
                   last_logits_rel_err=_rel(last, plain_last),
                   argmax_agree=float((last.argmax(-1)
                                       == plain_last.argmax(-1)).float()
                                      .mean()))
        if cfg.family == "encoder":     # the encoder's product: all frames
            with torch.inference_mode():
                logits = tf.logits_fn(params, cfg, hidden)
                plain_logits = tf.logits_fn(params, cfg, plain_hidden)
            check(bool(torch.isfinite(logits).all()), f"{arch}: logits")
            rec["logits_rel_err"] = _rel(logits, plain_logits)
            del logits, plain_logits
        rec["cores"] = _core_controls(cfg, first)
        del first
        with torch.inference_mode():
            for name, fault in (("rounding", False), ("fault", True)):
                with _plain_core_as(functools.partial(_control_core,
                                                      fault=fault)):
                    ctl = tf.forward(params, cfg, tokens, backend="torch")
                rec[f"{name}_hidden_rel_err"] = _rel(ctl, plain_hidden)
                if not fault:
                    rec["hidden_rel_err_vs_rounding"] = _rel(hidden, ctl)
                del ctl
        print(json.dumps(dict(phase="prefill_model", arch=arch, **rec)),
              flush=True)
        for key in ("hidden_rel_err", "last_logits_rel_err",
                    "logits_rel_err", "rounding_hidden_rel_err"):
            if key in rec:
                check(rec[key] <= PREFILL_REL_TOL,
                      f"{arch}: {key} {rec[key]} > {PREFILL_REL_TOL}")
        for key, core in rec["cores"].items():
            check(core["kernel_rel_err"] <= FA_REL_TOL[torch.bfloat16],
                  f"{arch} {key}: kernel vs plain on the layer's own "
                  f"inputs, relative L2 {core['kernel_rel_err']}")
            check(core["fault_rel_err"] > FA_REL_TOL[torch.bfloat16],
                  f"{arch} {key}: the control fault reads "
                  f"{core['fault_rel_err']}")
        del plain_hidden, hidden
        times = []
        for _ in range(PREFILL_REPEATS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            step(params, tokens)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        ms = float(np.median(times))
        rec.update(prefill_ms=ms, prefill_ms_all=times,
                   tokens_per_s=b * s / ms * 1e3,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[arch] = rec
        del params, tokens, step
        torch.cuda.empty_cache()
    return out, launches


def _fused_vs_stepwise(device):
    """qwen3-1.7b, batch 8 x 128 tokens, auto mode: the fused step's
    last-position logits against ``Engine.prefill`` token by token, in
    bf16 at full depth and in f32 at FUSED_F32_LAYERS layers."""
    from repro_torch import configs
    from repro_torch.distributed.step import make_prefill_step
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, ServeConfig
    out = {}
    for dtype, n_layers, tol in (("bfloat16", None, PREFILL_REL_TOL),
                                 ("float32", FUSED_F32_LAYERS,
                                  FUSED_F32_TOL)):
        cfg = configs.get_config(ARCH)
        cfg = dataclasses.replace(cfg, dtype=dtype,
                                  n_layers=n_layers or cfg.n_layers)
        params = tf.init_params(cfg, torch.Generator(device=device)
                                .manual_seed(20), device=device)
        prompts = np.random.RandomState(20).randint(
            0, cfg.vocab, (FUSED_BATCH, FUSED_TOKENS))
        fused = make_prefill_step(cfg)(params, prompts)
        eng = Engine(cfg, params, ServeConfig(batch=FUSED_BATCH,
                                              max_kv=2 * FUSED_TOKENS))
        stepwise = eng.prefill(prompts)
        torch.cuda.synchronize()
        rel = _rel(fused, stepwise)
        agree = bool(torch.equal(fused.argmax(-1), stepwise.argmax(-1)))
        out[dtype] = dict(n_layers=cfg.n_layers, rel_err=rel,
                          max_abs_err=(fused - stepwise.float()).abs().max()
                          .item(), argmax_equal=agree, tol=tol)
        check(rel <= tol, f"fused vs token by token, {dtype}: rel {rel}")
        if dtype == "float32":
            check(agree, "fused vs token by token, f32: argmax differs")
        del eng, params
        torch.cuda.empty_cache()
    return out


def _attention_pairs(s, causal, window) -> int:
    """Unmasked (query, key) pairs of one head."""
    q = np.arange(s)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    hi = q + 1 if causal else np.full_like(q, s)
    return int((hi - lo).sum())


def _fa_time(device, gen):
    """Per main-path shape: the kernel's device time per launch beside its
    bound (the larger of 4 * hd FLOPs per unmasked pair and head over the
    bf16 peak, and q, k, v read once and o written once over HBM), the
    plain version, and the library yardstick the port never calls
    (``scaled_dot_product_attention``; a boolean mask for a window)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import blocks
    rows = []
    for b, h, hkv, s, hd, dt, causal, win, label, layers in \
            _fa_main_shapes():
        q, k, v = _fa_qkv(b, h, hkv, s, hd, dt, gen, device)
        if win is None:
            def lib(q=q, k=k, v=v, causal=causal):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        else:
            mask = blocks._attn_mask(s, s, causal=causal, window=win,
                                     device=device)

            def lib(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        k_ms, k_cov = device_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=win), 20)
        p_ms, p_cov = device_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=win), 3)
        l_ms, l_cov = device_ms(lib, 20)
        pairs = _attention_pairs(s, causal, win)
        flops = 4 * b * h * hd * pairs
        nbytes = (2 * b * h + 2 * b * hkv) * s * hd * q.element_size()
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        rows.append(dict(
            shape=label, b=b, h=h, h_kv=hkv, s=s, hd=hd, causal=causal,
            window=win, layers_per_forward=layers, ms=k_ms, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
            ops_ms=t_ops * 1e3, bytes_ms=t_bytes * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes, tflops_per_s=flops / k_ms / 1e9,
            sleep_covered=dict(kernel=k_cov, plain=p_cov, library=l_cov)))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_prefill(device, gen):
    t = time.perf_counter()
    torch.cuda.empty_cache()
    cases, errs, rels, main_rels = _fa_vs_plain(device, gen)
    main, launches = _prefill_main_path(device)
    fused = _fused_vs_stepwise(device)
    timing = _fa_time(device, gen)
    emit("prefill", cases=cases, max_abs_err=errs, tol=
         {str(k).split(".")[-1]: v for k, v in FA_TOL.items()},
         max_rel_err=rels, main_shape_rel_err=main_rels, rel_tol=
         {str(k).split(".")[-1]: v for k, v in FA_REL_TOL.items()},
         main_path=main, launches=launches, fused_vs_stepwise=fused,
         shapes=timing, seconds=round(time.perf_counter() - t, 3))
    return max(errs.values()), launches, timing


# ---------------------------------------------------------------------------
# phase 11: hierarchical 2PH AllReduce and AllGather-matmul
# ---------------------------------------------------------------------------
def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in f64, a rank and 2^26 elements at a
    time (``want`` broadcasts: one reduced buffer for every rank)."""
    num = den = 0.0
    step = 1 << 26
    for r in range(got.shape[0]):
        g = got[r].reshape(-1)
        w = (want[r] if want.dim() == got.dim() else want).reshape(-1)
        for i in range(0, g.numel(), step):
            wi = w[i:i + step].double()
            num += float((g[i:i + step].double() - wi).square().sum())
            den += float(wi.square().sum())
    return (num / den) ** 0.5 if den else float(num > 0)


def _max_abs_err(got, want) -> float:
    """max |got - want| in f64, a rank at a time."""
    return max((got[r].double() - want[r].double()).abs().max().item()
               for r in range(got.shape[0]))


def _2ph_fault(x, nn):
    """Plain torch: 2PH with the other nodes dropped from rank 0's phase-2
    fold, so node 0's ranks hold chunk 0 with their own node's sum only
    (rank 0's phase-1 fold, in its rotated order)."""
    from repro_torch.kernels.allreduce_2ph import all_reduce_2ph_plain
    ranks, total, cols = x.shape
    ln = ranks // nn
    y = all_reduce_2ph_plain(x, node_size=nn).reshape(
        ranks, ln, total // ln, cols).clone()
    xs = x.reshape(ranks, ln, total // ln, cols)
    acc = xs[0, 0]
    for i in range(1, ln):
        acc = acc + xs[i, 0]
    y[:ln, 0] = acc
    return y.reshape(ranks, total, cols)


def _agmm_fault(x, w, out_dtype):
    """Plain torch: rank 0 multiplies the chunk of slot 1 into row block
    0 (a chunk taken from the wrong slot)."""
    from repro_torch.kernels.collective_matmul import allgather_matmul_plain
    n, rows, _ = x.shape
    y = allgather_matmul_plain(x, w, out_dtype=out_dtype).reshape(
        n, n, rows, w.shape[-1]).clone()
    w0 = w[0] if w.dim() == 3 else w
    y[0, 0] = (x[1].float() @ w0.float()).to(out_dtype)
    return y.reshape(n, n * rows, w.shape[-1])


def _2ph_vs_plain(gen, device):
    """The 2PH kernel against its plain version, bit-equal, over the grid
    (and two calls back to back against the plain version twice), and
    the fault control's reading on one case."""
    from repro_torch.kernels import ops
    cases, err = 0, 0.0
    for nn, ln in HIER_GRIDS:
        for rows in HIER_ROWS:
            for cols in HIER_COLS:
                for dtype in (torch.float32, torch.bfloat16):
                    x = _rand((nn * ln, ln * rows, cols), dtype, gen, device)
                    y = ops.all_reduce(x, algo="2ph", node_size=nn)
                    y2 = ops.all_reduce(y, algo="2ph", node_size=nn)
                    p = ops.all_reduce(x, algo="2ph", node_size=nn,
                                       backend="torch")
                    p2 = ops.all_reduce(p, algo="2ph", node_size=nn,
                                        backend="torch")
                    torch.cuda.synchronize()
                    e = (y.double() - p.double()).abs().max().item()
                    err = max(err, e)
                    check(torch.equal(y, p) and torch.equal(y2, p2),
                          f"2PH kernel != plain: {nn}x{ln} rows={rows} "
                          f"cols={cols} {dtype} (max |err| {e})")
                    cases += 2
    x = _rand((8, 4 * 8, 128), torch.float32, gen, device)
    fault = (_2ph_fault(x, 2).double() - ops.all_reduce(
        x, algo="2ph", node_size=2).double()).abs().max().item()
    check(fault > 0, "2PH fault control reads bit-equal")
    return cases, err, fault


def _agmm_vs_plain(gen, device):
    """The AllGather-matmul kernel against its plain version over the
    grid, rel. L2 within AGMM_REL_TOL of the output type, and bf16 out
    bit-equal to the kernel's f32 out rounded; two calls in a row (the
    second on every rank's first row block, K = F); the fault control's
    reading."""
    from repro_torch.kernels import ops
    cases, errs, rels = 0, {}, {}

    def held(x, w, odt, what):
        nonlocal cases
        y = ops.fused_allgather_matmul(x, w, out_dtype=odt)
        p = ops.fused_allgather_matmul(x, w, out_dtype=odt, backend="torch")
        y32 = (ops.fused_allgather_matmul(x, w, out_dtype=torch.float32)
               if (x.dtype, odt) == (torch.bfloat16,) * 2 else None)
        torch.cuda.synchronize()
        key = f"{str(x.dtype)[6:]}->{str(odt)[6:]}"
        rel = _rel_l2(y, p)
        errs[key] = max(errs.get(key, 0.0),
                        (y.double() - p.double()).abs().max().item())
        rels[key] = max(rels.get(key, 0.0), rel)
        check(y.shape == p.shape and y.dtype == p.dtype
              and rel <= AGMM_REL_TOL[odt],
              f"AllGather-matmul kernel vs plain: {what} {key} rel. L2 "
              f"{rel} > {AGMM_REL_TOL[odt]}")
        check(y32 is None or torch.equal(y, y32.to(odt)),
              f"AllGather-matmul bf16 out != its f32 out rounded: {what}")
        cases += 1
        return y, p

    pairs = ((torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.float32))
    for n in AGMM_GRID["n"]:
        for rows in AGMM_GRID["rows"]:
            for k in AGMM_GRID["k"]:
                for f in AGMM_GRID["f"]:
                    for per_rank in (False, True):
                        for dt, odt in pairs:
                            x = _rand((n, rows, k), dt, gen, device)
                            w = _rand(((n,) if per_rank else ()) + (k, f),
                                      dt, gen, device)
                            held(x, w, odt, f"n={n} rows={rows} K={k} F={f} "
                                 f"per_rank={per_rank}")
                            del x, w
        torch.cuda.empty_cache()
    for n in AGMM_GRID["n"]:
        for rows in AGMM_GRID["rows"][:2]:
            for per_rank in (False, True):
                for dt in (torch.bfloat16, torch.float32):
                    x = _rand((n, rows, 128), dt, gen, device)
                    w = _rand(((n,) if per_rank else ()) + (128, 128), dt,
                              gen, device)
                    y1, p1 = held(x, w, dt, f"twice, first n={n}")
                    held(y1[:, :rows].contiguous(), w, dt,
                         f"twice, second n={n}")
    from repro_torch.kernels.collective_matmul import regime
    edges = []
    for n, rows, k, f in AGMM_EDGES:
        for per_rank in (False, True):
            for dt, odt in pairs:
                x = _rand((n, rows, k), dt, gen, device)
                w = _rand(((n,) if per_rank else ()) + (k, f), dt, gen,
                          device)
                held(x, w, odt, f"edge n={n} rows={rows} K={k} F={f} "
                     f"per_rank={per_rank}")
        edges.append(dict(n=n, rows=rows, K=k, F=f, regime=regime(n, rows)))
    check({e["regime"] for e in edges} == {"decode", "prefill"},
          f"regime cases {edges}")
    x = _rand((4, 64, 2048), torch.bfloat16, gen, device)
    w = _rand((4, 2048, 512), torch.bfloat16, gen, device)
    p = ops.fused_allgather_matmul(x, w, backend="torch")
    fault = _rel_l2(_agmm_fault(x, w, torch.bfloat16), p)
    check(fault > AGMM_REL_TOL[torch.bfloat16],
          f"AllGather-matmul fault control reads {fault} inside the gate")
    return cases, errs, rels, fault, edges


def _hier_exact(device, tmp):
    """Integer-valued f32: the hierarchical plan replay loaded from its
    exported JSON, the 2PH kernel, the flat nn*L plan and the plain sum,
    bit-equal at 2 x 4 and 4 x 4."""
    from repro_torch.core.comm import (Communicator, HierarchicalCommunicator,
                                       export_plan_set, load_plan_set)
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.kernels import ops
    out = []
    for nn, ln in ((2, 4), (4, 4)):
        planner = HierarchicalCommunicator("local", "node", local_n=ln,
                                           node_n=nn, device=device,
                                           backend="torch")
        shapes = {f"r{ln * r}c{c}": (ln * r, c) for r, c in ((8, 128),
                                                             (37, 2048))}
        path = tmp / f"exact{nn}x{ln}"
        export_plan_set({k: planner.compile(s, torch.float32)
                         for k, s in shapes.items()}, path)
        loaded = load_plan_set(path, device=device)
        flat = Communicator("x", n=nn * ln, device=device)
        for name, (rows, cols) in shapes.items():
            g = torch.Generator(device=device).manual_seed(rows * cols)
            x = torch.randint(-8, 8, (nn * ln, rows, cols), generator=g,
                              device=device).float()
            c0 = CudaExecutor.launches
            hier = loaded[name](x)
            launches = CudaExecutor.launches - c0
            kern = ops.all_reduce(x, algo="2ph", node_size=nn)
            fl = flat.compile("all_reduce", (rows, cols), torch.float32)(x)
            want = x.sum(0, keepdim=True).expand_as(x)
            torch.cuda.synchronize()
            check(launches == 3, f"hierarchical replay took {launches} "
                  f"launches, not 3")
            check(torch.equal(hier, want) and torch.equal(kern, want)
                  and torch.equal(fl, want),
                  f"{nn}x{ln} {name}: plan, kernel, flat and sum differ")
            out.append(dict(grid=f"{nn}x{ln}", rows=rows, cols=cols,
                            algo=loaded[name].algo, flat_algo=flat.compile(
                                "all_reduce", (rows, cols),
                                torch.float32).algo, bit_equal=True))
    return out


def _grad_leaves():
    """qwen3-1.7b's gradient as the explicit trainer hands it to
    hierarchical_all_reduce: every leaf reshaped to (-1, last), a 1-D
    leaf to (-1, 1), in the bf16 wire type."""
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    d, nl, hd = cfg.d_model, cfg.n_layers, cfg.head_dim
    return {"embed": (cfg.vocab, d), "unembed": (d, cfg.vocab),
            "ln_f": (d, 1), "ln_attn": (nl, d), "ln_mlp": (nl, d),
            "wq": (nl * d * cfg.n_heads, hd),
            "wk": (nl * d * cfg.n_kv_heads, hd),
            "wv": (nl * d * cfg.n_kv_heads, hd),
            "wo": (nl * cfg.n_heads * hd, d), "q_norm": (nl, hd),
            "k_norm": (nl, hd), "w_gate": (nl * d, cfg.d_ff),
            "w_up": (nl * d, cfg.d_ff), "w_down": (nl * cfg.d_ff, d)}


def _leaf(name, shape, device):
    """A leaf's seeded bf16 payload on every rank of the grid."""
    g = torch.Generator(device=device).manual_seed(
        sorted(_grad_leaves()).index(name))
    return torch.randn((HIER_NN * HIER_L,) + shape, generator=g,
                       device=device).to(torch.bfloat16)


def _f64_sum(x):
    s = x[0].double()
    for r in range(1, x.shape[0]):
        s += x[r]
    return s


def _agmm_main_shapes():
    """(label, n, rows a rank, K, F) of qwen3-1.7b's TP=4 projections:
    prefill (8 x 2048 tokens, sequence-sharded) and decode (batch 8) into
    the column shards of w_gate and wq."""
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    f_gate, f_q = cfg.d_ff // TP, cfg.n_heads * cfg.head_dim // TP
    pre, dec = AGMM_PREFILL_TOKENS // TP, BATCH // TP
    return [("prefill_w_gate", TP, pre, cfg.d_model, f_gate),
            ("prefill_wq", TP, pre, cfg.d_model, f_q),
            ("decode_w_gate", TP, dec, cfg.d_model, f_gate),
            ("decode_wq", TP, dec, cfg.d_model, f_q)]


def _hier_main_path(device, tmp):
    """The slice's main path with the launch counts set to 0 just before
    and read just after: the 14 gradient leaves through their loaded plan
    sets (three executor launches a replay) and through ops.all_reduce
    (algo '2ph', one launch each), then the AllGather-matmul at its four
    main shapes in both output types. Every output is checked here: each
    leaf's plan replay bit-equal to the same plan file replayed by the
    plain executor (the same groups and stride), the kernel bit-equal to
    its plain version, both within LEAF_REL_TOL of the f64 sum.

    The plans are compiled on the plain backend (no device state) and
    exported one leaf to a plan set, as a planner ships them; each set is
    loaded, which allocates its executors' scratch, just before its leaf
    runs and dropped after: all 14 at once would hold about 49 GB."""
    from repro_torch.core.comm import (HierarchicalCommunicator,
                                       export_plan_set, load_plan_set)
    from repro_torch.core.executor import CudaExecutor
    from repro_torch.kernels import comm_utils, ops
    leaves = _grad_leaves()
    planner = HierarchicalCommunicator("local", "node", local_n=HIER_L,
                                       node_n=HIER_NN, device=device,
                                       backend="torch")
    for k, shape in leaves.items():
        export_plan_set({k: planner.compile(shape, torch.bfloat16)},
                        tmp / "grad_plans" / k)
    mm_inputs = {}
    for label, n, rows, k, f in _agmm_main_shapes():
        g = torch.Generator(device=device).manual_seed(rows * f)
        mm_inputs[label] = (
            torch.randn((n, rows, k), generator=g, device=device).to(
                torch.bfloat16),
            (torch.randn((n, k, f), generator=g, device=device)
             / k ** 0.5).to(torch.bfloat16))
    recs, mm_recs = [], []
    torch.cuda.synchronize()
    CudaExecutor.launches = 0                   # just before the main path
    comm_utils.LAUNCHES.clear()
    for name, shape in leaves.items():
        plan = load_plan_set(tmp / "grad_plans" / name, device=device)[name]
        x = _leaf(name, shape, device)
        y_plan = plan(x)
        y_kern = ops.all_reduce(x, algo="2ph", node_size=HIER_NN)
        torch.cuda.synchronize()
        # checks (no kernel launches: the plain version and f64 sums)
        want = _f64_sum(x)
        rec = dict(leaf=name, rows=shape[0], cols=shape[1],
                   rank_bytes=x[0].numel() * x.element_size(),
                   algo=plan.algo, pad=plan.pad,
                   plan_rel_l2=_rel_l2(y_plan, want),
                   kernel_rel_l2=_rel_l2(y_kern, want))
        del plan
        torch.cuda.empty_cache()
        y_torch = load_plan_set(tmp / "grad_plans" / name, device=device,
                                backend="torch")[name](x)
        rec["plan_max_abs_err_plain"] = _max_abs_err(y_plan, y_torch)
        rec["plan_bit_equal_plain"] = torch.equal(y_plan, y_torch)
        del y_plan, y_torch
        torch.cuda.empty_cache()
        rec["kernel_bit_equal_plain"] = torch.equal(
            y_kern, ops.all_reduce(x, algo="2ph", node_size=HIER_NN,
                                   backend="torch"))
        if name == FAULT_LEAF:
            rec["fault_rel_l2"] = _rel_l2(_2ph_fault(x, HIER_NN), want)
        check(rec["kernel_bit_equal_plain"],
              f"2PH kernel != plain on leaf {name}")
        check(rec["plan_bit_equal_plain"],
              f"hierarchical plan replay != plain executor on leaf {name} "
              f"(max |err| {rec['plan_max_abs_err_plain']})")
        check(rec["plan_rel_l2"] <= LEAF_REL_TOL
              and rec["kernel_rel_l2"] <= LEAF_REL_TOL,
              f"leaf {name}: rel. L2 to the f64 sum {rec}")
        recs.append(rec)
        del x, y_kern, want
        torch.cuda.empty_cache()
    for label, n, rows, k, f in _agmm_main_shapes():
        x, w = mm_inputs[label]
        ys = {}
        for odt in (torch.bfloat16, torch.float32):
            y = ys[odt] = ops.fused_allgather_matmul(x, w, out_dtype=odt)
            p = ops.fused_allgather_matmul(x, w, out_dtype=odt,
                                           backend="torch")
            rel = _rel_l2(y, p)
            mm_recs.append(dict(shape=label, out=str(odt)[6:], rel_l2=rel,
                                max_abs_err=(y.double() - p.double()).abs()
                                .max().item()))
            check(bool(torch.isfinite(y.float()).all())
                  and rel <= AGMM_REL_TOL[odt],
                  f"AllGather-matmul {label} {odt}: rel. L2 {rel}")
        rounded = torch.equal(ys[torch.bfloat16],
                              ys[torch.float32].to(torch.bfloat16))
        mm_recs[-2]["equals_f32_out_rounded"] = rounded
        check(rounded, f"AllGather-matmul {label}: bf16 out != its f32 out "
              f"rounded")
        del ys
    torch.cuda.synchronize()
    launches = dict(comm_utils.LAUNCHES)        # read just after
    executor = CudaExecutor.launches
    expect = {"all_reduce_2ph": len(leaves),
              "allgather_matmul": 2 * len(mm_inputs)}
    check(launches == expect, f"main-path launches {launches} != {expect}")
    check(executor == 3 * len(leaves),
          f"{executor} executor launches for {len(leaves)} hierarchical "
          f"replays, not 3 each")
    fault = next(r["fault_rel_l2"] for r in recs if "fault_rel_l2" in r)
    check(fault > LEAF_REL_TOL, f"2PH fault control reads {fault}")
    return recs, mm_recs, dict(launches, executor=executor)


def _hier_time(device, tmp):
    """Per gradient leaf: the 2PH kernel's device time and wall time, the
    plan replay's (three executor launches) and the same plan's on the
    plain executor, the plain 2PH version's and the yardstick's (x.sum(0)
    expanded, which the port never calls), beside the bound: every
    rank's input read once and output written once over HBM."""
    from repro_torch.core.comm import load_plan_set
    from repro_torch.core.executor import THREADS
    from repro_torch.kernels import comm_utils, ops
    rows_out = []
    for name, shape in _grad_leaves().items():
        x = _leaf(name, shape, device)
        plan = load_plan_set(tmp / "grad_plans" / name, device=device)[name]
        nbytes = 2 * x.numel() * x.element_size()
        iters = max(2, min(50, int(2e9 // nbytes)))

        def kern(x=x):
            return ops.all_reduce(x, algo="2ph", node_size=HIER_NN)

        def plain(x=x):
            return ops.all_reduce(x, algo="2ph", node_size=HIER_NN,
                                  backend="torch")

        def lib(x=x):
            return x.sum(0, keepdim=True).expand_as(x).contiguous()

        k_ms, k_cov = device_ms(kern, iters)
        k_wall = wall_ms(kern, iters)
        r_ms, r_cov = device_ms(lambda: plan(x), max(1, iters // 4))
        # blocks a rank and threads of the RS, AR and AG launches
        phases = [p.executor for p in (plan.rs_plan, plan.ar_plan,
                                       plan.ag_plan)]
        plan_blocks = [e.blocks for e in phases]
        plan_threads = [THREADS] * len(phases)
        del plan, phases
        torch.cuda.empty_cache()
        plan = load_plan_set(tmp / "grad_plans" / name, device=device,
                             backend="torch")[name]
        rp_ms, rp_cov = device_ms(lambda: plan(x), max(1, iters // 4))
        del plan
        torch.cuda.empty_cache()
        p_ms, p_cov = device_ms(plain, max(1, iters // 4))
        l_ms, l_cov = device_ms(lib, iters)
        rows_out.append(dict(
            leaf=name, rows=shape[0], cols=shape[1], ranks=x.shape[0],
            rank_bytes=x[0].numel() * x.element_size(),
            blocks_per_rank=comm_utils.workspace(
                f"all_reduce_2ph/nodes{HIER_NN}", x).blocks,
            ms=k_ms, ms_wall=k_wall, plan_ms=r_ms, plan_plain_ms=rp_ms,
            plan_blocks_per_rank=plan_blocks, plan_threads=plan_threads,
            plain_ms=p_ms, library_ms=l_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
            sleep_covered=dict(kernel=k_cov, plan=r_cov, plan_plain=rp_cov,
                               plain=p_cov, library=l_cov)))
        del x
        torch.cuda.empty_cache()
    return rows_out


def _agmm_time(device, gen):
    """Per main shape and output type: the AllGather-matmul kernel's
    device and wall time, the plain version's, and the yardstick's (one
    torch.matmul of the gathered rows by every rank's w, bf16 out, which
    the port never calls), beside the bound: the larger of 2 n (n rows) K
    F FLOP over the bf16 peak and x, w, out bytes over HBM."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.collective_matmul import decode_splits, regime
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows_out = []
    for label, n, rows, k, f in _agmm_main_shapes():
        x = _rand((n, rows, k), torch.bfloat16, gen, device)
        w = _rand((n, k, f), torch.bfloat16, gen, device)
        mode = regime(n, rows)
        splits = decode_splits(n, k, f, sms)[0] if mode == "decode" else None

        def lib(x=x, w=w):
            return torch.matmul(x.reshape(1, n * rows, k), w)

        l_ms, l_cov = device_ms(lib, 20)
        for odt in (torch.bfloat16, torch.float32):
            def kern(x=x, w=w, odt=odt):
                return ops.fused_allgather_matmul(x, w, out_dtype=odt)

            def plain(x=x, w=w, odt=odt):
                return ops.fused_allgather_matmul(x, w, out_dtype=odt,
                                                  backend="torch")

            k_ms, k_cov = device_ms(kern, 20)
            k_wall = wall_ms(kern, 20)
            p_ms, p_cov = device_ms(plain, 5)
            flops = 2 * n * (n * rows) * k * f
            out_bytes = n * n * rows * f * (4 if odt == torch.float32 else 2)
            nbytes = (x.numel() + w.numel()) * 2 + out_bytes
            t_ops = flops / BF16_FLOPS_PER_S
            t_bytes = nbytes / HBM_BYTES_PER_S
            rows_out.append(dict(
                shape=label, n=n, rows=rows, K=k, F=f, out=str(odt)[6:],
                regime=mode, k_splits=splits, ms=k_ms, ms_wall=k_wall, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3, ops_ms=t_ops * 1e3,
                bytes_ms=t_bytes * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes, tflops_per_s=flops / k_ms / 1e9,
                sleep_covered=dict(kernel=k_cov, plain=p_cov,
                                   library=l_cov)))
        del x, w
        torch.cuda.empty_cache()
    return rows_out


def phase_hierarchical(device, gen):
    import tempfile
    t = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tmp = pathlib.Path(d)
        cases_2ph, err_2ph, fault_2ph_grid = _2ph_vs_plain(gen, device)
        cases_mm, errs_mm, rels_mm, fault_mm, edges_mm = _agmm_vs_plain(
            gen, device)
        exact = _hier_exact(device, tmp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        leaves, mm_main, launches = _hier_main_path(device, tmp)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        hier_timing = _hier_time(device, tmp)
        mm_timing = _agmm_time(device, gen)
    total = {k: sum(r[k] for r in hier_timing)
             for k in ("ms", "ms_wall", "plan_ms", "plan_plain_ms",
                       "plain_ms", "library_ms", "bound_ms")}
    emit("hierarchical", grid=f"{HIER_NN}x{HIER_L}", cases_2ph=cases_2ph,
         max_abs_err_2ph=err_2ph, fault_2ph_grid_max_abs_err=fault_2ph_grid,
         cases_agmm=cases_mm, max_abs_err_agmm=errs_mm,
         max_rel_l2_agmm=rels_mm, fault_agmm_rel_l2=fault_mm,
         agmm_regime_edges=edges_mm,
         agmm_rel_tol={str(k)[6:]: v for k, v in AGMM_REL_TOL.items()},
         leaf_rel_tol=LEAF_REL_TOL, exact=exact, leaves=leaves,
         agmm_main=mm_main, launches=launches, peak_gb_main_path=peak_gb,
         gradient_total=total, leaf_shapes=hier_timing,
         agmm_shapes=mm_timing, seconds=round(time.perf_counter() - t, 3))
    return dict(err_2ph=err_2ph, errs_mm=errs_mm, mm_main=mm_main,
                launches=launches, hier_timing=hier_timing,
                mm_timing=mm_timing,
                err_plan=max(r["plan_max_abs_err_plain"] for r in leaves))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,8,9,10,11",
                    help="comma-separated phases to run (default 1-6 and "
                         "8-11; 7 profiles a decode step)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here, before any output,
    # when the script runs outside a checkout of the repository)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    max_err, launches, timing, coll, moe, prefill, hier = (None,) * 7
    if 2 in phases:
        phase_build()
    if 3 in phases:
        max_err = phase_kernel_vs_plain(device, gen)
    if 4 in phases:
        launches = phase_main_path(device)
    if 5 in phases:
        phase_f32_reduced_depth(device)
    if 6 in phases:
        timing = phase_kernel_time(device, gen)
    if 7 in phases:
        phase_profile(device)
    if 8 in phases:
        coll = phase_collectives(device, gen)
    if 9 in phases:
        moe = phase_moe(device, gen)
    if 10 in phases:
        prefill = phase_prefill(device, gen)
    if 11 in phases:
        hier = phase_hierarchical(device, gen)
    kernels = []
    if timing is not None:
        # each main path's per-step launch mix at full occupancy (every
        # plan family at its top bucket): qwen3-1.7b's layer AllReduces
        # and embedding, one logits gather; phi3.5-moe's attention
        # AllReduces and embedding, dispatch and combine per layer, one
        # logits gather. The entry's times are the two paths' means
        # weighted by their launches (phases 4 and 9, each counted from
        # 0); ``by_path`` keeps each path's own
        from repro_torch import configs
        n_layers = configs.get_config(ARCH).n_layers
        mixes = {ARCH: {"layer_allreduce": 2 * n_layers + 1,
                        "logits_allgather": 1},
                 MOE_ARCH: {"layer_allreduce": MOE_LAYERS + 1,
                            "moe_alltoall": 2 * MOE_LAYERS,
                            "logits_allgather": 1}}
        counted = {ARCH: launches, MOE_ARCH: moe[2] if moe else None}
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")
        by_path = {}
        for arch, mix in mixes.items():
            top = {p: max((t for t in timing
                           if t["arch"] == arch and t["plan"] == p),
                          key=lambda t: t["rows"]) for p in mix}
            total = sum(mix.values())
            by_path[arch] = dict(
                launches=counted[arch], launch_mix=mix,
                blocks_per_rank={p: top[p]["blocks_per_rank"] for p in mix},
                threads={p: top[p]["threads"] for p in mix},
                **{k: sum(top[p][k] * c for p, c in mix.items()) / total
                   for k in keys})
        weight = {a: v["launches"] for a, v in by_path.items()
                  if v["launches"]} or {ARCH: 1}
        kernels.append(dict(
            name="dsl_executor", route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES, max_abs_err=max_err,
            launches=(sum(weight.values()) if any(counted.values())
                      else None),
            **{k: sum(by_path[a][k] * w for a, w in weight.items())
               / sum(weight.values()) for k in keys},
            bound_by="bytes",
            blocks_per_rank=sorted({t["blocks_per_rank"] for t in timing}),
            threads=sorted({t["threads"] for t in timing}),
            by_path=by_path, per_shape=timing))
    if hier is not None:
        # the executor's group view on phase 11's path, apart from the
        # decode mixes above: 14 hierarchical replays of 3 launches each.
        # Times are the replays' sums over their launches (the plain
        # executor replaying the same plan files; x.sum(0) expanded), so
        # launches x ms is the path's executor time; ``per_shape`` keeps
        # each leaf's whole replay
        ht = hier["hier_timing"]
        n_hier = hier["launches"]["executor"]
        kernels.append(dict(
            name="dsl_executor_group_view", route="cuda",
            source=KERNEL_SOURCE, replaces=REPLACES, launches=n_hier,
            max_abs_err=hier["err_plan"],
            **{k: sum(r[src] for r in ht) / n_hier
               for k, src in (("ms", "plan_ms"), ("plain_ms", "plan_plain_ms"),
                              ("bound_ms", "bound_ms"),
                              ("library_ms", "library_ms"))},
            bound_by="bytes", grid=f"{HIER_NN}x{HIER_L}",
            launches_per_replay=n_hier // len(ht),
            blocks_per_rank=sorted({b for r in ht
                                    for b in r["plan_blocks_per_rank"]}),
            threads=sorted({t for r in ht for t in r["plan_threads"]}),
            per_shape=[dict(leaf=r["leaf"], replay_ms=r["plan_ms"],
                            plain_replay_ms=r["plan_plain_ms"],
                            bound_ms=r["bound_ms"],
                            library_ms=r["library_ms"],
                            blocks_per_rank=r["plan_blocks_per_rank"],
                            threads=r["plan_threads"]) for r in ht]))
    if coll is not None:
        # the decode-size row of each kernel: the 1PA LL decode AllReduce,
        # the two halves of the decode AllReduce through 2PA, and the
        # logits gather through the ring
        errs, coll_launches, coll_timing = coll
        at = {"all_reduce_1pa": ("decode", True),
              "reduce_scatter_2pa": ("decode", None),
              "all_gather_2pa": ("decode_2pa_half", None),
              "all_gather_ring": ("logits", None)}
        for name, (source, replaces) in COLLECTIVES.items():
            label, ll = at[name]
            row = next(r for r in coll_timing[name]
                       if r["size"] == label and r.get("use_ll") == ll)
            kernels.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=coll_launches.get(name, 0), max_abs_err=errs[name],
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by="bytes",
                library_ms=row["library_ms"]))
    if moe is not None:
        # the decode top bucket: 64 rows per block, (4, 256, 4096) bf16
        a2a_err, a2a_launches, _, a2a_timing = moe
        row = next(r for r in a2a_timing
                   if r["size"] == f"moe_c{_moe_caps()[-1]}")
        kernels.append(dict(
            name="all_to_all", route="cuda", source=A2A_SOURCE,
            replaces=A2A_REPLACES, launches=a2a_launches,
            max_abs_err=a2a_err, ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by="bytes",
            library_ms=row["library_ms"]))
    if prefill is not None:
        # launch-weighted over the main path's forwards: each shape's
        # layers per forward
        fa_err, fa_launches, fa_timing = prefill
        mean = {k: sum(r[k] * r["layers_per_forward"] for r in fa_timing)
                / sum(r["layers_per_forward"] for r in fa_timing)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                          "ops_ms", "bytes_ms")}
        kernels.append(dict(
            name="flash_attention", route="cuda", source=FA_SOURCE,
            replaces=FA_REPLACES, launches=fa_launches, max_abs_err=fa_err,
            **{k: mean[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")},
            bound_by="operations" if mean["ops_ms"] >= mean["bytes_ms"]
            else "bytes", per_shape=fa_timing))
    if hier is not None:
        # launch-weighted over the main path: one 2PH launch per gradient
        # leaf, one AllGather-matmul launch per shape and output type
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")
        ht, mt = hier["hier_timing"], hier["mm_timing"]
        kernels.append(dict(
            name="all_reduce_2ph", route="cuda", source=AR2PH_SOURCE,
            replaces=AR2PH_REPLACES,
            launches=hier["launches"]["all_reduce_2ph"],
            max_abs_err=hier["err_2ph"],
            **{k: sum(r[k] for r in ht) / len(ht) for k in keys},
            bound_by="bytes", per_shape=ht))
        mean = {k: sum(r[k] for r in mt) / len(mt)
                for k in keys + ("ops_ms", "bytes_ms")}
        kernels.append(dict(
            name="allgather_matmul", route="cuda", source=AGMM_SOURCE,
            replaces=AGMM_REPLACES,
            launches=hier["launches"]["allgather_matmul"],
            max_abs_err=max(r["max_abs_err"] for r in hier["mm_main"]),
            **{k: mean[k] for k in keys},
            bound_by="operations" if mean["ops_ms"] >= mean["bytes_ms"]
            else "bytes", per_shape=mt))
    emit("total", seconds=time.perf_counter() - t0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(RECORD, kernels=kernels), indent=1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
