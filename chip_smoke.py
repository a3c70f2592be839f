#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                # every phase; needs one CUDA card
    python3 chip_smoke.py --phases 1,2,3 # device, build, kernel checks only
    python3 chip_smoke.py --phases 1,2,9 # build, then the MoE slice

Phases, each printing one JSON line (any failure raises, exit != 0):

1. device — the card's name, and name + power limit from nvidia-smi;
2. build — compiles every kernel of ``src/repro_torch/csrc`` into
   ``build/`` (one nvcc per source, started together);
3. kernel vs plain — the DSL-executor kernel against ``TorchExecutor``
   on the card, bit-equal in f32 and bf16, over every registry entry ×
   n in {2, 4, 8} × O0-O3, and the decode plans of qwen3-1.7b and of
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
   yardstick;
7. (opt-in, ``--phases 7``) a ``torch.profiler`` breakdown of one
   decode step in each mode, for the main paths of phases 4 and 9:
   device busy share and the top kernels;
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
   time at the MoE sizes and over the per-rank sweep at n=4.

The last lines are the card's nvidia-smi line, one ``{"kernels": [...]}``
JSON object, and ``{"ok": true, "device": {...}}``. The whole record
also goes to ``chiprun_out/chip_smoke.json``.
The kernels line holds one entry per kernel. The executor's times are
the launch-weighted mean of both main paths' decode mixes, each path's
own under ``by_path`` and every shape's under ``per_shape``; the other
kernels' per-shape times are in the phase lines.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
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
    ptxas = [ln.strip() for b in build.last_build.values()
             for ln in b["log"].splitlines() if "registers" in ln]
    emit("build", seconds=round(time.perf_counter() - t, 3),
         libraries=sorted(str(p.relative_to(ROOT)) if p.is_relative_to(ROOT)
                          else str(p) for p in libs.values()),
         ptxas=ptxas)


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
    from repro_torch.core.executor import OPCODES, CudaExecutor, TorchExecutor
    cases, max_err = 0, 0.0
    for name in sorted(algorithms.REGISTRY):
        for n in (2, 4, 8):
            for lvl in range(4):
                prog = passes.optimize(algorithms.REGISTRY[name](n), lvl, n)
                n_in = prog.chunks[prog.in_buffer]
                kern = CudaExecutor(prog).prepare(n)
                plain = TorchExecutor(prog, vectorize=lvl > 0).prepare(n)
                # (2, 40): aligned 16-byte vector path; (1, 13): odd
                # chunk sizes, so later chunks take the scalar path
                for rows, cols in ((2, 40), (1, 13)):
                    for dtype in (torch.float32, torch.bfloat16):
                        x = torch.randn(n, n_in * rows, cols, generator=gen,
                                        device=device).to(dtype)
                        got, want = kern(x), plain(x)
                        torch.cuda.synchronize()
                        max_err = max(max_err, (got.float() - want.float())
                                      .abs().max().item())
                        check(torch.equal(got, want),
                              f"kernel != plain: {name} n={n} O{lvl} "
                              f"{dtype} ({rows}x{cols})")
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
                               table=list(enc.ops.shape),
                               flag_slots=enc.n_flags,
                               puts_per_rank=int((enc.ops[0, :, 0]
                                                  == OPCODES["put"]).sum())))
    emit("kernel_vs_plain", cases=cases, max_abs_err=max_err,
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
    written once), the plain version and the one-call yardstick."""
    from repro_torch.core.executor import TorchExecutor

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
            rows_out.append(dict(
                arch=arch, plan=pname, algo=plan.algo, rows=b,
                cols=plan.shape[1], dtype=plan.dtype, ms=k_ms,
                ms_wall=wall_ms(lambda: ex(x), 200), plain_ms=p_ms,
                library_ms=l_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bytes=nbytes, sleep_covered=bool(k_cov and p_cov and l_cov)))
    emit("kernel_time", shapes=rows_out)
    return rows_out


def phase_profile(device):
    """Opt-in (``--phases 7``): where one decode step's time goes —
    ``torch.profiler`` over 4 steps of each mode at each main path's
    shape (qwen3-1.7b, phase 4; phi3.5-moe at 8 layers, phase 9); device
    busy share = summed kernel time over the steps' wall time, with and
    without the profiler, and the kernels that take most of it."""
    from torch.autograd import DeviceType
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
            rows = []
            for e in prof.key_averages():
                # device-side kernel events only: a CPU op's self device
                # time repeats the kernels it launched
                if (e.device_type == DeviceType.CUDA
                        and e.self_device_time_total):
                    rows.append((e.self_device_time_total / steps,
                                 e.count // steps, e.key))
            rows.sort(reverse=True)
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
         **out)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,8,9",
                    help="comma-separated phases to run (default 1-6, 8 "
                         "and 9; 7 profiles a decode step)")
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
    max_err, launches, timing, coll, moe = None, None, None, None, None
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
            bound_by="bytes", by_path=by_path, per_shape=timing))
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
    emit("total", seconds=time.perf_counter() - t0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
