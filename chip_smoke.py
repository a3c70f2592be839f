#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                # every phase; needs one CUDA card
    python3 chip_smoke.py --phases 1,2,3 # device, build, kernel checks only

Phases, each printing one JSON line (any failure raises, exit != 0):

1. device — the card's name, and name + power limit from nvidia-smi;
2. build — compiles every kernel of ``src/repro_torch/csrc`` into
   ``build/`` (one nvcc per source, started together);
3. kernel vs plain — the DSL-executor kernel against ``TorchExecutor``
   on the card, bit-equal in f32 and bf16, over every registry entry ×
   n in {2, 4, 8} × O0-O3 and the decode shapes of qwen3-1.7b at TP 2/4;
4. main path — full-width qwen3-1.7b (28 layers, seeded random bf16
   weights), TP=4 stacked on the card: 8 requests of 16-token prompts,
   then 32 greedy tokens, in auto and in explicit mode. Explicit must
   run on the kernel with exactly 58 launches per step and match auto's
   first-step logits within the stated bf16 tolerance;
5. f32 at full width, 4 layers: explicit and auto greedy tokens equal
   over 16 steps;
6. kernel time at each decode shape beside its HBM bound, the plain
   version and a one-call PyTorch yardstick;
7. (opt-in, ``--phases 7``) a ``torch.profiler`` breakdown of one
   decode step in each mode: device busy share and the top kernels;
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
   its HBM bound, its plain version and a one-call PyTorch yardstick.

The last lines are the card's nvidia-smi line, one ``{"kernels": [...]}``
JSON object, and ``{"ok": true, "device": {...}}``. The whole record
also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
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


def phase_kernel_vs_plain(device, gen):
    from repro_torch.core import algorithms, passes
    from repro_torch.core.executor import CudaExecutor, TorchExecutor
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
    for tp, plans in _decode_plans(device).items():
        for pname, bp in plans.items():
            for b, plan in bp.plans.items():
                plain = TorchExecutor(plan.program).prepare(tp)
                for rep in range(3):        # replays reuse flags + scratch
                    x = torch.randn((tp,) + plan.shape, generator=gen,
                                    device=device).to(plan.executor._bound[2])
                    got, want = plan(x), plain(x)
                    torch.cuda.synchronize()
                    max_err = max(max_err, (got.float() - want.float())
                                  .abs().max().item())
                    check(torch.equal(got, want), f"kernel != plain: {pname} "
                          f"tp={tp} rows={b} rep={rep}")
                    cases += 1
                shapes.append(dict(plan=pname, tp=tp, rows=b,
                                   cols=plan.shape[1], dtype=plan.dtype,
                                   algo=plan.algo, opt_level=plan.opt_level))
    emit("kernel_vs_plain", cases=cases, max_abs_err=max_err,
         decode_shapes=shapes)
    return max_err


def _run_engine(cfg, params, prompts, mode, n_decode, count_launches):
    """Serve ``prompts`` then ``n_decode`` greedy tokens; returns the
    first step's logits, the last prefill logits, the tokens, ms/token
    of the decode loop and the kernel launches seen per step."""
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
    """Per decode shape of the TP=4 main path: the kernel's device time
    per launch, its HBM bound (each input read once, each output written
    once), the plain version and the one-call yardstick."""
    from repro_torch.core.executor import TorchExecutor
    plans = _decode_plans(device)[TP]
    rows_out = []
    for pname, bp in plans.items():
        for b, plan in bp.plans.items():
            ex = plan.executor
            dtype = ex._bound[2]
            x = torch.randn((TP,) + plan.shape, generator=gen,
                            device=device).to(dtype)
            plain = TorchExecutor(plan.program).prepare(TP)
            n_out = plan.program.chunks[plan.program.out_buffer]
            nbytes = (x.numel() + x.numel() * n_out) * x.element_size()
            if pname == "layer_allreduce":
                def lib(x=x):
                    return x.sum(0, keepdim=True).expand_as(x).contiguous()
            else:
                def lib(x=x):
                    return x.reshape(1, -1, x.shape[-1]).expand(
                        TP, TP * x.shape[1], x.shape[-1]).contiguous()
            k_ms, k_cov = device_ms(lambda: ex(x), 200)
            p_ms, p_cov = device_ms(lambda: plain(x), 50)
            l_ms, l_cov = device_ms(lib, 200)
            rows_out.append(dict(
                plan=pname, algo=plan.algo, rows=b, cols=plan.shape[1],
                dtype=plan.dtype, ms=k_ms, ms_wall=wall_ms(lambda: ex(x), 200),
                plain_ms=p_ms, library_ms=l_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
                sleep_covered=bool(k_cov and p_cov and l_cov)))
    emit("kernel_time", shapes=rows_out)
    return rows_out


def phase_profile(device):
    """Opt-in (``--phases 7``): where one decode step's time goes —
    ``torch.profiler`` over 4 steps of each mode at the main path's
    shape; device busy share = summed kernel time over the steps' wall
    time, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = configs.get_config(ARCH)
    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(0), device=device)
    tok = torch.zeros(BATCH, dtype=torch.long, device=device)
    out = {}
    for mode in ("auto", "explicit"):
        eng = Engine(cfg, params, ServeConfig(batch=BATCH, max_kv=MAX_KV),
                     tp=TP, mode=mode)
        for _ in range(PROMPT):                # warm, and fill the cache
            eng._run_step(tok)
            eng.pos += 1
        torch.cuda.synchronize()
        steps = 4
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
            # device-side kernel events only: a CPU op's self device time
            # repeats the kernels it launched
            if e.device_type == DeviceType.CUDA and e.self_device_time_total:
                rows.append((e.self_device_time_total / steps,
                             e.count // steps, e.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        out[mode] = dict(
            step_wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_busy_share=busy_ms / wall_ms if rows else None,
            top_kernels=[dict(name=k[:90], us_per_step=us, launches=c)
                         for us, c, k in rows[:12]])
        del eng
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,8",
                    help="comma-separated phases to run (default 1-6 and "
                         "8; 7 profiles a decode step)")
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
    max_err, launches, timing, coll = None, None, None, None
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
    kernels = []
    if timing is not None:
        # the main path's per-step launch mix at full occupancy: every
        # layer AllReduce and the embedding at the top bucket, one logits
        # gather
        from repro_torch import configs
        n_layers = configs.get_config(ARCH).n_layers
        top = {t["plan"]: t for t in timing if t["rows"] == BATCH}
        mix = {"layer_allreduce": 2 * n_layers + 1, "logits_allgather": 1}
        total = sum(mix.values())

        def mean(key):
            return sum(top[p][key] * k for p, k in mix.items()) / total

        kernels.append(dict(
            name="dsl_executor", route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES, launches=launches, max_abs_err=max_err,
            ms=mean("ms"), plain_ms=mean("plain_ms"),
            bound_ms=mean("bound_ms"), bound_by="bytes",
            library_ms=mean("library_ms"),
            per_shape=timing))
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
                library_ms=row["library_ms"], per_shape=coll_timing[name]))
    RECORD["seconds"] = time.perf_counter() - t0
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
