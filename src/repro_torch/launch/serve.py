"""Serving launcher: batched prefill + decode for any decode-capable
arch (port of ``repro.launch.serve``), on the CUDA card by default::

    python -m repro_torch.launch.serve --arch qwen3-1.7b --tp 4 \\
        --mode explicit [--kv-quant] [--layers 4]

With ``--replicas N`` it runs the continuous-batching stack instead: N
engine replicas of ``--tp`` ranks each, every one started from the SAME
exported plan-file set (``--plan-dir`` keeps the artifact), behind the
least-loaded router, driven by the reference's seeded virtual-clock
request trace::

    python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \\
        --replicas 2 --tp 2 --mode explicit --requests 20

Weights are ``transformer.init_params`` from a seeded ``torch.Generator``
(seed 0, as the reference's ``jax.random.key(0)``; the numbers differ).
``--device cpu`` runs the plain path on the CPU (the tests do);
``--layers N`` cuts the model to N layers at full width. The reference's
``--dp`` has no counterpart: a replica's TP ranks are stacked on one
card and a replica has no data axis (``distributed.step.local_batch``);
data parallelism is the router's replicas (``--replicas``).
:func:`main` takes ``argv`` so that a caller can run it in-process.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.mesh import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a decode-capable arch on the port.")
    ap.add_argument("--arch", required=True, choices=sorted(configs._MODULES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (full width)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-kv", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--mode", choices=("auto", "explicit"), default="auto",
                    help="decode partitioning: the unsharded step (auto) "
                         "or the explicit-TP plan-replay hot path (§5.2)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache with per-token scales (both modes; "
                         "explicit keeps scales rank-replicated next to "
                         "the cache)")
    ap.add_argument("--replicas", type=int, default=0,
                    help=">=1: run the continuous-batching router over N "
                         "plan-file replicas instead of the one-shot "
                         "prefill+decode path")
    ap.add_argument("--requests", type=int, default=20,
                    help="router path: synthetic requests to serve")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="router path: Poisson arrival rate (requests per "
                         "virtual second)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-dir", default=None,
                    help="router path: where to export/load the shared "
                         "plan-file set (default: a temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the plain path)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    cfg = configs.get_config(args.arch)
    if cfg.family == "encoder":
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    if args.reduced:
        cfg = configs.reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = resolve_device(args.device)
    params = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    scfg = ServeConfig(batch=args.batch, max_kv=args.max_kv,
                       temperature=args.temperature, mode=args.mode,
                       kv_quant=args.kv_quant)
    if args.replicas >= 1:
        return _serve_router(cfg, scfg, params, device, args)

    eng = Engine(cfg, params, scfg, tp=args.tp, device=device)
    del params
    if args.mode != eng.mode:
        print(f"note: mode={args.mode} unavailable, running {eng.mode}")
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)

    _sync(device)
    t0 = time.perf_counter()
    logits = eng.prefill(prompts)
    _sync(device)
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng.decode(logits, num_tokens=args.tokens)
    _sync(device)
    t_dec = time.perf_counter() - t0
    rep = eng.plan_report()
    print(f"arch={cfg.name} mode={eng.mode} prefill {t_pre*1e3:.0f}ms, "
          f"decode {t_dec/args.tokens*1e3:.1f}ms/token × {args.batch} seqs "
          f"(pred comm {rep['predicted_comm_us_per_token']}us/token)")
    print("seq0:", out[0][:12].tolist())
    return 0


def _serve_router(cfg, scfg, params, device, args) -> int:
    """The continuous-batching path: plan once → export → N replicas
    load the same files → the seeded virtual-clock trace through the
    least-loaded router."""
    from repro_torch.serve.router import build_replicas
    from repro_torch.serve.scheduler import Request

    plan_dir = args.plan_dir or tempfile.mkdtemp(prefix="repro_plan_set_")
    router = build_replicas(cfg, scfg, n_replicas=args.replicas, tp=args.tp,
                            plan_dir=plan_dir, params=params, mode=args.mode,
                            device=device)
    rng = np.random.RandomState(args.seed)
    t, pending = 0.0, deque()
    for i in range(args.requests):
        t += rng.exponential(1.0 / args.rate)
        plen = int(min(rng.zipf(1.5), args.prompt_len))
        pending.append(Request(
            rid=i, prompt=rng.randint(0, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=args.tokens, arrival_s=t,
            temperature=args.temperature, seed=i))

    step_s = 0.05
    _sync(device)
    t0 = time.perf_counter()
    while pending or router.outstanding():
        while pending and pending[0].arrival_s <= router.now:
            router.submit(pending.popleft())
        if router.n_active == 0 and router.outstanding() == 0 and pending:
            router.advance_to(pending[0].arrival_s)
            continue
        info = router.tick()
        router.advance(step_s * (1 + info.micro_steps))
    _sync(device)
    wall = time.perf_counter() - t0

    m = router.metrics()
    rep = router.plan_report()
    print(f"arch={cfg.name} router: {args.replicas} replicas x "
          f"tp={args.tp} modes={rep['modes']} degraded={rep['degraded']} "
          f"(plans from {plan_dir})")
    print(f"served {m['completed']}/{args.requests} requests "
          f"({m['dropped']} dropped), {m['tokens']} tokens at "
          f"{m['tokens_per_vs']} tok/vs; ttft_vs p50={m['ttft_vs']['p50']:.3f} "
          f"p95={m['ttft_vs']['p95']:.3f}; bucket_steps={m['bucket_steps']} "
          f"[{wall:.1f}s wall]")
    for rid in sorted(router.streams)[:1]:
        print(f"req{rid}:", router.streams[rid][:12])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
