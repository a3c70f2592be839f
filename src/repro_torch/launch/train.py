"""Training launcher (port of ``repro.launch.train``), on the CUDA card by
default::

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --steps 50 --batch 8 --seq 128 --mode explicit --dp 8 --nodes 2

``--dp`` DP ranks stacked on the card; ``--nodes N`` splits them into a
node-major grid of N nodes of ``dp / N`` ranks (two DP axes, ``pod`` and
``data``), whose explicit mode reduces every gradient leaf through the
hierarchical 2PH plans, where one axis takes one flat AllReduce plan.
Weights are ``init_sharded``'s, from seed 0 (the reference's
``jax.random.key(0)``; the numbers differ). ``--device cpu`` runs the
plain path on the CPU (the tests do).

The reference's ``--tp`` has no counterpart: the reference leaves tensor
parallelism to GSPMD inside its step, and the port's trainer computes
each DP rank's model whole. :func:`main` takes ``argv`` so that a caller
can run it in-process.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch import configs
from repro_torch.mesh import RankAxis, resolve_device
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train an arch data-parallel on the port (no --tp: the "
                    "trainer computes each DP rank's model whole).")
    ap.add_argument("--arch", required=True, choices=sorted(configs._MODULES))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dp", type=int, default=2,
                    help="DP ranks, stacked on the card")
    ap.add_argument("--nodes", type=int, default=1,
                    help="split the DP ranks into this many nodes (two DP "
                         "axes: hierarchical 2PH gradient reduction)")
    ap.add_argument("--mode", default="auto", choices=["auto", "explicit"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain path)")
    return ap


def dp_axes(dp: int, nodes: int, device) -> tuple:
    """The DP axes of ``dp`` ranks over ``nodes`` nodes: ``()`` for one
    rank, one ``data`` axis for one node, else ``(pod, data)``."""
    if dp < 1 or nodes < 1 or dp % nodes:
        raise SystemExit(f"--dp {dp} does not split over --nodes {nodes}")
    if dp == 1:
        return ()
    if nodes == 1:
        return (RankAxis("data", dp, device),)
    return (RankAxis("pod", nodes, device),
            RankAxis("data", dp // nodes, device))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    device = resolve_device(args.device)
    axes = dp_axes(args.dp, args.nodes, device)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"mesh=({args.nodes},{args.dp // args.nodes}) mode={args.mode}")
    res = train_loop.run(
        cfg, axes,
        train_loop.TrainConfig(
            steps=args.steps, global_batch=args.batch, seq_len=args.seq,
            mode=args.mode, ckpt_dir=args.ckpt_dir, log_every=10),
        opt_cfg=opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 1)),
        device=device)
    mean = res["mean_step_s"]
    print(f"final loss {res['losses'][-1]:.4f} "
          f"({'-' if mean is None else f'{mean:.2f}'}s/step, "
          f"{res['stragglers']} stragglers)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
