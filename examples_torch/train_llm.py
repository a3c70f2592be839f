"""End-to-end training driver on the port: a ~100M-parameter llama-style
model, data-parallel over DP = 2 ranks stacked on one card, the MSCCL++
stack on the gradient-reduction critical path (``--mode explicit``:
every gradient leaf reduced by a compiled AllReduce plan replayed on the
hand-written executor kernel), checkpoints every 50 steps, and a run
that resumes from the latest checkpoint in ``--ckpt-dir``.

    PYTHONPATH=src python examples_torch/train_llm.py --steps 300    # the real run
    PYTHONPATH=src python examples_torch/train_llm.py --steps 5 --tiny --device cpu

Weights are ``init_sharded``'s, from seed 0. Departures from
``examples/train_llm.py``: the reference's TP 4 is not ported by design
(the port's trainer computes each DP rank's model whole); and the
reference's fallback to auto where partial-manual ``shard_map`` is
missing has no counterpart, since explicit mode runs on the card. The
default checkpoint directory is a new temporary one, so a run resumes
only from a ``--ckpt-dir`` it is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional, Sequence

from repro_torch.mesh import RankAxis, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt

DP = 2


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="llama-100m", family="dense",
        n_layers=10, d_model=640, n_heads=10, n_kv_heads=5, head_dim=64,
        d_ff=2560, vocab=32000, max_seq=2048, dtype="float32",
    )


def tiny(cfg: ModelConfig) -> ModelConfig:
    """The smoke-run shrink of ``--tiny`` (the reference's)."""
    return dataclasses.replace(cfg, n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, head_dim=32, d_ff=256,
                               vocab=1024)


def main(argv: Optional[Sequence[str]] = None, *,
         params: Optional[dict] = None) -> dict:
    """``params``: starting weights in the reference layout instead of the
    seeded ones (the tests carry the reference's across)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from when it holds "
                         "one (default: a new temporary directory)")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the model for a smoke run")
    ap.add_argument("--mode", default="explicit",
                    choices=["auto", "explicit"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_100m()
    if args.tiny:
        cfg = tiny(cfg)
    n_params = cfg.param_count()
    print(f"model: {cfg.name}  params≈{n_params/1e6:.0f}M  mode={args.mode}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix="repro_torch_train_llm_")
    resumed_from = ckpt.latest_step(ckpt_dir)
    res = train_loop.run(
        cfg, (RankAxis("data", DP, device),),
        train_loop.TrainConfig(
            steps=args.steps, global_batch=args.batch, seq_len=args.seq,
            ckpt_dir=ckpt_dir, ckpt_every=50, log_every=10,
            mode=args.mode),
        opt_cfg=opt.AdamWConfig(lr=3e-4, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 1)),
        params=params, device=device)
    if res["losses"]:
        mean = res["mean_step_s"]
        print(f"final loss: {res['losses'][-1]:.4f}  "
              f"mean step: {'-' if mean is None else f'{mean:.3f}s'}  "
              f"stragglers: {res['stragglers']}")
    else:
        print(f"nothing to train: {ckpt_dir} holds step {resumed_from}")
    if res["plan_stats"]:
        # explicit mode: the DP communicators' compile-once record —
        # every gradient shape planned exactly once, then replayed
        print(f"dp plan caches: {res['plan_stats']}")
    return dict(device=str(device), model=cfg.name, n_params=n_params,
                mode=args.mode, dp=DP, ckpt_dir=ckpt_dir,
                resumed_from=resumed_from, saved=ckpt.latest_step(ckpt_dir),
                losses=res["losses"], grad_norms=res["grad_norms"],
                mean_step_s=res["mean_step_s"],
                stragglers=res["stragglers"], plan_stats=res["plan_stats"])


if __name__ == "__main__":
    main()
