"""Training loop (port of ``repro.train.loop``): checkpoint/restart,
straggler watchdog, elastic re-ranking.

* **Checkpoint/restart** — async checkpoints every ``ckpt_every`` steps;
  on (re)start the loop resumes from the latest manifest and the
  counter-based data pipeline replays the exact stream.
* **Elastic re-ranking** — a checkpoint holds one copy of the params and
  the optimizer state, whatever the DP grid, so ``run()`` resumes on any
  DP axes whose ranks divide the batch (a 2 x 4 grid's checkpoint
  resumes on DP 4).
* **Straggler watchdog** — a wall-clock time per step (it waits for the
  loss on the host, the counterpart of ``block_until_ready``); steps
  slower than ``straggler_factor`` x the rolling median are logged and
  counted.

The result holds the per-step losses, gradient norms and wall seconds,
the final params and optimizer state, the straggler count, the mean step
time and each DP communicator's plan counters (``plan_stats``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.distributed.step import init_sharded, make_train_step
from repro_torch.mesh import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt

__all__ = ["TrainConfig", "run"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_n: int = 3
    log_every: int = 10
    mode: str = "auto"                 # 'auto' | 'explicit'
    dp_backend: Optional[str] = None   # explicit mode; None: the device's
    straggler_factor: float = 3.0
    seed: int = 0
    remat_policy: str = "none"
    fixed_batch: bool = False          # overfit batch_at(0) (tests)


def run(cfg: ModelConfig, dp_axes, train_cfg: TrainConfig,
        opt_cfg: Optional[opt.AdamWConfig] = None, *,
        params: Optional[dict] = None, device: DeviceLike = None,
        log_fn: Callable[[str], None] = print) -> dict:
    """Train ``cfg`` over the DP axes ``dp_axes`` (``RankAxis`` es,
    outermost first, naming the device; else ``device``, default the
    CUDA card). ``params`` starts from the given weights (the step updates
    them in place) instead of ``init_sharded``'s seeded ones."""
    opt_cfg = opt_cfg or opt.AdamWConfig(
        total_steps=train_cfg.steps,
        warmup_steps=max(1, train_cfg.steps // 10))
    # the loop owns the planning objects (paper §4.4/§5.2: set up a
    # communicator once, compile plans, replay them every step); their
    # plan-cache stats come back in the result
    step_fn = make_train_step(
        cfg, dp_axes, opt_cfg, mode=train_cfg.mode,
        global_batch=train_cfg.global_batch, seq_len=train_cfg.seq_len,
        remat_policy=train_cfg.remat_policy,
        dp_backend=train_cfg.dp_backend, device=device)

    pipeline = data_lib.make_pipeline(data_lib.DataConfig(
        vocab=cfg.vocab, batch=train_cfg.global_batch,
        seq_len=train_cfg.seq_len, seed=train_cfg.seed,
        embedded_dim=cfg.d_model if cfg.frontend != "none" else 0))

    if params is None:
        params, opt_state = init_sharded(cfg, device=step_fn.device,
                                         optimizer_cfg=opt_cfg)
    else:
        opt_state = opt.adamw_init(params)
    start = 0
    if train_cfg.ckpt_dir and ckpt.latest_step(train_cfg.ckpt_dir) is not None:
        restored, start = ckpt.restore(train_cfg.ckpt_dir,
                                       {"params": params, "opt": opt_state})
        # the restored tree replaces the initial one: nothing else holds
        # the initial tensors, so they go back to the allocator here
        params, opt_state = restored["params"], restored["opt"]
        del restored
        log_fn(f"[ckpt] resumed from step {start}")

    losses, gnorms, durs, stragglers = [], [], [], 0
    for step in range(start, train_cfg.steps):
        batch = pipeline.batch_at(0 if train_cfg.fixed_batch else step)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.perf_counter() - t0
        durs.append(dt)
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        # straggler watchdog on the rolling median
        if len(durs) >= 5:
            med = float(np.median(durs[-50:]))
            if dt > train_cfg.straggler_factor * med:
                stragglers += 1
                log_fn(f"[straggler] step {step}: {dt:.3f}s vs median "
                       f"{med:.3f}s")
        if step % train_cfg.log_every == 0:
            log_fn(f"step {step}: loss={loss:.4f} "
                   f"gnorm={gnorms[-1]:.3f} "
                   f"{dt * 1e3:.0f}ms")
        if (train_cfg.ckpt_dir and step > start
                and step % train_cfg.ckpt_every == 0):
            ckpt.save_async(train_cfg.ckpt_dir, step,
                            {"params": params, "opt": opt_state},
                            keep_n=train_cfg.keep_n)
    if train_cfg.ckpt_dir:
        ckpt.wait_pending()
        ckpt.save(train_cfg.ckpt_dir, train_cfg.steps,
                  {"params": params, "opt": opt_state},
                  keep_n=train_cfg.keep_n)
    return dict(losses=losses, grad_norms=gnorms, step_s=durs,
                params=params, opt_state=opt_state, stragglers=stragglers,
                mean_step_s=float(np.mean(durs[1:])) if len(durs) > 1
                else None,
                plan_stats=step_fn.plan_stats())
