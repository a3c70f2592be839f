"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro.train.optimizer``): functions over trees of tensors, no
``torch.optim``.

The state is ``{"mu", "nu", "count"}``: ``mu`` and ``nu`` are f32
whatever the params' type, ``count`` a 0-d int32 tensor. The schedule,
the bias corrections (``b1 ** count``, a power of f32 tensors) and the
update run in f32 tensors as the reference's do, never in Python
doubles. Leaves are walked in the reference's order
(:mod:`repro_torch.tree`), which orders the global norm's sum.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as tree_lib

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor) as an f32 tensor:
    linear warmup to ``cfg.lr``, then a cosine to 0 at
    ``total_steps``."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * frac))


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm over every leaf, summed leaf by leaf in order."""
    total = None
    for x in tree_lib.leaves(tree):
        s = x.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(every leaf scaled in f32 and cast back to its type, the norm)."""
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)
    return tree_lib.map_leaves(
        lambda x: (x.float() * scale).to(x.dtype), tree), g


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    leaf = tree_lib.leaves(params)[0]
    return {"mu": tree_lib.map_leaves(zeros, params),
            "nu": tree_lib.map_leaves(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adamw_update(cfg: AdamWConfig, params, grads, state, *,
                 donate: bool = False):
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``.

    The grads are clipped to ``cfg.clip_norm`` by their global norm, each
    leaf scaled in f32 and cast back to its type before the update reads
    it (the reference's ``clip_by_global_norm``), one leaf at a time, so
    no clipped copy of the whole tree is held. ``donate=True`` writes the
    new params and moments into the given tensors (the counterpart of the
    reference step's ``donate_argnums``): a step then holds one leaf's
    temporaries beyond its state instead of a second copy of it."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = state["count"] + 1
    lr = cosine_schedule(cfg, count)
    c = count.float()
    one = torch.ones((), dtype=torch.float32, device=c.device)
    bc1 = 1 - torch.pow(one * cfg.b1, c)
    bc2 = 1 - torch.pow(one * cfg.b2, c)

    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(tree_lib.leaves(params), tree_lib.leaves(grads),
                            tree_lib.leaves(state["mu"]),
                            tree_lib.leaves(state["nu"])):
        g32 = (g.float() * scale).to(g.dtype).float()
        m = cfg.b1 * mu + (1 - cfg.b1) * g32
        v = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g32)
        del g32
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        q = (p.float() - lr * step).to(p.dtype)
        del step
        if donate:
            p.copy_(q)
            mu.copy_(m)
            nu.copy_(v)
            q, m, v = p, mu, nu
        new_p.append(q)
        new_mu.append(m)
        new_nu.append(v)
    if donate:
        state["count"].copy_(count)
        count = state["count"]
    return (tree_lib.unflatten(params, new_p),
            {"mu": tree_lib.unflatten(state["mu"], new_mu),
             "nu": tree_lib.unflatten(state["nu"], new_nu),
             "count": count},
            {"grad_norm": gnorm, "lr": lr})
