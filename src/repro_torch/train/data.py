"""Deterministic, resumable data pipeline (port of ``repro.train.data``).

Counter-based: ``batch_at(step)`` is a pure function of ``(seed,
step)``, so a restart from a checkpoint resumes the exact token stream
with no state file. Two sources:

* :class:`SyntheticLM`, the reference's stream bit for bit: its keys
  ``fold_in(key(seed), step)`` and its ``randint``/``normal`` draws are
  :mod:`repro_torch.prng`'s copies of ``jax.random``;
* :class:`MemmapTokens`, ``.bin`` shards of uint16 tokens read at
  ``RandomState(seed + step)``'s offsets, as in the reference.

Batches are int32 ``tokens`` and ``labels`` tensors (float32 frame
embeddings as ``tokens`` for a frontend arch) on the CPU; the train step
moves them to its device.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import prng

__all__ = ["DataConfig", "SyntheticLM", "MemmapTokens", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    path: Optional[str] = None      # None -> synthetic
    embedded_dim: int = 0           # >0 -> frontend-stub float inputs


class SyntheticLM:
    """Uniform synthetic tokens; labels = next token of the same
    stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        key = prng.fold_in(prng.key(cfg.seed), step)
        if cfg.embedded_dim:
            k1, k2 = prng.split(key)
            tokens = prng.normal(k1, (cfg.batch, cfg.seq_len,
                                      cfg.embedded_dim))
            labels = prng.randint(k2, (cfg.batch, cfg.seq_len), 0, cfg.vocab)
            return dict(tokens=tokens, labels=labels)
        stream = prng.randint(key, (cfg.batch, cfg.seq_len + 1), 0,
                              cfg.vocab)
        return dict(tokens=stream[:, :-1], labels=stream[:, 1:])


class MemmapTokens:
    """Token shards on disk; deterministic strided reads by step
    index."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        paths = sorted(Path(cfg.path).glob("*.bin"))
        if not paths:
            raise FileNotFoundError(f"no .bin shards under {cfg.path}")
        self.shards = [np.memmap(p, dtype=np.uint16, mode="r") for p in paths]
        self.total = sum(s.size for s in self.shards)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        span = cfg.seq_len + 1
        rng = np.random.RandomState(cfg.seed + step)
        toks = np.empty((cfg.batch, span), np.int32)
        for i in range(cfg.batch):
            shard = self.shards[(step * cfg.batch + i) % len(self.shards)]
            start = rng.randint(0, max(shard.size - span, 1))
            toks[i] = np.asarray(shard[start:start + span], np.int32) % cfg.vocab
        toks = torch.from_numpy(toks)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:])


def make_pipeline(cfg: DataConfig):
    return MemmapTokens(cfg) if cfg.path else SyntheticLM(cfg)
