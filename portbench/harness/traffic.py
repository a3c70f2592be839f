"""The one traffic generator every mix goes through: a traffic file's
parameters in, the run's requests out.

Every seed draws from the same pool in another order. The sizes of a
mix's ``pool`` of requests (prompt and output lengths, which shared
prefix a prompt opens with) and the gaps between arrivals are drawn once
from a generator seeded by the file's ``base_seed``, so they are a
property of the mix; the run's ``--seed`` permutes the whole pool (and
the gaps) and draws the token ids. The part of the pool a window reaches
differs from seed to seed as a deployment's traffic does, and the
bounds are set from the spread that gives.

The arithmetic is that of the program's ``serve/loadgen.py``
``synth_trace`` (exponential gaps of a Poisson process, uniform token
ids, prompts opening with a prefix from a Zipf-skewed pool), with
lognormal and uniform lengths besides its Zipf ones, run on the wall
clock by a driver (``drivers/<kind>.py``) instead of the scheduler's
virtual clock.

A traffic file::

    {"driver": "closed" | "open",
     "clients": 64,                       # closed loop
     "arrivals": {"dist": "exponential", "rate_rps": 3.0},   # open loop
     "pool": 1024, "base_seed": 0,
     "prompt": {"dist": "lognormal", "median": 128, "sigma": 1.0,
                "min": 16, "max": 1024},
     "output": {"dist": "uniform", "min": 128, "max": 512},
     "prefix": {"pool": 4, "len": 1024, "zipf_a": 1.2}}      # optional

Distributions: ``lognormal`` (median, sigma), ``uniform`` (min, max,
integers), ``zipf`` (a), ``exponential`` (rate_rps) and ``gamma``
(rate_rps, shape: under 1 is burstier than Poisson); ``min``/``max``
clamp any of them.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Req:
    """One request of the mix: its prompt's token ids and the tokens it
    asks for (greedy)."""
    prompt: np.ndarray
    max_new: int


def _draw(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    kind = spec["dist"]
    if kind == "lognormal":
        x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    elif kind == "uniform":
        x = rng.integers(spec["min"], spec["max"] + 1, size=n)
    elif kind == "zipf":
        x = rng.zipf(spec["a"], size=n)
    elif kind == "exponential":
        x = rng.exponential(1.0 / spec["rate_rps"], size=n)
    elif kind == "gamma":
        shape = spec["shape"]
        x = rng.gamma(shape, 1.0 / (shape * spec["rate_rps"]), size=n)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(x, spec.get("min", -np.inf), spec.get("max", np.inf))


def _sizes(traffic: dict) -> tuple:
    """(prompt lengths, output lengths, prefix index or -1) of the pool,
    the same for every seed."""
    n = int(traffic["pool"])
    rng = np.random.default_rng(int(traffic.get("base_seed", 0)))
    plen = np.rint(_draw(traffic["prompt"], n, rng)).astype(np.int64)
    olen = np.rint(_draw(traffic["output"], n, rng)).astype(np.int64)
    pre = traffic.get("prefix")
    which = (((rng.zipf(pre["zipf_a"], size=n) - 1) % pre["pool"])
             if pre else np.full(n, -1))
    return np.maximum(plen, 1), np.maximum(olen, 1), which


def longest(traffic: dict) -> int:
    """The most positions one request of the mix can fill: its longest
    prompt (shared prefix included) plus its longest output."""
    plen, olen, which = _sizes(traffic)
    pre = traffic.get("prefix")
    plen = plen + (np.where(which >= 0, pre["len"], 0) if pre else 0)
    return int((plen + olen).max())


def requests(traffic: dict, vocab: int, seed: int) -> list:
    """The pool's requests in the order ``seed`` gives them, with token
    ids drawn from ``seed``."""
    plen, olen, which = _sizes(traffic)
    rng = np.random.default_rng(seed)
    order = rng.permutation(int(traffic["pool"]))
    pre = traffic.get("prefix")
    shared = [rng.integers(0, vocab, size=pre["len"]).astype(np.int32)
              for _ in range(pre["pool"])] if pre else []
    out = []
    for i in order:
        prompt = rng.integers(0, vocab, size=int(plen[i])).astype(np.int32)
        if which[i] >= 0:
            prompt = np.concatenate([shared[which[i]], prompt])
        out.append(Req(prompt=prompt, max_new=int(olen[i])))
    return out


def arrivals(traffic: dict, seed: int) -> np.ndarray:
    """An open loop's due times in seconds from the window's start: the
    pool's gaps, the same set for every seed, in the order ``seed``
    gives them."""
    n = int(traffic["pool"])
    gaps = _draw(traffic["arrivals"], n, np.random.default_rng(
        int(traffic.get("base_seed", 0)) + 1))
    return np.cumsum(gaps[np.random.default_rng([seed, 1]).permutation(n)])
