"""Seeded virtual-clock load generator for the serving layer — the
port's copy of the reference's trace code (``benchmarks/loadgen.py``):
:class:`TrafficConfig`, :func:`synth_trace`, :func:`run_load` and
:func:`sequential_baseline` (numpy only).

Synthetic traffic — Poisson arrivals, Zipf prompt lengths, uniform
generation budgets, all from one ``np.random.default_rng(seed)`` — on
the scheduler's virtual clock, so a trace replays identically on every
run: the same seed gives the reference's trace (the port's
:class:`~repro_torch.serve.scheduler.Request` is built from the same
draws), the same routing, the same batching.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List

import numpy as np

from repro_torch.serve.scheduler import Request

__all__ = ["TrafficConfig", "synth_trace", "run_load",
           "sequential_baseline"]


@dataclasses.dataclass
class TrafficConfig:
    """Knobs of the synthetic trace. ``rate_rps`` is Poisson arrival
    intensity in requests per *virtual* second; ``zipf_a`` shapes the
    prompt-length distribution (heavy head of short prompts, rare long
    ones — the shape that makes chunked prefill earn its keep).

    Shared-prefix mode (``prefix_pool > 0``): every request's prompt is
    a shared "system prompt" — drawn Zipf-skewed from a pool of
    ``prefix_pool`` fixed token runs of length ``prefix_len`` — followed
    by its own random suffix. This is the serving north star's traffic
    shape (millions of requests over a handful of system prompts) and
    what makes the prefix cache measurable: a skewed pool gives high
    hit rates on the head prompt while the tail still exercises misses."""
    seed: int = 0
    n_requests: int = 20
    rate_rps: float = 4.0
    zipf_a: float = 1.5
    max_prompt: int = 12
    max_new: int = 8
    temperature: float = 0.0
    step_s: float = 0.05               # virtual cost of one decode step
    prefix_pool: int = 0               # shared system prompts (0 = off)
    prefix_len: int = 0                # tokens per shared prefix
    prefix_zipf_a: float = 1.2         # pool-index skew


def synth_trace(tcfg: TrafficConfig, vocab: int) -> List[Request]:
    """The seeded trace: exponential inter-arrival gaps (Poisson
    process at ``rate_rps``), Zipf prompt lengths clamped to
    ``max_prompt``, uniform ``1..max_new`` generation budgets, uniform
    random token ids. With ``prefix_pool`` set, each prompt is
    ``pool[zipf % pool_size] + suffix``. Same ``tcfg`` + ``vocab`` →
    same trace, always."""
    rng = np.random.default_rng(tcfg.seed)
    pool = [rng.integers(0, vocab, size=tcfg.prefix_len).astype(np.int32)
            for _ in range(tcfg.prefix_pool)]
    t = 0.0
    reqs: List[Request] = []
    for i in range(tcfg.n_requests):
        t += float(rng.exponential(1.0 / tcfg.rate_rps))
        plen = int(min(rng.zipf(tcfg.zipf_a), tcfg.max_prompt))
        n_new = int(rng.integers(1, tcfg.max_new + 1))
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        if pool:
            shared = pool[(int(rng.zipf(tcfg.prefix_zipf_a)) - 1)
                          % len(pool)]
            prompt = np.concatenate([shared, prompt]).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=n_new,
                            arrival_s=round(t, 6),
                            temperature=tcfg.temperature, seed=i))
    return reqs


def run_load(target, trace: List[Request], *, step_s: float,
             max_ticks: int = 100_000) -> list:
    """Drive a Scheduler or Router through a trace on the virtual
    clock. Requests are submitted only once their ``arrival_s`` has
    passed — so the router's least-loaded choice sees arrival-time
    load, exactly like a front door would — idle gaps fast-forward to
    the next arrival, and each tick costs ``step_s * (1 +
    micro_steps)``. Returns the list of per-tick ``TickInfo`` (the
    property tests assert invariants over it)."""
    pending = deque(sorted(trace, key=lambda r: (r.arrival_s, r.rid)))
    infos: list = []
    while pending or target.outstanding():
        if len(infos) >= max_ticks:
            raise RuntimeError(
                f"load run did not drain in {max_ticks} ticks")
        while pending and pending[0].arrival_s <= target.now:
            target.submit(pending.popleft())
        if target.n_active == 0 and target.outstanding() == 0 and pending:
            target.advance_to(pending[0].arrival_s)
            continue
        info = target.tick()
        infos.append(info)
        target.advance(step_s * (1 + info.micro_steps))
    return infos


def sequential_baseline(sched, trace: List[Request], *,
                        step_s: float) -> Dict[int, List[int]]:
    """The ground truth the load test compares against: the SAME
    requests, one at a time on a fresh single scheduler — each runs
    with the whole batch to itself, so batching effects are impossible
    by construction. Returns rid -> token stream."""
    for req in trace:
        sched.submit(dataclasses.replace(req, arrival_s=0.0))
        sched.run_until_drained(step_s=step_s)
    return {req.rid: list(sched.streams[req.rid]) for req in trace}
