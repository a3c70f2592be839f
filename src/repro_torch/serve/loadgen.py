"""Seeded virtual-clock load generator for the serving layer — the
port's copy of the reference's trace code (``benchmarks/loadgen.py``):
:class:`TrafficConfig`, :func:`synth_trace`, :func:`run_load`,
:func:`sequential_baseline` and the full load test
:func:`run_serve_load` (with its smoke model, :func:`_serve_model`).

Synthetic traffic — Poisson arrivals, Zipf prompt lengths, uniform
generation budgets, all from one ``np.random.default_rng(seed)`` — on
the scheduler's virtual clock, so a trace replays identically on every
run: the same seed gives the reference's trace (the port's
:class:`~repro_torch.serve.scheduler.Request` is built from the same
draws), the same routing, the same batching.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.scheduler import Request

__all__ = ["TrafficConfig", "synth_trace", "run_load",
           "sequential_baseline", "run_serve_load"]


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


def _serve_model():
    """The smoke model: qwen3-1.7b shrunk by ``configs.reduced`` —
    d_model=128, vocab=512 (divisible by tp=2/4 for the vocab-sharded
    logits plan), float32, 2 layers."""
    from repro_torch import configs
    return configs.reduced(configs.get_config("qwen3-1.7b"))


def run_serve_load(tcfg: Optional[TrafficConfig] = None, *,
                   n_replicas: int = 2, tp: int = 2, batch: int = 4,
                   mode: str = "explicit", prefill_chunk: int = 4,
                   fused_prefill: bool = False,
                   prefill_seq_buckets=None,
                   prefix_cache_tokens=None, queue_limit=None,
                   plan_dir=None, params: Optional[dict] = None,
                   device=None) -> dict:
    """The full load test: build ``n_replicas`` × ``tp`` replicas on
    ``device`` (default: the CUDA card) from ONE exported plan-file set,
    drive the seeded trace through the router, then verify every stream
    bit-identical against the sequential single-request baseline (itself
    a replica loaded from the same files). The baseline is always COLD —
    no fused prefill, no prefix cache — so enabling either knob is
    differentially tested against the plain token-by-token path.
    ``params`` (the reference layout) defaults to ``init_params`` from
    seed 0, as the reference's ``params_key=0``. Returns the reference's
    summary dict."""
    import torch

    from repro_torch.mesh import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.router import build_replicas

    tcfg = tcfg or TrafficConfig()
    device = resolve_device(device)
    cfg = _serve_model()
    if params is None:
        params = tf.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device)
    scfg = ServeConfig(batch=batch, max_kv=64, mode=mode,
                       prefill_seq_buckets=prefill_seq_buckets)
    plan_dir = plan_dir or tempfile.mkdtemp(prefix="repro_plan_set_")
    trace = synth_trace(tcfg, cfg.vocab)

    t0 = time.perf_counter()
    router = build_replicas(cfg, scfg, n_replicas=n_replicas, tp=tp,
                            plan_dir=plan_dir, params=params, mode=mode,
                            prefill_chunk=prefill_chunk,
                            fused_prefill=fused_prefill,
                            prefix_cache_tokens=prefix_cache_tokens,
                            queue_limit=queue_limit, device=device)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    infos = run_load(router, trace, step_s=tcfg.step_s)
    ticks = len(infos)
    micro_steps = sum(i.micro_steps for i in infos)
    load_s = time.perf_counter() - t0

    m = router.metrics()
    rep = router.plan_report()

    # baseline replica: the same weights, the same exported plan files (a
    # plan set with extra prefill buckets loads fine into a config that
    # does not use them), cold path — token-by-token prefill, no prefix
    # cache
    base_scfg = ServeConfig(batch=batch, max_kv=64, mode=mode)
    base = build_replicas(cfg, base_scfg, n_replicas=1, tp=tp,
                          plan_dir=plan_dir, params=params, mode=mode,
                          prefill_chunk=prefill_chunk, device=device)
    base_streams = sequential_baseline(base.replicas[0], trace,
                                       step_s=tcfg.step_s)
    streams = router.streams
    mismatched = [r.rid for r in trace
                  if streams.get(r.rid) != base_streams[r.rid]]
    base_m = base.metrics()

    # plan-family hits per replica (explicit mode only): how many bucketed
    # dispatches each replica's ONE loaded family served
    plan_hits: List[dict] = []
    for r in router.replicas:
        fam = (r.eng.decode_plans or {}).get("layer_allreduce")
        hits = getattr(fam, "hits", None)
        plan_hits.append({int(k): int(v) for k, v in hits.items()}
                         if hits else {})

    return dict(
        model=cfg.name, replicas=n_replicas, tp=tp, batch=batch,
        mode=mode, modes=rep["modes"], degraded=rep["degraded"],
        seed=tcfg.seed, requests=len(trace),
        completed=m["completed"], dropped=m["dropped"],
        bit_identical=not mismatched, mismatched=mismatched,
        tokens=m["tokens"], ticks=ticks, micro_steps=micro_steps,
        tokens_per_vs=m["tokens_per_vs"],
        ttft_vs=m["ttft_vs"], wait_vs=m["wait_vs"],
        bucket_steps=m["bucket_steps"], plan_hits=plan_hits,
        health=rep["health"],
        fused_prefill=fused_prefill,
        rejected=m["rejected"],
        prefix_hits=m["prefix_hits"], prefix_misses=m["prefix_misses"],
        prefix_tokens_reused=m["prefix_tokens_reused"],
        prefix_hit_rate=m["prefix_hit_rate"],
        prefill_bucket_steps=[
            r["scheduler"].get("prefill_bucket_steps", {})
            for r in rep["replicas"]],
        seq_tokens_per_vs=base_m["tokens_per_vs"],
        batching_speedup=round(
            m["tokens_per_vs"] / max(base_m["tokens_per_vs"], 1e-9), 3),
        per_replica_completed=[p["completed"] for p in m["per_replica"]],
        build_s=round(build_s, 3), load_s=round(load_s, 3))
