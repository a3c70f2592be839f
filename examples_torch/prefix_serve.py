"""Shared-prefix serving example on the port: fused bucketed prefill +
prefix/KV cache reuse behind the plan-file router.

The serving workload: many requests sharing a handful of system prompts.
Two replicas (TP = 2 each, their ranks stacked on one card) load ONE
exported plan set whose ``layer_allreduce`` ladder carries the
fused-prefill sequence buckets; each replica gets its own
``PrefixCache`` (a token trie over KV slot snapshots), so a request
whose prompt starts with an already-served prefix seeds its cache row
from the trie and skips straight to the divergent suffix. The same
trace then runs COLD — no fusion, no cache, token by token — and the
script verifies every stream is bit-identical to a cold sequential
baseline while printing the micro-step reduction and hit rate the warm
path bought. On the card each replica decodes by replaying one CUDA
graph a slot bucket, its collectives on the executor kernel, and fused
prefill reaches the flash-attention kernel.

    PYTHONPATH=src python examples_torch/prefix_serve.py --requests 8
    PYTHONPATH=src python examples_torch/prefix_serve.py --requests 24 --prefix-len 8
    PYTHONPATH=src python examples_torch/prefix_serve.py --device cpu --requests 8

The model is ``serve/loadgen.py:_serve_model`` (qwen3-1.7b reduced:
2 layers, d_model 128, vocab 512, f32) on seeded random weights.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

from repro_torch.mesh import resolve_device
from repro_torch.serve import loadgen


def main(argv: Optional[Sequence[str]] = None, *,
         params: Optional[dict] = None) -> dict:
    """``params``: weights in the reference layout to serve instead of
    the seeded ones (the tests carry the reference's across)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prefix-pool", type=int, default=2,
                    help="number of shared system prompts")
    ap.add_argument("--prefix-len", type=int, default=6,
                    help="tokens per shared prompt")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    tcfg = loadgen.TrafficConfig(
        seed=args.seed, n_requests=args.requests,
        prefix_pool=args.prefix_pool, prefix_len=args.prefix_len,
        max_prompt=6, max_new=6, temperature=0.8)

    plan_dir = tempfile.mkdtemp(prefix="prefix_serve_plans_")
    warm = loadgen.run_serve_load(
        tcfg, fused_prefill=True, prefill_seq_buckets=(4, 8),
        prefix_cache_tokens=0, plan_dir=plan_dir, params=params,
        device=device)
    cold = loadgen.run_serve_load(tcfg, plan_dir=plan_dir, params=params,
                                  device=device)

    # both runs were diffed against a cold sequential baseline inside
    # run_serve_load — the optimization must be invisible in the tokens
    assert warm["bit_identical"], f"warm diverged: {warm['mismatched']}"
    assert cold["bit_identical"], f"cold diverged: {cold['mismatched']}"
    assert warm["prefix_hits"] > 0, "trace never shared a prefix"

    print(f"requests: {warm['requests']}  replicas: {warm['replicas']} "
          f"x tp={warm['tp']}  mode: {warm['mode']}")
    print(f"prefix cache: hit_rate={warm['prefix_hit_rate']} "
          f"({warm['prefix_hits']} hits / {warm['prefix_misses']} misses, "
          f"{warm['prefix_tokens_reused']} prompt tokens skipped)")
    print(f"fused prefill buckets (slot x seq -> micro-steps): "
          f"{warm['prefill_bucket_steps']}")
    speedup = cold["micro_steps"] / max(warm["micro_steps"], 1)
    print(f"prefill micro-steps: cold={cold['micro_steps']} "
          f"warm={warm['micro_steps']}  ({speedup:.2f}x fewer)")
    print(f"streams bit-identical to the cold token-by-token baseline: "
          f"{warm['bit_identical']}")
    return dict(device=str(device), warm=warm, cold=cold,
                micro_step_ratio=speedup)


if __name__ == "__main__":
    main()
