"""Batched serving example on the port: a small LM with TP = 4 ranks
stacked on one card, prefill + decode with a sharded KV cache — the
paper's §5.2 deployment shape (vLLM + TP), with the decode-path
AllReduces running over this library's stack.

With ``--mode explicit`` (the default) the decode step is the explicit-TP
hot path: each layer's two AllReduces (attention out-proj, MLP
down-proj) and the logits AllGather REPLAY the engine's init-compiled
ExecutionPlans, on the card on the hand-written executor kernel, and the
whole step is captured once in a CUDA graph that every token replays;
``--mode auto`` serves the unsharded step. Decode plans are compiled per
active-slot BUCKET (compile once per bucket, pad at dispatch), and the
per-bucket cost cards + dispatch hit counts are printed.

    PYTHONPATH=src python examples_torch/serve_llm.py --tokens 32
    PYTHONPATH=src python examples_torch/serve_llm.py --mode auto --tokens 32
    PYTHONPATH=src python examples_torch/serve_llm.py --device cpu --tokens 4

Weights are seeded random (``transformer.init_params``, seed 0).
Departure from ``examples/serve_llm.py``: the reference's ``data`` axis
of 2 is dropped — the port's engine serves TP alone (its ranks stacked
on one card), and data parallelism is the router's replicas
(``examples_torch/prefix_serve.py``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.mesh import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Engine, ServeConfig

TP = 4
PROMPT = 12
TEMPERATURE = 0.8
SEED = 1


def serve_demo() -> ModelConfig:
    """The reference's ``serve-demo`` config."""
    return ModelConfig(
        name="serve-demo", family="dense",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=1024, vocab=4096, max_seq=512, dtype="float32")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None, *,
         params: Optional[dict] = None) -> dict:
    """``params``: weights in the reference layout to serve instead of
    the seeded ones (the tests carry the reference's across)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--mode", choices=("auto", "explicit"),
                    default="explicit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = serve_demo()
    if params is None:
        params = tf.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device)
    eng = Engine(cfg, params,
                 ServeConfig(batch=args.batch, max_kv=256,
                             temperature=TEMPERATURE, mode=args.mode),
                 tp=TP, device=device)
    # decode-step plans were compiled at engine init (§5.2: plan once),
    # one per active-slot bucket — inspect algorithm choice and predicted
    # comm cost before serving a single request. In explicit mode these
    # ARE the kernels every generated token replays.
    report = eng.plan_report()
    print(f"mode={eng.mode}")
    cards = {}
    for name, fam in report["plans"].items():
        for b, card in fam["cards"].items():
            print(f"plan[{name}][bucket={b}]: {card['algo']} "
                  f"O{card['opt_level']} est={card['estimate_us']}us")
            cards[f"{name}@{b}"] = card["algo"]
    print(f"predicted comm/token: {report['predicted_comm_us_per_token']}us "
          f"({cfg.n_layers} layers x 2 AllReduce + logits gather)")
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (args.batch, PROMPT)).astype(np.int32)

    _sync(device)
    t0 = time.perf_counter()
    logits = eng.prefill(prompts)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    compiles_before = eng.comm.stats["compiles"]
    t0 = time.perf_counter()
    out = eng.decode(logits, num_tokens=args.tokens, seed=SEED)
    _sync(device)
    t_decode = time.perf_counter() - t0
    assert eng.comm.stats["compiles"] == compiles_before  # pure replay

    per_tok = t_decode / args.tokens * 1e3
    print(f"prefill: {t_prefill*1e3:.1f} ms for {prompts.shape[1]} tokens")
    print(f"decode:  {per_tok:.2f} ms/token  ({args.batch} sequences"
          f"{', CUDA-graph replay' if eng.graph is not None else ''})")
    # bucketed dispatch counters: which plan sizes the served traffic hit
    report = eng.plan_report()
    hits = {}
    for name, fam in report["plans"].items():
        print(f"bucket hits[{name}]: {fam['hits']}")
        hits[name] = dict(fam["hits"])
    print(f"plan cache: {eng.comm.stats} (compiles flat across decode)")
    print(f"sample continuation (seq 0): {out[0][:16].tolist()}")
    return dict(
        device=str(device), mode=eng.mode, requested_mode=args.mode,
        cards=cards,
        predicted_comm_us_per_token=report["predicted_comm_us_per_token"],
        prefill_ms=t_prefill * 1e3, decode_ms_per_token=per_tok,
        compiles_before_decode=compiles_before,
        compiles_after_decode=eng.comm.stats["compiles"], hits=hits,
        graph=eng.graph is not None,
        graph_launches=None if eng.graph is None else eng.graph.launches,
        graph_replays=None if eng.graph is None else eng.graph.replays,
        tokens=out.tolist(), continuation=out[0][:16].tolist(),
        health=report["health"])


if __name__ == "__main__":
    main()
