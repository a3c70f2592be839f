"""How many kernel records ``torch.profiler`` keeps over repeated
profiles of one engine's CUDA-graph replays (the check behind
``chip_smoke._profile_replays``). Needs a card; run from the repository
root:

    python3 scripts/profiler_records.py [moe|hybrid] [profiles]

Builds the explicit engine of chip_smoke's phase 9 (phi3.5-moe, 8
layers) or phase 12 (hymba-1.5b), serves a prompt, then takes
``profiles`` (default 100) profiles of 4 replays each. A graph replays
the same nodes every time, so every profile should hold the same kernel
records; prints one JSON line with the executor kernels and all kernel
records of each profile that held fewer than the most, and their count.
"""
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def _counts(prof):
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in rows if "dsl_executor_kernel" in e.key),
            sum(e.count for e in rows))


def main() -> int:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, ServeConfig
    which = sys.argv[1] if len(sys.argv) > 1 else "moe"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    device = torch.device("cuda", 0)
    build.build_all()
    cfg = cs._moe_cfg(cs.MOE_LAYERS) if which == "moe" else cs._hybrid_cfg()
    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(2), device=device)
    prompts = np.random.RandomState(2).randint(0, cfg.vocab,
                                               (cs.BATCH, cs.PROMPT))
    eng = Engine(cfg, params, ServeConfig(batch=cs.BATCH, max_kv=cs.MAX_KV),
                 tp=cs.TP, mode="explicit")
    del params
    cs._serve(eng, prompts, 4)
    tok = torch.zeros(cs.BATCH, dtype=torch.long, device=device)
    counts = []
    for _ in range(n):
        eng.pos = cs.PROMPT
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(cs.MAIN_DECODE_STEPS):
                eng._run_step(tok)
            torch.cuda.synchronize()
        counts.append(_counts(prof))
    most = max(c[1] for c in counts)
    short = [c for c in counts if c[1] < most]
    print(json.dumps(dict(
        arch=cfg.name, replays=cs.MAIN_DECODE_STEPS, profiles=n,
        executor_kernels_want=cs.MAIN_DECODE_STEPS * eng.graph.launches,
        kernel_records_most=most, short_profiles=len(short),
        short=short, nvidia_smi=cs.nvidia_smi())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
