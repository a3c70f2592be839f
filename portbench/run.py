"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the CUDA card(s) the
cell asks for. It serves the cell's traffic through ``repro_torch``
(never the JAX package) for ``--seconds``, checks what was served
against the plain reference, and prints the result as one JSON object on
the last line of standard output, the numbers compared beside their
limits on the last lines of standard error. Without the cards, or with a
module of ``jax``, ``jaxlib``, ``flax`` or ``repro`` loaded once the
window has closed, it prints no result and exits non-zero.

Every build and kernel cache the program writes goes under the
checkout's ``build/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _caches() -> None:
    build = CHECKOUT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port may not
    load, the part before the first dot compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(BENCH), str(CHECKOUT / "src")]
    import torch
    from harness import bench, spec

    cell = spec.load_cell(args.workload, root=CHECKOUT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 2
    try:
        out = bench.run(cell, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), device="cuda:0",
                        t_start=T_START)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"modules the port may not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
