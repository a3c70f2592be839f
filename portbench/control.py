"""The control of a cell's check, its sound readings, and the check
under a planted fault, at the cell's own size on the card:

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 51 [--fault <name>]

For each seed it runs the cell as ``run.py`` does (a window at the
cell's own load), then reads the check's numbers (``check.numbers``)
twice over the same served sample: the program's gaps under the
float32 reference (a sound reading) and the control's, the reference
itself with every weight product in fp8 put in the program's place (the
precision below the configuration's bf16), its own first choice at
each position read at its gap under the float32 reference. Both are
judged by the same limits (``check.verdict``): ``correct`` is the
program's verdict, ``control_correct`` the control's. Each limit of the
configuration's ``check`` lies between the sound readings' largest and
the control's smallest (PERF.md). With ``--fault`` (a name in
``faults.py``) the fault is planted under the program before its
set-up, and the control is not read. One JSON line a seed; the
benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_cli  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    bench_cli._caches()
    sys.path[:0] = [str(bench_cli.BENCH), str(bench_cli.CHECKOUT / "src")]
    import torch
    from harness import bench, spec
    cell = spec.load_cell(args.workload, root=bench_cli.CHECKOUT)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    if args.fault:
        import pytest
        from faults import FAULTS
        mp = pytest.MonkeyPatch()
        FAULTS[args.fault](mp)
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            out = bench.run(cell, seed=seed, seconds=args.seconds,
                            trace=False, device="cuda:0", t_start=t,
                            control=not args.fault)
        except Exception as e:
            if not args.fault:
                raise
            # a run that breaks down gives no result: not correct
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": args.fault, "correct": False,
                              "error": repr(e)[:500]}), flush=True)
            t = time.perf_counter()
            continue
        notes = out["notes"]
        row = {"workload": args.workload, "seed": seed,
               "fault": args.fault,
               "sound": notes["gaps"],
               "limits": {k: c["limit"] for k, c in out["checks"].items()},
               "checks": {k: c["value"] for k, c in out["checks"].items()},
               "correct": out["correct"],
               "requests_finished": notes["requests_finished"],
               "setup_phases_s": notes["setup_phases_s"]}
        if not args.fault:
            row.update(control=notes["control"],
                       control_correct=notes["control_correct"])
        print(json.dumps(row), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
