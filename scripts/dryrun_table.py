#!/usr/bin/env python3
"""Print the dry run's table (PERF.md §6) from the JSON that
``python -m repro_torch.launch.dryrun --all [--multi-pod]`` wrote under
``experiments/dryrun_torch/``: for each arch and cell on each production
grid, the per-rank peak in GB (✗ past one card's 80 GB), the dominant
roofline term and ``roofline_fraction``; "no layout" where the port's
layout cannot run the cell, "—" where the arch has no such cell.

    PYTHONPATH=src python scripts/dryrun_table.py
"""
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402

CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GRIDS = ("16x16", "2x16x16")
TERMS = {"memory": "mem", "compute": "cmp", "collective": "coll"}


def entry(r) -> str:
    if r is None:
        return "—"
    if not r["ok"]:
        return "no layout"
    rf = r["roofline"]
    return (f'{r["memory"]["peak_bytes"] / 1e9:.1f}{"" if r["fits"] else " ✗"}'
            f' {TERMS[rf["dominant"]]} {rf["roofline_fraction"]:.3f}')


def main() -> int:
    found = {}
    for f in sorted((ROOT / "experiments" / "dryrun_torch").glob("*.json")):
        r = json.loads(f.read_text())
        if r["mode"] == "auto":
            found[(r["arch"], r["cell"], r["mesh"])] = r
    print("| arch | " + " | ".join(f"{c} {g}" for c in CELLS for g in GRIDS)
          + " |")
    print("|---" * (1 + len(CELLS) * len(GRIDS)) + "|")
    for arch in configs.ARCHS:
        print(f"| {arch} | " + " | ".join(
            entry(found.get((arch, c, g))) for c in CELLS for g in GRIDS)
            + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
