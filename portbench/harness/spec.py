"""What one run measures, read from ``BENCHMARK.json`` and the data
files it names: the cell's configuration (``configs/<config>.json``, the
file the entry names), its traffic mix (``traffic/<traffic>.json``) and
the metrics the cell reports. Nothing here knows a cell by name: a cell
added as data files alone is found the same way."""
from __future__ import annotations

import dataclasses
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    bench_dir: pathlib.Path     # the benchmark's own folder
    config: dict                # the configuration file, as run
    traffic: dict               # the traffic mix's parameters
    chips: int
    end_to_end: list            # metric entries this cell reports
    per_layer: list


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root=None, bench_dir=None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (``root``: the
    working directory by default; ``bench_dir``: where ``traffic/`` is,
    the benchmark's folder by default)."""
    root = pathlib.Path(root or ".").resolve()
    bench_dir = pathlib.Path(bench_dir or BENCH_DIR)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, bench_dir=bench_dir, config=config,
                traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in spec["end_to_end"]
                            if _reported(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reported(m, name)])
