"""Shared pieces of the benchmark's tests: its own folder and the
port's sources on the path, and a checkout of tiny cells (``data/``)
that the harness runs on the CPU."""
import json
import pathlib
import shutil
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(BENCH.parent / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
DATA = pathlib.Path(__file__).resolve().parent / "data"

#: tiny cells: (workload, config, traffic)
TINY = [("tiny.moe", "tiny-moe", "tiny-closed"),
        ("tiny.hybrid", "tiny-hybrid", "tiny-open")]


def write_checkout(root: pathlib.Path, cells=TINY) -> pathlib.Path:
    """A checkout at ``root``: the benchmark's folder with the tiny
    configurations and traffic mixes added as data files, and a
    ``BENCHMARK.json`` naming ``cells``."""
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for kind in ("configs", "traffic"):
        for f in (DATA / kind).glob("*.json"):
            shutil.copy(f, bench / kind / f.name)
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": c, "source": "test",
                        "file": f"portbench/configs/{c}.json",
                        "reduced": [], "why": "tiny"}
                       for c in sorted({c for _, c, _ in cells})]
    spec["workloads"] = [{"name": w, "config": c, "traffic": t, "chips": 1,
                          "why": "tiny"} for w, c, t in cells]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_tiny(root, workload, *, seed=2**31 + 11, seconds=3.0, trace=False):
    """One run of a tiny cell on the CPU, as ``run.py`` runs one, on one
    thread (parallel test workers would otherwise slow each other's
    windows to a crawl; the worker's thread count is put back after)."""
    import torch
    from harness import bench, spec
    cell = spec.load_cell(workload, root=root, bench_dir=root / "portbench")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return bench.run(cell, seed=seed, seconds=seconds, trace=trace,
                         device="cpu", t_start=time.perf_counter())
    finally:
        torch.set_num_threads(threads)
