"""The harness runs a cell that is nothing but data files, end to end on
the CPU, and its reference agrees with the port's plain path."""
import json
import subprocess
import sys

import pytest
import torch

from portbench_helpers import BENCH, TINY, run_tiny


@pytest.mark.parametrize("workload", [w for w, _, _ in TINY])
def test_a_cell_added_as_data_files_runs(tiny_root, workload):
    out = run_tiny(tiny_root, workload)
    assert out["correct"] is True
    assert out["checks"]["max_logit_gap"]["value"] <= \
        out["checks"]["max_logit_gap"]["limit"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s", "itl_p95_ms"}
    assert list(out)[-1] == "checks"


def test_each_file_is_found_by_name(tiny_root):
    from harness import spec
    cell = spec.load_cell("tiny.hybrid", root=tiny_root,
                          bench_dir=tiny_root / "portbench")
    assert cell.config["name"] == "tiny-hybrid"
    assert cell.traffic["driver"] == "open"
    for m in cell.end_to_end + cell.per_layer:
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").exists()
    for fam in ("moe", "hybrid"):
        assert (BENCH / "reference" / f"{fam}.py").exists()


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-hybrid"])
def test_reference_matches_the_ports_plain_path(name):
    """The family's plain reference against the port's full-sequence
    forward on the CPU, f32, on the benchmark's own weights, and the
    weights in exactly the layout the port's ``init_params`` makes."""
    import importlib

    from harness import serving, weights
    from repro_torch.models import transformer as tf
    config = json.loads((BENCH / "tests" / "data" / "configs" /
                         f"{name}.json").read_text())
    ref = importlib.import_module(f"reference.{config['family']}")
    cfg = serving.model_config(config)
    params = weights.make(config, 3, "cpu")

    def shapes(t, pre=""):
        if isinstance(t, dict):
            return {k: v for kk, vv in t.items()
                    for k, v in shapes(vv, f"{pre}/{kk}").items()}
        if isinstance(t, list):
            return {k: v for i, vv in enumerate(t)
                    for k, v in shapes(vv, f"{pre}/{i}").items()}
        return {pre: (tuple(t.shape), t.dtype)}

    assert shapes(params) == shapes(tf.init_params(cfg, device="meta"))
    for n in (9, 30):        # inside and past the tiny window of 16
        toks = torch.randint(0, config["vocab"], (1, n),
                             generator=torch.Generator().manual_seed(n))
        want = tf.logits_fn(params, cfg, tf.forward(params, cfg, toks,
                                                     backend="torch"))[0]
        got = ref.logits(params, config, [toks[0]], [0])[0]
        assert (got - want).abs().max().item() < 1e-4


def test_no_jax_or_reference_package_is_loaded(tiny_root):
    """A run loads nothing whose top-level name is ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` (compared whole: ``repro_torch`` is the port)."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r];"
        "from portbench_helpers import run_tiny; import pathlib;"
        "run_tiny(pathlib.Path(%r), 'tiny.moe', seconds=0.5);"
        "import run; print(run.forbidden_modules());"
        "print(sorted(m for m in sys.modules if m.split('.')[0] =="
        " 'repro_torch')[:1])"
    ) % (str(BENCH / "tests"), str(BENCH), str(tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['repro_torch']"


def test_run_refuses_without_a_card(tiny_root):
    """Without the CUDA card the cell asks for, no result and a non-zero
    exit."""
    out = subprocess.run(
        [sys.executable, str(tiny_root / "portbench" / "run.py"),
         "--workload", "tiny.moe", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tiny_root)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
