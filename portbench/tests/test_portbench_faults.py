"""The check fails a broken timed path: each fault a served cell can
have, planted under a tiny cell's run on the CPU, turns ``correct``
false; and the control (the reference in fp8 in the program's place)
reads past the limit."""
import json

import numpy as np
import pytest
import torch

from portbench_helpers import BENCH, TINY, run_tiny
from faults import FAULTS


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", [w for w, _, _ in TINY])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault,
                                            workload):
    FAULTS[fault](monkeypatch)
    out = run_tiny(tiny_root, workload, seconds=2.0)
    checks = out["checks"]
    # judged on what was served, not for want of a finished request
    assert checks["requests_checked"]["value"] > 0, checks
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in checks.items()
               if k.endswith("logit_gap")), checks


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-hybrid"])
def test_control_reads_past_the_limit(name):
    """At a tiny size on the CPU: the reference with fp8 weight products
    in the program's place, read at its first choices, fails the limit
    the sound path meets."""
    from harness import check, weights
    config = json.loads((BENCH / "tests" / "data" / "configs" /
                         f"{name}.json").read_text())
    g = torch.Generator().manual_seed(4)
    seqs = [torch.randint(0, config["vocab"], (n,), generator=g)
            for n in (12, 30)]
    starts = [4, 10]
    ref = check.reference_logits(config, 5, seqs, starts, "cpu")
    low = check.reference_logits(config, 5, seqs, starts, "cpu",
                                 precision="fp8")
    sound = check.gaps(ref, [lg.argmax(-1).numpy() for lg in ref])
    ctrl = check.gaps(ref, [lg.argmax(-1).numpy() for lg in low])
    chk = config["check"]
    assert np.all(sound == 0)
    assert ctrl.max() > 3 * chk["max_logit_gap"]
    # the verdict the runs take, by the same limits
    assert check.verdict(check.numbers(sound, chk), chk)[1] is True
    assert check.verdict(check.numbers(ctrl, chk), chk)[1] is False
    assert weights.make(config, 5, "cpu")["embed"].dtype == torch.float32


def _control(workload, *args):
    """``control.py`` on the card at the cell's own size and load; its
    JSON lines."""
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, str(BENCH / "control.py"), "--workload", workload,
         *args], capture_output=True, text=True, timeout=1800,
        cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()
            if line.startswith("{")]


def _cells():
    return [w["name"] for w in json.loads(
        (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


def _seconds():
    """A run's window: the check compares as many requests as a run's."""
    return str(json.loads((BENCH.parent / "BENCHMARK.json").read_text())[
        "run_seconds"])


@pytest.mark.card
@pytest.mark.parametrize("workload", _cells())
def test_control_fails_at_the_cells_size(card, workload):
    """On the card, at the cell's own size and load: the control fails
    the check's verdict (``check.judge``, the same limits) and the
    program passes it (PERF.md has the readings the limits came from)."""
    rows = _control(workload, "--seeds", "2147483711,2147483712,2147483713",
                    "--seconds", _seconds())
    assert len(rows) == 3
    for r in rows:
        assert r["correct"] and not r["control_correct"], r


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", _cells())
def test_a_broken_timed_path_is_not_correct_at_the_cells_size(
        card, workload, fault):
    """On the card, at the cell's own size and load, each fault planted
    under the program turns the run's ``correct`` false."""
    rows = _control(workload, "--seeds", "2147483721", "--seconds",
                    _seconds(), "--fault", fault)
    assert rows and all(r["correct"] is False for r in rows), rows
