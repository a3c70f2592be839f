"""Each case of ``tests/test_chaos.py`` at TP 2 and 4 for the MoE and
hybrid families (dense and int8: ``tests/test_torch_chaos.py``, which
also holds the port's own chaos cases): the recovered engine's greedy
tokens equal to the reference's clean auto engine's on the same weights,
its guardrail counters to the reference engine's at the same TP under
the same ``FaultSpec``."""
import _torch_chaos_common as common
import pytest
import torch

torch.set_num_threads(1)

GRID = [(f, tp) for f in ("moe", "hybrid") for tp in common.TPS]


@pytest.mark.parametrize("family,tp", GRID)
def test_guardrails_do_not_perturb_clean_decode(family, tp):
    common.guardrails_do_not_perturb_clean_decode(family, tp)


@pytest.mark.parametrize("family,tp", GRID)
def test_transient_failure_recovers_by_retry(family, tp):
    common.transient_failure_recovers_by_retry(family, tp)


@pytest.mark.parametrize("family,tp", GRID)
def test_persistent_failure_falls_back_to_auto(family, tp):
    common.persistent_failure_falls_back_to_auto(family, tp)


@pytest.mark.parametrize("family,tp", GRID)
def test_numeric_guard_detects_corruption(family, tp):
    common.numeric_guard_detects_corruption(family, tp)


@pytest.mark.parametrize("family,tp", GRID)
def test_watchdog_times_out_stalled_rank(family, tp):
    common.watchdog_times_out_stalled_rank(family, tp)
