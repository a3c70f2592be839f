"""The port's fault-injection module (``repro_torch.core.faults``)
against the reference's (``repro.core.faults``): every static fault kind
injected into every registry program (O2) at n in {2, 4, 8} with seeds
0 and 1 gives the reference's mutation, ``program_to_dict`` for
``program_to_dict``, and the port's verifier rejects it with the
reference verifier's findings; ``FaultSpec``/``FaultInjector``
validation as in ``tests/test_chaos.py``; and the runtime hook's
``corrupt_chunk`` poisons a copy, never the caller's tensor."""
import pytest
import torch

from repro.core import algorithms as ref_algos
from repro.core import dsl as ref_dsl
from repro.core import faults as ref_faults
from repro.core import passes as ref_passes
from repro.core import verify as ref_verify
from repro_torch.core import algorithms, dsl, faults, passes, verify

COLLECTIVE_OF = {
    "allpairs_rs": "reduce_scatter", "ring_rs": "reduce_scatter",
    "allpairs_ag": "all_gather", "ring_ag": "all_gather",
    "allreduce_1pa": "all_reduce", "allreduce_2pa": "all_reduce",
    "allreduce_ring": "all_reduce", "alltoall": "all_to_all",
    "broadcast_allpairs": "broadcast", "halving_rs": "reduce_scatter",
    "doubling_ag": "all_gather", "allreduce_rd": "all_reduce",
    "swing_allreduce": "all_reduce",
}


def _build(registry, name, n):
    build = registry[name]
    return build(n, 0) if name == "broadcast_allpairs" else build(n)


def test_names_match_reference():
    assert faults.__all__ == ref_faults.__all__
    assert faults.STATIC_KINDS == ref_faults.STATIC_KINDS
    assert faults.RUNTIME_KINDS == ref_faults.RUNTIME_KINDS
    assert faults.ALL_KINDS == ref_faults.ALL_KINDS


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(algorithms.REGISTRY))
@pytest.mark.parametrize("kind", faults.STATIC_KINDS)
def test_static_fault_matches_reference_and_is_rejected(kind, name, n):
    mine = passes.optimize(_build(algorithms.REGISTRY, name, n), 2, n)
    theirs = ref_passes.optimize(_build(ref_algos.REGISTRY, name, n), 2, n)
    coll = COLLECTIVE_OF[name]
    for seed in (0, 1):
        try:
            want = ref_faults.inject_program(
                theirs, ref_faults.FaultSpec(kind, seed=seed), n)
        except ValueError as e:
            with pytest.raises(ValueError, match="has no"):
                faults.inject_program(mine, faults.FaultSpec(kind, seed=seed),
                                      n)
            assert "has no" in str(e)
            continue
        bad = faults.inject_program(mine, faults.FaultSpec(kind, seed=seed), n)
        assert dsl.program_to_dict(bad) == ref_dsl.program_to_dict(want)
        report = verify.verify_program(bad, n, collective=coll)
        assert not report.ok, f"verifier missed {kind} in {name} n={n}"
        ref_report = ref_verify.verify_program(want, n, collective=coll)
        assert [str(f) for f in report.findings] == \
            [str(f) for f in ref_report.findings]
        # the source program is left as it was
        assert dsl.program_to_dict(mine) == ref_dsl.program_to_dict(theirs)


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultSpec("melt_gpu")
    prog_fault = faults.FaultSpec("fail_call")
    with pytest.raises(ValueError, match="runtime fault"):
        faults.inject_program(algorithms.REGISTRY["allreduce_ring"](4),
                              prog_fault, 4)
    with pytest.raises(ValueError, match="static fault"):
        faults.FaultInjector(faults.FaultSpec("drop_put"))
    assert faults.active() is None     # nothing leaks between tests


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_corrupt_chunk_poisons_a_copy(dtype):
    """Row 0 of every rank's payload poisoned (NaN, or iinfo.max for an
    integer dtype), the rest and the caller's tensor untouched; the
    fault fires ``count`` times, then passes the payload through."""
    x = torch.arange(3 * 4 * 5).reshape(3, 4, 5).to(dtype)
    keep = x.clone()
    with faults.inject(faults.FaultSpec("corrupt_chunk", count=1)) as inj:
        y = faults.active().on_execute(x)
        z = faults.active().on_execute(x)
    assert torch.equal(x, keep) and z is x and inj.fired == 1
    bad = (torch.isnan(y[:, 0]).all() if dtype.is_floating_point
           else (y[:, 0] == torch.iinfo(dtype).max).all())
    assert bad
    assert torch.equal(y[:, 1:], keep[:, 1:])
    assert faults.active() is None


def test_fail_call_and_stall_fire_count_times():
    x = torch.zeros(2, 1, 1)
    with faults.inject(faults.FaultSpec("fail_call", count=2)) as inj:
        for _ in range(2):
            with pytest.raises(faults.FaultInjected):
                faults.active().on_execute(x)
        assert faults.active().on_execute(x) is x
    assert inj.fired == 2
    with faults.inject(faults.FaultSpec("stall_rank", delay_s=0.01)) as inj:
        assert faults.active().on_execute(x) is x
    assert inj.fired == 1 and inj.remaining == 0


def test_suspended_holds_the_hook_back():
    with faults.inject(faults.FaultSpec("fail_call")) as inj:
        with faults.suspended():
            assert faults.active() is None
        assert faults.active() is inj
    assert faults.active() is None
