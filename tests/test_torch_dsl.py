"""The port's framework-free DSL layer against the reference: equal
``program_to_dict`` payloads and verifier findings for every registry
entry × opt level × n, and the same selector choices under the
reference's link constants."""
import copy

import pytest

from repro.core import algorithms as ref_algos
from repro.core import dsl as ref_dsl
from repro.core import passes as ref_passes
from repro.core import selector as ref_sel
from repro.core import verify as ref_verify
from repro_torch.core import algorithms, dsl, passes, selector, verify

NAMES = sorted(algorithms.REGISTRY)
GRID = [(name, n, lvl) for name in NAMES for n in (2, 4, 8, 16)
        for lvl in range(4)]

COLLECTIVE = {
    "allpairs_rs": "reduce_scatter", "ring_rs": "reduce_scatter",
    "halving_rs": "reduce_scatter", "allpairs_ag": "all_gather",
    "ring_ag": "all_gather", "doubling_ag": "all_gather",
    "allreduce_1pa": "all_reduce", "allreduce_2pa": "all_reduce",
    "allreduce_ring": "all_reduce", "allreduce_rd": "all_reduce",
    "swing_allreduce": "all_reduce", "alltoall": "all_to_all",
    "broadcast_allpairs": "broadcast",
}


def test_registry_names_match():
    assert set(algorithms.REGISTRY) == set(ref_algos.REGISTRY)
    assert len(algorithms.REGISTRY) == 13


def _findings(report):
    return [str(f) for f in report.findings], report.checks


@pytest.mark.parametrize("name,n,lvl", GRID)
def test_program_dict_and_findings_match(name, n, lvl):
    mine = passes.optimize(algorithms.REGISTRY[name](n), lvl, n)
    theirs = ref_passes.optimize(ref_algos.REGISTRY[name](n), lvl, n)
    d = dsl.program_to_dict(mine)
    assert d == ref_dsl.program_to_dict(theirs)
    coll = COLLECTIVE[name]
    assert _findings(verify.verify_program(mine, n, collective=coll)) == \
        _findings(ref_verify.verify_program(theirs, n, collective=coll))
    # payloads cross between the packages unchanged
    assert ref_dsl.program_to_dict(ref_dsl.program_from_dict(d)) == d


def _drop_first_wait(d):
    i = next(k for k, ins in enumerate(d["instructions"])
             if ins["op"] == "wait")
    del d["instructions"][i]


def _shift_first_put(d):
    put = next(ins for ins in d["instructions"] if ins["op"] == "put")
    target = put["dst"] if put["dst"] is not None else put["dsts"][0]
    target[1]["offset"] += 1


@pytest.mark.parametrize("mutate", [_drop_first_wait, _shift_first_put])
@pytest.mark.parametrize("name", ["allpairs_rs", "ring_ag", "allreduce_1pa",
                                  "swing_allreduce"])
def test_broken_program_findings_match(name, mutate):
    """Non-empty reports agree too (a missing wait, a misaddressed put)."""
    n = 4
    d = copy.deepcopy(dsl.program_to_dict(algorithms.REGISTRY[name](n)))
    mutate(d)
    coll = COLLECTIVE[name]
    mine = verify.verify_program(dsl.program_from_dict(d), n, collective=coll)
    theirs = ref_verify.verify_program(ref_dsl.program_from_dict(d), n,
                                       collective=coll)
    assert mine.findings
    assert _findings(mine) == _findings(theirs)


@pytest.mark.parametrize("collective", ["all_reduce", "all_gather",
                                        "reduce_scatter", "all_to_all"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_choose_agrees_under_reference_link(collective, n):
    for nbytes in (256, 32 << 10, 1 << 20, 64 << 20):
        for lvl in (None, 0, 2, 3):
            assert selector.choose(collective, n=n, nbytes=nbytes,
                                   link=selector.ICI, opt_level=lvl) == \
                ref_sel.choose(collective, n=n, nbytes=nbytes,
                               link=ref_sel.ICI, opt_level=lvl)
    for algo in selector.CANDIDATES[collective]:
        if selector.supports(algo, n):
            assert selector.estimate_us(algo, n, 1 << 20, selector.DCN) == \
                ref_sel.estimate_us(algo, n, 1 << 20, ref_sel.DCN)


def test_default_link_is_the_unfitted_placeholder():
    assert selector.UNFITTED not in (selector.ICI, selector.DCN)
    # decode-size AllReduce at TP=4 picks the one-phase all-pairs form
    assert selector.choose("all_reduce", n=4, nbytes=8 * 2048 * 2) == \
        "allreduce_1pa"
