"""The port's simulator and trace-driven fits (``repro_torch.core.
simulate``, ``selector.fit_from_traces``, ``TuningTable.from_traces``)
against the reference's on the same trace JSON: replay and what-if
predictions, planted-constant recovery, the single-size and error
contracts, and the tables built from traces. No test reads a host
clock: every trace here is either synthetic or compared as data."""
import dataclasses
import json

import jax.numpy as jnp
import pytest
import torch

from repro.core import comm as ref_comm
from repro.core import selector as ref_sel
from repro.core import simulate as ref_simulate
from repro.core import trace as ref_trace
from repro_torch.core import selector as sel
from repro_torch.core import simulate, trace
from repro_torch.core.comm import Communicator

torch.set_num_threads(1)

N = 8
LINK = dict(alpha_us=1.5, beta_GBps=40.0, torus=False, sync_us=0.3)


def _links():
    return sel.LinkModel(**LINK), ref_sel.LinkModel(**LINK)


def _both(d):
    """One trace document loaded in each package."""
    return trace.Trace.from_dict(d), ref_trace.Trace.from_dict(d)


def _ref_suite():
    """Reference captures (host emulation) of four collectives at two
    sizes, as JSON documents."""
    out = []
    for coll, algo, lvl in (("all_reduce", "allreduce_ring", 2),
                            ("all_reduce", "allreduce_2pa", 2),
                            ("reduce_scatter", "allpairs_rs", 0),
                            ("all_gather", "ring_ag", 2)):
        for rows, cols in ((64, 8), (1024, 128)):
            plan = ref_comm.Communicator("x", n=N).compile(
                coll, (rows, cols), jnp.float32, algo=algo, opt_level=lvl)
            out.append(ref_trace.capture_plan(plan).to_dict())
    return out


@pytest.fixture(scope="module")
def suite():
    return _ref_suite()


def _port_trace(coll, rows, cols, algo, lvl):
    plan = Communicator("x", n=N, device="cpu").compile(
        coll, (rows, cols), torch.float32, algo=algo, opt_level=lvl)
    return trace.capture_plan(plan)


# ---------------------------------------------------------------------------
# replay / whatif: the reference's predictions on the same document
# ---------------------------------------------------------------------------
def test_replay_matches_reference(suite):
    link, ref_link = _links()
    for d in suite:
        port, ref = _both(d)
        for lk, rlk in ((None, None), (link, ref_link)):
            got = simulate.replay(port, link=lk)
            want = ref_simulate.replay(ref, link=rlk)
            assert got.predicted_us == pytest.approx(want.predicted_us,
                                                     rel=1e-9)
            assert got.measured_us == want.measured_us
            assert got.service_us_by_op == want.service_us_by_op
        assert simulate.replay(port).rel_err <= simulate.REPLAY_TOLERANCE


@pytest.mark.parametrize("source", ["reference", "port"])
def test_whatif_matches_reference(suite, source):
    """Every candidate and both opt levels, predicted from one trace of
    each package (a port trace's ``torch`` backend rebuilds as the
    reference's ``xla``)."""
    link, ref_link = _links()
    docs = suite[:2] if source == "reference" else [
        _port_trace("all_reduce", 64, 8, "allreduce_ring", 2).to_dict(),
        _port_trace("reduce_scatter", 1024, 128, "allpairs_rs", 0).to_dict()]
    for d in docs:
        port, ref = _both(d)
        for algo in sel.CANDIDATES[port.collective]:
            for lvl in (0, 2):
                got = simulate.whatif(port, algo=algo, opt_level=lvl,
                                      link=link)
                want = ref_simulate.whatif(ref, algo=algo, opt_level=lvl,
                                           link=ref_link)
                assert got.predicted_us == pytest.approx(
                    want.predicted_us, rel=1e-9), (algo, lvl)
                assert got.events == want.events
                assert (got.measured_us is None) == (want.measured_us is None)
        # the default link: fitted from the trace itself, α pinned
        base = sel.LinkModel(**dataclasses.asdict(ref_sel.ICI))
        got = simulate.whatif(port, algo=port.algo,
                              link=sel.fit_from_traces(
                                  [port], base, allow_single_size=True))
        want = ref_simulate.whatif(ref, algo=ref.algo)
        assert got.predicted_us == pytest.approx(want.predicted_us, rel=1e-9)


def test_whatif_errors_name_the_candidates(suite):
    port, _ = _both(suite[0])
    with pytest.raises(ValueError) as e:
        simulate.whatif(port, algo="nope")
    for cand in sel.CANDIDATES["all_reduce"]:
        assert cand in str(e.value)
    with pytest.raises(ValueError, match="unknown trace backend"):
        simulate.whatif(port, backend="tpu")
    nameless = dataclasses.replace(port, algo=None)
    with pytest.raises(ValueError, match="needs an algorithm"):
        simulate.whatif(nameless)


def test_whatif_rebuilds_reference_backends_here(suite):
    port, _ = _both(suite[0])
    assert port.backend == "xla"
    same = simulate.whatif(port, link=sel.ICI)
    assert same.config["backend"] == "torch"
    assert same.measured_us == port.span_us        # same algo, level, backend
    on_card = simulate.whatif(port, backend="pallas", link=sel.ICI)
    assert on_card.config["backend"] == "cuda" and on_card.measured_us is None


# ---------------------------------------------------------------------------
# fit_from_traces
# ---------------------------------------------------------------------------
def _synthetic_trace(alpha, beta_GBps, sync, torus, sizes, n=8):
    """Traces whose put/wait services follow the α-β model exactly, with
    1-hop and 3-hop puts so raw and wire bytes disagree."""
    events = []
    for iid, nbytes in enumerate(sizes):
        for shift, rank in ((1, 0), (3, 1)):
            wire = nbytes * min(shift, n - shift)
            svc = alpha + (wire if torus else nbytes) / (beta_GBps * 1e3)
            events.append(trace.TraceEvent(
                iid=iid, sub=0, op="put", lowered="ppermute", rank=rank,
                peer=(rank + shift) % n, round_id=iid, chunks=1,
                bytes=nbytes, wire_bytes=wire, issue_us=0.0,
                complete_us=svc))
            events.append(trace.TraceEvent(
                iid=iid, sub=1, op="wait", lowered="data_dep", rank=rank,
                peer=-1, round_id=iid, chunks=1, bytes=nbytes,
                wire_bytes=0, issue_us=0.0, complete_us=sync,
                deps=[(iid, 0, rank)]))
    return trace.Trace(
        name="synthetic", backend="torch", n=n, shape=(8, 8), rows_in=8,
        cols=8, dtype="float32", chunk_rows=2, chunk_bytes=64,
        events=events, span_us=1.0)


@pytest.mark.parametrize("alpha,beta,sync,torus", [
    (0.5, 1.0, 0.05, False), (2.0, 75.0, 0.4, True), (8.0, 200.0, 2.0, False),
    (3.3, 12.5, 0.7, True), (1.0, 3000.0, 0.01, False)])
def test_fit_recovers_planted_constants(alpha, beta, sync, torus):
    t = _synthetic_trace(alpha, beta, sync, torus,
                         sizes=(1 << 10, 1 << 14, 1 << 18))
    fitted = sel.fit_from_traces([t])
    assert fitted.alpha_us == pytest.approx(alpha, rel=1e-4)
    assert fitted.beta_GBps == pytest.approx(beta, rel=1e-4)
    assert fitted.sync_us == pytest.approx(sync, rel=1e-6)
    assert fitted.torus == torus
    # the same document (times at its 4 decimals) fits alike in both
    got = sel.fit_from_traces([trace.Trace.from_dict(t.to_dict())])
    want = ref_sel.fit_from_traces(
        [ref_trace.Trace.from_dict(t.to_dict())],
        ref_sel.LinkModel(**dataclasses.asdict(sel.UNFITTED)))
    assert dataclasses.asdict(got) == pytest.approx(
        dataclasses.asdict(want), rel=1e-12)


def test_fit_matches_reference_on_captured_traces(suite):
    base = sel.LinkModel(**LINK)
    ref_base = ref_sel.LinkModel(**LINK)
    got = sel.fit_from_traces([trace.Trace.from_dict(d) for d in suite],
                              base)
    want = ref_sel.fit_from_traces(
        [ref_trace.Trace.from_dict(d) for d in suite], ref_base)
    assert dataclasses.asdict(got) == pytest.approx(dataclasses.asdict(want),
                                                    rel=1e-12)


def test_fit_single_size_pins_alpha_and_fits_beta():
    t = _synthetic_trace(1.0, 50.0, 0.2, False, sizes=(1 << 14,))
    base = sel.LinkModel(alpha_us=1.0, beta_GBps=5.0, torus=False,
                         sync_us=9.9)
    fitted = sel.fit_from_traces([t], base, allow_single_size=True)
    assert fitted.alpha_us == base.alpha_us
    assert fitted.beta_GBps == pytest.approx(50.0, rel=1e-6)
    assert fitted.sync_us == pytest.approx(0.2)


def test_fit_from_traces_error_contracts():
    with pytest.raises(ValueError, match="at least one captured trace"):
        sel.fit_from_traces([])
    one_size = _synthetic_trace(1.0, 50.0, 0.2, False, sizes=(1024,))
    with pytest.raises(ValueError, match="unidentifiable"):
        sel.fit_from_traces([one_size])
    no_puts = dataclasses.replace(
        one_size, events=[e for e in one_size.events if e.op != "put"])
    with pytest.raises(ValueError, match="no put events"):
        sel.fit_from_traces([no_puts])
    # services that shrink with bytes: a degenerate fit is refused
    shrinking = _synthetic_trace(50.0, 1.0, 0.2, False,
                                 sizes=(1 << 10, 1 << 14))
    for ev, svc in zip([e for e in shrinking.events if e.op == "put"],
                       (30.0, 30.0, 10.0, 10.0)):
        ev.complete_us = svc
    with pytest.raises(ValueError, match="degenerate"):
        sel.fit_from_traces([shrinking])


# ---------------------------------------------------------------------------
# TuningTable.from_traces
# ---------------------------------------------------------------------------
def test_from_traces_matches_reference(suite):
    link, ref_link = _links()
    got = sel.TuningTable.from_traces(
        [trace.Trace.from_dict(d) for d in suite], link=link)
    want = ref_sel.TuningTable.from_traces(
        [ref_trace.Trace.from_dict(d) for d in suite], link=ref_link)
    assert got.entries == want.entries and got.entries
    # the fitted default link, both packages from the same base
    fit = sel.fit_from_traces([trace.Trace.from_dict(d) for d in suite],
                              sel.ICI)
    got = sel.TuningTable.from_traces(
        [trace.Trace.from_dict(d) for d in suite], link=fit)
    want = ref_sel.TuningTable.from_traces(
        [ref_trace.Trace.from_dict(d) for d in suite])
    assert got.entries == want.entries


def test_from_traces_installs_on_a_communicator():
    """A table from traces under a switched link picks a low-round
    all_reduce at 512 KiB where the torus cost model picks the ring."""
    traces = [_port_trace("all_reduce", rows, cols, None, None)
              for rows, cols in ((64, 8), (4096, 128))]
    link = sel.LinkModel(alpha_us=1.0, beta_GBps=50.0, torus=False,
                         sync_us=0.2)
    table = sel.TuningTable.from_traces(traces, link=link)
    nbytes = 4096 * 128 * 4
    assert sel.choose("all_reduce", n=N, nbytes=nbytes,
                      link=sel.ICI) == "allreduce_ring"
    tabled = table.lookup("all_reduce", nbytes)
    assert tabled in {"allreduce_2pa", "allreduce_rd", "swing_allreduce"}
    tuned = Communicator("x", n=N, device="cpu", table=table, link=sel.ICI)
    assert tuned.compile("all_reduce", (4096, 128),
                         torch.float32).algo == tabled
    with pytest.raises(ValueError, match="at least one captured trace"):
        sel.TuningTable.from_traces([])


def test_trace_json_is_stable_through_both_packages(suite):
    """A document read and written by the port, then by the reference,
    is the document."""
    for d in suite[:3]:
        text = trace.Trace.from_dict(d).to_json()
        again = ref_trace.Trace.from_json(text).to_dict()
        assert again == d == json.loads(text)
