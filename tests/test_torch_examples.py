"""The port's examples (``examples_torch/``) against the reference's
(``examples/``): examples 1–5 run in-process through ``main(argv)``
with ``--device cpu`` (the plain executors), each held against the
reference on the same keys — the DSL programs' ``program_to_dict``,
their comm stats, the plans' algorithms and cost cards, hierarchical
phases and pad, the selector's picks, and trace event counts. The
port's costs are under ``selector.UNFITTED``; the reference is asked
under a ``LinkModel`` of the same constants.

Over all eight files: no ``jax`` or ``repro`` import (an AST scan), a
docstring, ``main(argv=None)``, nothing run at import, and the card as
the default device (raising without one). The examples themselves run
on the card in ``chip_smoke.py`` phase 19."""
import ast
import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as ref_comm
from repro.core import dsl as ref_dsl
from repro.core import selector as ref_sel
from repro.core import simulate as ref_simulate
from repro.core import trace as ref_trace
from repro_torch.core import selector as sel

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ("custom_collective", "quickstart", "communicator",
            "profile_plan", "hierarchical", "serve_llm", "prefix_serve",
            "train_llm")
N = 8
#: the reference's selector on the port's placeholder link
REF_UNFITTED = ref_sel.LinkModel(**dataclasses.asdict(sel.UNFITTED))


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example(name):
    return _load(ROOT / "examples_torch" / f"{name}.py",
                 f"examples_torch_{name}")


def _cpu(name, *argv):
    return example(name).main(["--device", "cpu", *argv])


def _no_backend(d):
    if isinstance(d, dict):
        return {k: _no_backend(v) for k, v in d.items() if k != "backend"}
    return d


def _ref_my_rs(n):
    """``examples/quickstart.py``'s program, rebuilt with the reference's
    DSL (the reference example runs at import)."""
    prog = ref_dsl.Program("my_rs", chunks=dict(input=n, scratch=n,
                                                 output=1))
    with prog.round():
        for i in range(1, n):
            prog.put(src=("input", ref_dsl.PEER(+i)),
                     dst=("scratch", ref_dsl.RANK), to=ref_dsl.PEER(+i))
    with prog.round():
        for i in range(1, n):
            prog.wait(("scratch", ref_dsl.PEER(+i)), frm=ref_dsl.PEER(+i))
    prog.local_reduce(("output", 0),
                      [("input", ref_dsl.RANK)] +
                      [("scratch", ref_dsl.PEER(+i)) for i in range(1, n)])
    return prog.freeze()


def test_custom_collective_matches_reference():
    res = _cpu("custom_collective")
    ref = _load(ROOT / "examples" / "custom_collective.py",
                "examples_custom_collective")
    prog = ref.rooted_allreduce(N)
    assert res["program"] == ref_dsl.program_to_dict(prog)
    assert res["stats"] == prog.comm_stats(N, chunk_bytes=1024)
    assert res["max_err"]["torch"] < 1e-5
    assert res["cuda_equals_torch"] is None          # no kernel on the CPU
    for c in res["costs"]:
        st = prog.comm_stats(N, max(c["nbytes"], 1))
        assert c["rooted_us"] == pytest.approx(REF_UNFITTED.time_us(
            st["comm_rounds"], st["wire_bytes_per_rank"]), rel=1e-12)
        lib = ref_sel.choose("all_reduce", n=N, nbytes=c["nbytes"],
                             link=REF_UNFITTED)
        assert c["library"] == lib
        assert c["library_us"] == pytest.approx(ref_sel.estimate_us(
            lib, N, c["nbytes"], link=REF_UNFITTED), rel=1e-12)


def test_quickstart_matches_reference():
    res = _cpu("quickstart")
    prog = _ref_my_rs(N)
    assert res["program"] == ref_dsl.program_to_dict(prog)
    assert res["dsl_stats"] == prog.comm_stats(N, 1024)
    nbytes = 128 * 256 * 4
    assert res["collective_algo"] == ref_sel.choose(
        "all_reduce", n=N, nbytes=nbytes, link=REF_UNFITTED)
    rplan = ref_comm.Communicator("x", n=N, backend="xla",
                                  link=REF_UNFITTED).compile(
        "all_reduce", (128, 256), jnp.float32)
    assert res["plan_algo"] == rplan.algo
    assert res["comm_stats"] == {"compiles": 1, "hits": 0}
    assert res["policy"] == {1 << e: ref_sel.choose(
        "all_reduce", n=N, nbytes=1 << e, link=REF_UNFITTED)
        for e in (10, 13, 16, 19, 22, 26, 30)}
    assert max(res["max_err"].values()) < 1e-4
    assert res["cuda_equals_torch"] == {}


def _ref_ring_traces(shapes):
    c = ref_comm.Communicator("x", n=N, backend="xla", link=REF_UNFITTED)
    return [ref_trace.capture_plan(c.compile(
        "all_reduce", s, jnp.float32, algo="allreduce_ring", opt_level=2))
        for s in shapes]


def test_communicator_matches_reference():
    mod = example("communicator")
    res = mod.main(["--device", "cpu"])
    rplan = ref_comm.Communicator("x", n=N, backend="xla",
                                  link=REF_UNFITTED).compile(
        "all_reduce", (128, 256), jnp.float32)
    assert res["algo"] == rplan.algo
    assert _no_backend(res["cost_card"]) == _no_backend(rplan.cost_card())
    assert res["stats_after_replays"] == {"compiles": 1, "hits": 0}
    assert res["stats_after_all_reduce"] == {"compiles": 1, "hits": 1}
    assert res["json_bit_identical"] is True
    assert pathlib.Path(res["plan_path"]).exists()
    assert res["tuned_algo"] == "allreduce_ring"
    assert res["trace_events"] == [len(t.events) for t in
                                   _ref_ring_traces(mod.FIT_SHAPES)]
    assert res["fitted"]["beta_GBps"] > 0 and res["fitted"]["alpha_us"] > 0
    assert res["max_err"] < 1e-4


def test_profile_plan_matches_reference():
    mod = example("profile_plan")
    res = mod.main(["--device", "cpu"])
    refs = _ref_ring_traces(mod.SHAPES)
    assert res["events"] == {f"{r}x{c}": len(t.events)
                             for (r, c), t in zip(mod.SHAPES, refs)}
    t = refs[1]
    link = ref_sel.LinkModel(**res["link"])
    w0 = ref_simulate.whatif(t, algo="allreduce_1pa", opt_level=0,
                             link=link)
    w2 = ref_simulate.whatif(t, algo="allreduce_1pa", opt_level=2,
                             link=link)
    assert res["whatif_events"] == dict(O0=w0.events, O2=w2.events)
    tr_plan = ref_comm.Communicator("x", n=N, link=REF_UNFITTED,
                                    trace=True).compile(
        "all_reduce", (64, 8), jnp.float32)
    assert res["serve_trace_algo"] == tr_plan.algo
    assert res["serve_trace_events"] == len(tr_plan.capture_trace().events)
    assert res["replay"]["predicted_us"] == pytest.approx(
        res["replay"]["measured_us"], rel=0.05)
    assert {e[0] for e in res["table"]} == {"all_reduce"}


def test_hierarchical_matches_reference():
    mod = example("hierarchical")
    res = mod.main(["--device", "cpu"])
    node_link = ref_sel.LinkModel(**dataclasses.asdict(mod.NODE_LINK))
    rplan = ref_comm.HierarchicalCommunicator(
        "local", "node", local_n=mod.L, node_n=mod.M,
        local_link=REF_UNFITTED, node_link=node_link).compile(
        (mod.ROWS, mod.COLS), jnp.float32)
    assert res["phases"] == {k: p.algo for k, p in rplan.phases.items()}
    assert res["algo"] == rplan.algo and res["pad"] == rplan.pad
    assert res["hier_us"] == pytest.approx(rplan.estimate_us, rel=1e-12)
    assert res["groups"] == {"rs": (mod.M, 1), "ar": (mod.L, mod.L),
                             "ag": (mod.M, 1)}
    assert res["exact"] and res["json_bit_identical"]
    assert "clean" in res["verify"]
    flat = ref_comm.Communicator("fx", n=mod.L * mod.M,
                                 link=node_link).compile(
        "all_reduce", (mod.ROWS, mod.COLS), jnp.float32)
    assert res["flat_algo"] == flat.algo
    assert res["flat_us"] == pytest.approx(flat.estimate_us, rel=1e-12)
    assert res["fallback_phases"] == ["flat"]
    assert res["registry"] == {b: ref_sel.choose(
        "all_reduce", n=16, nbytes=b, link=REF_UNFITTED)
        for b in (1 << 17, 1 << 30)}


# -- all eight files -----------------------------------------------------------
def _tree(name):
    return ast.parse((ROOT / "examples_torch" / f"{name}.py").read_text())


def test_eight_examples_one_per_reference_example():
    port = sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py"))
    ref = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert port == ref == sorted(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_the_reference(name):
    mods = set()
    for node in ast.walk(_tree(name)):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    roots = {m.split(".")[0] for m in mods}
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, mods
    assert "repro_torch" in roots


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_shape_and_nothing_runs_at_import(name, capsys):
    tree = _tree(name)
    assert ast.get_docstring(tree)
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    assert main.args.args[0].arg == "argv"
    assert isinstance(main.args.defaults[0], ast.Constant) \
        and main.args.defaults[0].value is None
    # at top level: the docstring, imports, constants, defs and the
    # __main__ guard only
    for node in tree.body:
        ok = isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef,
                               ast.ClassDef, ast.Assign, ast.AnnAssign))
        ok |= isinstance(node, ast.Expr) and isinstance(node.value,
                                                        ast.Constant)
        ok |= isinstance(node, ast.If) and "__main__" in ast.dump(node.test)
        assert ok, ast.dump(node)[:200]
    mod = example(name)
    assert capsys.readouterr().out == ""
    assert callable(mod.main)


@pytest.mark.parametrize("name", EXAMPLES)
def test_default_device_is_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main([])
