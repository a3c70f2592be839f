"""Communicator + ExecutionPlan walkthrough on the port — compile once,
execute many.

The paper's production story (§4.4, §5.2): a deployment sets up a
communicator, compiles its collective plans ONCE, and replays them
every step. This example walks the whole surface with eight ranks
stacked on one card:

1. build a Communicator (axis, link model, defaults);
2. compile an ExecutionPlan and inspect its cost card;
3. replay the plan (on the card: one executor-kernel launch a replay);
4. dump the plan to JSON and reload it (MSCCL++ plan-file shape);
5. install a TuningTable and watch the algorithm choice change;
6. fit α/β link constants from traces this run captured, and install
   the fit on a second communicator.

    PYTHONPATH=src python examples_torch/communicator.py            # card
    PYTHONPATH=src python examples_torch/communicator.py --device cpu

On the card each replay is also held bit-equal to the same plan on the
plain executor. Departure from ``examples/communicator.py``: step 6
does not read ``BENCH_collectives.json``, which records the reference's
CPU emulation; it captures traces of ring AllReduce plans in this run
(``trace.capture_plan``: on the card the executor kernel's own stamps)
and fits the link from them (``selector.fit_from_traces``).
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import selector as sel
from repro_torch.core import trace
from repro_torch.core.comm import Communicator, ExecutionPlan
from repro_torch.mesh import resolve_device

N = 8
FIT_SHAPES = ((64, 8), (1024, 128), (4096, 128))   # the traced ring plans


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    x = torch.from_numpy(np.random.RandomState(0).randn(
        N, 128, 256).astype(np.float32)).to(device)
    want = x.sum(0)
    res: dict = dict(device=str(device), cuda_equals_torch=None)

    # -- 1. a communicator: the init-once planning object -------------------
    comm = Communicator("x", n=N, device=device)
    print(f"[comm] {comm}")

    # -- 2. compile a plan, inspect the cost card ---------------------------
    plan = comm.compile("all_reduce", (128, 256), torch.float32)
    print(f"[plan] {plan}")
    print(f"[plan] cost card: {plan.cost_card()}")
    res.update(algo=plan.algo, backend=plan.backend,
               cost_card=plan.cost_card())

    # -- 3. execute it — zero re-planning -----------------------------------
    for _ in range(3):            # "every decode step" in miniature
        out = plan(x)
    err = float((out[0] - want).abs().max())
    print(f"[plan] executed 3x, max_err={err:.2e}, cache stats={comm.stats}")
    res.update(max_err=err, stats_after_replays=dict(comm.stats))
    if on_card:
        plain = Communicator("x", n=N, device=device, backend="torch")
        res["cuda_equals_torch"] = bool(torch.equal(
            out, plain.compile("all_reduce", (128, 256), x.dtype)(x)))
        print(f"[plan] executor kernel bit-equal to the plain executor: "
              f"{res['cuda_equals_torch']}")

    # comm.all_reduce is compile-or-hit-cache: same key -> same plan object
    comm.all_reduce(x)
    print(f"[comm] after comm.all_reduce with the same key: "
          f"stats={comm.stats} (hits grew, compiles did not)")
    res["stats_after_all_reduce"] = dict(comm.stats)

    # -- 4. serialize / reload (the MSCCL++ execution-plan-file shape) ------
    plan_path = pathlib.Path(tempfile.mkdtemp(
        prefix="repro_torch_plan_")) / "allreduce_plan.json"
    plan_path.write_text(plan.to_json())
    plan2 = ExecutionPlan.from_json(plan_path.read_text(), device=device)
    same = bool(torch.equal(plan2(x), out))
    print(f"[json] wrote {plan_path} ({plan_path.stat().st_size} bytes); "
          f"reloaded plan bit-identical: {same}")
    res.update(json_bit_identical=same, plan_path=str(plan_path))

    # -- 5. deployment tuning: a table overrides the cost model -------------
    tuned = Communicator("x", n=N, device=device, table=sel.TuningTable(
        entries=[("all_reduce", 1 << 30, "allreduce_ring")]))
    p_tuned = tuned.compile("all_reduce", (128, 256), torch.float32)
    print(f"[tuning] table forces {p_tuned.algo} where the model picked "
          f"{plan.algo}")
    res["tuned_algo"] = p_tuned.algo

    # -- 6. fitted link constants from this run's traces --------------------
    traces = [trace.capture_plan(comm.compile(
        "all_reduce", shape, torch.float32, algo="allreduce_ring",
        opt_level=2)) for shape in FIT_SHAPES]
    fitted = sel.fit_from_traces(traces)
    print(f"[fit] measured constants from {len(traces)} traces "
          f"({sum(len(t.events) for t in traces)} events): "
          f"alpha={fitted.alpha_us:.2f}us beta={fitted.beta_GBps:.2f}GB/s "
          f"(guessed: alpha={sel.UNFITTED.alpha_us}us "
          f"beta={sel.UNFITTED.beta_GBps}GB/s)")
    fit_comm = Communicator("x", n=N, device=device, link=fitted)
    p_fit = fit_comm.compile("all_reduce", (128, 256), torch.float32)
    print(f"[fit] installed on a second communicator -> {fit_comm}; "
          f"it picks {p_fit.algo} at 128 KiB a rank")
    res.update(trace_events=[len(t.events) for t in traces],
               fitted=dict(alpha_us=fitted.alpha_us,
                           beta_GBps=fitted.beta_GBps,
                           sync_us=fitted.sync_us, torus=fitted.torus),
               fitted_algo=p_fit.algo)
    return res


if __name__ == "__main__":
    main()
