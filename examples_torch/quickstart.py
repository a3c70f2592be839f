"""Quickstart: the MSCCL++ API levels on the port, eight ranks stacked on
one card (``x[r]`` is rank ``r``'s buffer).

    PYTHONPATH=src python examples_torch/quickstart.py            # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

1. Collective API  — drop-in all_reduce, algorithm auto-selected (thin
                     wrapper over a process-default Communicator), on
                     ``torch_native`` (one PyTorch call), ``torch`` (the
                     plain executor) and ``cuda`` (the executor kernel);
2. Communicator    — the production surface: compile an ExecutionPlan
                     once, inspect its cost card, replay it every step
                     (see examples_torch/communicator.py for the tour);
3. DSL API         — a one-hop reduce-scatter declared in 20 lines and
                     run on both executors;
4. the selector's AllReduce policy table.

On the card every executor result is also held bit-equal to the plain
executor's on the same input. Departure from ``examples/quickstart.py``:
the policy table is the one under ``selector.UNFITTED`` (the port's
placeholder link for ranks on one card), not the reference's "v5e ICI".
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import api, selector
from repro_torch.core.comm import Communicator
from repro_torch.core.dsl import PEER, RANK, Program, program_to_dict
from repro_torch.core.executor import execute
from repro_torch.mesh import resolve_device

N = 8
SELECTOR_EXPS = (10, 13, 16, 19, 22, 26, 30)


def my_rs(n: int) -> Program:
    """A one-hop reduce-scatter: every rank puts its chunk for each peer
    into that peer's slot, then reduces its own chunk with the n - 1
    slots."""
    prog = Program("my_rs", chunks=dict(input=n, scratch=n, output=1))
    with prog.round():
        for i in range(1, n):
            prog.put(src=("input", PEER(+i)), dst=("scratch", RANK),
                     to=PEER(+i))
    with prog.round():
        for i in range(1, n):
            prog.wait(("scratch", PEER(+i)), frm=PEER(+i))
    prog.local_reduce(("output", 0),
                      [("input", RANK)] +
                      [("scratch", PEER(+i)) for i in range(1, n)])
    return prog.freeze()


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
    res: dict = dict(device=str(device), max_err={}, cuda_equals_torch={})

    # -- 1. Collective API --------------------------------------------------
    algo = selector.choose("all_reduce", n=N, nbytes=x[0].nbytes)
    outs = {}
    for backend in ("torch_native", "torch") + (("cuda",) if on_card
                                                 else ()):
        outs[backend] = api.all_reduce(x, "x", backend=backend)
        err = float((outs[backend][0] - want).abs().max())
        res["max_err"][f"collective/{backend}"] = err
        print(f"[collective] backend={backend:12s} algo={algo:16s} "
              f"max_err={err:.2e}")
    res["collective_algo"] = algo
    if on_card:
        res["cuda_equals_torch"]["collective"] = bool(
            torch.equal(outs["cuda"], outs["torch"]))

    # -- 2. Communicator: compile once, execute many ------------------------
    comm = Communicator("x", n=N, device=device)
    plan = comm.compile("all_reduce", (128, 256), x.dtype)
    print(f"[comm] compiled {plan}")
    for _ in range(3):
        out = plan(x)                  # pure plan replay — no re-planning
    err = float((out[0] - want).abs().max())
    print(f"[comm] 3 executions, max_err={err:.2e}, stats={comm.stats}")
    res.update(plan_algo=plan.algo, plan_backend=plan.backend,
               comm_stats=dict(comm.stats))
    res["max_err"]["comm"] = err
    if on_card:
        plain = Communicator("x", n=N, device=device, backend="torch")
        res["cuda_equals_torch"]["comm"] = bool(torch.equal(
            out, plain.compile("all_reduce", (128, 256), x.dtype)(x)))

    # -- 3. DSL API: declare a custom one-hop reduce-scatter ----------------
    prog = my_rs(N)
    prog.validate(N)
    stats = prog.comm_stats(N, 1024)
    print(f"[dsl] program:\n{prog}")
    print(f"[dsl] comm stats @1KB chunks: {stats}")
    res.update(program=program_to_dict(prog), dsl_stats=stats)
    xs = x.reshape(N, N * 16, 256)               # (N, 16, 256) a rank chunk
    ref = x.reshape(N, N, 16, 256).sum(0)        # (N, 16, 256)
    ys = {}
    for backend in ("torch",) + (("cuda",) if on_card else ()):
        ys[backend] = execute(prog, xs, backend=backend)
        err = float((ys[backend] - ref).abs().max())
        res["max_err"][f"dsl/{backend}"] = err
        print(f"[dsl] executor={backend:7s} reduce-scatter max_err={err:.2e}")
    if on_card:
        res["cuda_equals_torch"]["dsl"] = bool(
            torch.equal(ys["cuda"], ys["torch"]))
        print(f"[dsl] executor=cuda bit-equal to executor=torch: "
              f"{res['cuda_equals_torch']}")

    # -- 4. algorithm selection table ---------------------------------------
    print("\n[selector] AllReduce policy (UNFITTED link, ranks on one card):")
    res["policy"] = {}
    for exp in SELECTOR_EXPS:
        pick = selector.choose("all_reduce", n=N, nbytes=1 << exp)
        res["policy"][1 << exp] = pick
        print(f"   {1 << exp:>12d} B -> {pick}")
    return res


if __name__ == "__main__":
    main()
