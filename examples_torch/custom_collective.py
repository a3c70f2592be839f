"""The paper's core user story (§4.3) on the port: author a *custom*
collective for your workload in the DSL, validate it, run it on both
executors and cost it against the library's algorithms — without
touching the library.

Here: a broadcast-reduce ("one-shot AllReduce with a root hop"): every
rank puts its buffer into every peer's slot, then every rank reduces
its gathered slots. Two rounds, a deliberately non-library algorithm to
show the declaration surface. The eight ranks are stacked on one card
(``x[r]`` is rank ``r``'s buffer); on the card the program runs on the
hand-written executor kernel (``cuda``) beside its plain version
(``torch``), and the two must agree bit for bit.

    PYTHONPATH=src python examples_torch/custom_collective.py  # the card
    PYTHONPATH=src python examples_torch/custom_collective.py --device cpu

Departure from ``examples/custom_collective.py``: the costs are the
α-β model under ``selector.UNFITTED`` (the port's placeholder link for
ranks on one card), not ``selector.ICI`` (the reference's TPU
constants).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import selector
from repro_torch.core.dsl import PEER, RANK, Program, program_to_dict
from repro_torch.core.executor import execute
from repro_torch.mesh import resolve_device

N = 8
SIZES = (1 << 10, 1 << 16, 1 << 20)


def rooted_allreduce(n: int, root: int = 0) -> Program:
    p = Program("rooted_ar", chunks=dict(input=1, scratch=n, output=1))
    # round 1: everyone (incl. root's self-copy) stages into root's slots
    p.local_copy(("scratch", RANK), ("input", 0))
    with p.round():
        for i in range(1, n):
            p.put(src=("input", 0), dst=("scratch", RANK), to=PEER(+i))
    with p.round():
        for i in range(1, n):
            p.wait(("scratch", PEER(+i)), frm=PEER(+i))
    # every rank reduces its gathered slots (symmetric keeps the program
    # SPMD; a root-only reduce + result broadcast is equally expressible)
    del root
    p.local_reduce(("output", 0),
                   [("scratch", RANK)] +
                   [("scratch", PEER(+i)) for i in range(1, n)])
    return p.freeze()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    prog = rooted_allreduce(N)
    prog.validate(N)
    print(prog)
    stats = prog.comm_stats(N, chunk_bytes=1024)
    print("stats:", stats)

    x = torch.from_numpy(np.random.RandomState(0).randn(
        N, 16, 128).astype(np.float32)).to(device)
    want = x.sum(0)
    outs, errs = {}, {}
    for backend in ("torch",) + (("cuda",) if device.type == "cuda"
                                 else ()):
        outs[backend] = execute(prog, x, backend=backend)
        errs[backend] = float((outs[backend][0] - want).abs().max())
        print(f"executor={backend:7s} max_err={errs[backend]:.2e}")
    same = (bool(torch.equal(outs["cuda"], outs["torch"]))
            if "cuda" in outs else None)
    if same is not None:
        print(f"executor=cuda bit-equal to executor=torch: {same}")

    # compare against the library algorithms under the α-β model
    costs = []
    for nbytes in SIZES:
        st = prog.comm_stats(N, max(nbytes, 1))
        mine = selector.UNFITTED.time_us(st["comm_rounds"],
                                         st["wire_bytes_per_rank"])
        lib = selector.choose("all_reduce", n=N, nbytes=nbytes)
        lib_t = selector.estimate_us(lib, N, nbytes)
        print(f"{nbytes:>8d}B  rooted={mine:8.1f}us  "
              f"library[{lib}]={lib_t:8.1f}us")
        costs.append(dict(nbytes=nbytes, rooted_us=mine, library=lib,
                          library_us=lib_t))
    return dict(program=program_to_dict(prog), stats=stats, max_err=errs,
                cuda_equals_torch=same, costs=costs, device=str(device))


if __name__ == "__main__":
    main()
