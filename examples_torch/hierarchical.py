"""Hierarchical (two-axis) AllReduce walkthrough on the port.

The 2PH composition on a 4 x 4 (node x local) rank grid, the 16 ranks
stacked node-major on one card (rank = node * 4 + local,
``mesh.RankGrid``):

1. build a HierarchicalCommunicator (a link model per axis) and compile
   the RS(local) -> AR(node) -> AG(local) plan;
2. replay it on the stacked payload (on the card: three launches of the
   executor kernel, one a phase, each over every group of its axis) and
   check the sum;
3. serialize / reload via ``api.load_plan`` (kind="hierarchical_plan")
   and re-verify every nested phase program;
4. compare the modelled cost against the flat 16-rank plan that pays the
   cross-node link for every byte;
5. watch the single-axis fallback degrade to one flat plan;
6. peek at the n = 16 registry the phases select from.

    PYTHONPATH=src python examples_torch/hierarchical.py            # card
    PYTHONPATH=src python examples_torch/hierarchical.py --device cpu

On the card the replay is also held bit-equal to the same plan on the
plain executor. Departure from ``examples/hierarchical.py``: the per-axis
links are the port's own — the local axis on ``selector.UNFITTED`` (the
placeholder for ranks on one card), the node axis at the datasheet
network rate of an HGX H100 node (``roofline.analysis.H100.net_bw``,
UNFITTED's α) — not the reference's TPU ICI and DCN constants.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core import selector as sel
from repro_torch.core.comm import Communicator, HierarchicalCommunicator
from repro_torch.core.executor import CudaExecutor
from repro_torch.mesh import RankGrid, resolve_device
from repro_torch.roofline.analysis import H100

L, M = 4, 4                      # local (intra) x node (inter)
ROWS, COLS = 128, 64
#: the node axis: the datasheet network rate of an H100 node
NODE_LINK = dataclasses.replace(sel.UNFITTED, beta_GBps=H100.net_bw / 1e9)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    grid = RankGrid(M, L)

    # integer-valued payloads: the sum is exact in f32, so the replay can
    # be compared bit for bit
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -8, 8, (grid.size, ROWS, COLS)).astype(np.float32)).to(device)
    want = x.sum(0)
    res: dict = dict(device=str(device), cuda_equals_torch=None)

    # -- 1. compile the composed plan ---------------------------------------
    hc = HierarchicalCommunicator("local", "node", local_n=L, node_n=M,
                                  device=device, node_link=NODE_LINK)
    plan = hc.compile((ROWS, COLS), torch.float32)
    phases = {k: p.algo for k, p in plan.phases.items()}
    print(f"[plan] {plan}")
    print(f"[plan] phases: {phases} pad={plan.pad}")
    res.update(algo=plan.algo, phases=phases, pad=plan.pad,
               groups={k: (p.groups, p.stride)
                       for k, p in plan.phases.items()})

    # -- 2. replay it over both axes ----------------------------------------
    before = CudaExecutor.launches
    out = plan(x)
    launches = CudaExecutor.launches - before
    exact = all(bool(torch.equal(out[r], want)) for r in range(grid.size))
    print(f"[exec] bit-equal to the {grid.size}-rank sum: {exact}; "
          f"{launches} executor launches; cache stats={hc.stats}")
    res.update(exact=exact, launches_per_replay=launches)
    if on_card:
        plain = HierarchicalCommunicator(
            "local", "node", local_n=L, node_n=M, device=device,
            node_link=NODE_LINK, backend="torch").compile(
                (ROWS, COLS), torch.float32)
        res["cuda_equals_torch"] = bool(torch.equal(out, plain(x)))
        print(f"[exec] executor kernel bit-equal to the plain executor: "
              f"{res['cuda_equals_torch']}")

    # -- 3. serialize / reload / re-verify ----------------------------------
    loaded = api.load_plan(plan.to_json(), device=device)  # verifies phases
    report = api.verify_plan(loaded)
    same = bool(torch.equal(loaded(x), out))
    print(f"[json] round-tripped plan verifies clean ({report.summary()}) "
          f"and replays bit-identical: {same}")
    res.update(verify=report.summary(), json_bit_identical=same)

    # -- 4. why bother: the modelled cost of the two links ------------------
    flat = Communicator("fx", n=L * M, device=device,
                        link=NODE_LINK).compile(
        "all_reduce", (ROWS, COLS), torch.float32)
    print(f"[model] flat n={L * M} on the node link: {flat.estimate_us:.1f}us "
          f"({flat.algo}) vs hierarchical {plan.estimate_us:.1f}us "
          f"({plan.algo}) -> {flat.estimate_us / plan.estimate_us:.2f}x "
          f"(only 1/{L} of the bytes cross nodes)")
    res.update(flat_us=flat.estimate_us, flat_algo=flat.algo,
               hier_us=plan.estimate_us)

    # -- 5. the single-axis fallback ----------------------------------------
    flat_hc = HierarchicalCommunicator("local", local_n=L, device=device)
    fallback = list(flat_hc.compile((ROWS, COLS), torch.float32).phases)
    print(f"[fallback] node_axis=None -> phases={fallback}")
    res["fallback_phases"] = fallback

    # -- 6. the widened registry the phases select from ---------------------
    res["registry"] = {}
    for nbytes in (1 << 17, 1 << 30):
        pick = sel.choose("all_reduce", n=16, nbytes=nbytes)
        print(f"[registry] n=16 {nbytes >> 10}KiB -> {pick}")
        res["registry"][nbytes] = pick
    return res


if __name__ == "__main__":
    main()
