"""Roofline terms of a step on NVIDIA H100 GPUs (port of
``repro.roofline.analysis``).

    compute    = FLOPs / peak
    memory     = traffic bytes / HBM rate
    collective = NVLink bytes / NVLink rate + network bytes / network rate

every term one rank's seconds. The counts come from
:mod:`~repro_torch.roofline.op_stats` (a step run on fake tensors, its
plan calls recorded), not from HLO: the port has none to read.

:data:`H100` holds datasheet figures, not measurements: an H100 SXM5
(NVIDIA H100 80GB HBM3, the card the port's chip runs use, at a power
limit of 700.00 W as ``nvidia-smi --query-gpu=name,power.limit`` reads
it), in an HGX H100 node of 8 GPUs:

* dense bf16 tensor-core peak 989 TFLOP/s;
* HBM3 3.35 TB/s, 80 GB;
* NVLink 4, 18 links: 450 GB/s a direction a GPU;
* one 400 Gb/s NDR port a GPU across nodes: 50 GB/s.

A card run below 700 W runs slower under load than these.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "H100", "HBM_BYTES_PER_S", "BF16_FLOPS_PER_S",
           "collective_bytes", "roofline", "RooflineReport"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float      # FLOP/s a GPU
    hbm_bw: float          # B/s a GPU
    nvlink_bw: float       # B/s a direction a GPU, inside a node
    node_ranks: int        # GPUs of one NVLink domain
    net_bw: float          # B/s a GPU across nodes
    hbm_bytes: float = 80e9


H100 = HW(peak_flops=989e12, hbm_bw=3.35e12, nvlink_bw=450e9, node_ranks=8,
          net_bw=50e9, hbm_bytes=80e9)

#: the two constants every phase of ``chip_smoke.py`` bounds its kernels by
HBM_BYTES_PER_S = H100.hbm_bw
BF16_FLOPS_PER_S = H100.peak_flops

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "broadcast")


def spans_nodes(ranks, node_ranks: int) -> bool:
    """Whether a rank group reaches past one node of ``node_ranks``."""
    return len({r // node_ranks for r in ranks}) > 1


def collective_bytes(calls, *, node_ranks: int = H100.node_ranks) -> dict:
    """Per collective and per link, the bytes of the recorded plan calls
    (``op_stats.PlanRecorder.calls``: each a dict of ``collective``,
    ``bytes`` a rank and the traced rank's ``ranks`` group). A group that
    spans two nodes counts as network bytes, any other as NVLink bytes."""
    out = {c: 0 for c in COLLECTIVES}
    out.update(nvlink=0, network=0)
    for c in calls:
        out[c["collective"]] += c["bytes"]
        link = "network" if spans_nodes(c["ranks"], node_ranks) else "nvlink"
        out[link] += c["bytes"]
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    cell: str
    mesh: str
    ranks: int
    flops: float
    traffic_bytes: float
    coll_nvlink_bytes: float
    coll_network_bytes: float
    model_flops: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    @property
    def dominant(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / the largest term: 1.0 is compute-bound."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def row(self) -> str:
        return (f"| {self.arch} | {self.cell} | {self.mesh} "
                f"| {self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} "
                f"| {self.collective_s*1e3:.2f} | {self.dominant} "
                f"| {self.useful_flop_ratio:.2f} "
                f"| {self.roofline_fraction:.2f} |")


def roofline(*, arch: str, cell: str, mesh_name: str, ranks: int, stats,
             model_flops: float, hw: HW = H100) -> RooflineReport:
    """The three terms of one rank from ``stats`` (an ``OpStats`` of one
    rank's step: FLOPs, traffic bytes, ``coll["nvlink"]`` and
    ``coll["network"]``); ``model_flops`` is one rank's useful share."""
    rep = RooflineReport(
        arch=arch, cell=cell, mesh=mesh_name, ranks=ranks,
        flops=stats.flops, traffic_bytes=stats.traffic_bytes,
        coll_nvlink_bytes=float(stats.coll["nvlink"]),
        coll_network_bytes=float(stats.coll["network"]),
        model_flops=model_flops)
    rep.compute_s = stats.flops / hw.peak_flops
    rep.memory_s = stats.traffic_bytes / hw.hbm_bw
    rep.collective_s = (stats.coll["nvlink"] / hw.nvlink_bw
                        + stats.coll["network"] / hw.net_bw)
    return rep
