"""Algorithm selection — the α-β cost model over the DSL programs'
analytic stats (rounds = α term, bytes-on-wire = β term), ported from
``repro.core.selector`` as far as the plan layer uses it.

``ICI``/``DCN`` are the reference's TPU constants, kept only so a
parity test can hold :func:`choose` against the reference. They
describe no part of the H100. The port's default link
(:data:`UNFITTED`) is a named placeholder: its numbers are not fitted
to any measurement, and a later PR fits them from timings on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core import algorithms as algos
from repro_torch.core import passes

__all__ = ["LinkModel", "ICI", "DCN", "UNFITTED", "estimate_us", "choose",
           "CANDIDATES", "supports"]


@dataclasses.dataclass(frozen=True)
class LinkModel:
    alpha_us: float       # per-round latency
    beta_GBps: float      # per-rank injection bandwidth
    torus: bool = True    # point-to-point torus: puts pay hop distance
    sync_us: float = 0.2  # per EXTRA sync step beyond one per round

    def time_us(self, rounds: int, bytes_on_wire: int,
                extra_syncs: int = 0) -> float:
        return (rounds * self.alpha_us + extra_syncs * self.sync_us
                + bytes_on_wire / (self.beta_GBps * 1e3))


# the reference's TPU v5e constants (parity tests only)
ICI = LinkModel(alpha_us=1.0, beta_GBps=50.0, torus=True, sync_us=0.2)
DCN = LinkModel(alpha_us=10.0, beta_GBps=6.25, torus=False, sync_us=1.0)

#: Placeholder for ranks stacked on one H100: all-to-all addressing (no
#: torus hops), one flag handshake per round. UNFITTED — these are not
#: measured values; they only rank candidates until a fit replaces them.
UNFITTED = LinkModel(alpha_us=1.0, beta_GBps=100.0, torus=False,
                     sync_us=0.2)

CANDIDATES: dict[str, list[str]] = {
    "all_reduce": ["allreduce_1pa", "allreduce_2pa", "allreduce_ring",
                   "allreduce_rd", "swing_allreduce"],
    "all_gather": ["allpairs_ag", "ring_ag", "doubling_ag"],
    "reduce_scatter": ["allpairs_rs", "ring_rs", "halving_rs"],
    "all_to_all": ["alltoall"],
}

# geometry-restricted candidates (power-of-two log-step family)
_SUPPORTS: dict[str, Callable[[int], bool]] = {
    name: algos.is_power_of_two
    for name in ("allreduce_rd", "swing_allreduce", "doubling_ag",
                 "halving_rs")
}


def supports(name: str, n: int) -> bool:
    """True when algorithm ``name`` can run on an ``n``-rank axis."""
    pred = _SUPPORTS.get(name)
    return pred is None or bool(pred(n))


def estimate_us(algo_name: str, n: int, nbytes: int,
                link: LinkModel = UNFITTED,
                opt_level: Optional[int] = None) -> float:
    """α-β estimate for one algorithm on an n-rank axis, costed in its
    post-optimizer form at ``opt_level`` (default pipeline level)."""
    if not supports(algo_name, n):
        raise ValueError(
            f"algorithm {algo_name!r} does not support n={n} ranks; "
            f"choose() skips it automatically")
    prog = passes.optimize(algos.REGISTRY[algo_name](n),
                           passes.DEFAULT_OPT_LEVEL if opt_level is None
                           else opt_level, n)
    n_in = prog.chunks[prog.in_buffer]
    chunk_bytes = max(nbytes // n_in, 1)
    stats = prog.comm_stats(n, chunk_bytes)
    bytes_key = "wire_bytes_per_rank" if link.torus else "bytes_per_rank"
    return link.time_us(stats["comm_rounds"] + stats["barriers"],
                        stats[bytes_key],
                        extra_syncs=max(0, stats["sync_steps"]
                                        - stats["comm_rounds"]))


def choose(collective: str, *, n: int, nbytes: int,
           link: LinkModel = UNFITTED,
           opt_level: Optional[int] = None) -> str:
    """The candidate with the least α-β estimate at ``opt_level``."""
    cands = [a for a in CANDIDATES[collective] if supports(a, n)]
    return min(cands, key=lambda a: estimate_us(a, n, nbytes, link,
                                                opt_level=opt_level))
