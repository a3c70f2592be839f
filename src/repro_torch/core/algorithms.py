"""Collective algorithms declared in the MSCCL++ DSL (paper §4.4).

Each builder returns a ``dsl.Program`` symbolic in rank, valid for any
axis size ``n``. These are the paper's default collective library:

* ``allreduce_1pa``  — one-phase all-pairs (small messages; fewest syncs)
* ``allreduce_2pa``  — two-phase all-pairs RS+AG (medium messages)
* ``allpairs_rs`` / ``allpairs_ag`` — the 2PA building blocks (Fig. 5)
* ``ring_ag`` / ``ring_rs`` / ``allreduce_ring`` — bandwidth-optimal for
  large messages
* ``alltoall``      — MoE dispatch/combine
* ``broadcast_allpairs`` — root broadcast via gather+select

2PH (hierarchical) is a *composition* over two mesh axes and lives in
``api.hierarchical_all_reduce`` — the DSL is single-axis by design,
mirroring MSCCLang's per-communicator programs.
"""
from __future__ import annotations

import functools

from repro_torch.core.dsl import CONST, PARITY_PEER, PEER, RANK, Program

__all__ = [
    "allpairs_rs", "allpairs_ag", "allreduce_1pa", "allreduce_2pa",
    "ring_ag", "ring_rs", "allreduce_ring", "alltoall",
    "broadcast_allpairs", "halving_rs", "doubling_ag", "allreduce_rd",
    "swing_allreduce", "is_power_of_two", "REGISTRY",
]


def is_power_of_two(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _require_power_of_two(name: str, n: int) -> int:
    """log2(n), or an actionable error: the recursive-distance family
    only closes over power-of-two rings (selector falls back to ring
    elsewhere — see ``selector.supports``)."""
    if not is_power_of_two(n) or n < 2:
        raise ValueError(
            f"{name} requires a power-of-two axis size >= 2, got n={n}; "
            f"use a ring/all-pairs algorithm for this size (the selector "
            f"does this automatically)")
    return n.bit_length() - 1


@functools.lru_cache(maxsize=None)
def allpairs_rs(n: int) -> Program:
    """All-pairs ReduceScatter — paper Fig. 5, one network hop."""
    p = Program("allpairs_rs", chunks=dict(input=n, scratch=n, output=1))
    with p.round():
        for i in range(1, n):
            p.put(src=("input", PEER(+i)), dst=("scratch", RANK), to=PEER(+i))
    with p.round():
        for i in range(1, n):
            p.wait(("scratch", PEER(+i)), frm=PEER(+i))
    p.local_reduce(("output", 0),
                   [("input", RANK)] + [("scratch", PEER(+i)) for i in range(1, n)])
    return p.freeze()


@functools.lru_cache(maxsize=None)
def allpairs_ag(n: int) -> Program:
    """All-pairs AllGather — one hop, N× fan-out."""
    p = Program("allpairs_ag", chunks=dict(input=1, output=n))
    p.local_copy(("output", RANK), ("input", 0))
    with p.round():
        for i in range(1, n):
            p.put(src=("input", 0), dst=("output", RANK), to=PEER(+i))
    with p.round():
        for i in range(1, n):
            p.wait(("output", PEER(+i)), frm=PEER(+i))
    return p.freeze()


@functools.lru_cache(maxsize=None)
def allreduce_1pa(n: int) -> Program:
    """One-phase all-pairs AllReduce: broadcast whole buffer, reduce
    locally. Latency-optimal for tiny messages (paper §4.4-1PA)."""
    p = Program("allreduce_1pa", chunks=dict(input=1, scratch=n, output=1))
    with p.round():
        for i in range(1, n):
            p.put(src=("input", 0), dst=("scratch", RANK), to=PEER(+i))
    with p.round():
        for i in range(1, n):
            p.wait(("scratch", PEER(+i)), frm=PEER(+i))
    p.local_reduce(("output", 0),
                   [("input", 0)] + [("scratch", PEER(+i)) for i in range(1, n)])
    return p.freeze()


@functools.lru_cache(maxsize=None)
def allreduce_2pa(n: int) -> Program:
    """Two-phase all-pairs AllReduce = all-pairs RS + all-pairs AG
    (paper §4.4-2PA). Bandwidth 2(N-1)/N × message, two hops."""
    p = Program("allreduce_2pa", chunks=dict(input=n, scratch=n, output=n))
    # phase 1: RS
    with p.round():
        for i in range(1, n):
            p.put(src=("input", PEER(+i)), dst=("scratch", RANK), to=PEER(+i))
    with p.round():
        for i in range(1, n):
            p.wait(("scratch", PEER(+i)), frm=PEER(+i))
    p.local_reduce(("output", RANK),
                   [("input", RANK)] + [("scratch", PEER(+i)) for i in range(1, n)])
    # phase 2: AG of the reduced shard
    with p.round():
        for i in range(1, n):
            p.put(src=("output", RANK), dst=("output", RANK), to=PEER(+i))
    with p.round():
        for i in range(1, n):
            p.wait(("output", PEER(+i)), frm=PEER(+i))
    return p.freeze()


@functools.lru_cache(maxsize=None)
def ring_ag(n: int) -> Program:
    """Ring AllGather: N-1 neighbor hops, bandwidth-optimal."""
    p = Program("ring_ag", chunks=dict(input=1, output=n))
    p.local_copy(("output", RANK), ("input", 0))
    for s in range(n - 1):
        with p.round():
            p.put(src=("output", PEER(-s)), dst=("output", PEER(-s)),
                  to=PEER(+1))
            p.wait(("output", PEER(-s - 1)), frm=PEER(-1))
    return p.freeze()


@functools.lru_cache(maxsize=None)
def ring_rs(n: int) -> Program:
    """Ring ReduceScatter: partial sums travel the ring (paper Fig. 1's
    NCCL algorithm, re-expressed one-sided)."""
    # Chunk ownership: chunk c is first sent by rank c+1 (= PEER(-1) of the
    # sender), travels n-1 hops accumulating every rank's contribution, and
    # lands fully-reduced at rank c — receiver r finishes with chunk r.
    p = Program("ring_rs", chunks=dict(input=n, scratch=n, output=1))
    with p.round():
        p.put(src=("input", PEER(-1)), dst=("scratch", PEER(-1)), to=PEER(+1))
    for s in range(1, n - 1):
        with p.round():
            p.wait(("scratch", PEER(-s - 1)), frm=PEER(-1))
            p.local_reduce(("scratch", PEER(-s - 1)),
                           [("scratch", PEER(-s - 1)), ("input", PEER(-s - 1))])
            p.put(src=("scratch", PEER(-s - 1)), dst=("scratch", PEER(-s - 1)),
                  to=PEER(+1))
    with p.round():
        p.wait(("scratch", RANK), frm=PEER(-1))
    p.local_reduce(("output", 0), [("scratch", RANK), ("input", RANK)])
    return p.freeze()


@functools.lru_cache(maxsize=None)
def allreduce_ring(n: int) -> Program:
    """Ring AllReduce = ring RS + ring AG, bandwidth-optimal for large
    messages."""
    p = Program("allreduce_ring", chunks=dict(input=n, scratch=n, output=n))
    # RS phase (as ring_rs, but the reduced shard lands in output[RANK])
    with p.round():
        p.put(src=("input", RANK), dst=("scratch", RANK), to=PEER(+1))
    for s in range(1, n - 1):
        with p.round():
            p.wait(("scratch", PEER(-s)), frm=PEER(-1))
            p.local_reduce(("scratch", PEER(-s)),
                           [("scratch", PEER(-s)), ("input", PEER(-s))])
            p.put(src=("scratch", PEER(-s)), dst=("scratch", PEER(-s)),
                  to=PEER(+1))
    with p.round():
        p.wait(("scratch", PEER(-(n - 1))), frm=PEER(-1))
    p.local_reduce(("output", PEER(-(n - 1))),
                   [("scratch", PEER(-(n - 1))), ("input", PEER(-(n - 1)))])
    # AG phase: circulate the reduced shards
    for s in range(n - 1):
        with p.round():
            p.put(src=("output", PEER(-(n - 1) - s)),
                  dst=("output", PEER(-(n - 1) - s)), to=PEER(+1))
            p.wait(("output", PEER(-(n - 1) - s - 1)), frm=PEER(-1))
    return p.freeze()


@functools.lru_cache(maxsize=None)
def alltoall(n: int) -> Program:
    """All-pairs AllToAll (MoE dispatch)."""
    p = Program("alltoall", chunks=dict(input=n, output=n))
    p.local_copy(("output", RANK), ("input", RANK))
    with p.round():
        for i in range(1, n):
            p.put(src=("input", PEER(+i)), dst=("output", RANK), to=PEER(+i))
    with p.round():
        for i in range(1, n):
            p.wait(("output", PEER(+i)), frm=PEER(+i))
    return p.freeze()


@functools.lru_cache(maxsize=None)
def broadcast_allpairs(n: int, root: int = 0) -> Program:
    """Root broadcast via all-pairs gather + select. SPMD-expressible
    (every rank puts; receivers keep only the root's chunk)."""
    p = Program("broadcast_allpairs", chunks=dict(input=1, scratch=n, output=1))
    p.local_copy(("scratch", RANK), ("input", 0))
    with p.round():
        for i in range(1, n):
            p.put(src=("input", 0), dst=("scratch", RANK), to=PEER(+i))
    with p.round():
        for i in range(1, n):
            p.wait(("scratch", PEER(+i)), frm=PEER(+i))
    p.local_copy(("output", 0), ("scratch", CONST(root)))
    return p.freeze()


@functools.lru_cache(maxsize=None)
def halving_rs(n: int) -> Program:
    """Recursive-halving ReduceScatter (power-of-two n): log2(n) rounds,
    ring-equal n-1 chunks on the wire. At step distance d each rank
    sends its partial window [r+d, r+2d) to r+d and folds the window
    [r, r+d) received from r-d, halving the live window per step until
    only the fully-reduced chunk r remains.

    Running partials live in ``acc`` (local-only, indexed by absolute
    chunk); every step receives into its own disjoint ``scratch`` slot
    range (offset n-2d), so no slot is ever reused across rounds — the
    hazard discipline the static verifier enforces."""
    k = _require_power_of_two("halving_rs", n)
    p = Program("halving_rs",
                chunks=dict(input=n, scratch=n - 1, acc=n, output=1))
    for s in range(k):
        d = n >> (s + 1)
        o = n - 2 * d                      # this step's scratch offset
        src_buf = "input" if s == 0 else "acc"
        with p.round():
            for j in range(d):
                p.put(src=(src_buf, PEER(d + j)),
                      dst=("scratch", CONST(o + j)), to=PEER(+d))
        with p.round():
            for j in range(d):
                p.wait(("scratch", CONST(o + j)), frm=PEER(-d))
        for j in range(d):
            p.local_reduce(("acc", PEER(j)),
                           [(src_buf, PEER(j)), ("scratch", CONST(o + j))])
    p.local_copy(("output", 0), ("acc", RANK))
    return p.freeze()


@functools.lru_cache(maxsize=None)
def doubling_ag(n: int) -> Program:
    """Recursive-doubling AllGather (power-of-two n): log2(n) rounds,
    ring-equal n-1 chunks on the wire. At step distance d each rank
    forwards its already-gathered window [r, r+d) to r-d, doubling the
    window per step. Every output slot is written exactly once."""
    k = _require_power_of_two("doubling_ag", n)
    p = Program("doubling_ag", chunks=dict(input=1, output=n))
    p.local_copy(("output", RANK), ("input", 0))
    for s in range(k):
        d = 1 << s
        with p.round():
            for j in range(d):
                p.put(src=("output", PEER(j)), dst=("output", PEER(j)),
                      to=PEER(-d))
        with p.round():
            for j in range(d):
                p.wait(("output", PEER(d + j)), frm=PEER(+d))
    return p.freeze()


@functools.lru_cache(maxsize=None)
def allreduce_rd(n: int) -> Program:
    """Recursive halving/doubling AllReduce (power-of-two n) =
    recursive-halving RS + recursive-doubling AG: 2·log2(n) rounds at
    ring-equal 2(n-1)/n bandwidth — the classic latency/bandwidth
    compromise between all-pairs (1-2 rounds, n× bytes) and ring
    (2(n-1) rounds, optimal bytes)."""
    k = _require_power_of_two("allreduce_rd", n)
    p = Program("allreduce_rd",
                chunks=dict(input=n, scratch=n - 1, acc=n, output=n))
    # RS phase (recursive halving into acc, as halving_rs)
    for s in range(k):
        d = n >> (s + 1)
        o = n - 2 * d
        src_buf = "input" if s == 0 else "acc"
        with p.round():
            for j in range(d):
                p.put(src=(src_buf, PEER(d + j)),
                      dst=("scratch", CONST(o + j)), to=PEER(+d))
        with p.round():
            for j in range(d):
                p.wait(("scratch", CONST(o + j)), frm=PEER(-d))
        for j in range(d):
            p.local_reduce(("acc", PEER(j)),
                           [(src_buf, PEER(j)), ("scratch", CONST(o + j))])
    p.local_copy(("output", RANK), ("acc", RANK))
    # AG phase (recursive doubling over the reduced shards)
    for s in range(k):
        d = 1 << s
        with p.round():
            for j in range(d):
                p.put(src=("output", PEER(j)), dst=("output", PEER(j)),
                      to=PEER(-d))
        with p.round():
            for j in range(d):
                p.wait(("output", PEER(d + j)), frm=PEER(+d))
    return p.freeze()


def _swing_rho(s: int) -> int:
    """Swing step-s pairing distance ρ_s = (1 - (-2)^(s+1)) / 3:
    +1, -1, +3, -5, +11, ... — always odd, so every step is a pairwise
    exchange between opposite parities (its own inverse)."""
    return (1 - (-2) ** (s + 1)) // 3


def _swing_chunk_sets(k: int) -> list:
    """C[s] = the chunk-offset set a rank still owns before RS step s,
    in the parity frame (chunk = r + (-1)^r·c). C[k] = {0} (only the
    home chunk survives); growing backwards, step s keeps C[s+1] and
    sends its image ρ_s - C[s+1] to the step-s peer."""
    C = [None] * (k + 1)
    C[k] = {0}
    for s in range(k - 1, -1, -1):
        C[s] = C[s + 1] | {_swing_rho(s) - c for c in C[s + 1]}
    return C


@functools.lru_cache(maxsize=None)
def swing_allreduce(n: int) -> Program:
    """Swing AllReduce (power-of-two n): log-step RS + AG where the
    step-s peer is ``r + (-1)^r·ρ_s`` (``PARITY_PEER``), ρ_s = +1, -1,
    +3, -5, ... Each step is a pairwise exchange between opposite
    parities; the alternating signs keep hop distances short (|ρ_s|
    grows ~2^s/3 instead of 2^s), which on a torus roughly halves the
    hop-weighted wire bytes of recursive halving/doubling at equal
    round count — the swing algorithm's reason to exist.

    Chunk responsibility is parity-equivariant: before RS step s rank r
    owns chunks ``{r + (-1)^r·c : c in C[s]}`` (``_swing_chunk_sets``);
    step s ships the peer's half of that set as partials, received into
    per-step disjoint scratch slots, and folds into ``acc``. After RS,
    chunk r is fully reduced at rank r; the AG phase replays the
    exchanges in reverse directly into ``output``."""
    k = _require_power_of_two("swing_allreduce", n)
    C = _swing_chunk_sets(k)
    p = Program("swing_allreduce",
                chunks=dict(input=n, scratch=max(n - 1, 1), acc=n, output=n))
    # RS phase: fold the peer's partials into acc
    o = 0                                  # per-step scratch offset
    for s in range(k):
        rho = _swing_rho(s)
        cl = sorted(C[s + 1])              # canonical slot order
        src_buf = "input" if s == 0 else "acc"
        with p.round():
            for j, c in enumerate(cl):
                p.put(src=(src_buf, PARITY_PEER(rho - c)),
                      dst=("scratch", CONST(o + j)), to=PARITY_PEER(rho))
        with p.round():
            for j, c in enumerate(cl):
                p.wait(("scratch", CONST(o + j)), frm=PARITY_PEER(rho))
        for j, c in enumerate(cl):
            p.local_reduce(("acc", PARITY_PEER(c)),
                           [(src_buf, PARITY_PEER(c)),
                            ("scratch", CONST(o + j))])
        o += len(cl)
    p.local_copy(("output", RANK), ("acc", RANK))
    # AG phase: reverse the exchanges, writing output slots exactly once
    for s in range(k - 1, -1, -1):
        rho = _swing_rho(s)
        cl = sorted(C[s + 1])
        with p.round():
            for c in cl:
                p.put(src=("output", PARITY_PEER(c)),
                      dst=("output", PARITY_PEER(c)), to=PARITY_PEER(rho))
        with p.round():
            for c in cl:
                p.wait(("output", PARITY_PEER(rho - c)),
                       frm=PARITY_PEER(rho))
    return p.freeze()


REGISTRY = {
    "allpairs_rs": allpairs_rs,
    "allpairs_ag": allpairs_ag,
    "allreduce_1pa": allreduce_1pa,
    "allreduce_2pa": allreduce_2pa,
    "ring_ag": ring_ag,
    "ring_rs": ring_rs,
    "allreduce_ring": allreduce_ring,
    "alltoall": alltoall,
    "broadcast_allpairs": broadcast_allpairs,
    "halving_rs": halving_rs,
    "doubling_ag": doubling_ag,
    "allreduce_rd": allreduce_rd,
    "swing_allreduce": swing_allreduce,
}
