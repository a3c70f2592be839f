"""DSL optimizer — composable ``Program -> Program`` passes.

The paper's core argument (§3.2.3, §4.3) is that a chunk-level DSL lets
a *compiler* apply workload-specific rewrites that a fixed-function
stack cannot: batching synchronization, fusing transfers, pipelining
chunks. This module is that compiler layer. Each pass is a pure
function from a frozen :class:`~repro_torch.core.dsl.Program` to a new frozen
``Program`` with identical data semantics (bit-equivalent outputs on
the executors) but cheaper structure; :func:`optimize` composes them
under an ``opt_level`` knob that the Collective API threads through.

Passes
======

``eliminate_dead``
    Dead-copy / dead-scratch elimination. Removes self-copies, then
    iterates buffer-level liveness to a fixpoint: any instruction whose
    only effect is writing a buffer that is never read afterwards (and
    is not the output buffer) is dropped, along with the waits paired
    to dropped puts. Unreferenced non-I/O buffers leave ``chunks`` so
    executors stop allocating them.

``coalesce_puts``
    Transfer fusion. Two shapes, both operating on *consecutive* puts
    inside one round (consecutiveness keeps the read-before-write
    order of the executors' sequential semantics intact):

    * **same-shift runs** — k puts sharing one ring shift merge into a
      single multi-chunk put (``srcs``/``dsts``/``tos`` tuples). The
      torch executor moves the group as ONE stacked rank permutation;
      the CUDA executor issues the k puts back-to-back (one slab put
      when the chunks are contiguous). Merging hoists the group's reads before its writes, so a
      group is split wherever a later put may read a chunk an earlier
      put in the group delivers (``_may_alias``).
    * **full fan-out rounds** — n-1 single-chunk puts covering every
      shift 1..n-1 exactly once with a common (src, dst) buffer pair
      and receiver-side placement ``dst[RANK-of-sender]`` merge into
      one fan-out put. The torch executor recognizes the two canonical
      index patterns on the merged instruction and runs the whole
      round as ONE tensor op: a transpose of the (rank, chunk) axes
      when each peer receives its own chunk (all-pairs RS / AllToAll),
      or a broadcast over ranks when every peer receives the same
      chunk (1PA broadcast rounds, AG phases).

``batch_syncs``
    Synchronization batching (paper §3.2.3). Runs of consecutive waits
    in one round collapse into a single round-boundary wait carrying
    all chunk/source pairs. The α-term of the cost model
    (``comm_stats()['sync_steps']``) drops from per-chunk to per-round.

``split_chunks``
    Chunk-split pipelining. Splits every buffer of a *ring-style*
    program (all puts single-chunk at shift ±1) into S interleaved
    sub-chunk streams — chunk-major (sub-chunk j of logical chunk c
    lands at index ``S*c + j``), so the flat payload layout is
    untouched and outputs stay bit-identical. The S per-stream puts of
    each round are adjacent, which lets ``coalesce_puts`` fuse them
    back into one multi-chunk put: the net effect is S× finer DMA
    granularity per round at the *same* instruction count — the
    overlap knob for large-message rings (each stream's round r can
    overlap stream j+1's round r-1 on hardware).

Opt levels
==========

===== =====================================================
level passes applied (in order)
===== =====================================================
0     none — the program exactly as declared
1     eliminate_dead, batch_syncs
2     + coalesce_puts                       (library default)
3     + split_chunks (ring programs only, S=2) before the rest
===== =====================================================

``optimize`` is memoized per (program identity, level, n) — weakly on
the program, so library programs (whose builders are lru-cached) are
optimized once per process while user-built programs are released with
their last reference.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.dsl import (IndexExpr, Instr, Op, Program, RANK, Round,
                            full_fanout)

__all__ = [
    "optimize", "eliminate_dead", "coalesce_puts", "batch_syncs",
    "split_chunks", "DEFAULT_OPT_LEVEL", "SPLIT_FACTOR", "is_ring_like",
]

DEFAULT_OPT_LEVEL = 2
SPLIT_FACTOR = 2
MAX_OPT_LEVEL = 3


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _rebuild(program: Program, rounds: Sequence[Sequence[Instr]],
             chunks: Optional[dict] = None) -> Program:
    """A frozen copy of ``program`` with new instruction lists."""
    p = Program.__new__(Program)
    p.name = program.name
    p.chunks = dict(chunks if chunks is not None else program.chunks)
    p.in_buffer = program.in_buffer
    p.out_buffer = program.out_buffer
    p.rounds = []
    for ri, instrs in enumerate(rounds):
        r = Round()
        for i in instrs:
            i = dataclasses.replace(i, round_id=len(p.rounds))
            r.instrs.append(i)
        if r.instrs:
            p.rounds.append(r)
    p._frozen = True
    return p


def _reads(instr: Instr) -> set:
    """Buffers whose *data* this instruction reads."""
    return {b for b, _ in instr.srcs}


def _writes(instr: Instr) -> set:
    """Buffers this instruction writes (PUT writes receiver-side)."""
    out = {b for b, _ in instr.dsts}
    if instr.dst is not None:
        out.add(instr.dst[0])
    return out


# ---------------------------------------------------------------------------
# pass: dead-copy / dead-scratch elimination
# ---------------------------------------------------------------------------
def eliminate_dead(program: Program) -> Program:
    """Drop self-copies and instructions writing never-read buffers."""
    instrs = [i for i in program.instructions()
              if not (i.op is Op.COPY and i.dst == i.srcs[0])]

    while True:
        read = {program.out_buffer}
        for i in instrs:
            read |= _reads(i)
        keep = []
        for i in instrs:
            w = _writes(i)
            if i.op in (Op.PUT, Op.COPY, Op.REDUCE, Op.WAIT) and w \
                    and not (w & read):
                continue  # whole effect lands in dead buffers
            keep.append(i)
        if len(keep) == len(instrs):
            break
        instrs = keep

    live = {program.in_buffer, program.out_buffer}
    for i in instrs:
        live |= _reads(i) | _writes(i)
    chunks = {b: k for b, k in program.chunks.items() if b in live}

    rounds: List[List[Instr]] = []
    by_round: dict = {}
    for i in instrs:
        by_round.setdefault(i.round_id, []).append(i)
    for rid in sorted(by_round):
        rounds.append(by_round[rid])
    return _rebuild(program, rounds, chunks)


# ---------------------------------------------------------------------------
# pass: put coalescing (transfer fusion)
# ---------------------------------------------------------------------------
def _is_rank_expr(e: IndexExpr) -> bool:
    return e == RANK


def _may_alias(dst_pair, to, src_pair, n: int) -> bool:
    """Can the receiver-side chunk a put writes (``dst[di(sender)]`` on
    rank r, sender = the rank whose ``to`` lands on r) be the chunk a
    later put in the same merged group reads (``src[si(r)]``) on any
    rank? Merging hoists all reads before all writes, so such a pair
    must stay unfused."""
    (db, di), (sb, si) = dst_pair, src_pair
    if db != sb:
        return False
    try:
        shift = to.shift()
        senders = [(r - shift) % n for r in range(n)]
    except ValueError:
        # parity-alternating target: invert the peer map per rank
        inv = {to(s, n) % n: s for s in range(n)}
        if len(inv) < n:
            return True            # non-bijective: stay conservative
        senders = [inv[r] for r in range(n)]
    return any(di(senders[r], n) == si(r, n) for r in range(n))


def _merge_run(run: List[Instr], n: int) -> List[Instr]:
    """Merge a run of consecutive PUTs; see module docstring."""
    if len(run) == 1 and not run[0].dsts:
        return run
    triples = [t for i in run for t in i.put_triples()]

    # full fan-out (contract shared with the executor: dsl.full_fanout)
    fo = full_fanout(triples, n) if all(not i.dsts for i in run) else None
    if fo is not None:
        sb0, db0 = fo
        # A read is only safe when nothing in the round can write the
        # chunk it reads: a RANK-indexed source is the receiver's own
        # slot, which a fan-out round (dst index = sender, shifts >= 1)
        # never touches; any other index is safe only when the source
        # buffer is not written at all. Static indices are NOT safe —
        # slot c of the dst buffer is written by sender c.
        srcs_safe = all(
            _is_rank_expr(si) or sb != db0
            for (sb, si), _, _ in triples)
        if srcs_safe:
            order = sorted(triples, key=lambda t: t[2].shift() % n)
            return [Instr(Op.PUT,
                          srcs=tuple(s for s, _, _ in order),
                          dsts=tuple(d for _, d, _ in order),
                          tos=tuple(t for _, _, t in order),
                          round_id=run[0].round_id)]

    # same-shift sub-runs
    out: List[Instr] = []
    cur: List[Tuple] = []

    def flush():
        if not cur:
            return
        if len(cur) == 1:
            (sb, si), (db, di), to = cur[0]
            out.append(Instr(Op.PUT, dst=(db, di), srcs=((sb, si),), to=to,
                             round_id=run[0].round_id))
        else:
            out.append(Instr(Op.PUT,
                             srcs=tuple(s for s, _, _ in cur),
                             dsts=tuple(d for _, d, _ in cur),
                             tos=tuple(t for _, _, t in cur),
                             round_id=run[0].round_id))
        cur.clear()

    for t in triples:
        # splitting the group at a read-after-write pair preserves the
        # reference lowering's sequential order (groups run in order)
        if cur and (cur[-1][2] != t[2]
                    or any(_may_alias(d, to_, t[0], n)
                           for _, d, to_ in cur)):
            flush()
        cur.append(t)
    flush()
    return out


def coalesce_puts(program: Program, num_ranks: int) -> Program:
    """Fuse consecutive puts per round (same-shift and full-fan-out)."""
    rounds = []
    for rnd in program.rounds:
        new: List[Instr] = []
        run: List[Instr] = []
        for i in rnd.instrs:
            if i.op is Op.PUT:
                run.append(i)
                continue
            if run:
                new += _merge_run(run, num_ranks)
                run = []
            new.append(i)
        if run:
            new += _merge_run(run, num_ranks)
        rounds.append(new)
    return _rebuild(program, rounds)


# ---------------------------------------------------------------------------
# pass: synchronization batching (paper §3.2.3)
# ---------------------------------------------------------------------------
def batch_syncs(program: Program) -> Program:
    """Collapse runs of consecutive waits into one round-boundary wait."""
    rounds = []
    for rnd in program.rounds:
        new: List[Instr] = []
        run: List[Instr] = []

        def flush():
            if not run:
                return
            if len(run) == 1 and not run[0].dsts:
                new.append(run[0])
            else:
                chunks = [c for i in run for c in i.wait_chunks()]
                new.append(Instr(Op.WAIT,
                                 dsts=tuple(d for d, _ in chunks),
                                 frms=tuple(f for _, f in chunks),
                                 round_id=run[0].round_id))
            run.clear()

        for i in rnd.instrs:
            if i.op is Op.WAIT:
                run.append(i)
                continue
            flush()
            new.append(i)
        flush()
        rounds.append(new)
    return _rebuild(program, rounds)


# ---------------------------------------------------------------------------
# pass: chunk-split pipelining
# ---------------------------------------------------------------------------
def is_ring_like(program: Program) -> bool:
    """True when every put moves one chunk to a ±1 ring neighbor — the
    large-message programs whose rounds the split pass can overlap."""
    puts = [i for i in program.instructions() if i.op is Op.PUT]
    if not puts:
        return False
    for p in puts:
        for _, _, to in p.put_triples():
            try:
                if abs(to.shift()) != 1:
                    return False
            except ValueError:
                return False
    return True


def split_chunks(program: Program, factor: int) -> Program:
    """Split every buffer into ``factor`` interleaved sub-chunk streams.

    Chunk-major layout (stream j of chunk c at ``factor*c + j``) keeps
    the flat payload identical; every data instruction is replicated
    per stream with ``IndexExpr.split`` indices, streams adjacent so
    ``coalesce_puts`` can fuse them back into multi-chunk instructions.
    """
    if factor <= 1:
        return program
    chunks = {b: k * factor for b, k in program.chunks.items()}
    rounds = []
    for rnd in program.rounds:
        new: List[Instr] = []
        for i in rnd.instrs:
            if i.op in (Op.BARRIER, Op.FLUSH):
                new.append(i)
                continue
            for j in range(factor):
                new.append(dataclasses.replace(
                    i,
                    dst=(None if i.dst is None else
                         (i.dst[0], i.dst[1].split(factor, j))),
                    srcs=tuple((b, e.split(factor, j)) for b, e in i.srcs),
                    dsts=tuple((b, e.split(factor, j)) for b, e in i.dsts),
                ))
        rounds.append(new)
    return _rebuild(program, rounds, chunks)


# ---------------------------------------------------------------------------
# pipeline driver
# ---------------------------------------------------------------------------
# Memo keyed *weakly* on program identity: REGISTRY programs (lru-cached
# builders) stay memoized for the process lifetime, while user-built
# programs are released with their last reference instead of being
# pinned forever (an lru_cache here would leak one entry per Program).
_OPT_MEMO: "weakref.WeakKeyDictionary[Program, dict]" = \
    weakref.WeakKeyDictionary()


def optimize(program: Program, opt_level: int = DEFAULT_OPT_LEVEL,
             num_ranks: Optional[int] = None) -> Program:
    """Run the pass pipeline at ``opt_level`` (see module docstring).

    ``num_ranks`` is the axis size the program will execute over; it
    gates fan-out detection. Defaults to the largest chunk count, which
    equals the build-time n for every library program. Results are
    memoized per (program, level, n).
    """
    if opt_level <= 0:
        return program
    memo = _OPT_MEMO.setdefault(program, {})
    key = (opt_level, num_ranks)
    if key not in memo:
        n = num_ranks if num_ranks is not None \
            else max(program.chunks.values())
        p = program
        if opt_level >= 3 and is_ring_like(p):
            p = split_chunks(p, SPLIT_FACTOR)
        p = eliminate_dead(p)
        if opt_level >= 2:
            p = coalesce_puts(p, n)
        memo[key] = batch_syncs(p)
    return memo[key]
