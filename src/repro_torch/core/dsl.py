"""MSCCL++ DSL — a chunk-oriented language for collective algorithms.

The PyTorch port's copy of the paper's §4.3 DSL (an MSCCLang
descendant), kept identical to ``repro.core.dsl`` so plan files and
``program_to_dict`` payloads cross between the two packages unchanged.
An algorithm is declared *once* with a symbolic rank: every data
movement is addressed relative to the executing rank (``PEER(+i)``
style offsets), which is exactly the SPMD form both executors need:

* the **CUDA executor** encodes the instruction list into a per-rank
  table that one hand-written Hopper kernel interprets with put /
  signal / wait primitives (paper-faithful path);
* the **torch executor** runs each put round as a permutation of the
  rank axis of rank-stacked tensors (+ local torch compute), the plain
  version of the same algorithm on any device.

Buffers are logical, chunk-granular arrays (``input``, ``output``,
``scratch``), mirroring MSCCLang's chunk model. Synchronization is
declared with ``wait``/``barrier`` but the executors are free to
implement it differently (semaphores vs. collective data dependence) —
the separation of declaration from implementation that the paper
argues for.

Between declaration and execution sits the optimizer
(``repro_torch.core.passes``): ``Program -> Program`` rewrites — put
coalescing, sync batching, dead-copy elimination, chunk-split
pipelining — that produce the multi-chunk instruction forms
(``Instr.dsts``/``tos``/``frms``) both executors consume. Programs
written by hand never contain those forms; ``Instr.put_triples()`` /
``wait_chunks()`` give a uniform view over single and fused
instructions.

Example (all-pairs ReduceScatter, paper Fig. 5)::

    p = Program("allpairs_rs", chunks=dict(input=N, scratch=N, output=1))
    with p.round():
        for i in range(1, N):
            p.put(src=("input", PEER(+i)), dst=("scratch", RANK),
                  to=PEER(+i))
    with p.round():
        for i in range(1, N):
            p.wait(("scratch", PEER(+i)), frm=PEER(-i))
    p.local_reduce(("output", 0), [("input", RANK)] +
                   [("scratch", PEER(+i)) for i in range(1, N)])
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Any, List, Optional, Sequence, Tuple

__all__ = [
    "RANK", "PEER", "CONST", "PARITY_PEER", "IndexExpr",
    "Program", "Round", "Instr", "Op", "full_fanout",
    "program_to_dict", "program_from_dict",
]


# --------------------------------------------------------------------------
# Symbolic index algebra: idx = (sign*rank + offset) mod N  |  constant
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class IndexExpr:
    """Index/rank expression ``scale * base + post`` with
    ``base = (sign * rank + offset) mod axis_size`` when ``relative``
    else the constant ``offset``.

    ``scale``/``post`` are produced by the chunk-split pipelining pass
    (``passes.split_chunks``): sub-chunk ``j`` of logical chunk ``e``
    over a buffer split ``S`` ways lives at ``S*e + j`` (chunk-major,
    so the flat payload layout is unchanged). Hand-written programs
    leave them at the identity (1, 0).
    """

    sign: int = 0          # coefficient of `rank` (0, +1, -1)
    offset: int = 0
    relative: bool = True  # False -> plain constant (no mod)
    scale: int = 1         # sub-chunk stride (chunk-split pass)
    post: int = 0          # sub-chunk offset (chunk-split pass)
    alt: int = 0           # coefficient of (-1)^rank (swing-style
                           # parity-alternating peers/chunks)

    def __call__(self, rank: Any, n: Any):
        """Evaluate for a concrete rank (plain ints)."""
        if not self.relative:
            return self.scale * self.offset + self.post
        base = self.sign * rank + self.offset
        if self.alt:
            # (-1)^rank as 1 - 2*(rank % 2): int- and traced-value safe
            base = base + self.alt * (1 - 2 * (rank % 2))
        return self.scale * (base % n) + self.post

    def shift(self) -> int:
        """For put targets: the uniform ring shift this expression encodes
        (requires sign=+1, no parity term, and identity scale/post — rank
        addressing is never sub-chunk-split)."""
        if not (self.relative and self.sign == 1 and self.alt == 0
                and self.scale == 1 and self.post == 0):
            raise ValueError(f"not a uniform shift: {self}")
        return self.offset

    def is_static(self) -> bool:
        """True when the index is rank-independent: it folds to a Python
        int at trace time (the executors' static-index fast path)."""
        return not self.relative or (self.sign == 0 and self.alt == 0)

    def split(self, factor: int, stream: int) -> "IndexExpr":
        """The expression addressing sub-chunk ``stream`` after the
        owning buffer is split ``factor`` ways (chunk-major layout)."""
        return dataclasses.replace(
            self, scale=self.scale * factor, post=self.post * factor + stream)

    def __repr__(self):
        if not self.relative:
            base = f"{self.offset}"
        else:
            s = {1: "rank", -1: "-rank", 0: ""}[self.sign]
            if self.alt:
                s += f"{self.alt:+d}*(-1)^rank"
            if self.offset:
                s += f"{self.offset:+d}"
            base = f"({s})%N"
        if self.scale != 1:
            base = f"{self.scale}*{base}"
        if self.post:
            base += f"+{self.post}"
        return base


RANK = IndexExpr(sign=1, offset=0)


def PEER(offset: int) -> IndexExpr:
    """Rank at ring distance ``offset`` (may be negative)."""
    return IndexExpr(sign=1, offset=offset)


def PARITY_PEER(delta: int, offset: int = 0) -> IndexExpr:
    """Rank (or chunk) at parity-alternating distance
    ``(-1)^rank * delta + offset`` — the swing-algorithm addressing
    form: even ranks look ``+delta`` around the ring, odd ranks
    ``-delta``, so with odd ``delta`` the relation is a pairwise
    exchange (its own inverse)."""
    return IndexExpr(sign=1, offset=offset, alt=delta)


def CONST(c: int) -> IndexExpr:
    return IndexExpr(sign=0, offset=c, relative=False)


def _as_expr(v) -> IndexExpr:
    if isinstance(v, IndexExpr):
        return v
    if isinstance(v, int):
        return CONST(v)
    raise TypeError(f"index must be IndexExpr or int, got {type(v)}")


# --------------------------------------------------------------------------
# Instruction set
# --------------------------------------------------------------------------
class Op(enum.Enum):
    PUT = "put"              # one-sided chunk write to a peer
    WAIT = "wait"            # wait for a chunk to arrive (recv side)
    FLUSH = "flush"          # source-side completion of pending puts
    BARRIER = "barrier"      # full-axis barrier (paper Fig.5 line 18)
    COPY = "copy"            # local chunk copy
    REDUCE = "reduce"        # local chunk reduction: dst = sum(srcs)


@dataclasses.dataclass
class Instr:
    op: Op
    # (buffer_name, chunk_index) pairs; semantics depend on op
    dst: Optional[Tuple[str, IndexExpr]] = None
    srcs: Tuple[Tuple[str, IndexExpr], ...] = ()
    to: Optional[IndexExpr] = None    # PUT: destination rank
    frm: Optional[IndexExpr] = None   # WAIT: source rank (for sizing/debug)
    round_id: int = -1
    # Multi-chunk forms, produced by the optimizer passes (never by the
    # builder API):
    #   * coalesced PUT — ``srcs``/``dsts`` hold k aligned chunk pairs
    #     sharing one ``to`` shift (``dst`` is None); the torch executor
    #     moves the group as ONE stacked rank permutation.
    #   * batched WAIT — ``dsts``/``frms`` hold the k per-chunk waits
    #     collapsed into one round-boundary sync (paper §3.2.3).
    dsts: Tuple[Tuple[str, IndexExpr], ...] = ()
    frms: Tuple[IndexExpr, ...] = ()
    tos: Tuple[IndexExpr, ...] = ()   # coalesced PUT: per-pair dest rank

    # -- uniform accessors over single and multi forms ---------------------
    def put_triples(self) -> List[Tuple[Tuple[str, IndexExpr],
                                        Tuple[str, IndexExpr], IndexExpr]]:
        """PUT as aligned (src_chunk, dst_chunk, to_rank) triples."""
        if self.dsts:
            tos = self.tos if self.tos else (self.to,) * len(self.dsts)
            return list(zip(self.srcs, self.dsts, tos))
        return [(self.srcs[0], self.dst, self.to)]

    def wait_chunks(self) -> List[Tuple[Tuple[str, IndexExpr], IndexExpr]]:
        """WAIT as (dst_chunk, frm_rank) pairs."""
        if self.dsts:
            return list(zip(self.dsts, self.frms))
        return [(self.dst, self.frm)]

    def chunk_refs(self) -> Tuple[Tuple[str, IndexExpr], ...]:
        """Every (buffer, index) this instruction touches."""
        refs = tuple(self.srcs) + tuple(self.dsts)
        if self.dst is not None:
            refs += (self.dst,)
        return refs

    def __repr__(self):
        parts = [self.op.value]
        if self.srcs:
            parts.append("src=" + ",".join(f"{b}[{i}]" for b, i in self.srcs))
        if self.dst:
            parts.append(f"dst={self.dst[0]}[{self.dst[1]}]")
        if self.dsts:
            parts.append("dst=" + ",".join(f"{b}[{i}]" for b, i in self.dsts))
        if self.to is not None:
            parts.append(f"to={self.to}")
        if self.tos:
            parts.append("to=" + ",".join(map(repr, self.tos)))
        if self.frm is not None:
            parts.append(f"frm={self.frm}")
        if self.frms:
            parts.append("frm=" + ",".join(map(repr, self.frms)))
        return " ".join(parts)


def full_fanout(triples, n: int) -> Optional[Tuple[str, str]]:
    """If put triples form a full fan-out round — single-chunk puts
    covering every shift 1..n-1 exactly once, one (src, dst) buffer
    pair, receiver-side placement ``dst[RANK-of-sender]`` — return
    ``(src_buffer, dst_buffer)``, else None.

    This is the ONE definition of the fan-out contract, shared by the
    coalescing pass (mergability) and the torch executor's lowering
    classifier so the two can never drift apart.
    """
    if len(triples) != n - 1 or n <= 2:
        return None
    try:
        shifts = sorted(to.shift() % n for _, _, to in triples)
    except ValueError:
        return None
    if shifts != list(range(1, n)):
        return None
    sbs = {sb for (sb, _), _, _ in triples}
    dbs = {db for _, (db, _), _ in triples}
    dis = {di for _, (_, di), _ in triples}
    if len(sbs) == 1 and len(dbs) == 1 and dis == {RANK}:
        return next(iter(sbs)), next(iter(dbs))
    return None


@dataclasses.dataclass
class Round:
    """A communication round: puts issued together, synchronized at the
    round boundary. The unit over which optimization passes batch
    signals/waits (paper §3.2.3 'batching synchronization')."""

    instrs: List[Instr] = dataclasses.field(default_factory=list)


class Program:
    """A collective algorithm over one mesh axis, symbolic in rank.

    ``chunks``: dict buffer-name -> number of chunks. All chunks share
    one (rows, cols) shape chosen at execution time.
    """

    def __init__(self, name: str, chunks: dict[str, int],
                 in_buffer: str = "input", out_buffer: str = "output"):
        self.name = name
        self.chunks = dict(chunks)
        self.in_buffer = in_buffer
        self.out_buffer = out_buffer
        self.rounds: List[Round] = [Round()]
        self._frozen = False
        for b in (in_buffer, out_buffer):
            if b not in self.chunks:
                raise ValueError(f"{b!r} missing from chunks {list(chunks)}")

    # -- construction ------------------------------------------------------
    def _emit(self, instr: Instr) -> None:
        if self._frozen:
            raise RuntimeError("program is frozen")
        instr.round_id = len(self.rounds) - 1
        self.rounds[-1].instrs.append(instr)

    @contextlib.contextmanager
    def round(self):
        """Open a new communication round."""
        if self.rounds[-1].instrs:
            self.rounds.append(Round())
        yield self
        self.rounds.append(Round())

    def put(self, src, dst, to) -> None:
        sb, si = src
        db, di = dst
        self._emit(Instr(Op.PUT, dst=(db, _as_expr(di)),
                         srcs=((sb, _as_expr(si)),), to=_as_expr(to)))

    def wait(self, chunk, frm) -> None:
        b, i = chunk
        self._emit(Instr(Op.WAIT, dst=(b, _as_expr(i)), frm=_as_expr(frm)))

    def flush(self) -> None:
        self._emit(Instr(Op.FLUSH))

    def barrier(self) -> None:
        self._emit(Instr(Op.BARRIER))

    def local_copy(self, dst, src) -> None:
        db, di = dst
        sb, si = src
        self._emit(Instr(Op.COPY, dst=(db, _as_expr(di)),
                         srcs=((sb, _as_expr(si)),)))

    def local_reduce(self, dst, srcs) -> None:
        db, di = dst
        self._emit(Instr(Op.REDUCE, dst=(db, _as_expr(di)),
                         srcs=tuple((b, _as_expr(i)) for b, i in srcs)))

    # -- introspection -----------------------------------------------------
    def freeze(self) -> "Program":
        self.rounds = [r for r in self.rounds if r.instrs]
        self._frozen = True
        return self

    def instructions(self) -> List[Instr]:
        return [i for r in self.rounds for i in r.instrs]

    def validate(self, num_ranks: int) -> None:
        """Static checks: buffer names exist, chunk indices in range for
        every concrete rank, every awaited chunk has a matching put."""
        for instr in self.instructions():
            for b, i in instr.chunk_refs():
                if b not in self.chunks:
                    raise ValueError(f"unknown buffer {b!r} in {instr}")
                for r in range(num_ranks):
                    idx = i(r, num_ranks)
                    if not 0 <= idx < self.chunks[b]:
                        raise ValueError(
                            f"chunk index {idx} out of range for {b!r} "
                            f"(rank {r}) in {instr}")
        # wait/put matching: for each WAIT on (buf, idx) from rank f(r),
        # some PUT must target (buf, idx') on `to`-rank with matching index.
        put_dsts = [(to, dst) for p in self.instructions()
                    if p.op is Op.PUT for _, dst, to in p.put_triples()]
        for w in self.instructions():
            if w.op is not Op.WAIT:
                continue
            for (wbuf, widx), frm in w.wait_chunks():
                for r in range(num_ranks):      # receiver rank
                    src_rank = frm(r, num_ranks)
                    want_idx = widx(r, num_ranks)
                    ok = any(
                        to(src_rank, num_ranks) == r
                        and db == wbuf
                        and di(src_rank, num_ranks) == want_idx
                        for to, (db, di) in put_dsts
                    )
                    if not ok:
                        raise ValueError(
                            f"wait {w} (rank {r}) has no matching put")

    def comm_stats(self, num_ranks: int, chunk_bytes: int) -> dict:
        """Analytical cost: per-device bytes sent and sync rounds —
        the DSL-level 'performance analysis' the paper mentions.

        ``wire_bytes_per_rank`` weights each put by its ring-hop distance
        (a put at shift s crosses min(s, N-s) links on a torus) —
        the contention term that makes ring beat all-pairs at large
        sizes. Switched fabrics (DCN) should use ``bytes_per_rank``.

        Multi-chunk instructions (post-optimizer) count every chunk
        toward the byte terms but only once toward the instruction /
        sync terms — that is exactly the fusion the α-β model should
        see (``sync_steps`` drops when waits are batched;
        ``put_instrs`` drops when puts are coalesced; bytes never do).
        """
        puts = [i for i in self.instructions() if i.op is Op.PUT]
        rounds_with_comm = {i.round_id for i in puts}
        n = num_ranks
        wire = 0
        chunk_puts = 0
        for p in puts:
            for _, _, to in p.put_triples():
                chunk_puts += 1
                try:
                    s = to.shift() % n
                    hops = min(s, n - s)
                except ValueError:
                    # parity-alternating target: hop distance per rank,
                    # averaged (equal across parities for swing's odd
                    # deltas, so the average is exact, not a smear)
                    ds = [(to(r, n) % n - r) % n for r in range(n)]
                    avg = sum(min(d, n - d) for d in ds) / n
                    hops = int(avg) if avg.is_integer() else avg
                wire += chunk_bytes * hops
        return dict(
            puts_per_rank=chunk_puts,
            put_instrs=len(puts),
            bytes_per_rank=chunk_puts * chunk_bytes,
            wire_bytes_per_rank=wire,
            comm_rounds=len(rounds_with_comm),
            sync_steps=sum(1 for i in self.instructions()
                           if i.op is Op.WAIT),
            barriers=sum(1 for i in self.instructions() if i.op is Op.BARRIER),
        )

    def __repr__(self):
        lines = [f"Program({self.name!r}, chunks={self.chunks})"]
        for ri, r in enumerate(self.rounds):
            lines.append(f"  round {ri}:")
            lines += [f"    {i}" for i in r.instrs]
        return "\n".join(lines)


# --------------------------------------------------------------------------
# serialization — the MSCCL++ "execution plan file" shape: a Program is
# plain data (instructions over a symbolic rank), so it round-trips
# through JSON-compatible dicts. Multi-chunk optimizer forms included.
# --------------------------------------------------------------------------
def _expr_to_dict(e: IndexExpr) -> dict:
    d = dict(sign=e.sign, offset=e.offset, relative=e.relative,
             scale=e.scale, post=e.post)
    if e.alt:
        # emitted only when set, so pre-parity plan files stay
        # byte-identical and old readers never see the key
        d["alt"] = e.alt
    return d


def _expr_from_dict(d: dict) -> IndexExpr:
    return IndexExpr(sign=d["sign"], offset=d["offset"],
                     relative=d["relative"], scale=d["scale"],
                     post=d["post"], alt=d.get("alt", 0))


def _chunk_to_dict(c: Tuple[str, IndexExpr]) -> list:
    return [c[0], _expr_to_dict(c[1])]


def _chunk_from_dict(c) -> Tuple[str, IndexExpr]:
    return (c[0], _expr_from_dict(c[1]))


def program_to_dict(p: Program) -> dict:
    """``Program`` as a JSON-compatible dict (see ``program_from_dict``)."""
    instrs = []
    for ri, r in enumerate(p.rounds):
        for i in r.instrs:
            instrs.append(dict(
                op=i.op.value,
                round=ri,
                dst=_chunk_to_dict(i.dst) if i.dst is not None else None,
                srcs=[_chunk_to_dict(s) for s in i.srcs],
                to=_expr_to_dict(i.to) if i.to is not None else None,
                frm=_expr_to_dict(i.frm) if i.frm is not None else None,
                dsts=[_chunk_to_dict(d) for d in i.dsts],
                frms=[_expr_to_dict(f) for f in i.frms],
                tos=[_expr_to_dict(t) for t in i.tos],
            ))
    return dict(name=p.name, chunks=dict(p.chunks),
                in_buffer=p.in_buffer, out_buffer=p.out_buffer,
                instructions=instrs)


def program_from_dict(d: dict) -> Program:
    """Rebuild a frozen ``Program`` from ``program_to_dict`` output,
    preserving round structure and optimizer multi-chunk forms. A
    truncated or hand-edited payload raises ``ValueError`` naming the
    broken field instead of a raw ``KeyError``."""
    try:
        return _program_from_dict(d)
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(
            f"malformed program payload ({type(e).__name__}: {e}): "
            f"missing or corrupted field — not program_to_dict output, "
            f"or a truncated plan file") from e


def _program_from_dict(d: dict) -> Program:
    p = Program.__new__(Program)
    p.name = d["name"]
    p.chunks = dict(d["chunks"])
    p.in_buffer = d["in_buffer"]
    p.out_buffer = d["out_buffer"]
    by_round: dict = {}
    for di in d["instructions"]:
        instr = Instr(
            Op(di["op"]),
            dst=_chunk_from_dict(di["dst"]) if di["dst"] is not None else None,
            srcs=tuple(_chunk_from_dict(s) for s in di["srcs"]),
            to=_expr_from_dict(di["to"]) if di["to"] is not None else None,
            frm=_expr_from_dict(di["frm"]) if di["frm"] is not None else None,
            dsts=tuple(_chunk_from_dict(c) for c in di["dsts"]),
            frms=tuple(_expr_from_dict(f) for f in di["frms"]),
            tos=tuple(_expr_from_dict(t) for t in di["tos"]),
        )
        by_round.setdefault(di["round"], []).append(instr)
    p.rounds = []
    for rid in sorted(by_round):
        r = Round()
        for instr in by_round[rid]:
            instr.round_id = len(p.rounds)
            r.instrs.append(instr)
        p.rounds.append(r)
    p._frozen = True
    return p
