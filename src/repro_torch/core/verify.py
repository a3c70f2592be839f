"""Static plan verifier — reject bad Programs before they lower.

MSCCL++'s pitch is that hand-rolled communication stacks are "fast but
error-prone"; GC3-style compilers answer by *checking* collective
programs statically instead of trusting them. This module is that
checker for our DSL: any :class:`~repro_torch.core.dsl.Program` — hand
written, optimizer-emitted, or loaded from a plan file — can be
verified against the executors' concurrency model before a single
instruction lowers. The Communicator runs it at plan compilation (on
by default) and ``ExecutionPlan.from_json`` runs it on loaded plan
files, so a pass bug or a corrupted plan JSON fails loudly at compile
time instead of silently corrupting decode output or hanging a rank.

Concurrency model (matches both executors, see ``docs/robustness.md``):
ranks execute the same flattened instruction list in program order
(SPMD); a PUT issues an asynchronous one-sided write that lands at the
receiver at some point before the matching WAIT completes or the next
BARRIER is crossed (puts are flushed at issue — the CUDA executor's
contract); WAIT blocks until its chunk's delivery signal; BARRIER is a
full-axis rendezvous; COPY/REDUCE are local. Each chunk delivery must
be ordered against every local access of that chunk by a WAIT or a
BARRIER — anything else is a data race on the destination buffer.

Checks, in order:

* **structure** — buffer names exist, chunk indices in range for every
  concrete rank (a findings-collecting version of ``Program.validate``).
* **sync** — per-rank signal/wait matching as a one-to-one pairing:
  every waited chunk has its own delivering put (``unmatched-wait``),
  every delivery its own wait (``signal-imbalance`` — a duplicated put
  double-credits the semaphore and lets a later wait in the same pair
  fire early), and the matching put precedes the wait in program order
  (``deadlock`` — under SPMD every rank blocks at the same wait, so a
  later put can never be issued: a cross-rank cycle).
* **hazard** — for every local read/write of a chunk some remote put
  delivers into, the delivery must be ordered by a wait at or before
  the access, or separated from it by a barrier (``hazard``).
* **conservation** — an abstract interpretation over all ranks tracks
  each chunk's provenance (a multiset of input atoms); every output
  chunk must be produced exactly once (``conservation``) from fully
  initialized data (``uninit``). This catches optimizer-pass bugs like
  dead-copy-elimination deleting a live copy.
* **semantics** (when the collective is known) — the final provenance
  of every output chunk must equal the collective's specification
  (e.g. all_reduce: out[c]@r == Σ_s in[c]@s) — wrong-but-initialized
  data is still an error (``semantics``).

Verification is **compile-time only**: a verified plan replays with
zero added work on the hot path.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import Counter
from typing import Dict, List, Optional, Tuple

from repro_torch.core.dsl import Instr, Op, Program

__all__ = [
    "Finding", "VerifyReport", "VerificationError",
    "verify_program", "check", "MODES", "SEMANTIC_COLLECTIVES",
]

MODES = ("off", "warn", "strict")

#: collectives the semantics check has a specification for
SEMANTIC_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter",
                        "all_to_all", "broadcast")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verification failure. ``pos`` is the flattened instruction
    position (program order), ``rank`` the concrete rank the failure
    manifests on (None = rank-independent)."""

    code: str
    message: str
    rank: Optional[int] = None
    pos: Optional[int] = None

    def __str__(self):
        where = []
        if self.rank is not None:
            where.append(f"rank {self.rank}")
        if self.pos is not None:
            where.append(f"instr {self.pos}")
        loc = f" ({', '.join(where)})" if where else ""
        return f"[{self.code}]{loc} {self.message}"


class VerificationError(ValueError):
    """A Program failed verification in strict mode. Subclasses
    ``ValueError`` so existing plan-failure fallbacks (the engine's
    explicit→auto ladder) catch it without new plumbing."""

    def __init__(self, program: str, findings: List[Finding]):
        self.program = program
        self.findings = list(findings)
        lines = [f"  - {f}" for f in self.findings[:12]]
        if len(self.findings) > 12:
            lines.append(f"  ... and {len(self.findings) - 12} more")
        super().__init__(
            f"program {program!r} failed plan verification with "
            f"{len(self.findings)} finding(s):\n" + "\n".join(lines))


@dataclasses.dataclass
class VerifyReport:
    program: str
    num_ranks: int
    collective: Optional[str]
    checks: Tuple[str, ...]
    findings: List[Finding]

    @property
    def ok(self) -> bool:
        return not self.findings

    def raise_if_failed(self) -> None:
        if self.findings:
            raise VerificationError(self.program, self.findings)

    def summary(self) -> str:
        state = "clean" if self.ok else f"{len(self.findings)} finding(s)"
        return (f"verify {self.program!r} n={self.num_ranks} "
                f"checks={'+'.join(self.checks)}: {state}")


# --------------------------------------------------------------------------
# events: deliveries, waits, and local accesses, concretized per rank
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Delivery:
    """A chunk landing on ``receiver`` because ``sender`` executed the
    PUT at flattened position ``pos``."""

    pos: int
    sender: int
    buf: str
    chunk: int


def _deliveries(instrs: List[Instr], receiver: int, n: int):
    """All remote writes into ``receiver``, plus self-put findings."""
    out: List[_Delivery] = []
    findings: List[Finding] = []
    for pos, instr in enumerate(instrs):
        if instr.op is not Op.PUT:
            continue
        for (sb, si), (db, di), to in instr.put_triples():
            for s in range(n):
                tgt = to(s, n) % n
                if tgt == s:
                    if s == receiver:   # report once, on the sender
                        findings.append(Finding(
                            "self-put", f"put targets its own rank: {instr}",
                            rank=s, pos=pos))
                    continue
                if tgt == receiver:
                    out.append(_Delivery(pos, s, db, di(s, n)))
    return out, findings


def _waits(instrs: List[Instr], receiver: int, n: int):
    """(pos, buf, chunk, sender) for every waited chunk on ``receiver``."""
    out = []
    for pos, instr in enumerate(instrs):
        if instr.op is not Op.WAIT:
            continue
        for (wb, wi), frm in instr.wait_chunks():
            out.append((pos, wb, wi(receiver, n), frm(receiver, n) % n))
    return out


def _accesses(instrs: List[Instr], rank: int, n: int):
    """(pos, buf, chunk, kind) for every local chunk read/write on
    ``rank``. PUT reads its sources locally; COPY/REDUCE read sources
    and write the destination. WAIT is the synchronization itself, and
    a PUT's remote write is covered by :func:`_deliveries`."""
    out = []
    for pos, instr in enumerate(instrs):
        if instr.op is Op.PUT:
            for (sb, si), _, _ in instr.put_triples():
                out.append((pos, sb, si(rank, n), "read"))
        elif instr.op in (Op.COPY, Op.REDUCE):
            for sb, si in instr.srcs:
                out.append((pos, sb, si(rank, n), "read"))
            db, di = instr.dst
            out.append((pos, db, di(rank, n), "write"))
    return out


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------
def _check_structure(program: Program, n: int) -> List[Finding]:
    findings = []
    for pos, instr in enumerate(program.instructions()):
        for b, i in instr.chunk_refs():
            if b not in program.chunks:
                findings.append(Finding(
                    "unknown-buffer", f"unknown buffer {b!r} in {instr}",
                    pos=pos))
                continue
            for r in range(n):
                idx = i(r, n)
                if not 0 <= idx < program.chunks[b]:
                    findings.append(Finding(
                        "index-range",
                        f"chunk index {idx} out of range for {b!r} "
                        f"({program.chunks[b]} chunks) in {instr}",
                        rank=r, pos=pos))
                    break
    return findings


def _check_sync_and_hazards(program: Program, n: int) -> List[Finding]:
    instrs = program.instructions()
    barriers = [pos for pos, i in enumerate(instrs) if i.op is Op.BARRIER]
    findings: List[Finding] = []
    imbalance_seen = set()

    for r in range(n):
        deliveries, self_puts = _deliveries(instrs, r, n)
        findings += self_puts
        waits = _waits(instrs, r, n)

        # one-to-one pairing per (buf, chunk, sender), in program order
        by_key: Dict[tuple, List[_Delivery]] = {}
        for d in deliveries:
            by_key.setdefault((d.buf, d.chunk, d.sender), []).append(d)
        wait_of: Dict[_Delivery, int] = {}
        for wpos, wb, wc, ws in sorted(waits):
            key = (wb, wc, ws)
            pool = by_key.get(key, [])
            if not pool:
                findings.append(Finding(
                    "unmatched-wait",
                    f"wait on {wb}[{wc}] from rank {ws} has no "
                    f"delivering put", rank=r, pos=wpos))
                continue
            d = min(pool, key=lambda d: d.pos)
            pool.remove(d)
            wait_of[d] = wpos
            if d.pos > wpos:
                findings.append(Finding(
                    "deadlock",
                    f"wait on {wb}[{wc}] from rank {ws} matches a put "
                    f"issued later (instr {d.pos}): under SPMD every "
                    f"rank blocks at this wait and the put is never "
                    f"reached", rank=r, pos=wpos))
        for (buf, chunk, sender), pool in by_key.items():
            for d in pool:
                if (d.pos, buf, chunk) not in imbalance_seen:
                    imbalance_seen.add((d.pos, buf, chunk))
                    findings.append(Finding(
                        "signal-imbalance",
                        f"put at instr {d.pos} delivers {buf}[{chunk}] "
                        f"from rank {sender} with no matching wait: the "
                        f"extra signal double-credits the semaphore",
                        rank=r, pos=d.pos))

        # hazards: every local access vs every delivery into that chunk
        delivered: Dict[tuple, List[_Delivery]] = {}
        for d in deliveries:
            delivered.setdefault((d.buf, d.chunk), []).append(d)
        for pos, buf, chunk, kind in _accesses(instrs, r, n):
            for d in delivered.get((buf, chunk), ()):
                w = wait_of.get(d)
                if w is not None and w <= pos:
                    continue     # waited before the access
                if any(d.pos < b < pos for b in barriers):
                    continue     # delivery completed across a barrier
                if any(pos < b < d.pos for b in barriers):
                    continue     # access finishes before the put issues
                findings.append(Finding(
                    "hazard",
                    f"{kind} of {buf}[{chunk}] races the put from rank "
                    f"{d.sender} (instr {d.pos}) delivering into the "
                    f"same chunk — no wait or barrier orders them",
                    rank=r, pos=pos))
    return findings


_UNINIT = ("uninit", -1, -1)


def _check_conservation(program: Program, n: int,
                        collective: Optional[str],
                        root: int) -> List[Finding]:
    """Abstract interpretation across all ranks: each chunk carries a
    provenance multiset of input atoms ``('in', rank, chunk)``."""
    instrs = program.instructions()
    val: Dict[tuple, tuple] = {}
    for b, k in program.chunks.items():
        for r in range(n):
            for c in range(k):
                init = (("in", r, c),) if b == program.in_buffer else (_UNINIT,)
                val[(r, b, c)] = init
    out_writes: Counter = Counter()

    def write(r, b, c, v):
        if b == program.out_buffer:
            out_writes[(r, c)] += 1
        val[(r, b, c)] = v

    for instr in instrs:
        if instr.op is Op.PUT:
            updates = []
            for (sb, si), (db, di), to in instr.put_triples():
                for s in range(n):
                    tgt = to(s, n) % n
                    if tgt == s:
                        continue     # flagged by the sync check
                    updates.append(((tgt, db, di(s, n)),
                                    val[(s, sb, si(s, n))]))
            for (r, b, c), v in updates:
                write(r, b, c, v)
        elif instr.op is Op.COPY:
            sb, si = instr.srcs[0]
            db, di = instr.dst
            for r in range(n):
                write(r, db, di(r, n), val[(r, sb, si(r, n))])
        elif instr.op is Op.REDUCE:
            db, di = instr.dst
            for r in range(n):
                acc: List[tuple] = []
                for sb, si in instr.srcs:
                    acc += val[(r, sb, si(r, n))]
                write(r, db, di(r, n), tuple(sorted(acc)))

    findings = []
    n_out = program.chunks[program.out_buffer]
    in_place = program.out_buffer == program.in_buffer
    for r in range(n):
        for c in range(n_out):
            v = val[(r, program.out_buffer, c)]
            cnt = out_writes[(r, c)]
            if cnt == 0 and not in_place:
                findings.append(Finding(
                    "conservation",
                    f"output chunk {c} is never produced", rank=r))
                continue
            if cnt > 1:
                findings.append(Finding(
                    "conservation",
                    f"output chunk {c} is produced {cnt} times "
                    f"(expected exactly once)", rank=r))
            if _UNINIT in v:
                findings.append(Finding(
                    "uninit",
                    f"output chunk {c} derives from uninitialized "
                    f"data", rank=r))
    if collective in SEMANTIC_COLLECTIVES and not any(
            f.code == "uninit" for f in findings):
        findings += _check_semantics(program, n, collective, root, val)
    return findings


def _expected_provenance(collective: str, n: int, n_in: int, n_out: int,
                         root: int):
    """out[chunk] @ rank -> expected provenance multiset, or None when
    the chunk grid doesn't fit the collective's shape contract (that
    mismatch is reported as a finding by the caller)."""
    if collective == "all_reduce":
        if n_in != n_out:
            return None
        return lambda r, m: tuple(sorted(("in", s, m) for s in range(n)))
    if collective == "reduce_scatter":
        if n_in != n_out * n:
            return None
        k = n_out
        return lambda r, m: tuple(
            sorted(("in", s, k * r + m) for s in range(n)))
    if collective == "all_gather":
        if n_out != n_in * n:
            return None
        k = n_in
        return lambda r, m: (("in", m // k, m % k),)
    if collective == "all_to_all":
        if n_in != n_out or n_in % n != 0:
            return None
        k = n_in // n
        return lambda r, m: (("in", m // k, k * r + m % k),)
    if collective == "broadcast":
        if n_in != n_out:
            return None
        return lambda r, m: (("in", root, m),)
    return None


def _check_semantics(program: Program, n: int, collective: str, root: int,
                     val: Dict[tuple, tuple]) -> List[Finding]:
    n_in = program.chunks[program.in_buffer]
    n_out = program.chunks[program.out_buffer]
    expected = _expected_provenance(collective, n, n_in, n_out, root)
    if expected is None:
        return [Finding(
            "semantics",
            f"chunk grid in={n_in} out={n_out} does not fit the "
            f"{collective} shape contract at n={n}")]
    findings = []
    for r in range(n):
        for m in range(n_out):
            got = val[(r, program.out_buffer, m)]
            want = expected(r, m)
            if got != want:
                findings.append(Finding(
                    "semantics",
                    f"output chunk {m} computes {_fmt(got)} but "
                    f"{collective} specifies {_fmt(want)}", rank=r))
    return findings


def _fmt(atoms: tuple) -> str:
    parts = [f"in[{c}]@{r}" for _, r, c in atoms]
    return " + ".join(parts) if parts else "<empty>"


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def verify_program(program: Program, num_ranks: int, *,
                   collective: Optional[str] = None,
                   root: int = 0) -> VerifyReport:
    """Run every check against ``program`` at concrete size
    ``num_ranks``; findings are collected, never raised. Pass
    ``collective`` to additionally check the output provenance against
    the collective's specification."""
    n = int(num_ranks)
    if n < 2:
        raise ValueError(f"verification needs num_ranks >= 2, got {n}")
    checks = ["structure"]
    findings = _check_structure(program, n)
    if not findings:
        # deeper checks evaluate indices; only sound on a well-formed
        # program
        checks += ["sync", "hazard", "conservation"]
        findings += _check_sync_and_hazards(program, n)
        findings += _check_conservation(program, n, collective, root)
        if collective in SEMANTIC_COLLECTIVES:
            checks.append("semantics")
    return VerifyReport(program=program.name, num_ranks=n,
                        collective=collective, checks=tuple(checks),
                        findings=findings)


def check(program: Program, num_ranks: int, *, mode: str = "strict",
          collective: Optional[str] = None,
          root: int = 0) -> Optional[VerifyReport]:
    """Policy wrapper: ``mode='off'`` skips entirely, ``'warn'`` emits a
    UserWarning on findings, ``'strict'`` raises
    :class:`VerificationError`. Returns the report (None when off)."""
    if mode == "off":
        return None
    if mode not in MODES:
        raise ValueError(f"verify mode must be one of {MODES}, got {mode!r}")
    report = verify_program(program, num_ranks, collective=collective,
                            root=root)
    if report.findings:
        if mode == "strict":
            report.raise_if_failed()
        warnings.warn(
            f"plan verification: {report.summary()}; first finding: "
            f"{report.findings[0]}", stacklevel=2)
    return report
