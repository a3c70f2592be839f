"""DSL executors of the port: run a ``dsl.Program`` on rank-stacked tensors.

Two executors of the *same* declared algorithm (paper §3.1/§4.3 —
declaration vs. implementation):

* ``TorchExecutor`` — the plain version, a port of the reference's
  ``XlaExecutor`` (``repro/core/executor.py:181-480``). Every rank's
  buffer is one slice of a rank-stacked tensor, so a put round is a
  permutation of the rank axis and a local op is one indexed tensor op
  for all ranks at once. Synchronization instructions erase to program
  order. Runs on any device.

  - ``vectorize=False`` — the reference lowering: every chunk put is its
    own rank permutation (the ``opt_level=0`` baseline).
  - ``vectorize=True`` (default) — the memoized lowering plan classifies
    each put: a full fan-out where every peer receives its own chunk is
    ONE transpose of the (rank, chunk) axes (the reference's
    ``all_to_all``), one where every peer receives the same chunk is ONE
    broadcast over ranks (its ``all_gather``), and same-shift groups
    move as ONE stacked permutation.

  Reductions left-fold in declaration order (``acc = acc + v``, rounded
  to the buffer dtype after each add) in both modes, so outputs are
  bit-identical to the reference and to the kernel.

* ``CudaExecutor`` — the wrapper of the hand-written Hopper kernel
  ``csrc/executor.cu``, the port of ``PallasExecutor._kernel``.
  :func:`encode` resolves every ``IndexExpr`` per rank at plan-build
  time into an int32 instruction table ``[n][ops][8]``; one cooperative
  launch runs every rank as ``nb`` blocks (:func:`blocks_per_rank`) of
  ``THREADS`` threads, block ``b`` walking the rank's row of the table on
  tile ``b`` of every chunk (contiguous tiles on 16-byte bounds, the last
  taking the tail: ``csrc/primitives.cuh:tile``). CUDA tensors only:
  there is no fallback.

Both take ``x`` shaped ``(n, chunks_in * rows, cols)`` — rank ``r``'s
payload is ``x[r]`` — and return ``(n, chunks_out * rows, cols)``.

Both also run one program over ``groups`` disjoint groups of ``n`` ranks
of a ``(groups * n, ...)`` tensor (``groups=``, ``stride=``; member ``m``
of group ``g`` is rank ``g % stride + m * stride + (g // stride) * n *
stride``, :func:`repro_torch.mesh.group_ranks`): the per-axis phases of a
hierarchical plan on a node-major rank grid. The kernel runs every group
in one launch, reading strided groups in place; the plain version runs
the groups one after another.

Both consult the chaos hook (:func:`repro_torch.core.faults.active`, one
read a call) before anything else. The reference's executors consult it
at trace time; the port's trace time is the CUDA-graph capture: on the
card Python runs an executor call only in a step's warm-ups, its
capture and an eager fused prefill step, so a graph replay pays nothing
and a fault fires into the captured graph, never into a replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.dsl import IndexExpr, Instr, Op, Program, full_fanout
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.mesh import group_ranks

__all__ = ["TorchExecutor", "CudaExecutor", "EncodedProgram", "encode",
           "execute", "graph_nodes", "device_timer", "CaptureScope",
           "capture_scope", "OPCODES", "FIELDS"]


# ---------------------------------------------------------------------------
# lowering plan (vectorized torch path) — as in the reference
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _PutAction:
    """One lowered put instruction: 'a2a' (one rank/chunk transpose),
    'gather' (one broadcast over ranks) or 'groups' (one stacked
    permutation per same-shift triple group)."""

    kind: str
    sb: str = ""
    db: str = ""
    src_expr: Optional[IndexExpr] = None
    groups: Tuple[Tuple[Any, Tuple], ...] = ()   # (peer key, triples)


def _peer_key(to: IndexExpr, n: int):
    """The uniform int shift of a put's peer map when one exists, else
    the peer ``IndexExpr`` itself (rank-dependent maps such as swing's
    parity-alternating exchanges)."""
    try:
        return to.shift() % n
    except ValueError:
        return to


def _peer_dests(key, n: int) -> List[int]:
    """``dests[r]`` = the rank that sender ``r`` puts to. The peer map
    must be a permutation of the ranks."""
    if isinstance(key, int):
        return [(r + key) % n for r in range(n)]
    dests = [key(r, n) % n for r in range(n)]
    if sorted(dests) != list(range(n)):
        raise ValueError(
            f"put peer map {key!r} is not a permutation of {n} ranks "
            f"(destinations {dests}); rank-dependent puts must pair "
            f"every sender with a distinct receiver")
    return dests


def _group_by_shift(triples, n) -> Tuple[Tuple[Any, Tuple], ...]:
    groups: List[Tuple[Any, List]] = []
    for t in triples:
        s = _peer_key(t[2], n)
        if groups and groups[-1][0] == s:
            groups[-1][1].append(t)
        else:
            groups.append((s, [t]))
    return tuple((s, tuple(ts)) for s, ts in groups)


def _classify_put(instr: Instr, n: int, chunks: dict) -> _PutAction:
    triples = instr.put_triples()
    fo = full_fanout(triples, n) if len(triples) > 1 else None
    if fo is not None:
        sb, db = fo
        if chunks[db] == n:
            if (chunks[sb] == n
                    and all(si == to for (_, si), _, to in triples)):
                return _PutAction("a2a", sb=sb, db=db)
            sis = {si for (_, si), _, _ in triples}
            if len(sis) == 1:
                return _PutAction("gather", sb=sb, db=db,
                                  src_expr=next(iter(sis)))
    return _PutAction("groups", groups=_group_by_shift(triples, n))


_PLAN_MEMO: "weakref.WeakKeyDictionary[Program, dict]" = \
    weakref.WeakKeyDictionary()


def _lowering_plan(program: Program, n: int):
    """Per-(program, n) classification of every PUT, memoized."""
    memo = _PLAN_MEMO.setdefault(program, {})
    if n not in memo:
        memo[n] = {
            id(instr): _classify_put(instr, n, program.chunks)
            for instr in program.instructions() if instr.op is Op.PUT
        }
    return memo[n]


def _slab(exprs: Sequence[IndexExpr]) -> Optional[IndexExpr]:
    """If ``exprs`` address k contiguous sub-chunks ``k*base + j``
    (j = 0..k-1) of one split buffer, return the base expression."""
    k = len(exprs)
    e0 = exprs[0]
    if e0.scale != k or e0.post != 0:
        return None
    for j, e in enumerate(exprs):
        if dataclasses.replace(e, post=0) != dataclasses.replace(e0, post=0) \
                or e.post != j:
            return None
    return dataclasses.replace(e0, scale=1, post=0)


def _writes_buffer(program: Program, name: str) -> bool:
    """Does any instruction write buffer ``name`` (locally or by put)?"""
    for instr in program.instructions():
        if instr.op is Op.PUT:
            if any(db == name for _, (db, _), _ in instr.put_triples()):
                return True
        elif instr.op in (Op.COPY, Op.REDUCE) and instr.dst[0] == name:
            return True
    return False


def _frozen(program: Program) -> Program:
    return program if program._frozen else program.freeze()


# ---------------------------------------------------------------------------
# TorchExecutor — the plain version
# ---------------------------------------------------------------------------
class TorchExecutor:
    """Interpret a Program with torch ops on rank-stacked tensors."""

    def __init__(self, program: Program, *, vectorize: bool = True):
        self.program = _frozen(program)
        self.vectorize = vectorize
        self._prepared: Optional[Tuple[int, dict]] = None
        self._writes_input = _writes_buffer(self.program,
                                            self.program.in_buffer)
        self._ix_cache: Dict[tuple, torch.Tensor] = {}

    def prepare(self, n: int) -> "TorchExecutor":
        """Prebuild the lowering plan for an ``n``-rank axis (the
        compile-once path an ``ExecutionPlan`` takes at build time)."""
        if self.vectorize:
            self._prepared = (n, _lowering_plan(self.program, n))
        return self

    # -- indexing helpers ----------------------------------------------------
    def _ix(self, values: Sequence[int], device) -> torch.Tensor:
        key = (tuple(values), device)
        t = self._ix_cache.get(key)
        if t is None:
            t = self._ix_cache[key] = torch.tensor(values, dtype=torch.long,
                                                   device=device)
        return t

    def _per_rank(self, e: IndexExpr, n: int, device) -> torch.Tensor:
        return self._ix([e(r, n) for r in range(n)], device)

    def _get(self, bufs, b, e, n, ar):
        """(n, rows, cols): every rank's chunk ``e`` of buffer ``b``."""
        if e.is_static():
            return bufs[b][:, e(0, n)]
        return bufs[b][ar, self._per_rank(e, n, ar.device)]

    def _set(self, bufs, b, e, val, n, ar):
        val = val.to(bufs[b].dtype)
        if e.is_static():
            bufs[b][:, e(0, n)] = val
        else:
            bufs[b][ar, self._per_rank(e, n, ar.device)] = val

    def _deliver(self, bufs, db, di, dests, val, n, ar):
        """Sender ``r``'s ``val[r]`` lands in ``bufs[db][dests[r]]`` at
        chunk ``di`` evaluated at the sender (the reference's
        ``di(sender, n)`` on the receiving side)."""
        bufs[db][self._ix(dests, ar.device),
                 self._per_rank(di, n, ar.device)] = val.to(bufs[db].dtype)

    # -- put lowerings -------------------------------------------------------
    def _run_put_reference(self, bufs, instr, n, ar):
        for (sb, si), (db, di), to in instr.put_triples():
            dests = _peer_dests(_peer_key(to, n), n)
            val = bufs[sb][ar, self._per_rank(si, n, ar.device)]
            self._deliver(bufs, db, di, dests, val, n, ar)

    def _run_put_vectorized(self, bufs, action: _PutAction, n, ar):
        if action.kind == "a2a":
            # peer j's chunk-for-me is its bufs[sb][me]: one transpose
            # moves the whole round; my own slot keeps its value (a put
            # never targets self)
            out = bufs[action.sb].transpose(0, 1).to(bufs[action.db].dtype)
            out = out.contiguous()
            out[ar, ar] = bufs[action.db][ar, ar]
            bufs[action.db] = out
            return
        if action.kind == "gather":
            val = self._get(bufs, action.sb, action.src_expr, n, ar)
            g = val.unsqueeze(0).expand((n,) + tuple(val.shape))
            g = g.to(bufs[action.db].dtype).contiguous()  # g[me, j] = val[j]
            g[ar, ar] = bufs[action.db][ar, ar]
            bufs[action.db] = g
            return
        for key, triples in action.groups:
            dests = _peer_dests(key, n)
            # read every source of the group before any write lands
            stacked = torch.stack([self._get(bufs, b, e, n, ar)
                                   for (b, e), _, _ in triples], dim=1)
            for i, (_, (db, di), _) in enumerate(triples):
                self._deliver(bufs, db, di, dests, stacked[:, i], n, ar)

    # -- reduce --------------------------------------------------------------
    def _reduce_operands(self, bufs, srcs, n, ar):
        """Operand values in declaration order; a run of operands in one
        buffer is gathered with one indexed read (vectorized mode)."""
        vals: List[torch.Tensor] = []
        i = 0
        while i < len(srcs):
            b = srcs[i][0]
            j = i + 1
            while j < len(srcs) and srcs[j][0] == b:
                j += 1
            run = srcs[i:j]
            if len(run) == 1:
                vals.append(self._get(bufs, b, run[0][1], n, ar))
            else:
                idx = self._ix([e(r, n) for r in range(n) for _, e in run],
                               ar.device).view(n, len(run))
                stacked = bufs[b][ar[:, None], idx]       # (n, k, rows, cols)
                vals += list(stacked.unbind(1))
            i = j
        return vals

    def _run_reduce(self, bufs, instr, n, ar):
        db, di = instr.dst
        if self.vectorize:
            vals = self._reduce_operands(bufs, list(instr.srcs), n, ar)
        else:
            vals = [bufs[b][ar, self._per_rank(e, n, ar.device)]
                    for b, e in instr.srcs]
        acc = vals[0]
        for v in vals[1:]:    # left fold: bit-identical to the reference
            acc = acc + v
        self._set(bufs, db, di, acc, n, ar)

    # -- profiling -----------------------------------------------------------
    def trace_emissions(self, n: int):
        """The lowered emission stream for an ``n``-rank axis
        (:mod:`repro_torch.core.trace`), as the reference's
        ``XlaExecutor.trace_emissions`` labels it: one ``all_to_all`` (a
        rank/chunk transpose here) or ``all_gather`` (a broadcast over
        ranks) emission per fan-out round, one (stacked) ``ppermute`` (a
        rank permutation) per same-shift group, per-triple emissions in
        reference mode; synchronization erases to program order
        (``data_dep``)."""
        from repro_torch.core.trace import Emission
        p = self.program
        plan = None
        if self.vectorize:
            if self._prepared is not None and self._prepared[0] == n:
                plan = self._prepared[1]
            else:
                plan = _lowering_plan(p, n)
        out = []
        for iid, instr in enumerate(p.instructions()):
            rid = instr.round_id
            if instr.op is Op.PUT:
                triples = instr.put_triples()
                if plan is None:
                    for sub, t in enumerate(triples):
                        k = _peer_key(t[2], n)
                        out.append(Emission(
                            iid, sub, "put", "ppermute", rid,
                            shift=k if isinstance(k, int) else None,
                            puts=(t,)))
                    continue
                action = plan[id(instr)]
                if action.kind == "a2a":
                    out.append(Emission(iid, 0, "put", "all_to_all", rid,
                                        puts=tuple(triples)))
                elif action.kind == "gather":
                    out.append(Emission(iid, 0, "put", "all_gather", rid,
                                        puts=tuple(triples)))
                else:
                    for sub, (k, ts) in enumerate(action.groups):
                        out.append(Emission(
                            iid, sub, "put",
                            "stacked_ppermute" if len(ts) > 1 else "ppermute",
                            rid, shift=k % n if isinstance(k, int) else None,
                            puts=tuple(ts)))
            elif instr.op is Op.WAIT:
                out.append(Emission(iid, 0, "wait", "data_dep", rid,
                                    waits=tuple(instr.wait_chunks())))
            elif instr.op is Op.BARRIER:
                out.append(Emission(iid, 0, "barrier", "data_dep", rid))
            elif instr.op is Op.FLUSH:
                continue  # no-op here (program order)
            elif instr.op in (Op.COPY, Op.REDUCE):
                out.append(Emission(iid, 0, instr.op.value, "jnp", rid,
                                    dst=instr.dst, srcs=tuple(instr.srcs)))
            else:  # pragma: no cover
                raise NotImplementedError(instr.op)
        return out

    # -- entry point ---------------------------------------------------------
    def __call__(self, x: torch.Tensor, *, groups: int = 1,
                 stride: int = 1) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"expected a rank-stacked (n, rows, cols) "
                             f"payload, got shape {tuple(x.shape)}")
        inj = faults.active()
        if inj is not None:       # chaos hook (core/faults.py)
            x = inj.on_execute(x)
        from repro_torch.core import trace as trace_mod
        col = trace_mod.active()
        if col is not None:       # profiler hook: one group's timeline
            p = self.program
            col.record(self, n=x.shape[0] // groups,
                       chunk_rows=x.shape[1] // p.chunks[p.in_buffer],
                       cols=x.shape[2], dtype=_dtype_str(x.dtype),
                       backend="torch")
        if groups == 1:
            return self._run(x)
        if x.shape[0] % groups:
            raise ValueError(f"{x.shape[0]} ranks do not split into "
                             f"{groups} groups")
        members = group_ranks(groups, x.shape[0] // groups, stride)
        outs = [self._run(x[m]) for m in members]
        out = torch.empty((x.shape[0],) + tuple(outs[0].shape[1:]),
                          dtype=outs[0].dtype, device=x.device)
        for m, o in zip(members, outs):
            out[m] = o
        return out

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        p = self.program
        n, total, cols = x.shape
        n_in = p.chunks[p.in_buffer]
        rows = total // n_in
        if self._writes_input:
            x = x.clone()
        if not self.vectorize:
            plan = None
        elif self._prepared is not None and self._prepared[0] == n:
            plan = self._prepared[1]
        else:
            plan = _lowering_plan(p, n)
        ar = self._ix(list(range(n)), x.device)

        bufs: Dict[str, torch.Tensor] = {}
        for name, k in p.chunks.items():
            if name == p.in_buffer:
                bufs[name] = x.reshape(n, n_in, rows, cols)
            else:
                bufs[name] = torch.zeros((n, k, rows, cols), dtype=x.dtype,
                                         device=x.device)

        for instr in p.instructions():
            if instr.op is Op.PUT:
                if plan is not None:
                    self._run_put_vectorized(bufs, plan[id(instr)], n, ar)
                else:
                    self._run_put_reference(bufs, instr, n, ar)
            elif instr.op in (Op.WAIT, Op.FLUSH, Op.BARRIER):
                continue  # program order IS the synchronization here
            elif instr.op is Op.COPY:
                (sb, si), (db, di) = instr.srcs[0], instr.dst
                self._set(bufs, db, di, self._get(bufs, sb, si, n, ar), n, ar)
            elif instr.op is Op.REDUCE:
                self._run_reduce(bufs, instr, n, ar)
            else:  # pragma: no cover
                raise NotImplementedError(instr.op)

        out = bufs[p.out_buffer]
        return out.reshape(n, out.shape[1] * rows, cols)


# ---------------------------------------------------------------------------
# encode — the host half of the CUDA executor
# ---------------------------------------------------------------------------
#: opcodes of the instruction table (mirrored in csrc/executor.cu)
OPCODES = {"nop": 0, "put": 1, "wait": 2, "copy": 3, "reduce": 4,
           "barrier": 5, "zero": 6}
#: int32 fields per instruction:
#:   put     [op, src_buf, src_chunk, dst_buf, dst_chunk, peer, nchunks, flag]
#:   wait    [op, -, -, -, -, -, -, flag]
#:   copy    [op, src_buf, src_chunk, dst_buf, dst_chunk, -, nchunks, -]
#:   reduce  [op, operand_start, operand_count, dst_buf, dst_chunk, -, 1, -]
#:   barrier [op, -, -, -, -, -, -, barrier_id]
#:   zero    [op, -, -, dst_buf, dst_chunk, -, nchunks, -]
FIELDS = 8
MAX_RANKS = 16      # kMaxGridRanks in csrc/executor.cu: ranks of one launch
MAX_BUFFERS = 8     # kMaxBufs
MAX_OPERANDS = 32   # kMaxOperands
#: threads a block of the kernel (at most kMaxThreads = 512)
THREADS = 256
#: chunk bytes a block owns, about: one 16-byte vector a thread
TILE_BYTES = 16 * THREADS


def blocks_per_rank(chunk_elems: int, esize: int, ranks: int,
                    cap: int) -> int:
    """Blocks a rank of one launch over ``ranks`` ranks (groups * n)
    whose chunks hold ``chunk_elems`` elements of ``esize`` bytes: about
    one block per ``TILE_BYTES`` of a chunk, at most ``cap // ranks``
    (``cap``: the blocks of ``THREADS`` threads the card keeps resident at
    once, from the occupancy query; the blocks spin on each other's
    flags, so all must be resident), and no more blocks than non-empty
    tiles."""
    if not 1 <= ranks <= MAX_RANKS:
        raise ValueError(f"the CUDA executor runs 1 to {MAX_RANKS} ranks per "
                         f"launch, got {ranks}")
    if cap < ranks:
        raise RuntimeError(f"the card keeps {cap} executor blocks resident, "
                           f"fewer than one per rank ({ranks})")
    units = max(1, -(-chunk_elems * esize // 16))
    want = max(1, min(cap // ranks, -(-chunk_elems * esize // TILE_BYTES),
                      units))
    per = -(-units // want)
    return -(-units // per)


@dataclasses.dataclass(frozen=True)
class EncodedProgram:
    """A program resolved for one axis size: per-rank instruction rows
    (chunk offsets and counts are in units of one chunk; the kernel
    scales them by the chunk's element count at launch)."""

    n: int
    buffers: Tuple[str, ...]       # buffer id -> name (0 input, 1 output)
    ops: np.ndarray                # int32 [n, n_ops, FIELDS]
    operands: np.ndarray           # int32 [n, n_operands, 2] (buf, chunk)
    n_flags: int                   # put flag slots per receiving rank
    n_barriers: int
    writes_input: bool             # input must be copied before launch
    #: int32 [n, n_ops, 2]: the (instruction, emission) each row runs —
    #: the ids of :meth:`CudaExecutor.trace_emissions` — or -1 (zero, nop)
    tags: np.ndarray
    #: wait instruction -> its chunks grouped by the flag slot each waits
    #: on (one row a group, indices into ``wait_chunks()``); None where
    #: the grouping differs between ranks
    wait_groups: Optional[Dict[int, Tuple[Tuple[int, ...], ...]]]

    def puts_per_rank(self) -> int:
        return int((self.ops[0, :, 0] == OPCODES["put"]).sum())


def _put_emissions(instr: Instr, n: int):
    """The puts one PUT instruction issues, grouped by peer map:
    ``(key, triples, slab)`` where ``slab`` is ``(sb, db, src_base,
    dst_base, k)`` when the group's k chunks are one contiguous slab on
    both sides (one put, as ``PallasExecutor._put_emissions``)."""
    out = []
    for key, triples in _group_by_shift(instr.put_triples(), n):
        slab = None
        if len(triples) > 1:
            sb0, db0 = triples[0][0][0], triples[0][1][0]
            if all(sb == sb0 for (sb, _), _, _ in triples) \
                    and all(db == db0 for _, (db, _), _ in triples):
                s_base = _slab([si for (_, si), _, _ in triples])
                d_base = _slab([di for _, (_, di), _ in triples])
                if s_base is not None and d_base is not None:
                    slab = (sb0, db0, s_base, d_base, len(triples))
        out.append((key, triples, slab))
    return out


def _peer_of(key, r: int, n: int) -> int:
    return (r + key) % n if isinstance(key, int) else key(r, n) % n


def encode(program: Program, n: int) -> EncodedProgram:
    """Resolve ``program`` for ``n`` ranks into the kernel's table.

    Port of ``PallasExecutor.prepare`` + ``_wait_put_rounds``: puts are
    grouped per peer map (a contiguous-slab group is one put), each put
    gets its own flag slot at the receiver — flag slots never alias, so
    the reference's rotation over 4 DMA semaphore pairs is not needed —
    and each wait carries the flag slot of the put that delivers its
    chunk. Slots that no instruction and no incoming put ever writes
    but that are read or returned are zeroed first, matching the
    plain version's zero-initialized buffers.
    """
    p = _frozen(program)
    if n > MAX_RANKS:
        raise ValueError(f"the CUDA executor runs at most {MAX_RANKS} ranks "
                         f"per launch, got n={n}")
    names = [p.in_buffer, p.out_buffer] + [
        b for b in p.chunks if b not in (p.in_buffer, p.out_buffer)]
    if len(names) > MAX_BUFFERS:
        raise ValueError(f"program {p.name!r} uses {len(names)} buffers; "
                         f"the kernel takes at most {MAX_BUFFERS}")
    bid = {b: i for i, b in enumerate(names)}
    instrs = p.instructions()

    # pass 1: flag slots (numbered in program order, identical on every
    # rank) and every delivery (sender, receiver, buffer, chunk) -> flags
    emissions: Dict[int, list] = {}
    deliveries: Dict[tuple, List[int]] = {}
    n_flags = 0
    for instr in instrs:
        if instr.op is not Op.PUT:
            continue
        ems = []
        for key, triples, slab in _put_emissions(instr, n):
            if slab is not None:
                fids = [n_flags]
                n_flags += 1
            else:
                fids = list(range(n_flags, n_flags + len(triples)))
                n_flags += len(triples)
            ems.append((key, triples, slab, fids))
            for r in range(n):
                peer = _peer_of(key, r, n)
                if slab is not None:
                    _, db, _, d_base, k = slab
                    for j in range(k):
                        deliveries.setdefault(
                            (r, peer, db, k * d_base(r, n) + j), []
                        ).append(fids[0])
                else:
                    for (_, (db, di), _), f in zip(triples, fids):
                        deliveries.setdefault(
                            (r, peer, db, di(r, n)), []).append(f)
        emissions[id(instr)] = ems

    # pass 2: per-rank instruction rows, each tagged with the (instruction,
    # emission) it runs
    ops: List[List[List[int]]] = []
    tags: List[List[Tuple[int, int]]] = []
    operands: List[List[Tuple[int, int]]] = []
    wait_groups: Optional[Dict[int, tuple]] = {}
    n_barriers = 0
    for r in range(n):
        row: List[List[int]] = []
        tag: List[Tuple[int, int]] = []
        opnd: List[Tuple[int, int]] = []
        consumed: Dict[tuple, int] = {}
        written = {(p.in_buffer, c) for c in range(p.chunks[p.in_buffer])}
        read: set = set()
        bar = 0
        for iid, instr in enumerate(instrs):
            if instr.op is Op.PUT:
                sub = 0
                for key, triples, slab, fids in emissions[id(instr)]:
                    peer = _peer_of(key, r, n)
                    if slab is not None:
                        sb, db, s_base, d_base, k = slab
                        s0 = k * s_base(r, n)
                        read |= {(sb, s0 + j) for j in range(k)}
                        row.append([OPCODES["put"], bid[sb], s0, bid[db],
                                    k * d_base(r, n), peer, k, fids[0]])
                        tag.append((iid, sub))
                        sub += 1
                    else:
                        for ((sb, si), (db, di), _), f in zip(triples, fids):
                            read.add((sb, si(r, n)))
                            row.append([OPCODES["put"], bid[sb], si(r, n),
                                        bid[db], di(r, n), peer, 1, f])
                            tag.append((iid, sub))
                            sub += 1
            elif instr.op is Op.WAIT:
                groups: Dict[int, List[int]] = {}
                for c, ((db, e), frm) in enumerate(instr.wait_chunks()):
                    key = (frm(r, n) % n, r, db, e(r, n))
                    flags = deliveries.get(key)
                    if not flags:
                        raise ValueError(f"wait {instr} (rank {r}) has no "
                                         f"matching put")
                    # the k-th wait on a chunk matches its k-th delivery
                    f = flags[min(consumed.get(key, 0), len(flags) - 1)]
                    consumed[key] = consumed.get(key, 0) + 1
                    if f not in groups:
                        tag.append((iid, len(groups)))
                        row.append([OPCODES["wait"], 0, 0, 0, 0, 0, 0, f])
                        groups[f] = []
                    groups[f].append(c)
                grouped = tuple(tuple(g) for g in groups.values())
                if r == 0:
                    wait_groups[iid] = grouped
                elif wait_groups is not None \
                        and wait_groups.get(iid) != grouped:
                    wait_groups = None
            elif instr.op is Op.BARRIER:
                row.append([OPCODES["barrier"], 0, 0, 0, 0, 0, 0, bar])
                tag.append((iid, 0))
                bar += 1
            elif instr.op is Op.FLUSH:
                continue  # puts complete before their signal: no-op
            elif instr.op is Op.COPY:
                (sb, si), (db, di) = instr.srcs[0], instr.dst
                read.add((sb, si(r, n)))
                written.add((db, di(r, n)))
                row.append([OPCODES["copy"], bid[sb], si(r, n), bid[db],
                            di(r, n), 0, 1, 0])
                tag.append((iid, 0))
            elif instr.op is Op.REDUCE:
                if len(instr.srcs) > MAX_OPERANDS:
                    raise ValueError(f"reduce with {len(instr.srcs)} operands;"
                                     f" the kernel takes {MAX_OPERANDS}")
                db, di = instr.dst
                row.append([OPCODES["reduce"], len(opnd), len(instr.srcs),
                            bid[db], di(r, n), 0, 1, 0])
                tag.append((iid, 0))
                for sb, si in instr.srcs:
                    read.add((sb, si(r, n)))
                    opnd.append((bid[sb], si(r, n)))
                written.add((db, di(r, n)))
            else:  # pragma: no cover
                raise NotImplementedError(instr.op)
        n_barriers = bar
        written |= {(db, c) for (_, rcv, db, c) in deliveries if rcv == r}
        out_slots = {(p.out_buffer, c) for c in range(p.chunks[p.out_buffer])}
        zero = sorted((read | out_slots) - written)
        row = [[OPCODES["zero"], 0, 0, bid[b], c, 0, 1, 0]
               for b, c in zero] + row
        tag = [(-1, -1)] * len(zero) + tag
        ops.append(row)
        tags.append(tag)
        operands.append(opnd)

    n_ops = max(len(rw) for rw in ops)
    table = np.zeros((n, max(n_ops, 1), FIELDS), np.int32)
    tag_table = np.full((n, max(n_ops, 1), 2), -1, np.int32)
    for r, rw in enumerate(ops):
        if rw:
            table[r, :len(rw)] = np.asarray(rw, np.int32)
            tag_table[r, :len(rw)] = np.asarray(tags[r], np.int32)
    n_opnd = max(1, max(len(o) for o in operands))
    opnds = np.zeros((n, n_opnd, 2), np.int32)
    for r, o in enumerate(operands):
        if o:
            opnds[r, :len(o)] = np.asarray(o, np.int32)
    return EncodedProgram(n=n, buffers=tuple(names), ops=table,
                          operands=opnds, n_flags=n_flags,
                          n_barriers=n_barriers,
                          writes_input=_writes_buffer(p, p.in_buffer),
                          tags=tag_table, wait_groups=wait_groups)


# ---------------------------------------------------------------------------
# CudaExecutor — the kernel's wrapper
# ---------------------------------------------------------------------------
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int32: 3}


def _dtype_str(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class CaptureScope:
    """What this thread launched into the graph it is capturing: the
    executor ``launches`` made into it, and the (executor, shape)
    ``marks`` of every shape first launched into a capture there."""

    def __init__(self):
        self.launches = 0
        self.marks: list = []

    def discard(self) -> None:
        """Take the marks back (the capture failed: its graph is gone, so
        those bindings may be re-bound)."""
        for ex, key in self.marks:
            ex._captured.discard(key)
        self.marks.clear()


_SCOPE = threading.local()


@contextlib.contextmanager
def capture_scope():
    """The :class:`CaptureScope` of one capture on this thread, current
    until the block ends: a capture in another thread keeps its own."""
    scope, prev = CaptureScope(), getattr(_SCOPE, "scope", None)
    _SCOPE.scope = scope
    try:
        yield scope
    finally:
        _SCOPE.scope = prev


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class CudaExecutor:
    """Run a Program through the hand-written Hopper kernel
    (``csrc/executor.cu``); replaces ``PallasExecutor``.

    The instruction table, the flag slots, the epoch words and every
    scratch buffer are device allocations made once when the plan is
    built (:meth:`bind`); a call allocates only its output and launches
    once. The flags' epoch lives on the card, one word per block that
    the kernel bumps at each launch, so the host passes nothing that
    changes between launches: a launch captured in a CUDA graph replays
    with a fresh epoch, and replays need no memset between them.

    Each shape keeps its binding as long as the executor lives, so a call
    at another shape leaves a captured graph's device pointers valid; an
    explicit re-bind of a shape that was launched into a capture raises.
    """

    #: kernel launches made through any CudaExecutor, eager or into a
    #: CUDA-graph capture (the main path's proof that it ran on the
    #: kernel); traced launches are counted apart
    launches: int = 0
    #: launches of the traced kernel (:meth:`launch_traced`)
    traced_launches: int = 0

    def __init__(self, program: Program):
        self.program = _frozen(program)
        self.encoded: Optional[EncodedProgram] = None
        self._bound: Optional[tuple] = None       # the last one launched
        self._bindings: dict[tuple, tuple] = {}
        self._captured: set[tuple] = set()
        self._traced: dict[tuple, tuple] = {}     # traced launches' state

    @property
    def blocks(self) -> Optional[int]:
        """Blocks a rank of the bound launch (None before :meth:`bind`)."""
        return None if self._bound is None else self._bound[10]

    @property
    def epochs(self) -> Optional[torch.Tensor]:
        """The bound launch's epoch words, one per block (None before
        :meth:`bind`)."""
        return None if self._bound is None else self._bound[11]

    def prepare(self, n: int) -> "CudaExecutor":
        self.encoded = encode(self.program, n)
        return self

    def bind(self, rows: int, cols: int, dtype: torch.dtype, device, *,
             groups: int = 1) -> "CudaExecutor":
        """Allocate the device state for ``(groups * n, n_in*rows, cols)``
        payloads of ``dtype`` on ``device``: instruction table, flags (one
        set per group, one word per tile), epoch words (one per block,
        zero), scratch; and fix the launch's :attr:`blocks` a rank."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CudaExecutor binds CUDA devices only, got "
                             f"{device}; the plain version is TorchExecutor")
        return self._bind(rows, cols, dtype, device, groups)

    def _bind(self, rows, cols, dtype, device, groups) -> "CudaExecutor":
        enc = self.encoded
        if enc is None:
            raise KernelLaunchError("CudaExecutor.bind before prepare(n)")
        if dtype not in _DTYPE_CODES:
            raise KernelLaunchError(f"CudaExecutor takes "
                                    f"{list(_DTYPE_CODES)}, got {dtype}")
        if _capturing():
            raise KernelLaunchError(
                f"CudaExecutor for {self.program.name!r} binds inside a CUDA "
                f"graph capture (host copies and an occupancy query): run "
                f"the plan once at this shape before capturing it")
        key = (rows, cols, dtype, device, groups)
        if key in self._captured:
            raise KernelLaunchError(
                f"CudaExecutor for {self.program.name!r} re-binds a shape "
                f"that a CUDA graph captured: the graph replays its flags, "
                f"epoch words and scratch")
        n = enc.n
        if groups < 1 or groups * n > MAX_RANKS:
            raise KernelLaunchError(f"{groups} groups of {n} ranks: the CUDA "
                                    f"executor runs at most {MAX_RANKS} "
                                    f"ranks per launch")
        scratch = self._scratch(rows, cols, dtype, device, groups)
        from repro_torch.kernels import build
        cap = build.executor_library().dsl_executor_max_blocks(
            _DTYPE_CODES[dtype], THREADS)
        esize = torch.empty((), dtype=dtype).element_size()
        blocks = blocks_per_rank(rows * cols, esize, groups * n, cap)
        group_flags = max(1, n * (enc.n_flags + enc.n_barriers) * blocks)
        flags = torch.zeros(groups * group_flags, dtype=torch.int32,
                            device=device)
        epochs = torch.zeros(groups * n * blocks, dtype=torch.int32,
                             device=device)
        ops = torch.from_numpy(enc.ops).to(device)
        opnds = torch.from_numpy(enc.operands).to(device)
        self._bound = self._bindings[key] = (
            rows, cols, dtype, device, groups, scratch, flags, group_flags,
            ops, opnds, blocks, epochs)
        return self

    def _scratch(self, rows, cols, dtype, device, groups) -> list:
        """The program's scratch buffers for one binding (contents are
        never read before the launch writes them)."""
        p, enc = self.program, self.encoded
        return [torch.empty((groups * enc.n, p.chunks[b] * rows, cols),
                            dtype=dtype, device=device)
                for b in enc.buffers[2:]]

    def release(self) -> int:
        """Give the scratch of every binding that no CUDA graph captured
        back to the allocator (stream-ordered, so a launch still in flight
        keeps it); the next launch at that shape allocates it again, with
        no host copy or query. Flags, epoch words and the instruction
        table stay bound (a few KiB; the epoch sequence goes on). A
        trainer that reduces many payload-sized leaves one after another
        holds one leaf's scratch at a time this way. Returns the bindings
        released."""
        released = 0
        for key, b in list(self._bindings.items()):
            if key in self._captured or b[5] is None:
                continue
            self._bindings[key] = b[:5] + (None,) + b[6:]
            if self._bound is b:
                self._bound = self._bindings[key]
            released += 1
        return released

    def __call__(self, x: torch.Tensor, *, groups: int = 1,
                 stride: int = 1) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError(
                f"CudaExecutor runs CUDA tensors only, got a tensor on "
                f"{x.device}; use backend='torch' for the plain version")
        inj = faults.active()
        if inj is not None:       # chaos hook: at a capture, not a replay
            x = inj.on_execute(x)
        from repro_torch.core import trace as trace_mod
        col = trace_mod.active()
        if col is not None:       # profiler hook: the traced kernel on x
            if groups != 1:
                raise ValueError("a trace covers one group of ranks; trace "
                                 "a group view's plan on one group")
            p = self.program
            col.record(self, n=x.shape[0],
                       chunk_rows=x.shape[1] // p.chunks[p.in_buffer],
                       cols=x.shape[2], dtype=_dtype_str(x.dtype),
                       backend="cuda", x=x)
        return self._launch(x, groups, stride)

    # -- profiling -----------------------------------------------------------
    def trace_emissions(self, n: int):
        """What the encoded table issues for an ``n``-rank axis
        (:mod:`repro_torch.core.trace`), one emission per row of a rank:
        puts grouped by peer map as ``PallasExecutor.trace_emissions``
        groups its DMAs (a contiguous slab is one ``put_slab``, else one
        ``put`` a chunk), one ``flag_wait`` per flag slot a WAIT spins on,
        ``block_barrier`` and ``block`` copies/reduces. The ids are the
        table's tags (:attr:`EncodedProgram.tags`)."""
        from repro_torch.core.trace import Emission
        p = self.program
        enc = (self.encoded if self.encoded is not None
               and self.encoded.n == n else encode(p, n))
        if enc.wait_groups is None:
            raise ValueError(f"{p.name!r}: its waits group by flag slot "
                             f"differently on different ranks at n={n}; "
                             f"its trace has no rank-independent ids")
        out = []
        for iid, instr in enumerate(p.instructions()):
            rid = instr.round_id
            if instr.op is Op.PUT:
                sub = 0
                for key, triples, slab in _put_emissions(instr, n):
                    k = key % n if isinstance(key, int) else None
                    if slab is not None:
                        out.append(Emission(iid, sub, "put", "put_slab", rid,
                                            shift=k, puts=tuple(triples)))
                        sub += 1
                    else:
                        for t in triples:
                            out.append(Emission(iid, sub, "put", "put", rid,
                                                shift=k, puts=(t,)))
                            sub += 1
            elif instr.op is Op.WAIT:
                chunks = instr.wait_chunks()
                for sub, group in enumerate(enc.wait_groups[iid]):
                    out.append(Emission(iid, sub, "wait", "flag_wait", rid,
                                        waits=tuple(chunks[c]
                                                    for c in group)))
            elif instr.op is Op.BARRIER:
                out.append(Emission(iid, 0, "barrier", "block_barrier", rid))
            elif instr.op is Op.FLUSH:
                continue  # puts complete before their signal
            elif instr.op in (Op.COPY, Op.REDUCE):
                out.append(Emission(iid, 0, instr.op.value, "block", rid,
                                    dst=instr.dst, srcs=tuple(instr.srcs)))
            else:  # pragma: no cover
                raise NotImplementedError(instr.op)
        return out

    def launch_traced(self, x: torch.Tensor):
        """One launch of the traced kernel on ``x`` (one group of ranks):
        ``(out, stamps)``, ``stamps`` int64 ``[n * blocks][ops][4]``
        (global start, global end, clock start, clock end a row; see
        ``csrc/executor.cu``). Its flags, epoch words, scratch and stamps
        are its own, kept per shape, and its blocks a rank come from the
        traced kernel's own residency limit; a next traced launch of the
        shape overwrites ``stamps``. Outside a CUDA-graph capture only."""
        enc = self.encoded
        if enc is None:
            raise RuntimeError("CudaExecutor.launch_traced before prepare(n)")
        if x.device.type != "cuda":
            raise ValueError(f"the traced kernel runs CUDA tensors only, got "
                             f"a tensor on {x.device}")
        if _capturing():
            raise RuntimeError("the traced kernel is not launched inside a "
                               "CUDA graph capture: captured steps hold the "
                               "untraced kernel only")
        p = self.program
        n = enc.n
        n_in, n_out = p.chunks[p.in_buffer], p.chunks[p.out_buffer]
        if x.dim() != 3 or x.shape[0] != n or x.shape[1] % n_in:
            raise ValueError(f"expected ({n}, {n_in} * rows, cols), got "
                             f"{tuple(x.shape)}")
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"CudaExecutor takes {list(_DTYPE_CODES)}, "
                             f"got {x.dtype}")
        rows, cols = x.shape[1] // n_in, x.shape[2]
        from repro_torch.kernels import build
        lib = build.executor_library()
        key = (rows, cols, x.dtype, x.device)
        st = self._traced.get(key)
        if st is None:
            cap = lib.dsl_executor_max_blocks_traced(_DTYPE_CODES[x.dtype],
                                                     THREADS)
            blocks = blocks_per_rank(rows * cols, x.element_size(), n, cap)
            scratch = [torch.empty((n, p.chunks[b] * rows, cols),
                                   dtype=x.dtype, device=x.device)
                       for b in enc.buffers[2:]]
            group_flags = max(1, n * (enc.n_flags + enc.n_barriers) * blocks)
            st = self._traced[key] = (
                blocks, scratch, group_flags,
                torch.zeros(group_flags, dtype=torch.int32, device=x.device),
                torch.zeros(n * blocks, dtype=torch.int32, device=x.device),
                torch.from_numpy(enc.ops).to(x.device),
                torch.from_numpy(enc.operands).to(x.device),
                torch.zeros((n * blocks, enc.ops.shape[1], 4),
                            dtype=torch.int64, device=x.device))
        blocks, scratch, group_flags, flags, epochs, ops, opnds, stamps = st
        x = x.contiguous()
        if enc.writes_input:
            x = x.clone()
        out = torch.empty((n, n_out * rows, cols), dtype=x.dtype,
                          device=x.device)
        table = self._buffer_table([x, out] + scratch, cols, n,
                                   x.element_size())
        rc = lib.dsl_executor_launch_traced(
            table, _DTYPE_CODES[x.dtype], n, 1, 1, ops.data_ptr(),
            ops.shape[1], opnds.data_ptr(), opnds.shape[1], flags.data_ptr(),
            enc.n_flags, group_flags, epochs.data_ptr(), rows * cols, blocks,
            THREADS, stamps.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise KernelLaunchError(
                f"traced dsl_executor launch failed for {p.name!r} (n={n}): "
                f"{lib.dsl_executor_error_string(rc).decode()}")
        CudaExecutor.traced_launches += 1
        return out, stamps

    @staticmethod
    def _buffer_table(tensors, cols: int, ranks: int, esize: int):
        """The kernel's [buffer][rank] table of base pointers."""
        table = (ctypes.c_void_p * (MAX_BUFFERS * MAX_RANKS))()
        for b, t in enumerate(tensors):
            step = (t.shape[1] * cols) * esize            # one rank's buffer
            base = t.data_ptr()
            for r in range(ranks):
                table[b * MAX_RANKS + r] = base + r * step
        return table

    def _launch(self, x: torch.Tensor, groups: int = 1,
                stride: int = 1) -> torch.Tensor:
        enc = self.encoded
        if enc is None:
            raise KernelLaunchError("CudaExecutor called before prepare(n)")
        p = self.program
        if x.dim() != 3 or x.shape[0] != groups * enc.n:
            raise ValueError(f"expected ({groups} * {enc.n}, rows, cols), "
                             f"got {tuple(x.shape)}")
        if stride < 1 or groups % stride:
            raise ValueError(f"{groups} groups at stride {stride}: the group "
                             f"count must be a multiple of the stride")
        n = enc.n
        total, cols = x.shape[1], x.shape[2]
        n_in, n_out = p.chunks[p.in_buffer], p.chunks[p.out_buffer]
        if total % n_in:
            raise ValueError(f"{total} rows do not divide into the {n_in} "
                             f"input chunks of {p.name!r}")
        rows = total // n_in
        key = (rows, cols, x.dtype, x.device, groups)
        if key in self._bindings:
            self._bound = self._bindings[key]
        else:
            self._bind(rows, cols, x.dtype, x.device, groups)
        if self._bound[5] is None:               # released: scratch anew
            self._bound = self._bindings[key] = self._bound[:5] + (
                self._scratch(rows, cols, x.dtype, x.device, groups),) \
                + self._bound[6:]
        capturing = _capturing()
        scope = getattr(_SCOPE, "scope", None) if capturing else None
        if capturing and key not in self._captured:
            self._captured.add(key)
            if scope is not None:
                scope.marks.append((self, key))
        (_, _, dtype, device, _, scratch, flags, group_flags, ops,
         opnds, blocks, epochs) = self._bound
        x = x.contiguous()
        if enc.writes_input:
            x = x.clone()
        out = torch.empty((groups * n, n_out * rows, cols), dtype=dtype,
                          device=device)

        chunk_elems = rows * cols
        table = self._buffer_table([x, out] + scratch, cols, groups * n,
                                   x.element_size())
        from repro_torch.kernels import build
        lib = build.executor_library()
        rc = lib.dsl_executor_launch(
            table, _DTYPE_CODES[dtype], n, groups, stride, ops.data_ptr(),
            ops.shape[1], opnds.data_ptr(), opnds.shape[1], flags.data_ptr(),
            enc.n_flags, group_flags, epochs.data_ptr(), chunk_elems, blocks,
            THREADS, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise KernelLaunchError(
                f"dsl_executor launch failed for {p.name!r} (n={n}, "
                f"groups={groups}): "
                f"{lib.dsl_executor_error_string(rc).decode()}")
        CudaExecutor.launches += 1
        if scope is not None:
            scope.launches += 1
        return out


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> tuple[int, int, int]:
    """(executor kernel nodes, of them cooperative, traced kernel nodes)
    of a captured graph kept with ``keep_graph=True``: what the capture
    recorded of the executor's launches, read back from the graph itself.
    The first two count the untraced kernel, which plans replay; the
    third the traced one, which a capture should never hold."""
    from repro_torch.kernels import build
    lib = build.executor_library()
    nodes, coop, traced = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.dsl_executor_graph_nodes(graph.raw_cuda_graph(),
                                      ctypes.byref(nodes), ctypes.byref(coop),
                                      ctypes.byref(traced))
    if rc != 0:
        raise RuntimeError(f"reading the graph's nodes failed: "
                           f"{lib.dsl_executor_error_string(rc).decode()}")
    return nodes.value, coop.value, traced.value


_TIMERS: Dict[Any, dict] = {}


def device_timer(device=None) -> dict:
    """The card's timers, probed once a device: ``tick_ns``, the least
    step of ``%globaltimer`` between two readings, and
    ``cycles_per_ns``, the SM clock (``clock64()`` cycles over 2 ms of
    ``%globaltimer``)."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    info = _TIMERS.get(device)
    if info is None:
        from repro_torch.kernels import build
        lib = build.executor_library()
        out = torch.zeros(4, dtype=torch.int64, device=device)
        rc = lib.dsl_executor_timer_probe(
            2_000_000, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"timer probe failed: "
                               f"{lib.dsl_executor_error_string(rc).decode()}")
        tick, span_ns, cycles, changes = (int(v) for v in out.tolist())
        if changes < 1 or span_ns <= 0:
            raise RuntimeError(f"%globaltimer did not advance over the "
                               f"probe ({out.tolist()})")
        info = _TIMERS[device] = dict(tick_ns=tick, cycles_per_ns=cycles
                                      / span_ns, probe_ns=span_ns,
                                      changes=changes)
    return info


def execute(program: Program, x: torch.Tensor, *,
            backend: Optional[str] = None,
            opt_level: Optional[int] = None) -> torch.Tensor:
    """Run a DSL program on a rank-stacked ``(n, rows, cols)`` payload,
    with the kernel for a CUDA tensor and the plain version for a CPU one
    unless ``backend`` says otherwise.

    ``opt_level``: when given, the program first runs through
    ``passes.optimize``; level 0 also selects the reference (per-chunk)
    torch lowering."""
    n = x.shape[0]
    backend = backend or ("cuda" if x.is_cuda else "torch")
    if opt_level is not None:
        from repro_torch.core import passes
        program = passes.optimize(program, opt_level, n)
    if backend == "torch":
        vectorize = opt_level is None or opt_level > 0
        return TorchExecutor(program, vectorize=vectorize).prepare(n)(x)
    if backend == "cuda":
        return CudaExecutor(program).prepare(n)(x)
    raise ValueError(f"unknown backend {backend!r}")
