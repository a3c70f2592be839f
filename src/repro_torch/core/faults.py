"""Seeded fault injection — prove the verifier and the guardrails catch
what they claim (port of ``repro.core.faults``).

Two injection surfaces, one :class:`FaultSpec`:

* **Static** faults mutate a :class:`~repro_torch.core.dsl.Program`
  (:func:`inject_program`) the way a buggy optimizer pass would —
  drop/duplicate/delay a put, skip a wait, retarget a chunk — and must
  be rejected by :mod:`repro_torch.core.verify` before lowering. The
  mutation is the reference's, choice for choice: the same spec on the
  same program gives the same ``dsl.program_to_dict``.
* **Runtime** faults fire inside the executors' ``__call__`` (the hook
  both ``TorchExecutor`` and ``CudaExecutor`` consult, one
  :func:`active` read a call): raise a transient failure, stall the
  caller, or poison the payload. These must be detected and recovered
  by the engine's and the scheduler's guardrails — retry with backoff,
  watchdog timeout, numeric guard, explicit→auto fallback
  (:mod:`repro_torch.serve.engine`).

Where the hook fires: the reference's executors consult it at trace
time. The port's trace time is the CUDA-graph capture: on the card
Python runs only in a step's warm-ups, its capture and an eager fused
prefill step, never in a replay, so a replay pays nothing and a fault
installed after the capture never fires in it. The capture's warm-ups
run with the hook suspended (:func:`suspended`), so a fault fires into
the captured graph (a poisoned payload is then poisoned at every
replay, as a poisoned trace is in the reference). On the CPU every step
runs eagerly and every executor call consults the hook.

Injection is process-global and off by default (``active()`` is None).
Use the context manager::

    with faults.inject(faults.FaultSpec("fail_call", count=1)):
        eng.decode(logits, num_tokens=4)    # first step retried
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import List, Optional

import torch

from repro_torch.core.dsl import Instr, Op, Program, Round

__all__ = [
    "FaultSpec", "FaultInjected", "FaultInjector",
    "STATIC_KINDS", "RUNTIME_KINDS", "ALL_KINDS",
    "inject_program", "install", "clear", "active", "inject",
]

#: program mutations a buggy pass could emit — caught statically
STATIC_KINDS = ("drop_put", "dup_put", "delay_put", "skip_wait",
                "retarget_put")
#: execution-time faults — detected/recovered by the runtime guardrails
RUNTIME_KINDS = ("fail_call", "stall_rank", "corrupt_chunk")
ALL_KINDS = STATIC_KINDS + RUNTIME_KINDS


class FaultInjected(RuntimeError):
    """The injected transient executor failure (``fail_call``)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One seeded fault. ``kind`` picks the class; ``seed`` makes the
    target choice reproducible; ``count`` bounds runtime firings (a
    transient fault fires ``count`` times, then the fault clears);
    ``delay_s`` is the ``stall_rank`` sleep."""

    kind: str
    seed: int = 0
    count: int = 1
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{ALL_KINDS}")


# --------------------------------------------------------------------------
# static faults: Program -> mutated Program
# --------------------------------------------------------------------------
def _rebuild(program: Program, rounds: List[List[Instr]]) -> Program:
    out = Program(program.name + "+fault", dict(program.chunks),
                  in_buffer=program.in_buffer,
                  out_buffer=program.out_buffer)
    out.rounds = []
    for instrs in rounds:
        if not instrs:
            continue
        r = Round()
        for i in instrs:
            i.round_id = len(out.rounds)
            r.instrs.append(i)
        out.rounds.append(r)
    return out.freeze()


def _positions(rounds: List[List[Instr]], op: Op):
    return [(ri, ii) for ri, instrs in enumerate(rounds)
            for ii, i in enumerate(instrs) if i.op is op]


def inject_program(program: Program, spec: FaultSpec,
                   num_ranks: int) -> Program:
    """Apply one static fault to a copy of ``program``. The mutation
    mimics a pass bug: the result is a structurally plausible Program
    that the verifier must reject. Raises ValueError for runtime-only
    kinds or when the program has no instruction of the needed op."""
    if spec.kind not in STATIC_KINDS:
        raise ValueError(
            f"{spec.kind!r} is a runtime fault; install it with "
            f"faults.inject(...) instead of mutating the program")
    rng = random.Random(spec.seed)
    rounds = [[dataclasses.replace(i) for i in r.instrs]
              for r in program.rounds]
    want = Op.WAIT if spec.kind == "skip_wait" else Op.PUT
    pos = _positions(rounds, want)
    if not pos:
        raise ValueError(
            f"program {program.name!r} has no {want.value} instruction "
            f"to inject {spec.kind!r} into")
    ri, ii = pos[rng.randrange(len(pos))]
    instr = rounds[ri][ii]

    if spec.kind == "drop_put":
        if instr.dsts and len(instr.dsts) > 1:
            k = rng.randrange(len(instr.dsts))
            tos = instr.tos if instr.tos else (instr.to,) * len(instr.dsts)
            keep = [j for j in range(len(instr.dsts)) if j != k]
            rounds[ri][ii] = dataclasses.replace(
                instr,
                srcs=tuple(instr.srcs[j] for j in keep),
                dsts=tuple(instr.dsts[j] for j in keep),
                tos=tuple(tos[j] for j in keep))
        else:
            del rounds[ri][ii]
    elif spec.kind == "dup_put":
        rounds[ri].insert(ii + 1, dataclasses.replace(instr))
    elif spec.kind == "delay_put":
        # move the put past its wait — the sync inversion a reordering
        # pass bug would produce
        del rounds[ri][ii]
        rounds.append([instr])
    elif spec.kind == "skip_wait":
        if instr.dsts and len(instr.dsts) > 1:
            k = rng.randrange(len(instr.dsts))
            keep = [j for j in range(len(instr.dsts)) if j != k]
            rounds[ri][ii] = dataclasses.replace(
                instr,
                dsts=tuple(instr.dsts[j] for j in keep),
                frms=tuple(instr.frms[j] for j in keep))
        else:
            del rounds[ri][ii]
    elif spec.kind == "retarget_put":
        # corrupt a chunk index: the put lands one chunk over
        def bump(chunk):
            b, e = chunk
            return (b, dataclasses.replace(e, offset=e.offset + 1))
        if instr.dsts:
            k = rng.randrange(len(instr.dsts))
            dsts = list(instr.dsts)
            dsts[k] = bump(dsts[k])
            rounds[ri][ii] = dataclasses.replace(instr, dsts=tuple(dsts))
        else:
            rounds[ri][ii] = dataclasses.replace(instr,
                                                 dst=bump(instr.dst))
    return _rebuild(program, rounds)


# --------------------------------------------------------------------------
# runtime faults: executor-entry hook
# --------------------------------------------------------------------------
class FaultInjector:
    """Runtime injector for one :class:`FaultSpec`. ``on_execute`` is
    called by both executors at the top of ``__call__`` with the
    rank-stacked ``(n, rows, cols)`` payload; it fires at most
    ``spec.count`` times, then passes through. ``fired`` counts actual
    firings (chaos-test assertion hook)."""

    def __init__(self, spec: FaultSpec):
        if spec.kind not in RUNTIME_KINDS:
            raise ValueError(
                f"{spec.kind!r} is a static fault; apply it with "
                f"inject_program(...) instead of installing a hook")
        self.spec = spec
        self.remaining = spec.count
        self.fired = 0

    def _fire(self) -> bool:
        if self.remaining <= 0:
            return False
        self.remaining -= 1
        self.fired += 1
        return True

    def on_execute(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the executor should run it: a ``corrupt_chunk``
        firing returns a copy with row 0 of every rank's payload set to
        NaN (``iinfo.max`` for an integer dtype) — the reference's
        ``x.at[0]`` on each device's local shard — and leaves ``x`` as
        it was."""
        kind = self.spec.kind
        if kind == "fail_call" and self._fire():
            raise FaultInjected(
                f"injected transient executor failure "
                f"(seed={self.spec.seed})")
        if kind == "stall_rank" and self._fire():
            time.sleep(self.spec.delay_s or 1.0)
        elif kind == "corrupt_chunk" and self._fire():
            bad = (float("nan") if x.is_floating_point()
                   else torch.iinfo(x.dtype).max)
            x = x.clone()
            x[:, 0] = bad
        return x


_ACTIVE: Optional[FaultInjector] = None


def install(spec: FaultSpec) -> FaultInjector:
    """Install (replacing any previous) the process-global injector."""
    global _ACTIVE
    _ACTIVE = FaultInjector(spec)
    return _ACTIVE


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def inject(spec: FaultSpec):
    """Scoped installation: the injector is cleared on exit even when
    the faulted code raises."""
    inj = install(spec)
    try:
        yield inj
    finally:
        clear()


@contextlib.contextmanager
def suspended():
    """No fault fires inside (a capture's warm-up steps: the capture is
    the port's trace time); the installed injector, if any, is back on
    exit unless another was installed meanwhile."""
    global _ACTIVE
    held, _ACTIVE = _ACTIVE, None
    try:
        yield
    finally:
        if _ACTIVE is None:
            _ACTIVE = held
