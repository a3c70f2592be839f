"""Communicator + ExecutionPlan — compile once, execute many (port of
``repro.core.comm``).

* :class:`Communicator` — owns an axis (its size ``n`` and device), a
  :class:`~.selector.LinkModel`, default backend / ``opt_level`` and a
  **plan cache** keyed by ``(collective, shape, dtype, n, backend, algo,
  opt_level, link[, root])``.
* :class:`ExecutionPlan` — a frozen artifact bundling the
  post-optimizer program, the chosen algorithm, the prepared executor
  (with its device state allocated), pad metadata and its cost card.
  Serializable with ``to_json`` / ``from_json``.
* :class:`BucketedPlan` — one plan per row-count bucket, padded at
  dispatch (``"rows"`` for all_reduce/broadcast, ``"tiled"`` for
  all_gather, ``"blocks"`` for all_to_all/reduce_scatter, whose buckets
  count rows per per-rank block — the MoE capacity buckets).
* :class:`HierarchicalCommunicator` / :class:`HierarchicalPlan` — the
  2PH AllReduce over a node × local rank grid (paper §4.4-2PH): three
  per-axis plans RS(local) → AR(node) → AG(local), or one flat plan when
  there is one node.

A plan takes and returns rank-stacked tensors: ``x`` is ``(n, rows,
cols)`` and ``x[r]`` is rank ``r``'s payload. A plan compiled with
``groups``/``stride`` runs over ``groups`` groups of ``n`` ranks of a
``(groups * n, rows, cols)`` tensor (the group view of
:mod:`~.executor`); a hierarchical plan takes the grid node-major,
``(nn * L, rows, cols)`` with rank ``node * L + local``
(:mod:`repro_torch.mesh`): its local phases run ``nn`` groups of L
contiguous ranks, its node phase L groups of nn ranks at stride L, one
kernel launch each.

Backends: ``"torch"`` is the plain version (:class:`~.executor.
TorchExecutor`) on any device; ``"cuda"`` is the hand-written kernel
(:class:`~.executor.CudaExecutor`) for CUDA tensors only.
:func:`default_backend` picks ``"cuda"`` on the card and ``"torch"`` on
the CPU. ``"torch_native"`` is the baseline the collectives are measured
against, the counterpart of the reference's ``"xla_native"``: one plain
PyTorch call a collective (``x.sum(0)`` expanded, a reshape, a
transpose), no plan.

:func:`default_communicator` keeps one process-default communicator an
axis name (what :mod:`repro_torch.core.api` calls through). It is made
without ``n``: it takes the axis size from each payload's leading
dimension and the device from the payload, so it serves any ``n`` on any
device, and a tuning table or link installed on it retunes every size. Plans exported by the reference (``repro.core.comm.
export_plan_set``) load here: the file's ``"xla"``/``"pallas"``
backend is ignored and each plan is re-prepared for this device.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core import algorithms as algos
from repro_torch.core import passes
from repro_torch.core import selector as sel
from repro_torch.core import verify as verify_mod
from repro_torch.core.dsl import Program, program_from_dict, program_to_dict
from repro_torch.core.executor import CudaExecutor, TorchExecutor, _capturing
from repro_torch.mesh import DeviceLike, RankGrid, resolve_device

__all__ = ["Communicator", "ExecutionPlan", "BucketedPlan",
           "HierarchicalPlan", "HierarchicalCommunicator",
           "hierarchical_all_reduce", "hierarchical_plan", "default_backend",
           "plan_from_json", "export_plan_set", "load_plan_set",
           "default_communicator", "reset_default_communicators",
           "PLAN_FORMAT_VERSION",
           "BACKENDS", "NATIVE"]

PLAN_FORMAT_VERSION = 1
BACKENDS = ("torch", "cuda")
#: the one-call PyTorch baseline of the collectives (no plan)
NATIVE = "torch_native"
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "broadcast")

#: collectives whose output keeps the caller's row count, so rows that
#: don't divide the chunk grid can be padded and sliced back
_PADDABLE = frozenset({"all_reduce", "broadcast"})

#: per-family padding for ``plan_for(..., buckets=)``: ``"rows"`` pads
#: the payload tail and slices the output tail; ``"tiled"`` (all_gather)
#: slices the padding out of every rank's block of the gathered output;
#: ``"blocks"`` (the row-redistributing families, whose ``(n*rows, cols)``
#: payload is n per-rank row blocks) counts buckets in rows per block and
#: pads each block on its own, so the block boundaries the algorithm
#: routes on stay aligned — all_to_all slices the padding out of every
#: received block, reduce_scatter off its reduced block's tail.
_BUCKET_PAD = {"all_reduce": "rows", "broadcast": "rows",
               "all_gather": "tiled", "all_to_all": "blocks",
               "reduce_scatter": "blocks"}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = str(getattr(dtype, "name", dtype))
    if name not in _DTYPES:
        raise ValueError(f"unsupported plan dtype {dtype!r}; expected one "
                         f"of {sorted(_DTYPES)}")
    return name


def default_backend(device: DeviceLike = None) -> str:
    """``"cuda"`` for a CUDA device, ``"torch"`` for the CPU."""
    return "cuda" if resolve_device(device).type == "cuda" else "torch"


def _check_version(d: dict, what: str) -> None:
    if d.get("version") is None and d.get("format") is None:
        raise ValueError(f"{what} payload has no schema 'version' field "
                         f"(keys: {sorted(d)[:8]}): not a plan file")
    for k in ("version", "format"):
        v = d.get(k)
        if v is not None and v != PLAN_FORMAT_VERSION:
            raise ValueError(f"unsupported plan format version {v!r} "
                             f"(field {k!r}); this build reads version "
                             f"{PLAN_FORMAT_VERSION}")


def _field(d: dict, key: str, what: str):
    try:
        return d[key]
    except KeyError:
        raise ValueError(f"{what} payload missing required field {key!r} "
                         f"(has {sorted(d)}): the plan file is truncated or "
                         f"corrupted") from None


def _build_executor(program: Program, backend: str, opt_level: int, n: int,
                    shape: Tuple[int, int], dtype: str, device: torch.device,
                    groups: int = 1):
    """The prepared executor; the kernel's device state (instruction
    table, flags, scratch — for ``groups`` groups of ``n`` ranks) is
    allocated here, at plan-build time."""
    if backend == "cuda":
        if device.type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got "
                             f"{device}; use backend='torch' on the CPU")
        n_in = program.chunks[program.in_buffer]
        return CudaExecutor(program).prepare(n).bind(
            shape[0] // n_in, shape[1], _DTYPES[dtype], device,
            groups=groups)
    if backend == "torch":
        return TorchExecutor(program, vectorize=opt_level > 0).prepare(n)
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class ExecutionPlan:
    """A compiled, frozen, executable collective. ``shape`` is one
    rank's ``(rows, cols)`` payload; ``pad`` rows are appended before
    execution and sliced off after (paddable collectives only).
    ``groups``/``stride`` are the replay geometry: the plan runs over
    ``groups`` groups of ``n`` ranks of a ``(groups * n, rows, cols)``
    payload (:func:`repro_torch.mesh.group_ranks`); they are not part of
    the plan file, whose reader chooses them."""

    collective: str
    algo: str
    axis: str
    n: int
    shape: Tuple[int, int]
    dtype: str
    backend: str
    opt_level: int
    requested_opt_level: int
    root: Optional[int]
    pad: int
    link: sel.LinkModel
    estimate_us: float
    comm_stats: Dict[str, int]
    program: Program
    executor: Any
    device: torch.device
    groups: int = 1
    stride: int = 1
    #: record a per-instruction timeline (:mod:`~.trace`) at the first
    #: call outside a CUDA-graph capture (:attr:`last_trace`); replays,
    #: graph replays among them, record nothing more
    trace: bool = False
    _trace_box: list = dataclasses.field(default_factory=list)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Replay on a rank-stacked ``(groups * n, rows, cols)`` payload:
        no selection, no passes, no executor preparation. A payload that
        already holds the ``pad`` rows (zeros) after its own is taken as
        it is, without a padded copy."""
        ranks = self.groups * self.n
        padded = bool(self.pad) and tuple(x.shape) == (
            ranks, self.shape[0] + self.pad, self.shape[1])
        if tuple(x.shape) != (ranks,) + tuple(self.shape) and not padded:
            raise ValueError(f"plan compiled for ({ranks},) + {self.shape}, "
                             f"got {tuple(x.shape)}")
        if x.dtype != _DTYPES[self.dtype]:
            raise ValueError(f"plan compiled for dtype {self.dtype}, got "
                             f"{x.dtype}")
        if self.trace and not self._trace_box and not _capturing():
            self.capture_trace(x)
        if self.pad and not padded:
            x = F.pad(x, (0, 0, 0, self.pad))
        out = self.executor(x, groups=self.groups, stride=self.stride)
        if self.pad:
            out = out[:, : self.shape[0]]
        return out

    def release(self) -> None:
        """Give the kernel's scratch of every shape no CUDA graph captured
        back to the allocator (:meth:`CudaExecutor.release`); the next
        call allocates it again. The plain executor holds none."""
        if isinstance(self.executor, CudaExecutor):
            self.executor.release()

    def capture_trace(self, x: Optional[torch.Tensor] = None):
        """Record (and return) this plan's timeline: on the card its
        traced kernel on a copy of ``x`` (default: seeded random data),
        on the CPU the host emulation (:func:`~.trace.capture_plan`)."""
        from repro_torch.core import trace as trace_mod
        tr = trace_mod.capture_plan(self, x)
        self._trace_box[:] = [tr]
        return tr

    @property
    def last_trace(self):
        """The latest :class:`~.trace.Trace` of this plan (None before
        one was recorded)."""
        return self._trace_box[-1] if self._trace_box else None

    def cost_card(self) -> dict:
        return dict(collective=self.collective, algo=self.algo, n=self.n,
                    shape=tuple(self.shape), dtype=self.dtype,
                    backend=self.backend, opt_level=self.opt_level,
                    estimate_us=round(self.estimate_us, 3),
                    **self.comm_stats)

    def __repr__(self):
        return (f"ExecutionPlan({self.collective}/{self.algo} n={self.n} "
                f"shape={tuple(self.shape)} dtype={self.dtype} "
                f"backend={self.backend} O{self.opt_level} "
                f"est={self.estimate_us:.2f}us)")

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return dict(
            version=PLAN_FORMAT_VERSION, format=PLAN_FORMAT_VERSION,
            collective=self.collective, algo=self.algo, axis=self.axis,
            n=self.n, shape=list(self.shape), dtype=self.dtype,
            backend=self.backend, opt_level=self.opt_level,
            requested_opt_level=self.requested_opt_level,
            root=self.root, pad=self.pad,
            link=dict(alpha_us=self.link.alpha_us,
                      beta_GBps=self.link.beta_GBps,
                      torus=self.link.torus, sync_us=self.link.sync_us),
            estimate_us=self.estimate_us,
            comm_stats=dict(self.comm_stats),
            program=program_to_dict(self.program),
        )

    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("indent", 2)
        json_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_dict(cls, d: dict, *, device: DeviceLike = None,
                  backend: Optional[str] = None, verify: str = "strict",
                  groups: int = 1, stride: int = 1) -> "ExecutionPlan":
        """Rebuild a plan: the program is reconstructed, verified, and
        prepared for ``device`` with ``backend`` (default: the device's
        backend — the file's own backend is not used), to replay over
        ``groups`` groups at ``stride``."""
        _check_version(d, "ExecutionPlan")
        if d.get("kind") == "bucketed_plan":
            raise ValueError("bucketed plan payload; use "
                             "BucketedPlan.from_json")
        req = lambda k: _field(d, k, "ExecutionPlan")  # noqa: E731
        device = resolve_device(device)
        backend = backend or default_backend(device)
        program = program_from_dict(req("program"))
        collective, n, root = req("collective"), req("n"), req("root")
        verify_mod.check(program, n, mode=verify, collective=collective,
                         root=0 if root is None else root)
        try:
            link = sel.LinkModel(**req("link"))
        except TypeError as e:
            raise ValueError(f"ExecutionPlan payload has a malformed 'link' "
                             f"field ({e})") from None
        shape = tuple(req("shape"))
        dtype = _dtype_name(req("dtype"))
        pad = req("pad")
        executor = _build_executor(program, backend, req("opt_level"), n,
                                   (shape[0] + pad, shape[1]), dtype, device,
                                   groups=groups)
        return cls(
            collective=collective, algo=req("algo"), axis=req("axis"), n=n,
            shape=shape, dtype=dtype, backend=backend,
            opt_level=req("opt_level"),
            requested_opt_level=req("requested_opt_level"), root=root,
            pad=pad, link=link, estimate_us=req("estimate_us"),
            comm_stats=dict(req("comm_stats")), program=program,
            executor=executor, device=device, groups=groups, stride=stride)

    @classmethod
    def from_json(cls, s: str, **kw) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s), **kw)


@dataclasses.dataclass(eq=False, repr=False)
class BucketedPlan:
    """A family of :class:`ExecutionPlan` s over row-count buckets:
    ``__call__`` routes a payload to the smallest bucket that fits,
    zero-pads it, replays that bucket's plan and slices the result back.
    ``hits`` counts dispatches per bucket."""

    collective: str
    axis: str
    n: int
    cols: int
    dtype: str
    buckets: Tuple[int, ...]
    plans: Dict[int, ExecutionPlan]
    hits: Dict[int, int]
    pad_strategy: str = "rows"

    def bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        unit = ("rows per per-rank block" if self.pad_strategy == "blocks"
                else "rows")
        raise ValueError(
            f"{self.collective} payload of {rows} {unit} exceeds the largest "
            f"bucket of {self!r}; recompile with plan_for(..., buckets=(*"
            f"{list(self.buckets)}, {rows}))")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_strategy == "blocks":
            return self._call_blocks(x)
        rows = int(x.shape[1])
        b = self.bucket_for(rows)
        self.hits[b] += 1
        plan = self.plans[b]
        if rows == b:
            return plan(x)
        out = plan(F.pad(x, (0, 0, 0, b - rows)))
        if self.pad_strategy == "tiled":
            # tiled output: slice the padding out of every rank's block
            return out.reshape(self.n, self.n, b, -1)[:, :, :rows].reshape(
                self.n, self.n * rows, out.shape[-1])
        return out[:, :rows]

    def _call_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` is ``(n, n*rows, cols)``: every rank's payload is n
        per-rank blocks of ``rows``. Each block pads to the bucket, the
        bucket's plan replays, and the padding is sliced back out."""
        n, total, cols = x.shape
        if total % self.n:
            raise ValueError(
                f"{self.collective} payload rows={total} not divisible by "
                f"the {self.n} per-rank blocks of {self!r}")
        rows = total // self.n
        b = self.bucket_for(rows)
        self.hits[b] += 1
        plan = self.plans[b]
        if rows == b:
            return plan(x)
        xp = F.pad(x.reshape(n, self.n, rows, cols), (0, 0, 0, b - rows))
        out = plan(xp.reshape(n, self.n * b, cols))
        if self.collective == "reduce_scatter":
            # (n, b, cols) reduced blocks: padded rows summed zeros
            return out[:, :rows]
        # all_to_all: slice the padding out of every received block
        return out.reshape(n, self.n, b, cols)[:, :, :rows].reshape(
            n, self.n * rows, cols)

    @property
    def last_trace(self):
        """The largest bucket's latest trace (None before one)."""
        return self.plans[self.buckets[-1]].last_trace

    def last_traces(self) -> Dict[int, Any]:
        """bucket -> that bucket's latest trace (or None)."""
        return {b: self.plans[b].last_trace for b in self.buckets}

    def cost_cards(self) -> Dict[int, dict]:
        return {b: self.plans[b].cost_card() for b in self.buckets}

    def report(self) -> dict:
        return dict(collective=self.collective, buckets=list(self.buckets),
                    pad_strategy=self.pad_strategy,
                    cards=self.cost_cards(), hits=dict(self.hits))

    def __repr__(self):
        return (f"BucketedPlan({self.collective}/{self.pad_strategy} "
                f"n={self.n} cols={self.cols} dtype={self.dtype} "
                f"buckets={list(self.buckets)} hits={dict(self.hits)})")

    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("indent", 2)
        json_kw.setdefault("sort_keys", True)
        return json.dumps(dict(
            version=PLAN_FORMAT_VERSION, format=PLAN_FORMAT_VERSION,
            kind="bucketed_plan", collective=self.collective,
            axis=self.axis, n=self.n, cols=self.cols, dtype=self.dtype,
            buckets=list(self.buckets), pad_strategy=self.pad_strategy,
            hits={str(b): h for b, h in self.hits.items()},
            plans={str(b): self.plans[b].to_dict() for b in self.buckets},
        ), **json_kw)

    @classmethod
    def from_json(cls, s: str, **kw) -> "BucketedPlan":
        d = json.loads(s)
        _check_version(d, "BucketedPlan")
        if d.get("kind") != "bucketed_plan":
            raise ValueError(f"not a bucketed plan payload "
                             f"(kind={d.get('kind')!r})")
        if d.get("pad_strategy") not in ("rows", "tiled", "blocks"):
            raise ValueError(f"unknown pad_strategy "
                             f"{d.get('pad_strategy')!r}; expected 'rows', "
                             f"'tiled' or 'blocks'")
        req = lambda k: _field(d, k, "BucketedPlan")  # noqa: E731
        buckets = tuple(int(b) for b in req("buckets"))
        payload = req("plans")
        missing = [b for b in buckets if str(b) not in payload]
        if missing:
            raise ValueError(f"bucketed plan payload missing buckets "
                             f"{missing} (has {sorted(payload)})")
        plans = {b: ExecutionPlan.from_dict(payload[str(b)], **kw)
                 for b in buckets}
        return cls(collective=req("collective"), axis=req("axis"),
                   n=req("n"), cols=req("cols"),
                   dtype=_dtype_name(req("dtype")), buckets=buckets,
                   plans=plans,
                   hits={b: int(d.get("hits", {}).get(str(b), 0))
                         for b in buckets},
                   pad_strategy=d["pad_strategy"])


class Communicator:
    """Init-once planning object for one rank axis of ``n`` ranks on
    ``device`` (``None``: the CUDA card, raising where there is none).

    Made without ``n`` (a process default, :func:`default_communicator`)
    it takes ``n`` and the device from each payload: ``x.shape[0]`` and
    ``x.device`` in the collectives, ``n=``/``device=`` in
    :meth:`compile`. ``table`` overrides the selector where it has an
    entry (:class:`~.selector.TuningTable`); ``trace=True`` makes every
    plan record its timeline at its first call (:mod:`~.trace`)."""

    def __init__(self, axis: str, *, n: Optional[int] = None,
                 device: DeviceLike = None,
                 link: sel.LinkModel = sel.UNFITTED,
                 table: Optional[sel.TuningTable] = None,
                 backend: Optional[str] = None,
                 opt_level: Optional[int] = None,
                 verify: str = "strict", trace: bool = False):
        if verify not in verify_mod.MODES:
            raise ValueError(f"verify must be one of {verify_mod.MODES}, "
                             f"got {verify!r}")
        self.axis = axis
        self.n = None if n is None else int(n)
        if n is None:             # per payload, unless given
            self.device = None if device is None else resolve_device(device)
            self.backend = backend
        else:
            self.device = resolve_device(device)
            self.backend = backend or default_backend(self.device)
        if self.backend not in BACKENDS + (NATIVE, None):
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS + (NATIVE,)}")
        self.link = link
        self.table = table
        self.opt_level = opt_level
        self.verify = verify
        self.trace = trace
        self._plans: Dict[tuple, ExecutionPlan] = {}
        self._bucketed: Dict[tuple, BucketedPlan] = {}
        self.stats = {"compiles": 0, "hits": 0}
        #: compile-side counters surfaced through Engine.plan_report
        self.health = {"verified": 0, "verify_failures": 0, "recompiles": 0}

    # -- configuration -------------------------------------------------------
    def set_tuning_table(self, table: Optional[sel.TuningTable]) -> None:
        """Install (or clear) a tuning table. Both plan caches are
        cleared: a cached algorithm choice may no longer apply."""
        self.table = table
        self._plans.clear()
        self._bucketed.clear()

    def load_bench_tuning(self, payload, *, fit_link: bool = True) -> None:
        """Install tuning from a ``BENCH_collectives.json`` payload (a
        path or the parsed dict): its measured-fastest
        :class:`~.selector.TuningTable` and, with ``fit_link``, α and β
        fitted from its wall times (:func:`~.selector.fit_link_model`)."""
        if not isinstance(payload, dict):
            with open(payload) as f:
                payload = json.load(f)
        if fit_link:
            self.link = sel.fit_link_model(payload, base=self.link)
        self.set_tuning_table(sel.TuningTable.from_bench(payload))

    def _level(self, opt_level: Optional[int]) -> int:
        lvl = self.opt_level if opt_level is None else opt_level
        return passes.DEFAULT_OPT_LEVEL if lvl is None else lvl

    def _where(self, n: Optional[int], device: DeviceLike):
        """(n, device) of a compile: the arguments, else the
        communicator's own."""
        n = self.n if n is None else int(n)
        if n is None:
            raise ValueError(f"communicator {self.axis!r} has no axis size: "
                             f"pass n= (a collective takes it from the "
                             f"payload)")
        if device is None:
            device = self.device
        return n, resolve_device(device)

    def compile(self, collective: str, shape, dtype, *,
                algo: Optional[str] = None, backend: Optional[str] = None,
                opt_level: Optional[int] = None, root: int = 0,
                link: Optional[sel.LinkModel] = None, groups: int = 1,
                stride: int = 1, n: Optional[int] = None,
                device: DeviceLike = None) -> ExecutionPlan:
        """Compile (or fetch from cache) the plan for one collective on a
        per-rank ``(rows, cols)`` payload of ``dtype``, replayed over
        ``groups`` groups of ``n`` ranks at ``stride`` (default: the
        axis alone). ``n``/``device`` default to the communicator's."""
        n, device = self._where(n, device)
        backend = backend or self.backend or default_backend(device)
        if backend not in BACKENDS:
            raise ValueError(f"plans run on a DSL backend {BACKENDS}, got "
                             f"{backend!r}")
        if collective not in COLLECTIVES:
            raise ValueError(f"unknown collective {collective!r}")
        if groups < 1 or stride < 1 or groups % stride:
            raise ValueError(f"{groups} groups at stride {stride}: the group "
                             f"count must be a positive multiple of the "
                             f"stride")
        link = link or self.link
        level_req = self._level(opt_level)
        rows, cols = int(shape[0]), int(shape[1])
        dtype = _dtype_name(dtype)
        key = (collective, (rows, cols), dtype, n, backend, algo,
               level_req, link, root if collective == "broadcast" else None,
               groups, stride, device)
        plan = self._plans.get(key)
        if plan is not None:
            self.stats["hits"] += 1
            return plan
        plan = self._build(collective, rows, cols, dtype, backend, algo,
                           level_req, root, link, n, device, groups, stride)
        self._plans[key] = plan
        self.stats["compiles"] += 1
        return plan

    def plan_for(self, collective: str, shape, dtype, *, buckets=None,
                 algo: Optional[str] = None, backend: Optional[str] = None,
                 opt_level: Optional[int] = None, root: int = 0,
                 link: Optional[sel.LinkModel] = None,
                 n: Optional[int] = None, device: DeviceLike = None):
        """:meth:`compile`, or with ``buckets=(b1, b2, ...)`` one plan per
        bucket behind a :class:`BucketedPlan` (itself cached). Buckets
        count payload rows, except for the ``"blocks"`` families
        (all_to_all, reduce_scatter): there ``shape`` is the full
        ``(n * rows, cols)`` payload and buckets count rows per per-rank
        block (for MoE, the per-rank token capacity)."""
        kw = dict(algo=algo, backend=backend, opt_level=opt_level,
                  root=root, link=link, n=n, device=device)
        if buckets is None:
            return self.compile(collective, shape, dtype, **kw)
        n, device = self._where(n, device)
        kw.update(n=n, device=device)
        strategy = _BUCKET_PAD.get(collective)
        if strategy is None:
            raise ValueError(f"unknown collective {collective!r}: bucketed "
                             f"compilation pads per family — "
                             f"{sorted(_BUCKET_PAD.items())}")
        rows, cols = int(shape[0]), int(shape[1])
        bs = tuple(sorted({int(b) for b in buckets}))
        if not bs or bs[0] <= 0:
            raise ValueError(f"buckets must be positive row counts: {buckets}")
        if strategy == "blocks":
            if rows % n:
                raise ValueError(
                    f"{collective} rows={rows} not divisible into the "
                    f"{n} per-rank blocks its 'blocks' padding "
                    f"strategy buckets over")
            rows //= n
        if rows > bs[-1]:
            raise ValueError(f"shape rows={rows} exceed the largest bucket "
                             f"{bs[-1]}")
        dtype_name = _dtype_name(dtype)
        key = (collective, bs, cols, dtype_name, n,
               backend or self.backend or default_backend(device), algo,
               self._level(opt_level), link or self.link,
               root if collective == "broadcast" else None, device)
        cached = self._bucketed.get(key)
        if cached is not None:
            self.stats["hits"] += 1
            return cached
        per = n if strategy == "blocks" else 1
        plans = {b: self.compile(collective, (per * b, cols), dtype, **kw)
                 for b in bs}
        bucketed = BucketedPlan(
            collective=collective, axis=self.axis, n=n, cols=cols,
            dtype=dtype_name, buckets=bs, plans=plans,
            hits={b: 0 for b in bs}, pad_strategy=strategy)
        self._bucketed[key] = bucketed
        return bucketed

    def _build(self, collective, rows, cols, dtype, backend, algo,
               level_req, root, link, n, device, groups=1,
               stride=1) -> ExecutionPlan:
        itemsize = _DTYPES[dtype].itemsize
        nbytes = rows * cols * itemsize
        if collective == "all_gather":
            nbytes *= n          # selection is on the full gathered message
        if collective == "broadcast":
            name = "broadcast_allpairs"
            source = algos.broadcast_allpairs(n, root)
        else:
            name = self._resolve_algo(collective, n, nbytes, algo, link,
                                      level_req)
            source = algos.REGISTRY[name](n)

        level = level_req
        prog = passes.optimize(source, level, n)
        if collective not in _PADDABLE:
            while level > 2 and rows % prog.chunks[prog.in_buffer] != 0:
                level -= 1
                prog = passes.optimize(source, level, n)
            if level != level_req and algo is None:
                name = self._resolve_algo(collective, n, nbytes, algo, link,
                                          level)
                source = algos.REGISTRY[name](n)
                prog = passes.optimize(source, level, n)

        # static verification at compile time; a failing optimized form
        # recompiles once unoptimized (O0 = the hand-written source)
        if self.verify != "off":
            vroot = root if collective == "broadcast" else 0
            report = verify_mod.verify_program(prog, n, collective=collective,
                                               root=vroot)
            if report.findings and level > 0:
                self.health["verify_failures"] += 1
                self.health["recompiles"] += 1
                warnings.warn(f"plan verification failed at O{level} for "
                              f"{collective}/{name} (n={n}): "
                              f"{report.findings[0]} — recompiling "
                              f"unoptimized", stacklevel=3)
                level = 0
                prog = passes.optimize(source, level, n)
                report = verify_mod.verify_program(
                    prog, n, collective=collective, root=vroot)
            if report.findings:
                self.health["verify_failures"] += 1
                if self.verify == "strict":
                    report.raise_if_failed()
                warnings.warn(f"plan verification: {report.summary()} — "
                              f"serving unverified (verify='warn')",
                              stacklevel=3)
            else:
                self.health["verified"] += 1

        n_in = prog.chunks[prog.in_buffer]
        pad = (-rows) % n_in if collective in _PADDABLE else 0
        if pad == 0 and rows % n_in != 0:
            raise ValueError(f"{collective} rows={rows} not divisible by the "
                             f"{n_in}-chunk input grid of {name!r} at n={n}")
        stats = prog.comm_stats(n, max(nbytes // n_in, 1))
        bytes_key = "wire_bytes_per_rank" if link.torus else "bytes_per_rank"
        est = link.time_us(
            stats["comm_rounds"] + stats["barriers"], stats[bytes_key],
            extra_syncs=max(0, stats["sync_steps"] - stats["comm_rounds"]))
        executor = _build_executor(prog, backend, level, n,
                                   (rows + pad, cols), dtype, device,
                                   groups=groups)
        return ExecutionPlan(
            collective=collective, algo=name, axis=self.axis, n=n,
            shape=(rows, cols), dtype=dtype, backend=backend,
            opt_level=level, requested_opt_level=level_req,
            root=root if collective == "broadcast" else None, pad=pad,
            link=link, estimate_us=est, comm_stats=stats, program=prog,
            executor=executor, device=device, groups=groups,
            stride=stride, trace=self.trace)

    def plans(self) -> Dict[tuple, ExecutionPlan]:
        """A snapshot of the plan cache (key -> plan)."""
        return dict(self._plans)

    # -- collectives on rank-stacked tensors -------------------------------
    # Each compiles the plan for x's shape at the first call and hits the
    # cache after; backend "torch_native" is one plain PyTorch call.
    def _native(self, backend: Optional[str]) -> bool:
        return (backend or self.backend) == NATIVE

    def _payload_plan(self, collective, shape, dtype, n, device, **kw):
        """:meth:`compile` for a payload of ``n`` ranks on ``device``,
        which fill in what the communicator was made without."""
        where = {}
        if self.n is None:
            where["n"] = n
        if self.device is None:
            where["device"] = device
        return self.compile(collective, shape, dtype, **where, **kw)

    def _collective(self, collective, x, **kw) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"expected a rank-stacked (n, rows, cols) "
                             f"payload, got shape {tuple(x.shape)}")
        return self._payload_plan(collective, tuple(x.shape[1:]), x.dtype,
                                  x.shape[0], x.device, **kw)(x)

    def all_reduce(self, x: torch.Tensor, *, backend: Optional[str] = None,
                   algo: Optional[str] = None,
                   link: Optional[sel.LinkModel] = None,
                   opt_level: Optional[int] = None) -> torch.Tensor:
        """x: ``(n, rows, cols)`` -> the same shape, summed over the
        axis."""
        if self._native(backend):
            return x.sum(0, dtype=x.dtype).expand_as(x)
        return self._collective("all_reduce", x, backend=backend, algo=algo,
                                link=link, opt_level=opt_level)

    def all_gather(self, x: torch.Tensor, *, backend: Optional[str] = None,
                   algo: Optional[str] = None,
                   link: Optional[sel.LinkModel] = None,
                   opt_level: Optional[int] = None) -> torch.Tensor:
        """x: ``(n, rows, cols)`` shards -> ``(n, n*rows, cols)``, every
        rank holding all shards in rank order."""
        if self._native(backend):
            n, rows, cols = x.shape
            return x.reshape(1, n * rows, cols).expand(n, n * rows, cols)
        return self._collective("all_gather", x, backend=backend, algo=algo,
                                link=link, opt_level=opt_level)

    def reduce_scatter(self, x: torch.Tensor, *,
                       backend: Optional[str] = None,
                       algo: Optional[str] = None,
                       link: Optional[sel.LinkModel] = None,
                       opt_level: Optional[int] = None) -> torch.Tensor:
        """x: ``(n, n*rows, cols)`` -> ``(n, rows, cols)``: rank ``r``'s
        reduced row block ``r``."""
        if self._native(backend):
            n, total, cols = x.shape
            return x.sum(0, dtype=x.dtype).reshape(n, total // n, cols)
        return self._collective("reduce_scatter", x, backend=backend,
                                algo=algo, link=link, opt_level=opt_level)

    def broadcast(self, x: torch.Tensor, root: int = 0, *,
                  backend: Optional[str] = None,
                  link: Optional[sel.LinkModel] = None,
                  opt_level: Optional[int] = None) -> torch.Tensor:
        """x: ``(n, rows, cols)`` -> root's buffer on every rank."""
        if self._native(backend):
            return x[root:root + 1].expand_as(x)
        return self._collective("broadcast", x, root=root, backend=backend,
                                link=link, opt_level=opt_level)

    def all_to_all(self, x: torch.Tensor, *, backend: Optional[str] = None,
                   algo: Optional[str] = None,
                   link: Optional[sel.LinkModel] = None,
                   opt_level: Optional[int] = None) -> torch.Tensor:
        """x: ``(n, n*rows, cols)``, row block ``b`` of rank ``d`` goes
        to rank ``b``; returns every rank's received blocks stacked."""
        if self._native(backend):
            n, total, cols = x.shape
            return x.reshape(n, n, total // n, cols).transpose(0, 1) \
                .reshape(n, total, cols)
        return self._collective("all_to_all", x, backend=backend, algo=algo,
                                link=link, opt_level=opt_level)

    def tree_all_reduce(self, tree, *, backend: Optional[str] = None,
                        lane: int = 128, **kw):
        """Bucket fusion over a pytree (nested dicts, lists, tuples) of
        rank-stacked ``(n, ...)`` leaves: flatten every leaf into one
        ``(n, rows, lane)`` buffer (dict keys sorted, the leaves' common
        type, zero-padded to a whole lane), all_reduce it once, and
        unflatten (the leaves come back as views of the reduced buffer).
        ``kw`` (``algo``, ``link``, ``opt_level``) go to
        :meth:`all_reduce`."""
        leaves = tree_lib.leaves(tree)
        if not leaves:
            return tree
        n = leaves[0].shape[0]
        dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            dtype = torch.promote_types(dtype, leaf.dtype)
        device = leaves[0].device
        sizes = [leaf[0].numel() for leaf in leaves]
        rows = -(-sum(sizes) // lane)
        plan = None if self._native(backend) else self._payload_plan(
            "all_reduce", (rows, lane), dtype, n, device, backend=backend,
            **kw)
        # one buffer, with the plan's pad rows already in it
        pad = 0 if plan is None else plan.pad
        flat = torch.zeros((n, (rows + pad) * lane), dtype=dtype,
                           device=device)
        off = 0
        for leaf, size in zip(leaves, sizes):
            flat[:, off:off + size] = leaf.reshape(n, size)
            off += size
        buf = flat.view(n, rows + pad, lane)
        red = (plan(buf) if plan is not None
               else self.all_reduce(buf, backend=backend)).reshape(n, -1)
        out, off = [], 0
        for leaf, size in zip(leaves, sizes):     # views of one buffer
            out.append(red[:, off:off + size].reshape(leaf.shape)
                       .to(leaf.dtype))
            off += size
        return tree_lib.unflatten(tree, out)

    def _resolve_algo(self, collective, n, nbytes, algo, link, opt_level):
        cands = sel.CANDIDATES[collective]
        if algo is not None:
            if algo not in cands:
                raise ValueError(f"unknown algorithm {algo!r} for "
                                 f"{collective!r}; expected one of {cands}")
            if not sel.supports(algo, n):
                raise ValueError(f"algorithm {algo!r} does not support "
                                 f"n={n} ranks")
            return algo
        return sel.choose(collective, n=n, nbytes=nbytes, link=link,
                          table=self.table, opt_level=opt_level)

    def __repr__(self):
        return (f"Communicator(axis={self.axis!r}, n={self.n}, "
                f"device={self.device}, backend={self.backend!r}, "
                f"plans={len(self._plans)}, stats={self.stats})")


def _hierarchical_phases(local: Communicator, node: Communicator, shape,
                         dtype, *, backend: Optional[str],
                         opt_level: Optional[int], small_message_bytes: int,
                         node_link: Optional[sel.LinkModel] = None,
                         local_n: Optional[int] = None,
                         node_n: Optional[int] = None,
                         device: DeviceLike = None) -> dict:
    """The 2PH composition on a node-major grid of ``node.n`` nodes of
    ``local.n`` ranks (``node_n``/``local_n`` for communicators made
    without ``n``): the pad that makes the rows divide L and the three
    phase plans, each replayed over its axis's groups of the grid
    (:class:`~repro_torch.mesh.RankGrid`). The cross-node AR uses 1PA for
    payloads at or under ``small_message_bytes`` (paper §4.4's first 2PH
    variant), else ``node``'s selector choice on ``node_link`` (default:
    its own link)."""
    grid = RankGrid(node_n or node.n, local_n or local.n)
    rows, cols = int(shape[0]), int(shape[1])
    dtype = _dtype_name(dtype)
    pad = (-rows) % grid.local
    shard = ((rows + pad) // grid.local, cols)
    kw = dict(backend=backend, opt_level=opt_level, device=device)
    lgroups, lstride = grid.local_view
    ngroups, nstride = grid.node_view
    small = rows * cols * _DTYPES[dtype].itemsize <= small_message_bytes
    return dict(
        pad=pad,
        rs_plan=local.compile("reduce_scatter", (rows + pad, cols), dtype,
                              groups=lgroups, stride=lstride, n=grid.local,
                              **kw),
        ar_plan=node.compile("all_reduce", shard, dtype, link=node_link,
                             algo="allreduce_1pa" if small else None,
                             groups=ngroups, stride=nstride, n=grid.nodes,
                             **kw),
        ag_plan=local.compile("all_gather", shard, dtype, groups=lgroups,
                              stride=lstride, n=grid.local, **kw))


def hierarchical_plan(shape, dtype, *, local: Communicator,
                      node: Communicator, backend: Optional[str] = None,
                      small_message_bytes: int = 1 << 20,
                      opt_level: Optional[int] = None,
                      node_link: Optional[sel.LinkModel] = None,
                      local_n: Optional[int] = None,
                      node_n: Optional[int] = None,
                      device: DeviceLike = None) -> "HierarchicalPlan":
    """The :class:`HierarchicalPlan` that :func:`hierarchical_all_reduce`
    replays on one rank's ``(rows, cols)`` payload of ``dtype``: its three
    phase plans compiled on (or fetched from) ``local`` and ``node``.
    ``local_n``/``node_n`` and ``device`` fill in what communicators made
    without ``n`` lack."""
    lnum = local_n or local.n
    if lnum is None:
        raise ValueError(f"communicator {local.axis!r} has no axis size: "
                         f"pass local_n=")
    nnum = node_n or node.n
    if nnum is None:
        raise ValueError(f"communicator {node.axis!r} has no axis size: "
                         f"pass node_n=")
    phases = _hierarchical_phases(
        local, node, shape, dtype, backend=backend, opt_level=opt_level,
        small_message_bytes=small_message_bytes, node_link=node_link,
        local_n=lnum, node_n=nnum,
        device=None if local.device is not None else device)
    return HierarchicalPlan(shape=(int(shape[0]), int(shape[1])),
                            dtype=_dtype_name(dtype), local_axis=local.axis,
                            node_axis=node.axis, **phases)


def hierarchical_all_reduce(x: torch.Tensor, *, local: Communicator,
                            node: Communicator,
                            backend: Optional[str] = None,
                            small_message_bytes: int = 1 << 20,
                            opt_level: Optional[int] = None,
                            node_link: Optional[sel.LinkModel] = None,
                            local_n: Optional[int] = None) -> torch.Tensor:
    """2PH AllReduce (paper §4.4-2PH) over two communicators:
    RS(local) → AR(node) → AG(local), on a node-major ``(node.n *
    local.n, rows, cols)`` grid (``local_n`` gives L where ``local`` was
    made without ``n``; the nodes are then ``x.shape[0] // L``).

    The cross-node phase moves 1/L of the data (L = ``local.n``). For
    small messages the cross-node hop uses 1PA (the paper's first 2PH
    variant); for large, whatever ``node``'s selector picks on
    ``node_link`` (default: the node communicator's own link)."""
    lnum = local_n or local.n
    if lnum is None:
        raise ValueError(f"communicator {local.axis!r} has no axis size: "
                         f"pass local_n=")
    nnum = node.n or x.shape[0] // lnum
    if x.dim() != 3 or x.shape[0] != lnum * nnum:
        raise ValueError(f"expected a ({nnum} nodes x {lnum} local, "
                         f"rows, cols) payload, got {tuple(x.shape)}")
    return hierarchical_plan(
        tuple(x.shape[1:]), x.dtype, local=local, node=node, backend=backend,
        small_message_bytes=small_message_bytes, opt_level=opt_level,
        node_link=node_link, local_n=lnum, node_n=nnum, device=x.device)(x)


# ---------------------------------------------------------------------------
# hierarchical (two-axis) composition — RS(local) → AR(node) → AG(local)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False, repr=False)
class HierarchicalPlan:
    """A frozen two-axis AllReduce: three per-axis :class:`ExecutionPlan`
    s composed RS(local) → AR(node) → AG(local) (paper §4.4-2PH), or ONE
    flat plan when the grid has one node.

    It replays on a node-major ``(nn * L, rows, cols)`` payload: the RS
    and AG phases over nn groups of L contiguous ranks, the AR phase over
    L groups of nn ranks at stride L, each one launch of the executor
    kernel on the card. The cross-node phase carries 1/L of the payload.
    Serializable like the reference's (:meth:`to_json` /
    :meth:`from_json`, ``kind="hierarchical_plan"``)."""

    shape: Tuple[int, int]
    dtype: str
    local_axis: str
    node_axis: Optional[str]
    #: rows appended before RS(local) and sliced back off after AG(local)
    #: so the payload divides the local axis
    pad: int
    rs_plan: Optional[ExecutionPlan]
    ar_plan: Optional[ExecutionPlan]
    ag_plan: Optional[ExecutionPlan]
    #: set instead of the three phases on the single-axis fallback
    flat_plan: Optional[ExecutionPlan] = None

    @property
    def ranks(self) -> int:
        """Ranks of the payload's leading axis (nn * L, or L flat)."""
        if self.flat_plan is not None:
            return self.flat_plan.n
        return self.rs_plan.n * self.ar_plan.n

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Replay on a node-major ``(nn * L, rows, cols)`` payload (the
        flat fallback: ``(L, rows, cols)``). Pure replay."""
        if tuple(x.shape[1:]) != tuple(self.shape) \
                or x.shape[0] != self.ranks:
            raise ValueError(
                f"hierarchical plan compiled for shape {self.shape} on "
                f"{self.ranks} ranks, got {tuple(x.shape)}")
        if self.flat_plan is not None:
            return self.flat_plan(x)
        rows = x.shape[1]
        if self.pad:
            x = F.pad(x, (0, 0, 0, self.pad))
        shard = self.rs_plan(x)
        shard = self.ar_plan(shard)
        out = self.ag_plan(shard)
        return out[:, :rows] if self.pad else out

    def release(self) -> None:
        """:meth:`ExecutionPlan.release` of every phase."""
        for plan in self.phases.values():
            plan.release()

    # -- inspection --------------------------------------------------------
    @property
    def phases(self) -> Dict[str, ExecutionPlan]:
        if self.flat_plan is not None:
            return {"flat": self.flat_plan}
        return {"rs": self.rs_plan, "ar": self.ar_plan, "ag": self.ag_plan}

    @property
    def estimate_us(self) -> float:
        """Analytic span: the phases run back to back, so costs add."""
        return sum(p.estimate_us for p in self.phases.values())

    @property
    def algo(self) -> str:
        """Phase algorithms as one label, e.g. ``allpairs_rs+
        allreduce_1pa+allpairs_ag`` (or the flat plan's algorithm)."""
        return "+".join(p.algo for p in self.phases.values())

    def cost_card(self) -> dict:
        return dict(collective="all_reduce", kind="hierarchical",
                    shape=tuple(self.shape), dtype=self.dtype,
                    axes=[a for a in (self.local_axis, self.node_axis)
                          if a is not None],
                    algo=self.algo, pad=self.pad,
                    estimate_us=round(self.estimate_us, 3),
                    phases={k: p.cost_card()
                            for k, p in self.phases.items()})

    def __repr__(self):
        axes = (self.local_axis if self.node_axis is None
                else f"{self.local_axis}x{self.node_axis}")
        return (f"HierarchicalPlan({self.algo} axes={axes} "
                f"shape={tuple(self.shape)} dtype={self.dtype} "
                f"est={self.estimate_us:.2f}us)")

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return dict(
            version=PLAN_FORMAT_VERSION, format=PLAN_FORMAT_VERSION,
            kind="hierarchical_plan", collective="all_reduce",
            shape=list(self.shape), dtype=self.dtype,
            local_axis=self.local_axis, node_axis=self.node_axis,
            pad=self.pad, estimate_us=self.estimate_us,
            plans={k: p.to_dict() for k, p in self.phases.items()},
        )

    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("indent", 2)
        json_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_dict(cls, d: dict, *, device: DeviceLike = None,
                  backend: Optional[str] = None,
                  verify: str = "strict") -> "HierarchicalPlan":
        """Rebuild from :meth:`to_dict` output (either package's): every
        phase plan is verified and prepared for ``device`` with
        ``backend``, with the replay geometry of its axis."""
        _check_version(d, "HierarchicalPlan")
        if d.get("kind") != "hierarchical_plan":
            raise ValueError(
                f"not a hierarchical plan payload (kind="
                f"{d.get('kind')!r}); use ExecutionPlan/BucketedPlan")
        req = lambda k: _field(d, k, "HierarchicalPlan")  # noqa: E731
        payload = req("plans")
        kw = dict(device=device, backend=backend, verify=verify)
        if "flat" in payload:
            phase = dict(rs_plan=None, ar_plan=None, ag_plan=None,
                         flat_plan=ExecutionPlan.from_dict(payload["flat"],
                                                           **kw))
        else:
            missing = {"rs", "ar", "ag"} - set(payload)
            if missing:
                raise ValueError(
                    f"hierarchical plan payload missing phase plans "
                    f"{sorted(missing)} (has {sorted(payload)})")
            grid = RankGrid(
                _field(payload["ar"], "n", "HierarchicalPlan ar phase"),
                _field(payload["rs"], "n", "HierarchicalPlan rs phase"))
            lgroups, lstride = grid.local_view
            ngroups, nstride = grid.node_view
            phase = dict(
                rs_plan=ExecutionPlan.from_dict(payload["rs"], groups=lgroups,
                                                stride=lstride, **kw),
                ar_plan=ExecutionPlan.from_dict(payload["ar"], groups=ngroups,
                                                stride=nstride, **kw),
                ag_plan=ExecutionPlan.from_dict(payload["ag"], groups=lgroups,
                                                stride=lstride, **kw),
                flat_plan=None)
        return cls(shape=tuple(req("shape")), dtype=_dtype_name(req("dtype")),
                   local_axis=req("local_axis"), node_axis=req("node_axis"),
                   pad=req("pad"), **phase)

    @classmethod
    def from_json(cls, s: str, **kw) -> "HierarchicalPlan":
        return cls.from_dict(json.loads(s), **kw)


class HierarchicalCommunicator:
    """Two-axis planning object for a node × local rank grid: owns a
    local-axis and a node-axis :class:`Communicator` and compiles frozen
    :class:`HierarchicalPlan` s composing RS(local) → AR(node) →
    AG(local).

    With ``node_axis=None`` (or ``node_n=1``) it degrades to a flat
    single-axis plan on the local communicator. Each axis keeps its own
    :class:`~.selector.LinkModel`; both default to the placeholder
    ``selector.UNFITTED`` (the reference's ICI/DCN are TPU constants and
    are passed explicitly only where a test holds the port to the
    reference). The cross-node AR uses 1PA for payloads at or under
    ``small_message_bytes`` (paper §4.4's first 2PH variant), else the
    node axis's selector choice."""

    def __init__(self, local_axis: str, node_axis: Optional[str] = None, *,
                 local_n: int, node_n: Optional[int] = None,
                 device: DeviceLike = None,
                 local_link: sel.LinkModel = sel.UNFITTED,
                 node_link: sel.LinkModel = sel.UNFITTED,
                 backend: Optional[str] = None,
                 opt_level: Optional[int] = None,
                 small_message_bytes: int = 1 << 20,
                 verify: str = "strict"):
        if node_axis is not None and node_n is None:
            raise ValueError(f"node axis {node_axis!r} needs its size "
                             f"node_n")
        self.local = Communicator(local_axis, n=local_n, device=device,
                                  link=local_link, backend=backend,
                                  opt_level=opt_level, verify=verify)
        self.node = (Communicator(node_axis, n=node_n, device=device,
                                  link=node_link, backend=backend,
                                  opt_level=opt_level, verify=verify)
                     if node_axis is not None else None)
        self.small_message_bytes = small_message_bytes
        self._plans: Dict[tuple, HierarchicalPlan] = {}
        self.stats = {"compiles": 0, "hits": 0}

    @property
    def local_axis(self) -> str:
        return self.local.axis

    @property
    def node_axis(self) -> Optional[str]:
        return None if self.node is None else self.node.axis

    def compile(self, shape, dtype, *, backend: Optional[str] = None,
                opt_level: Optional[int] = None) -> HierarchicalPlan:
        """Compile (or fetch) the hierarchical AllReduce plan for one
        rank's ``(rows, cols)`` payload."""
        rows, cols = int(shape[0]), int(shape[1])
        dtype_name = _dtype_name(dtype)
        lnum = self.local.n
        nnum = 1 if self.node is None else self.node.n
        key = ((rows, cols), dtype_name, lnum, nnum, backend, opt_level)
        plan = self._plans.get(key)
        if plan is not None:
            self.stats["hits"] += 1
            return plan
        if nnum <= 1:
            flat = self.local.compile("all_reduce", (rows, cols), dtype_name,
                                      backend=backend, opt_level=opt_level)
            plan = HierarchicalPlan(
                shape=(rows, cols), dtype=dtype_name,
                local_axis=self.local.axis, node_axis=self.node_axis,
                pad=0, rs_plan=None, ar_plan=None, ag_plan=None,
                flat_plan=flat)
        else:
            plan = HierarchicalPlan(
                shape=(rows, cols), dtype=dtype_name,
                local_axis=self.local.axis, node_axis=self.node.axis,
                **_hierarchical_phases(
                    self.local, self.node, (rows, cols), dtype_name,
                    backend=backend, opt_level=opt_level,
                    small_message_bytes=self.small_message_bytes))
        self._plans[key] = plan
        self.stats["compiles"] += 1
        return plan

    def all_reduce(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """x: node-major ``(nn * L, rows, cols)`` -> the same shape,
        summed over the whole grid."""
        return self.compile(tuple(x.shape[1:]), x.dtype, **kw)(x)

    def plans(self) -> Dict[tuple, HierarchicalPlan]:
        """A snapshot of the hierarchical plan cache."""
        return dict(self._plans)

    def __repr__(self):
        return (f"HierarchicalCommunicator(local={self.local.axis!r}, "
                f"node={self.node_axis!r}, plans={len(self._plans)}, "
                f"stats={self.stats})")


# ---------------------------------------------------------------------------
# plan sets: the §4.4 deployment artifact (compile once, ship JSON files)
# ---------------------------------------------------------------------------
def plan_from_json(text: str, **kw):
    """Load any plan flavor, dispatching on the payload's ``kind``
    (``bucketed_plan`` / ``hierarchical_plan`` / a plain
    :class:`ExecutionPlan`); ``kw`` go to ``from_dict`` (``device``,
    ``backend``, ``verify``)."""
    kind = json.loads(text).get("kind")
    if kind == "bucketed_plan":
        return BucketedPlan.from_json(text, **kw)
    if kind == "hierarchical_plan":
        return HierarchicalPlan.from_json(text, **kw)
    return ExecutionPlan.from_json(text, **kw)


def export_plan_set(plans: Dict[str, Any], path) -> pathlib.Path:
    """Write a named set of plans as one JSON file per plan plus a
    ``plan_set.json`` manifest (the reference's file layout)."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    entries = {}
    for name, plan in sorted(plans.items()):
        if not hasattr(plan, "to_json"):
            raise TypeError(
                f"plan set entry {name!r} is {type(plan).__name__}, which "
                f"has no to_json(): only ExecutionPlan/BucketedPlan/"
                f"HierarchicalPlan belong in a plan set")
        text = plan.to_json()
        fname = f"{name}.json"
        (path / fname).write_text(text)
        entries[name] = {"file": fname,
                         "kind": json.loads(text).get("kind",
                                                      "execution_plan")}
    manifest = {"version": PLAN_FORMAT_VERSION, "kind": "plan_set",
                "plans": entries}
    out = path / "plan_set.json"
    out.write_text(json.dumps(manifest, indent=2, sort_keys=True))
    return out


def load_plan_set(path, *, device: DeviceLike = None,
                  backend: Optional[str] = None,
                  verify: str = "strict") -> Dict[str, Any]:
    """Load a plan set written by either package's ``export_plan_set``
    (directory or manifest path). Every plan is re-verified and prepared
    for ``device`` with ``backend`` (default: the device's)."""
    p = pathlib.Path(path)
    if p.is_dir():
        p = p / "plan_set.json"
    if not p.exists():
        raise ValueError(f"no plan set at {p}: expected a plan_set.json "
                         f"manifest written by export_plan_set()")
    d = json.loads(p.read_text())
    if d.get("kind") != "plan_set":
        raise ValueError(f"{p} is not a plan-set manifest "
                         f"(kind={d.get('kind')!r})")
    _check_version(d, "plan set manifest")
    device = resolve_device(device)
    out = {}
    for name, ent in _field(d, "plans", "plan set manifest").items():
        f = p.parent / _field(ent, "file", f"plan set entry {name!r}")
        if not f.exists():
            raise ValueError(f"plan set entry {name!r} points at missing "
                             f"file {f}")
        out[name] = plan_from_json(f.read_text(), device=device,
                                   backend=backend, verify=verify)
    return out


# ---------------------------------------------------------------------------
# process-default communicators (what core/api.py calls through)
# ---------------------------------------------------------------------------
_DEFAULTS: Dict[str, Communicator] = {}


def default_communicator(axis: str) -> Communicator:
    """The process-default :class:`Communicator` of an axis name, made at
    first use without ``n`` or a device (both come from each payload).
    Install a tuning table or a link on it to retune the module-level
    :mod:`repro_torch.core.api` collectives of that axis."""
    comm = _DEFAULTS.get(axis)
    if comm is None:
        comm = _DEFAULTS[axis] = Communicator(axis)
    return comm


def reset_default_communicators() -> None:
    """Drop every process-default communicator."""
    _DEFAULTS.clear()
