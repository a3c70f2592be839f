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

A plan takes and returns rank-stacked tensors: ``x`` is ``(n, rows,
cols)`` and ``x[r]`` is rank ``r``'s payload.

Backends: ``"torch"`` is the plain version (:class:`~.executor.
TorchExecutor`) on any device; ``"cuda"`` is the hand-written kernel
(:class:`~.executor.CudaExecutor`) for CUDA tensors only.
:func:`default_backend` picks ``"cuda"`` on the card and ``"torch"`` on
the CPU. Plans exported by the reference (``repro.core.comm.
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

from repro_torch.core import algorithms as algos
from repro_torch.core import passes
from repro_torch.core import selector as sel
from repro_torch.core import verify as verify_mod
from repro_torch.core.dsl import Program, program_from_dict, program_to_dict
from repro_torch.core.executor import CudaExecutor, TorchExecutor
from repro_torch.mesh import DeviceLike, resolve_device

__all__ = ["Communicator", "ExecutionPlan", "BucketedPlan",
           "default_backend", "plan_from_json", "export_plan_set",
           "load_plan_set", "PLAN_FORMAT_VERSION", "BACKENDS"]

PLAN_FORMAT_VERSION = 1
BACKENDS = ("torch", "cuda")
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
           "float16": torch.float16}


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
                    shape: Tuple[int, int], dtype: str, device: torch.device):
    """The prepared executor; the kernel's device state (instruction
    table, flags, scratch) is allocated here, at plan-build time."""
    if backend == "cuda":
        if device.type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got "
                             f"{device}; use backend='torch' on the CPU")
        n_in = program.chunks[program.in_buffer]
        return CudaExecutor(program).prepare(n).bind(
            shape[0] // n_in, shape[1], _DTYPES[dtype], device)
    if backend == "torch":
        return TorchExecutor(program, vectorize=opt_level > 0).prepare(n)
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class ExecutionPlan:
    """A compiled, frozen, executable collective. ``shape`` is one
    rank's ``(rows, cols)`` payload; ``pad`` rows are appended before
    execution and sliced off after (paddable collectives only)."""

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

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Replay on a rank-stacked ``(n, rows, cols)`` payload: no
        selection, no passes, no executor preparation."""
        if tuple(x.shape) != (self.n,) + tuple(self.shape):
            raise ValueError(f"plan compiled for ({self.n},) + {self.shape}, "
                             f"got {tuple(x.shape)}")
        if x.dtype != _DTYPES[self.dtype]:
            raise ValueError(f"plan compiled for dtype {self.dtype}, got "
                             f"{x.dtype}")
        if self.pad:
            x = F.pad(x, (0, 0, 0, self.pad))
        out = self.executor(x)
        if self.pad:
            out = out[:, : self.shape[0]]
        return out

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
                  backend: Optional[str] = None,
                  verify: str = "strict") -> "ExecutionPlan":
        """Rebuild a plan: the program is reconstructed, verified, and
        prepared for ``device`` with ``backend`` (default: the device's
        backend — the file's own backend is not used)."""
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
                                   (shape[0] + pad, shape[1]), dtype, device)
        return cls(
            collective=collective, algo=req("algo"), axis=req("axis"), n=n,
            shape=shape, dtype=dtype, backend=backend,
            opt_level=req("opt_level"),
            requested_opt_level=req("requested_opt_level"), root=root,
            pad=pad, link=link, estimate_us=req("estimate_us"),
            comm_stats=dict(req("comm_stats")), program=program,
            executor=executor, device=device)

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
    ``device`` (``None``: the CUDA card, raising where there is none)."""

    def __init__(self, axis: str, *, n: int, device: DeviceLike = None,
                 link: sel.LinkModel = sel.UNFITTED,
                 backend: Optional[str] = None,
                 opt_level: Optional[int] = None,
                 verify: str = "strict"):
        if verify not in verify_mod.MODES:
            raise ValueError(f"verify must be one of {verify_mod.MODES}, "
                             f"got {verify!r}")
        self.axis = axis
        self.n = int(n)
        self.device = resolve_device(device)
        self.link = link
        self.backend = backend or default_backend(self.device)
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")
        self.opt_level = opt_level
        self.verify = verify
        self._plans: Dict[tuple, ExecutionPlan] = {}
        self._bucketed: Dict[tuple, BucketedPlan] = {}
        self.stats = {"compiles": 0, "hits": 0}
        #: compile-side counters surfaced through Engine.plan_report
        self.health = {"verified": 0, "verify_failures": 0, "recompiles": 0}

    def _level(self, opt_level: Optional[int]) -> int:
        lvl = self.opt_level if opt_level is None else opt_level
        return passes.DEFAULT_OPT_LEVEL if lvl is None else lvl

    def compile(self, collective: str, shape, dtype, *,
                algo: Optional[str] = None, backend: Optional[str] = None,
                opt_level: Optional[int] = None, root: int = 0,
                link: Optional[sel.LinkModel] = None) -> ExecutionPlan:
        """Compile (or fetch from cache) the plan for one collective on a
        per-rank ``(rows, cols)`` payload of ``dtype``."""
        backend = backend or self.backend
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if collective not in COLLECTIVES:
            raise ValueError(f"unknown collective {collective!r}")
        link = link or self.link
        level_req = self._level(opt_level)
        rows, cols = int(shape[0]), int(shape[1])
        dtype = _dtype_name(dtype)
        key = (collective, (rows, cols), dtype, self.n, backend, algo,
               level_req, link, root if collective == "broadcast" else None)
        plan = self._plans.get(key)
        if plan is not None:
            self.stats["hits"] += 1
            return plan
        plan = self._build(collective, rows, cols, dtype, backend, algo,
                           level_req, root, link)
        self._plans[key] = plan
        self.stats["compiles"] += 1
        return plan

    def plan_for(self, collective: str, shape, dtype, *, buckets=None,
                 algo: Optional[str] = None, backend: Optional[str] = None,
                 opt_level: Optional[int] = None, root: int = 0,
                 link: Optional[sel.LinkModel] = None):
        """:meth:`compile`, or with ``buckets=(b1, b2, ...)`` one plan per
        bucket behind a :class:`BucketedPlan` (itself cached). Buckets
        count payload rows, except for the ``"blocks"`` families
        (all_to_all, reduce_scatter): there ``shape`` is the full
        ``(n * rows, cols)`` payload and buckets count rows per per-rank
        block (for MoE, the per-rank token capacity)."""
        kw = dict(algo=algo, backend=backend, opt_level=opt_level,
                  root=root, link=link)
        if buckets is None:
            return self.compile(collective, shape, dtype, **kw)
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
            if rows % self.n:
                raise ValueError(
                    f"{collective} rows={rows} not divisible into the "
                    f"{self.n} per-rank blocks its 'blocks' padding "
                    f"strategy buckets over")
            rows //= self.n
        if rows > bs[-1]:
            raise ValueError(f"shape rows={rows} exceed the largest bucket "
                             f"{bs[-1]}")
        dtype_name = _dtype_name(dtype)
        key = (collective, bs, cols, dtype_name, self.n,
               backend or self.backend, algo, self._level(opt_level),
               link or self.link, root if collective == "broadcast" else None)
        cached = self._bucketed.get(key)
        if cached is not None:
            self.stats["hits"] += 1
            return cached
        per = self.n if strategy == "blocks" else 1
        plans = {b: self.compile(collective, (per * b, cols), dtype, **kw)
                 for b in bs}
        bucketed = BucketedPlan(
            collective=collective, axis=self.axis, n=self.n, cols=cols,
            dtype=dtype_name, buckets=bs, plans=plans,
            hits={b: 0 for b in bs}, pad_strategy=strategy)
        self._bucketed[key] = bucketed
        return bucketed

    def _build(self, collective, rows, cols, dtype, backend, algo,
               level_req, root, link) -> ExecutionPlan:
        n = self.n
        itemsize = _DTYPES[dtype].itemsize
        nbytes = rows * cols * itemsize
        if collective == "all_gather":
            nbytes *= n          # selection is on the full gathered message
        if collective == "broadcast":
            name = "broadcast_allpairs"
            source = algos.broadcast_allpairs(n, root)
        else:
            name = self._resolve_algo(collective, nbytes, algo, link,
                                      level_req)
            source = algos.REGISTRY[name](n)

        level = level_req
        prog = passes.optimize(source, level, n)
        if collective not in _PADDABLE:
            while level > 2 and rows % prog.chunks[prog.in_buffer] != 0:
                level -= 1
                prog = passes.optimize(source, level, n)
            if level != level_req and algo is None:
                name = self._resolve_algo(collective, nbytes, algo, link,
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
                                   (rows + pad, cols), dtype, self.device)
        return ExecutionPlan(
            collective=collective, algo=name, axis=self.axis, n=n,
            shape=(rows, cols), dtype=dtype, backend=backend,
            opt_level=level, requested_opt_level=level_req,
            root=root if collective == "broadcast" else None, pad=pad,
            link=link, estimate_us=est, comm_stats=stats, program=prog,
            executor=executor, device=self.device)

    def all_to_all(self, x: torch.Tensor, *, backend: Optional[str] = None,
                   algo: Optional[str] = None,
                   link: Optional[sel.LinkModel] = None,
                   opt_level: Optional[int] = None) -> torch.Tensor:
        """x: ``(n, n*rows, cols)``, row block ``b`` of rank ``d`` goes
        to rank ``b``; returns every rank's received blocks stacked.
        Compiles the plan for this shape at the first call, hits the
        cache after."""
        return self.compile("all_to_all", tuple(x.shape[1:]), x.dtype,
                            algo=algo, backend=backend, opt_level=opt_level,
                            link=link)(x)

    def _resolve_algo(self, collective, nbytes, algo, link, opt_level):
        cands = sel.CANDIDATES[collective]
        if algo is not None:
            if algo not in cands:
                raise ValueError(f"unknown algorithm {algo!r} for "
                                 f"{collective!r}; expected one of {cands}")
            if not sel.supports(algo, self.n):
                raise ValueError(f"algorithm {algo!r} does not support "
                                 f"n={self.n} ranks")
            return algo
        return sel.choose(collective, n=self.n, nbytes=nbytes, link=link,
                          opt_level=opt_level)

    def __repr__(self):
        return (f"Communicator(axis={self.axis!r}, n={self.n}, "
                f"device={self.device}, backend={self.backend!r}, "
                f"plans={len(self._plans)}, stats={self.stats})")


# ---------------------------------------------------------------------------
# plan sets: the §4.4 deployment artifact (compile once, ship JSON files)
# ---------------------------------------------------------------------------
def plan_from_json(text: str, **kw):
    """Load a plan of either flavor; ``kw`` go to ``from_dict``
    (``device``, ``backend``, ``verify``)."""
    kind = json.loads(text).get("kind")
    if kind == "bucketed_plan":
        return BucketedPlan.from_json(text, **kw)
    if kind == "hierarchical_plan":
        raise NotImplementedError("hierarchical plans are not ported yet")
    return ExecutionPlan.from_json(text, **kw)


def export_plan_set(plans: Dict[str, Any], path) -> pathlib.Path:
    """Write a named set of plans as one JSON file per plan plus a
    ``plan_set.json`` manifest (the reference's file layout)."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    entries = {}
    for name, plan in sorted(plans.items()):
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
