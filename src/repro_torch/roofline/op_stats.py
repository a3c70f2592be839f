"""A step's operation and byte counts, from running it on fake tensors —
the port's counterpart of ``repro.roofline.hlo_parse``.

The reference reads FLOPs, traffic and collective bytes out of compiled
HLO text. The port compiles nothing it could read, so this module runs
the step itself under ``torch._subclasses.fake_tensor.FakeTensorMode``:
every tensor has a shape, a type and a device but no data, so a
full-size configuration allocates nothing and the step's Python runs
as it would on the card. Hence the name: the counts are the aten ops'
statistics, not a parse. :func:`analyze` returns :class:`OpStats`:

* ``flops`` — matmul-class FLOPs (``torch.utils.flop_counter``: mm,
  bmm, addmm, baddbmm, convolutions, attention), as ``hlo_parse`` counts
  only dots;
* ``traffic_bytes`` — operand plus result bytes of every aten op that is
  not a view. Eager ops do not fuse, so this is an upper bound of the
  bytes the card moves (a fused kernel reads its inputs once);
* ``coll`` — the bytes of the plan calls by collective, and by link:
  ``nvlink`` or ``network`` (:func:`~.analysis.collective_bytes`). The
  step's communicators are swapped for a :class:`PlanRecorder`'s, whose
  plans return fake outputs of the plan's shape and type and record the
  collective, its bytes a rank and the traced rank's group. No kernel
  and no ``TorchExecutor`` arithmetic runs, so a plan's own ops never
  count as compute; the plan's kernel scratch is allocated (fake) for
  the call, sized as the executor sizes it for the program the
  selector picks (``core/executor.py:CudaExecutor._scratch``);
* ``peak_bytes`` — the most bytes of fake storage live at once (the
  inputs included, ``base_bytes`` of them), a storage counted from the
  op that made it until its last tensor dies.

The fake tensors live on the CPU: the step takes the plain path its
entry points take there (``device="cpu"``), whose matmuls and
elementwise ops are the card's. A kernel the card launches in place of
plain ops (flash attention) is counted as its plain version here.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import algorithms as algos
from repro_torch.core import passes
from repro_torch.core import selector as sel
from repro_torch.mesh import NamedGrid
from repro_torch.roofline import analysis

__all__ = ["OpStats", "PlanRecorder", "analyze", "fake_tree"]

_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view", "_local_scalar_dense", "sym_size",
               "sym_stride", "sym_numel", "sym_storage_offset"}


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    coll: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(
        analysis.COLLECTIVES + ("nvlink", "network"), 0))
    peak_bytes: int = 0
    base_bytes: int = 0
    ops: int = 0
    calls: list = dataclasses.field(default_factory=list)

    def per_rank(self, n: int) -> "OpStats":
        """The counts over ``n`` (a rank-stacked step's per-rank share;
        the collective bytes are already a rank's)."""
        return dataclasses.replace(
            self, flops=self.flops / n, traffic_bytes=self.traffic_bytes / n,
            peak_bytes=self.peak_bytes // n, base_bytes=self.base_bytes // n)


# ---------------------------------------------------------------------------
# the plan recorder: a Communicator's surface, no executor
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _chunks(name: str, n: int) -> tuple:
    """(input chunks, scratch chunks) of the registry program ``name`` at
    ``n`` ranks, after the default passes."""
    prog = passes.optimize(algos.REGISTRY[name](n), passes.DEFAULT_OPT_LEVEL,
                           n)
    scratch = sum(c for b, c in prog.chunks.items()
                  if b not in (prog.in_buffer, prog.out_buffer))
    return prog.chunks[prog.in_buffer], scratch


def scratch_elements(collective: str, n: int, rows: int, cols: int,
                     esize: int) -> int:
    """Elements of one rank's kernel scratch for a plan call on ``(rows,
    cols)``: the program the selector picks at its default link, its
    scratch buffers at the payload's rows a chunk (padded rows for the
    paddable collectives)."""
    if n < 2:
        return 0
    nbytes = rows * cols * esize * (n if collective == "all_gather" else 1)
    name = ("broadcast_allpairs" if collective == "broadcast"
            else sel.choose(collective, n=n, nbytes=nbytes))
    n_in, scratch = _chunks(name, n)
    return scratch * (-(-rows // n_in)) * cols


class RecordedPlan:
    """A plan that records its calls and returns a fake output (its
    kernel scratch live while it runs)."""

    def __init__(self, recorder, collective, n, shape, dtype, ranks,
                 buckets=None):
        self.recorder = recorder
        self.collective = collective
        self.n = n
        self.shape = tuple(shape)
        self.dtype = dtype
        self.ranks = ranks
        self.buckets = tuple(buckets) if buckets else None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        L, rows, cols = x.shape
        if self.collective == "all_gather":
            out = (L, self.n * rows, cols)
        elif self.collective == "reduce_scatter":
            out = (L, rows // self.n, cols)
        else:
            out = (L, rows, cols)
        if self.buckets:                     # bytes at the replayed bucket
            per = self.n if self.collective in ("all_to_all",
                                                "reduce_scatter") else 1
            b = next((b for b in self.buckets if b >= rows // per),
                     self.buckets[-1])
            rows = b * per
        nbytes = rows * cols * x.element_size()
        if self.collective == "all_gather":
            nbytes *= self.n
        scratch = torch.empty(L * scratch_elements(
            self.collective, self.n, rows, cols, x.element_size()),
            dtype=x.dtype, device=x.device)
        self.recorder.calls.append(dict(
            collective=self.collective, bytes=nbytes, n=self.n,
            ranks=self.ranks, shape=(rows, cols), dtype=str(x.dtype),
            scratch_bytes=scratch.numel() * scratch.element_size()))
        out = torch.empty(out, dtype=x.dtype, device=x.device)
        del scratch
        return out

    def release(self) -> None:
        pass


class RecordingCommunicator:
    """``Communicator.compile``/``plan_for`` over grid axes, handing out
    :class:`RecordedPlan` s."""

    def __init__(self, recorder, axes: tuple, n: int):
        self.recorder = recorder
        self.axis = "x".join(axes)
        self.axes = axes
        self.n = n
        #: the traced rank's (rank 0's) group over these axes
        self.ranks = recorder.grid.group_ranks(axes)[0]

    def compile(self, collective, shape, dtype, **_):
        return RecordedPlan(self.recorder, collective, self.n, shape, dtype,
                            self.ranks)

    def plan_for(self, collective, shape, dtype, *, buckets=None, **_):
        return RecordedPlan(self.recorder, collective, self.n, shape, dtype,
                            self.ranks, buckets)


class PlanRecorder:
    """Records the plan calls of a step over ``grid`` (rank ids row-major
    over its axes, ``node_ranks`` GPUs a node)."""

    def __init__(self, grid: NamedGrid, node_ranks: int = analysis.H100
                 .node_ranks):
        self.grid = grid
        self.node_ranks = node_ranks
        self.calls: list = []

    def communicator(self, *axes: str) -> RecordingCommunicator:
        n = 1
        for a in axes:
            n *= self.grid.shape[a]
        return RecordingCommunicator(self, tuple(axes), n)


# ---------------------------------------------------------------------------
# fake tensors, memory and traffic
# ---------------------------------------------------------------------------
class _Tracker(TorchDispatchMode):
    """Live storage bytes (and their peak) of every op's outputs; with
    ``counting``, the traffic of every op that is not a view."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.traffic = 0
        self.ops = 0
        self.counting = False
        self._seen: dict = {}

    def track(self, tree) -> None:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._seen:
            return
        n = s.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._drop, key)

    def _drop(self, key) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self._add(t)
        if self.counting and outs:
            name = func.overloadpacket.__name__
            if (not func.is_view and name not in _NO_TRAFFIC
                    and func.namespace != "prim"):
                ins = [t for t in tree_flatten((args, kwargs))[0]
                       if isinstance(t, torch.Tensor)]
                self.traffic += sum(t.numel() * t.element_size()
                                    for t in ins + outs)
                self.ops += 1
        return out


def fake_tree(tree):
    """Inside a fake mode: every ``meta`` tensor of ``tree`` (dicts, lists,
    tuples) as an empty CPU tensor of its shape and type."""
    if isinstance(tree, dict):
        return {k: fake_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.device.type == "meta":
        return torch.empty(tree.shape, dtype=tree.dtype, device="cpu")
    return tree


def analyze(fn, *args, prepare=None,
            recorder: Optional[PlanRecorder] = None) -> OpStats:
    """Run ``fn(*args)`` on fake tensors and count it. ``meta`` tensors
    in ``args`` become fake CPU tensors; ``prepare(*args) -> args``, when
    given, runs first (its tensors count towards the live bytes, its ops
    toward nothing else: a layout the step's inputs arrive in).
    ``recorder``: the :class:`PlanRecorder` whose communicators the step
    was built on; only its calls made by ``fn`` are counted."""
    stats = OpStats()
    with FakeTensorMode(allow_non_fake_inputs=True):
        tracker = _Tracker()
        with tracker:
            args = fake_tree(args)
            tracker.track(args)
            if prepare is not None:
                args = prepare(*args)
                tracker.track(args)
            if recorder is not None:
                recorder.calls.clear()
            tracker.peak = stats.base_bytes = tracker.live
            tracker.counting = True
            with FlopCounterMode(display=False) as flops:
                fn(*args)
            tracker.counting = False
        stats.flops = float(flops.get_total_flops())
    stats.traffic_bytes = float(tracker.traffic)
    stats.peak_bytes = int(tracker.peak)
    stats.ops = tracker.ops
    if recorder is not None:
        stats.calls = list(recorder.calls)
        stats.coll = analysis.collective_bytes(
            stats.calls, node_ranks=recorder.node_ranks)
    return stats
