"""MSCCL++ collective API — the drop-in top layer (paper §4.4; port of
``repro.core.api``).

NCCL-shaped collectives on rank-stacked tensors: ``x[r]`` is rank
``r``'s buffer, all ranks of an axis stacked on one device (the
reference calls its functions inside ``shard_map`` on one rank's shard).
Every function goes through the process-default
:class:`~repro_torch.core.comm.Communicator` of its axis name
(:func:`communicator`), which takes ``n`` from ``x.shape[0]`` and the
device from ``x`` and

1. consults the selector once per distinct (collective, shape, dtype,
   n, backend, algo, opt_level, device) — size → algorithm on its link,
   overridden by a ``TuningTable`` installed on the communicator — and
2. caches the compiled :class:`~repro_torch.core.comm.ExecutionPlan`, so
   a repeated call is one plan replay: one launch of the executor kernel
   on the card (``CudaExecutor.launches``).

Backends: ``"cuda"`` (the hand-written executor kernel; the default on
the card), ``"torch"`` (the plain version; the default on the CPU), and
``"torch_native"`` (one plain PyTorch call a collective, no plan: the
baseline the plans are measured against).

Shapes (``n`` ranks)::

    all_reduce       (n, rows, cols)   -> (n, rows, cols)
    all_gather       (n, rows, cols)   -> (n, n*rows, cols)   tiled
    reduce_scatter   (n, n*rows, cols) -> (n, rows, cols)
    all_to_all       (n, n*rows, cols) -> (n, n*rows, cols)
    broadcast        (n, rows, cols)   -> (n, rows, cols)     root's

Serving and training hold an explicit ``Communicator`` and compile
their plans at init (paper §5.2); these functions are for drop-in use.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.core import comm as comm_lib
from repro_torch.core import selector as sel
from repro_torch.core import verify as verify_mod
from repro_torch.core.comm import (BucketedPlan, Communicator, ExecutionPlan,
                                   HierarchicalCommunicator, HierarchicalPlan,
                                   default_backend, default_communicator,
                                   export_plan_set, load_plan_set)

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "broadcast", "hierarchical_all_reduce", "tree_all_reduce",
    "default_backend", "compile_plan", "load_plan", "verify_plan",
    "export_plan_set", "load_plan_set",
    "communicator", "Communicator", "ExecutionPlan", "BucketedPlan",
    "HierarchicalCommunicator", "HierarchicalPlan",
]


def communicator(axis: str) -> Communicator:
    """The process-default Communicator behind this module's functions
    for ``axis`` (install a TuningTable or a link on it, read its
    cache)."""
    return default_communicator(axis)


def compile_plan(collective: str, shape, dtype, axis: str,
                 **kw) -> ExecutionPlan:
    """Compile (or fetch) a plan on the axis's default communicator; pass
    ``n=`` (and ``device=``, default the card), which a collective call
    takes from its payload."""
    return default_communicator(axis).compile(collective, shape, dtype, **kw)


def load_plan(source, *, verify: str = "strict", **kw):
    """An :class:`ExecutionPlan`, :class:`BucketedPlan` or
    :class:`HierarchicalPlan` from a plan file path or a JSON string
    (either package's), dispatching on the payload's ``kind``. The
    program is verified before it is prepared (``verify='off'|'warn'|
    'strict'``): plan files cross a trust boundary. ``kw``: ``device``,
    ``backend``. A directory of plans loads with :func:`load_plan_set`."""
    text = source
    if isinstance(source, (bytes, os.PathLike)) or (
            isinstance(source, str) and not source.lstrip().startswith("{")):
        with open(source) as f:
            text = f.read()
    return comm_lib.plan_from_json(text, verify=verify, **kw)


def verify_plan(plan, *, num_ranks: Optional[int] = None):
    """Re-run the static checker (:mod:`~repro_torch.core.verify`) on a
    compiled plan's program; a bucketed or hierarchical plan returns the
    first failing report of its plans, else the last."""
    if isinstance(plan, BucketedPlan):
        report = None
        for b in plan.buckets:
            report = verify_plan(plan.plans[b], num_ranks=num_ranks)
            if report.findings:
                return report
        return report
    if isinstance(plan, HierarchicalPlan):
        report = None
        for phase in plan.phases.values():
            report = verify_plan(phase, num_ranks=num_ranks)
            if report.findings:
                return report
        return report
    root = 0 if plan.root is None else plan.root
    return verify_mod.verify_program(
        plan.program, num_ranks or plan.n,
        collective=plan.collective, root=root)


# ---------------------------------------------------------------------------
# collectives on rank-stacked tensors
# ---------------------------------------------------------------------------
def all_reduce(x, axis: str, *, backend: Optional[str] = None,
               algo: Optional[str] = None,
               link: Optional[sel.LinkModel] = None,
               opt_level: Optional[int] = None):
    """``(n, rows, cols)`` -> the same shape, summed over the ranks::

        y = api.all_reduce(grads, "data")                   # selector picks
        y = api.all_reduce(grads, "data", algo="allreduce_ring")
    """
    return default_communicator(axis).all_reduce(
        x, backend=backend, algo=algo, link=link, opt_level=opt_level)


def all_gather(x, axis: str, *, backend: Optional[str] = None,
               algo: Optional[str] = None,
               link: Optional[sel.LinkModel] = None,
               opt_level: Optional[int] = None):
    """``(n, rows, cols)`` shards -> ``(n, n*rows, cols)``, every rank
    holding all shards in rank order::

        full = api.all_gather(local_logits, "model")   # (tp, tp*b, vocab/tp)
    """
    return default_communicator(axis).all_gather(
        x, backend=backend, algo=algo, link=link, opt_level=opt_level)


def reduce_scatter(x, axis: str, *, backend: Optional[str] = None,
                   algo: Optional[str] = None,
                   link: Optional[sel.LinkModel] = None,
                   opt_level: Optional[int] = None):
    """``(n, n*rows, cols)`` -> ``(n, rows, cols)``: block ``i`` of every
    rank, summed, lands on rank ``i``."""
    return default_communicator(axis).reduce_scatter(
        x, backend=backend, algo=algo, link=link, opt_level=opt_level)


def all_to_all(x, axis: str, *, backend: Optional[str] = None,
               algo: Optional[str] = None,
               link: Optional[sel.LinkModel] = None,
               opt_level: Optional[int] = None):
    """``(n, n*rows, cols)``: row block ``b`` of rank ``d`` goes to rank
    ``b``; returns each rank's received blocks stacked (MoE dispatch and
    combine). Serving compiles it bucketed instead (``Communicator.
    plan_for("all_to_all", ..., buckets=...)``)."""
    return default_communicator(axis).all_to_all(
        x, backend=backend, algo=algo, link=link, opt_level=opt_level)


def broadcast(x, axis: str, root: int = 0, *, backend: Optional[str] = None,
              link: Optional[sel.LinkModel] = None,
              opt_level: Optional[int] = None):
    """``(n, rows, cols)`` -> rank ``root``'s buffer on every rank."""
    return default_communicator(axis).broadcast(
        x, root=root, backend=backend, link=link, opt_level=opt_level)


def hierarchical_all_reduce(x, *, local_axis: str, node_axis: str,
                            local_n: int, backend: Optional[str] = None,
                            small_message_bytes: int = 1 << 20,
                            opt_level: Optional[int] = None,
                            node_link: Optional[sel.LinkModel] = None):
    """2PH AllReduce (paper §4.4-2PH), RS(local) → AR(node) → AG(local),
    over the default communicators of the two axes, on a node-major
    ``(nodes * local_n, rows, cols)`` grid. The cross-node phase is
    costed on ``node_link`` (default: the node communicator's link)."""
    return comm_lib.hierarchical_all_reduce(
        x, local=default_communicator(local_axis),
        node=default_communicator(node_axis), node_link=node_link,
        backend=backend, small_message_bytes=small_message_bytes,
        opt_level=opt_level, local_n=local_n)


# ---------------------------------------------------------------------------
# pytree bucket fusion (NCCL-style) for a trainer
# ---------------------------------------------------------------------------
def tree_all_reduce(tree, axis: str, *, backend: Optional[str] = None,
                    lane: int = 128, **kw):
    """Flatten a pytree of rank-stacked leaves into one ``(n, rows,
    128)`` buffer, all_reduce it in one plan replay, unflatten: bucket
    fusion spreads one collective's latency over the whole set, as NCCL
    fuses small tensors. ``kw`` (``opt_level``, ``algo``, ``link``) go to
    :func:`all_reduce`."""
    return default_communicator(axis).tree_all_reduce(
        tree, backend=backend, lane=lane, **kw)
