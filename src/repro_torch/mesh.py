"""Rank axis on one device — the port's stand-in for ``shard_map``.

NCCL does not put two ranks on one device, so a tensor-parallel rank of
the port is a slice of a *rank-stacked* tensor: the leading axis is the
rank, ``x[r]`` is rank ``r``'s local buffer (the ``x[d]`` convention of
``repro/kernels/ref.py``). Code that the reference writes once per
device inside ``shard_map`` is written once here with an explicit rank
axis, and ``RankAxis.index()`` plays ``jax.lax.axis_index``.

Device resolution is shared by every entry point: ``device=None`` means
the CUDA card, and raises where there is none — the port never carries
on on the CPU unless the caller asked for it.

A two-level mesh (the reference's ``P("node", "local")``, paper §4.4's
nodes of L local ranks) is stacked node-major: rank = node·L + local, so
one ``(nn·L, rows, cols)`` tensor is both the hierarchical path's payload
and a flat axis of nn·L ranks. :class:`RankGrid` gives each axis's group
view (the ``groups``/``stride`` a phase plan replays with), and
:func:`group_ranks` is the one rule every group view follows: member
``m`` of group ``g`` is rank ``g % stride + m·stride + (g // stride)·n·
stride`` — stride 1 gives contiguous groups (the local axis), stride L
the ranks of one local index across nodes (the node axis).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import torch

__all__ = ["RankAxis", "RankGrid", "NamedGrid", "group_ranks",
           "resolve_device"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the current CUDA
    card and raises when there is no CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class RankAxis:
    """One named mesh axis of ``n`` ranks, all stacked on ``device``."""

    name: str
    n: int
    device: torch.device

    def __init__(self, name: str, n: int, device: DeviceLike = None):
        if n < 1:
            raise ValueError(f"axis size must be >= 1, got {n}")
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "device", resolve_device(device))

    def index(self) -> torch.Tensor:
        """(n,) rank ids — ``jax.lax.axis_index`` for every rank at once."""
        return torch.arange(self.n, device=self.device)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Split ``x`` into ``n`` equal blocks along ``dim`` and stack
        them on a new leading rank axis (a contiguous copy)."""
        if x.shape[dim] % self.n:
            raise ValueError(
                f"dim {dim} of size {x.shape[dim]} does not divide over "
                f"{self.n} ranks of axis {self.name!r}")
        return torch.stack(x.to(self.device).chunk(self.n, dim=dim)).contiguous()

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's own copy of ``x`` (a replicated leaf)."""
        x = x.to(self.device)
        return x.unsqueeze(0).expand((self.n,) + tuple(x.shape)).contiguous()


def group_ranks(groups: int, n: int, stride: int = 1) -> List[List[int]]:
    """The global ranks of ``groups`` groups of ``n`` members each:
    member ``m`` of group ``g`` is rank ``g % stride + m * stride +
    (g // stride) * n * stride``. ``groups`` must be a multiple of
    ``stride``."""
    if groups < 1 or n < 1 or stride < 1 or groups % stride:
        raise ValueError(f"{groups} groups of {n} ranks at stride {stride}: "
                         f"the group count must be a positive multiple of "
                         f"the stride")
    return [[g % stride + m * stride + (g // stride) * n * stride
             for m in range(n)] for g in range(groups)]


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """A two-level mesh of ``nodes`` × ``local`` ranks stacked node-major
    on one device: rank ``node * local + l``."""

    nodes: int
    local: int

    def __post_init__(self):
        if self.nodes < 1 or self.local < 1:
            raise ValueError(f"a {self.nodes} x {self.local} rank grid: both "
                             f"axes must be >= 1")

    @property
    def size(self) -> int:
        return self.nodes * self.local

    def rank(self, node: int, local: int) -> int:
        return node * self.local + local

    @property
    def local_view(self) -> Tuple[int, int]:
        """``(groups, stride)`` of the local axis: ``nodes`` groups of
        ``local`` contiguous ranks (one per node)."""
        return self.nodes, 1

    @property
    def node_view(self) -> Tuple[int, int]:
        """``(groups, stride)`` of the node axis: ``local`` groups of
        ``nodes`` ranks at stride ``local`` (the ranks of one local index,
        one per node)."""
        return self.local, self.local

    def local_groups(self) -> List[List[int]]:
        groups, stride = self.local_view
        return group_ranks(groups, self.local, stride)

    def node_groups(self) -> List[List[int]]:
        groups, stride = self.node_view
        return group_ranks(groups, self.nodes, stride)


@dataclasses.dataclass(frozen=True)
class NamedGrid:
    """A named rank grid — axis names and sizes, outermost first, and no
    device (the port's stand-in for a ``jax.sharding`` mesh where only
    its shape is read: the sharding specs, the dry run). Rank ids are
    row-major over the axes, as a mesh's device ids are.

    ``shape`` is the ``{name: size}`` dict the spec functions read
    (``jax.sharding.Mesh.shape``'s meaning); :meth:`rank_axes` puts the
    axes on a device as :class:`RankAxis` es."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) or len(
                set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names {self.axis_names} and sizes "
                             f"{self.axis_sizes}: one distinct name a size")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        out = 1
        for n in self.axis_sizes:
            out *= n
        return out

    def rank_axes(self, device: DeviceLike = None) -> Tuple[RankAxis, ...]:
        """The axes as :class:`RankAxis` es on ``device``."""
        return tuple(RankAxis(a, n, device)
                     for a, n in zip(self.axis_names, self.axis_sizes))

    def group_ranks(self, names) -> List[List[int]]:
        """The rank groups of a collective over the axes ``names``: one
        group for each index of the other axes, its members ordered
        row-major over ``names``."""
        names = set(names)
        stride, strides = 1, {}
        for a, n in reversed(list(zip(self.axis_names, self.axis_sizes))):
            strides[a] = stride
            stride *= n
        inner = [a for a in self.axis_names if a in names]
        outer = [a for a in self.axis_names if a not in names]

        def offsets(axes):
            out = [0]
            for a in axes:
                out = [o + i * strides[a] for o in out
                       for i in range(self.shape[a])]
            return out

        members = offsets(inner)
        return [[base + m for m in members] for base in offsets(outer)]
