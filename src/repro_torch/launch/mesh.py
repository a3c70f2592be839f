"""Production rank grids (port of ``repro.launch.mesh``).

A function, not a module constant, as in the reference; it touches no
device at all here: the grid is names and sizes
(:class:`~repro_torch.mesh.NamedGrid`), which is all the sharding specs
and the dry run read.

Single pod: ``(16, 16)`` over ``("data", "model")`` — 256 ranks.
Multi-pod:  ``(2, 16, 16)`` over ``("pod", "data", "model")`` — 512
ranks. Ranks are numbered row-major, so on H100 nodes of 8 GPUs
(:data:`repro_torch.roofline.analysis.H100.node_ranks`) a 16-rank
``model`` group spans two nodes.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import MeshAxes
from repro_torch.mesh import NamedGrid

__all__ = ["make_production_mesh", "mesh_axes_for"]


def make_production_mesh(*, multi_pod: bool = False) -> NamedGrid:
    if multi_pod:
        return NamedGrid(("pod", "data", "model"), (2, 16, 16))
    return NamedGrid(("data", "model"), (16, 16))


def mesh_axes_for(grid: NamedGrid) -> MeshAxes:
    if "pod" in grid.shape:
        return MeshAxes(data=("pod", "data"), model="model")
    return MeshAxes(data=("data",), model="model")
