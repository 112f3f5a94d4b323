"""Spatial co-location: split one mesh into disjoint sub-meshes (the port of
the JAX package's ``colocation/spatial.py``).

The scheduler treats sub-meshes like the paper treats GPU sets: a job gets a
contiguous slice of the rank grid. A sub-mesh is a ``DeviceMesh`` over that
slice of the parent's ranks with the parent's axis names, so the same model
specs apply. Building one creates its process groups, a collective: every
rank of the parent's group calls these functions, in the same order; a rank
outside a sub-mesh gets it too, with ``get_coordinate()`` None.
"""

from __future__ import annotations

from typing import List

from torch.distributed.device_mesh import DeviceMesh


def _sub(mesh: DeviceMesh, axis: str, start: int, stop: int) -> DeviceMesh:
    ax = mesh.mesh_dim_names.index(axis)
    idx = [slice(None)] * mesh.mesh.ndim
    idx[ax] = slice(start, stop)
    return DeviceMesh(mesh.device_type, mesh.mesh[tuple(idx)], mesh_dim_names=mesh.mesh_dim_names)


def split_mesh(mesh: DeviceMesh, parts: int, axis: str = "data") -> List[DeviceMesh]:
    """Split ``mesh`` into ``parts`` disjoint sub-meshes along ``axis``, each
    keeping the axis names with the split axis shrunk by ``parts``."""
    n = mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]
    if n % parts:
        raise ValueError(f"axis {axis} of size {n} not divisible into {parts} parts")
    return [_sub(mesh, axis, i * (n // parts), (i + 1) * (n // parts)) for i in range(parts)]


def submesh_for_job(mesh: DeviceMesh, start: int, size: int, axis: str = "data") -> DeviceMesh:
    """A contiguous sub-mesh slice [start, start+size) along ``axis``."""
    return _sub(mesh, axis, start, start + size)
