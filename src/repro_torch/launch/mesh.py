"""Device meshes: the reference's production meshes and a single-rank smoke
mesh, as ``torch.distributed`` ``DeviceMesh``es with the reference's axis
names.

A mesh of more than one rank uses the process group that the caller
started (``torchrun --nproc-per-node N``, or a test's spawned ranks):
nothing on a machine tells a program of its cluster. ``make_smoke_mesh``
alone starts a group when there is none: a single-rank one from an
in-memory store, which needs no environment variables and no port (NCCL on
``cuda``, gloo on ``cpu``). ``cuda`` never falls back to gloo or to the CPU.
"""

from __future__ import annotations

import inspect
import math
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """The assigned production meshes, of CUDA devices (``device``: the dry
    run's ``"cpu"`` mesh over a fake process group), over the running
    process group.

    single-pod: (16, 16) = 256 ranks, axes ("data", "model")
    multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model")

    ``ValueError`` naming the world size it needs when the process group has
    another size (or there is none)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = MULTI_POD_AXES if multi_pod else AXES
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} mesh {shape} needs a process group of "
                         f"{need} ranks; this one has {have}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_smoke_mesh(device: str = "cuda") -> DeviceMesh:
    """The (1, 1) mesh with the production axis names. Without a default
    process group it starts a single-rank one (NCCL for ``cuda``, gloo for
    ``cpu``) from an in-memory store; NCCL's communicator is created at
    once, so a card that cannot start it fails here. Without a card
    ``cuda`` raises ``RuntimeError``."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_smoke_mesh('cuda'): no CUDA device")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not dist.is_initialized():
        kw = {}
        if device == "cuda" and "device_id" in inspect.signature(dist.init_process_group).parameters:
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())  # eager communicator
        dist.init_process_group("nccl" if device == "cuda" else "gloo", store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    if dist.get_world_size() != 1:
        raise ValueError(f"the smoke mesh is one rank; the process group has {dist.get_world_size()}")
    return init_device_mesh(device, (1, 1), mesh_dim_names=AXES)


def batch_axes_of(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes that carry the batch dimension (pod composes with data)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
