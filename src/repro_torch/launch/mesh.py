"""Mesh construction (port of ``repro/launch/mesh.py``).  Functions, not
module state: importing this module touches no process group or device.

Production layouts (the reference's logical meshes):
  single pod : (16, 16)    = ('data', 'model')         — 256 ranks
  multi-pod  : (2, 16, 16) = ('pod', 'data', 'model')  — 512 ranks
The 'pod' axis carries only data parallelism (the hierarchical gradient
sync of ``core/collectives.py``); 'model' carries TP/SP/EP.

With a process group up, a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the axis
names (``init_device_mesh``); its ``get_group(axis)`` is the group a
collective of that axis runs on.  Without one it is a `MeshShape`, the
axis names and sizes alone, which is all the partition rules read
(``core/partitioning.py``), so specs can be computed with no process
group.  `MeshShape`, `axis_sizes` and `axis_group` live in
``core/comm.py`` and are re-exported here.
"""
from __future__ import annotations

import math

# MeshShape, axis_group and axis_sizes are this module's API as well
from repro_torch.core.comm import MeshShape, axis_group, axis_sizes


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of `shape` named by `axes` over the default process
    group (its size must be the product of `shape`), or, with no process
    group up, a `MeshShape`.  `device_type` is the DeviceMesh's device
    type: "cuda" (the default) or "cpu"."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ "
                         f"in length")
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return MeshShape(axes, shape)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"make_mesh: shape {shape} holds {math.prod(shape)} "
                         f"ranks, the process group {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh (rank count permitting)."""
    return make_mesh(shape, axes, device_type)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in ("pod", "data"):
        out *= sizes.get(a, 1)
    return out
