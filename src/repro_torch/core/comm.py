"""What the collectives stand on: a mesh's axes, and one ring hop.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims carry
the axis names (``launch.mesh`` builds it), or, with no process group, a
`MeshShape`: the axis names and sizes alone, which is all the partition
rules read (``core/partitioning.py``).  `axis_sizes` reads either, and any
object with ``axis_names`` and a ``shape`` mapping them to sizes, as a JAX
mesh has; `axis_group` gives the process group a collective of one axis
runs on, and `axis_coords` this rank's coordinate on each axis.

`ring_hop` is the one point-to-point step of the rings of
``core/collectives.py`` and ``train/compression.py``.  gloo's
point-to-point calls take host tensors only, so on a gloo group a CUDA
tensor travels through a host copy (`stages_on_host`), in the open, and
`CommLog` counts it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or groups."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a `MeshShape`, or an object
    with ``axis_names`` and a ``shape`` mapping (a JAX mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                        # a DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_group(mesh, axis: str):
    """The process group of `axis` of a ``DeviceMesh``; raises on a
    `MeshShape`, which has no ranks."""
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise ValueError(f"axis_group({axis!r}): {mesh!r} has no process "
                         f"group; initialise torch.distributed before "
                         f"making the mesh")
    return mesh.get_group(axis)


def axis_coords(mesh) -> dict[str, int]:
    """{axis name: this rank's coordinate on it} of a ``DeviceMesh`` (the
    reference's ``lax.axis_index`` of each axis); raises on a `MeshShape`,
    which has no ranks."""
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise ValueError(f"axis_coords: {mesh!r} has no process group; "
                         f"initialise torch.distributed before making the "
                         f"mesh")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("axis_coords: this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in coord)))


@dataclasses.dataclass
class CommLog:
    """What one rank's calls put on the wire, counted where they issue it:
    `ops` communication calls (a ring hop's ``batch_isend_irecv`` or a
    fused collective), `hops` of them ring hops, `wire_bytes` the bytes
    this rank sends (a hop: its tensors; a fused collective: the ring
    model's share, 2(n-1)/n x bytes for an all-reduce, (n-1)/n x the
    output for an all-gather), `staged_bytes` the bytes that went through
    a host copy on their way (`stages_on_host`)."""
    ops: int = 0
    hops: int = 0
    wire_bytes: int = 0
    staged_bytes: int = 0


def stages_on_host(t: torch.Tensor, group) -> bool:
    """True where `group`'s backend cannot move `t` where it lies: a CUDA
    tensor on a gloo group goes through a host copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t` in page-locked memory, which the copy engine
    fills at the link's rate (a pageable copy goes through a bounce
    buffer); PyTorch's host allocator caches the blocks."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def ring_hop(tensors, group, log: CommLog | None = None) -> tuple:
    """One hop of the ring: send each of `tensors` to group rank i+1 and
    receive the same shapes and dtypes from i-1 (the reference's
    ``_fwd_perm``), as one ``batch_isend_irecv``; returns the received
    tensors, on the device the sent ones lie on."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    out = [t.contiguous() for t in tensors]
    staged = [stages_on_host(t, group) for t in out]
    send = [to_host(t) if s else t for t, s in zip(out, staged)]
    recv = [torch.empty_like(t, pin_memory=s) for t, s in zip(send, staged)]
    ops = [dist.P2POp(dist.isend, t, nxt, group, tag) for tag, t
           in enumerate(send)]
    ops += [dist.P2POp(dist.irecv, t, prv, group, tag) for tag, t
            in enumerate(recv)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if log is not None:
        n_bytes = sum(t.numel() * t.element_size() for t in send)
        log.ops += 1
        log.hops += 1
        log.wire_bytes += n_bytes
        log.staged_bytes += sum(t.numel() * t.element_size()
                                for t, s in zip(send, staged) if s)
    return tuple(r.to(t.device) if s else r
                 for r, t, s in zip(recv, out, staged))
