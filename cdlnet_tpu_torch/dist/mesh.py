"""Device mesh construction from config (counterpart of
cdlnet_tpu/dist/mesh.py).

A config mesh spec like {"data": 4, "depth": 2} becomes a Mesh: the
shape by name and, once torch.distributed is initialized, a
torch.distributed.device_mesh.DeviceMesh with those named dims, whose
per-dim ProcessGroups take the place of the JAX mesh's axes. The train
step, the halo-sharded forwards and the Denoiser consume them by name
(dist/comm.py holds the collectives). Every rank runs the same program.

On one process with no process group the mesh is trivial: every dim has
size 1, no group exists and every collective is a no-op (no one-rank
group is initialized behind the caller's back).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass(frozen=True, eq=False)
class Mesh:
    """shape: {axis: size} in mesh order; device_mesh: the DeviceMesh, or
    None for the trivial one-process mesh."""

    shape: dict
    device_mesh: object = None

    def size(self, axis) -> int:
        """The axis's size; 1 for None or an axis the mesh lacks."""
        return self.shape.get(axis, 1) if axis is not None else 1

    def group(self, axis):
        """The axis's ProcessGroup, or None (no such axis, or no group)."""
        if self.device_mesh is None or axis is None or axis not in self.shape:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis) -> int:
        """This rank's coordinate along the axis (0 without one)."""
        if self.device_mesh is None or axis is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)


def make_mesh(spec: dict | None = None, device=None) -> Mesh:
    """Build a Mesh from {axis_name: size}. Sizes must multiply to the
    world size (the processes of the default group, 1 without one); a
    single -1 axis is inferred. spec=None -> a 1-D "data" mesh over every
    rank. device: "cuda" or "cpu", the DeviceMesh's device type (default:
    cuda under NCCL, cpu under gloo)."""
    n = world_size()
    if spec is None:
        spec = {"data": n}
    names = list(spec.keys())
    sizes = list(spec.values())
    if sizes.count(-1) == 1:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh spec {spec} does not match {n} devices")
    shape = dict(zip(names, sizes))
    if not dist.is_initialized():
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh

    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, init_device_mesh(str(device), tuple(sizes),
                                        mesh_dim_names=tuple(names)))


def as_mesh(mesh) -> Mesh | None:
    """A Mesh from a Mesh, a dict spec, or None."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return make_mesh(dict(mesh))
