"""Device meshes over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the axes ``("data",
"model")``; each process is one rank of it, and the mesh needs the
process group to be initialised first
(``torch.distributed.init_process_group``, given its address, world size
and rank).  A collective over one axis runs on ``mesh.get_group(axis)``.

Two functions of the JAX module have no counterpart here:

* ``activate_mesh``: torch has no ambient mesh.  The code that
  distributes takes the mesh as an argument, as the JAX package's
  ``apply_moe(..., mesh=)`` and the model entry points already take it.
* ``make_production_mesh``: its (16, 16) and (2, 16, 16) shapes are TPU
  v5e pods, and its users are ``launch/specs.py`` and
  ``launch/dryrun.py``; it comes with their port.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

AXES = ("data", "model")


def make_mesh(shape, axes=AXES, device_type: str = "cuda"):
    """A mesh of ``shape`` over every rank of the initialised process
    group (``prod(shape)`` must be its world size), with rank ``r`` at
    row-major position ``r``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device_type: str = "cuda"):
    """The (1, 1) mesh with the production axis names, for a world of
    one process."""
    return make_mesh((1, 1), AXES, device_type)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 for an axis the mesh does not have)."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.shape[names.index(axis)] if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis) if axis_size(mesh, axis) > 1 else 0


def batch_axes(mesh) -> tuple:
    """The mesh axes the global batch shards over."""
    return tuple(a for a in ("pod", "data")
                 if a in tuple(mesh.mesh_dim_names or ()))


def mesh_devices(mesh) -> int:
    return math.prod(mesh.shape)
