"""Named device meshes: the counterpart of ``graphsage_tpu/parallel/mesh.py``.

Axes, as in the JAX package:

* ``data``  — data parallelism: the seed batch splits; gradients are
  averaged over it.
* ``model`` — tensor parallelism over the feature dimension: the feature
  table's columns and the rows of layer 0's weight split over it, and layer
  0's partial product is summed over it once.
* ``graph`` — edge partitioning: each rank owns a contiguous CSR edge block
  and partial sums are summed over it.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks
of the process group (one device each); ``mesh.get_group(name)`` is the
process group of an axis. The JAX package's ``named``, ``graph_shardings``
and ``param_shardings`` have no counterpart: the sharded trainers slice
their tensors explicitly (only layer 0's weight splits on the model axis).
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from graphsage_torch.parallel import multihost


def make_mesh(axis_sizes: dict[str, int] | None = None, device_type: str | None = None
              ) -> DeviceMesh:
    """A mesh over every rank of the process group; default one ``data``
    axis. ``device_type`` defaults to the type of the device
    :func:`multihost.initialize` bound (which it calls, forming a world of
    one if no group exists yet)."""
    multihost.initialize()
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"data": world}
    total = math.prod(axis_sizes.values())
    if total > world:
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {total} devices, have {world}")
    if total != world:
        raise ValueError(
            f"mesh {dict(axis_sizes)} covers {total} of the {world} ranks; a "
            "mesh spans the whole process group")
    return init_device_mesh(device_type or multihost.device().type,
                            tuple(axis_sizes.values()),
                            mesh_dim_names=tuple(axis_sizes))


def default_mesh_shape(n_devices: int) -> dict[str, int]:
    """(data, model) factorization used by the dry-run harness: largest
    power-of-two model axis up to 4, remainder on data."""
    model = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            model = cand
            break
    return {"data": n_devices // model, "model": model}


def axis_size(mesh: DeviceMesh, axis: str | None) -> int:
    """Ranks along ``axis`` (1 when the mesh has no such axis)."""
    return mesh.size(mesh.mesh_dim_names.index(axis)) if has_axis(mesh, axis) else 1


def axis_index(mesh: DeviceMesh, axis: str | None) -> int:
    """This rank's coordinate along ``axis`` (0 when the mesh has no such
    axis)."""
    return mesh.get_local_rank(axis) if has_axis(mesh, axis) else 0


def has_axis(mesh: DeviceMesh, axis: str | None) -> bool:
    return axis is not None and axis in (mesh.mesh_dim_names or ())
