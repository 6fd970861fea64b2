"""Device mesh ownership (port of ``vlm_clip_tpu/parallel/mesh.py``).

The one module that owns the ``torch.distributed`` device mesh and its
axis names. Axes:

- ``data``: batch (DP); the contrastive loss all-gathers its features
  over it;
- ``model``: tensor parallelism (its rules are not ported yet:
  :data:`MESH_NOT_PORTED`);
- ``seq``: a sequence axis.

A rank holds one device, so a mesh is laid over the ranks of the process
group (``parallel/distributed.maybe_initialize`` brings it up). Where
the reference attaches ``NamedSharding``s and lets XLA insert the
collectives, the port's callers issue them on the axis's process group
(:func:`axis_group`); :func:`data_sharding` and :func:`replicated` name
the same layouts as DTensor placements.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

MESH_NOT_PORTED = (
    "model parallelism over a device mesh is not ported to "
    "vlm_clip_tpu_torch yet (ROADMAP.md, modules to port, item 8: model "
    "parallelism)")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: all remaining ranks
    model: int = 1
    seq: int = 1


def create_mesh(cfg: MeshConfig = MeshConfig(), device: str = "cuda"):
    """A ('data', 'model'[, 'seq']) ``DeviceMesh`` over the ranks of the
    process group, one ``device`` each."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs a process group: call parallel.distributed."
            "maybe_initialize() under a launcher first")
    n = dist.get_world_size()
    model = cfg.model if cfg.model > 0 else 1
    seq = cfg.seq if cfg.seq > 0 else 1
    data = cfg.data if cfg.data > 0 else n // (model * seq)
    if data * model * seq != n:
        raise ValueError(f"mesh {data}x{model}x{seq} != {n} devices")
    if seq == 1:
        return init_device_mesh(device, (data, model),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return init_device_mesh(device, (data, model, seq),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS, SEQ_AXIS))


_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "active_mesh", default=None)


@contextlib.contextmanager
def with_mesh(mesh):
    """Set the ambient mesh used by sharding helpers."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    return _ACTIVE_MESH.get()


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_coordinate(mesh, axis: str = DATA_AXIS) -> Tuple[int, int]:
    """(this rank's index along ``axis``, the axis's size)."""
    return mesh.get_local_rank(axis), axis_size(mesh, axis)


def axis_group(mesh: Optional[object], axis: str = DATA_AXIS):
    """The process group along ``axis`` of ``mesh``; without a mesh the
    whole world."""
    return dist.group.WORLD if mesh is None else mesh.get_group(axis)


def data_sharding(mesh, ndim: int = 1):
    """Batch-dim-sharded over ``data``, otherwise replicated: one DTensor
    placement per mesh axis."""
    del ndim  # a placement names the sharded dim; the rest replicate
    return tuple(Shard(0) if name == DATA_AXIS else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh):
    return tuple(Replicate() for _ in mesh.mesh_dim_names)
