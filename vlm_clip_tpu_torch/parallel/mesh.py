"""Device mesh ownership (port of ``vlm_clip_tpu/parallel/mesh.py``).

The one module that owns the ``torch.distributed`` device mesh and its
axis names. Axes:

- ``data``: batch (DP); the contrastive loss all-gathers its features
  over it;
- ``model``: tensor parallelism (``parallel/sharding`` cuts each rank's
  shard, ``parallel/tensor_parallel`` issues its collectives);
- ``seq``: a sequence axis (``data/video.score_video_frames_sharded``
  shards frames over it);
- ``pipe``: pipeline stages (:func:`create_pipe_mesh`,
  ``parallel/pipeline``).

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

PIPE_AXIS = "pipe"


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


def create_pipe_mesh(n_stages: int, model: int = 1, device: str = "cuda"):
    """A ``('pipe',)`` mesh over ``n_stages`` ranks, or a ``('pipe',
    'model')`` one over ``n_stages x model`` ranks (tensor parallelism
    within each stage), over the whole process group (port of
    ``vlm_clip_tpu/parallel/pipeline.py`` ``create_pipe_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "create_pipe_mesh needs a process group: call parallel."
            "distributed.maybe_initialize() under a launcher first")
    need = n_stages * model
    if dist.get_world_size() != need:
        raise ValueError(f"need {need} devices, have "
                         f"{dist.get_world_size()}")
    if model == 1:
        return init_device_mesh(device, (n_stages,),
                                mesh_dim_names=(PIPE_AXIS,))
    return init_device_mesh(device, (n_stages, model),
                            mesh_dim_names=(PIPE_AXIS, MODEL_AXIS))


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
    """(this rank's index along ``axis``, the axis's size); (0, 1) when
    the mesh has no such axis."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0, 1
    return mesh.get_local_rank(axis), axis_size(mesh, axis)


def axis_group(mesh: Optional[object], axis: str = DATA_AXIS):
    """The process group along ``axis`` of ``mesh``; without a mesh the
    whole world. A mesh without ``axis`` raises (a collective reads a
    None group as the whole world): check :func:`axis_size` first."""
    if mesh is None:
        return dist.group.WORLD
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh {mesh.mesh_dim_names} has no "
                         f"'{axis}' axis")
    return mesh.get_group(axis)


def data_sharding(mesh, ndim: int = 1):
    """Batch-dim-sharded over ``data``, otherwise replicated: one DTensor
    placement per mesh axis."""
    del ndim  # a placement names the sharded dim; the rest replicate
    return tuple(Shard(0) if name == DATA_AXIS else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh):
    return tuple(Replicate() for _ in mesh.mesh_dim_names)
