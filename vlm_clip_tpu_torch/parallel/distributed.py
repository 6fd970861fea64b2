"""Multi-process execution over ``torch.distributed`` (port of
``vlm_clip_tpu/parallel/distributed.py``).

- :func:`maybe_initialize`: ``torch.distributed.init_process_group``
  from the launcher's environment, idempotent, a no-op for a
  single-process run. The backend is chosen, never fallen back to: NCCL
  for ``device="cuda"`` (each rank binds ``cuda:LOCAL_RANK``), gloo for
  ``device="cpu"``.
- :func:`global_mesh`: a ('data', 'model') device mesh over every rank,
  data parallelism outermost across nodes (where the reference puts it
  across TPU slices), ``model`` inside one node.
- :func:`is_primary` / :func:`primary_only`: rank-0 gating for logging,
  checkpoint files and artifact writes.

Env contract: the variables ``torchrun`` and other PyTorch launchers set.
``MASTER_ADDR``:``MASTER_PORT`` take the place of the reference's
``JAX_COORDINATOR_ADDRESS``, ``WORLD_SIZE`` of ``JAX_NUM_PROCESSES``,
``RANK`` of ``JAX_PROCESS_ID``; ``LOCAL_RANK`` picks the rank's card and
``LOCAL_WORLD_SIZE`` counts the ranks of a node. The reference's Cloud-TPU
metadata autodetect has no counterpart: the launcher's environment is
the only source. The decisions are pure functions of an env dict
(``tests/test_torch_distributed.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
ENV_NUM_PROCESSES = "WORLD_SIZE"
ENV_PROCESS_ID = "RANK"
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
ENV_COORDINATOR = f"{ENV_MASTER_ADDR}:{ENV_MASTER_PORT}"

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Parsed multi-process launch spec; ``wanted`` False -> single."""
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_rank: Optional[int] = None
    local_world_size: Optional[int] = None

    @property
    def wanted(self) -> bool:
        return self.coordinator_address is not None \
            or (self.num_processes or 0) > 1

    def validate(self) -> None:
        if not self.wanted:
            return
        if self.coordinator_address is None:
            raise ValueError(
                f"{ENV_NUM_PROCESSES}>1 requires {ENV_COORDINATOR} "
                f"(host:port of rank 0)")
        if self.num_processes is None or self.process_id is None:
            raise ValueError(
                f"{ENV_COORDINATOR} set but {ENV_NUM_PROCESSES}/"
                f"{ENV_PROCESS_ID} missing")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} outside "
                f"[0, {self.num_processes})")


def config_from_env(env=None) -> DistributedConfig:
    env = os.environ if env is None else env

    def geti(k):
        v = env.get(k)
        return int(v) if v not in (None, "") else None

    addr, port = env.get(ENV_MASTER_ADDR), env.get(ENV_MASTER_PORT)
    return DistributedConfig(
        coordinator_address=f"{addr}:{port}" if addr and port else None,
        num_processes=geti(ENV_NUM_PROCESSES),
        process_id=geti(ENV_PROCESS_ID),
        local_rank=geti(ENV_LOCAL_RANK),
        local_world_size=geti(ENV_LOCAL_WORLD_SIZE))


def maybe_initialize(cfg: Optional[DistributedConfig] = None,
                     device: str = "cuda") -> bool:
    """Bring the process group up when the launch spec (``cfg``, else the
    environment) asks for one.

    Returns True when a process group is (already) up. Safe to call more
    than once; CLIs call it first thing, before the card is touched.
    """
    if dist.is_initialized():
        return True
    cfg = cfg if cfg is not None else config_from_env()
    if not cfg.wanted:
        return False
    cfg.validate()
    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, "
                         f"got {device!r}")
    if device == "cuda":
        torch.cuda.set_device(cfg.local_rank or 0)
    dist.init_process_group(BACKENDS[device],
                            init_method=f"tcp://{cfg.coordinator_address}",
                            world_size=cfg.num_processes,
                            rank=cfg.process_id)
    log.info("torch.distributed up (%s): rank %d/%d", BACKENDS[device],
             dist.get_rank(), dist.get_world_size())
    return True


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on rank 0 (and always in single-process runs).

    Reads the process group when it is up and the launcher's ``RANK``
    before; it never touches the card. Before init with ``WORLD_SIZE``
    > 1 and no ``RANK`` there is no truthful answer: returning True on
    every rank would let every one of them write the primary's files,
    so that case raises.
    """
    if dist.is_initialized():
        return dist.get_rank() == 0
    rank = os.environ.get(ENV_PROCESS_ID)
    if rank not in (None, ""):
        return int(rank) == 0
    if int(os.environ.get(ENV_NUM_PROCESSES) or 1) > 1:
        raise RuntimeError(
            f"is_primary() called before maybe_initialize() with "
            f"{ENV_NUM_PROCESSES} > 1 and no {ENV_PROCESS_ID}: this rank's "
            "identity is unknown here. Call parallel.distributed."
            "maybe_initialize() first.")
    return True


def primary_only(fn):
    """Decorator: run ``fn`` only on rank 0 (returns None elsewhere)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None

    return wrapper


def hybrid_mesh_shape(n_devices: int, n_nodes: int, model: int = 1
                      ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((inter_data, inter_model), (intra_data, intra_model)) factorization.

    Data parallel goes outermost across nodes (each node holds whole
    model replicas; the per-step gradient reduction crosses the network
    once), tensor parallelism stays inside a node. Raises when ``model``
    does not fit inside one node.
    """
    if n_devices % n_nodes:
        raise ValueError(f"{n_devices} devices not divisible into "
                         f"{n_nodes} nodes")
    per_node = n_devices // n_nodes
    if per_node % model:
        raise ValueError(
            f"model={model} does not divide the {per_node} devices of "
            f"one node; TP must not cross nodes")
    return (n_nodes, 1), (per_node // model, model)


def global_mesh(model: int = 1, device: str = "cuda"):
    """('data', 'model') device mesh over every rank (one device each).

    Launchers number ranks node by node, so a row-major (data, model)
    layout keeps each model group inside one node once
    :func:`hybrid_mesh_shape` accepts the split.
    """
    from vlm_clip_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    n = world_size()
    local = config_from_env().local_world_size or n
    n_nodes = max(n // local, 1)
    if n_nodes <= 1:
        if n % model:
            raise ValueError(f"model={model} does not divide {n} devices")
    else:
        hybrid_mesh_shape(n, n_nodes, model)
    return create_mesh(MeshConfig(data=n // model, model=model), device)


# ---------------------------------------------------------------------------
# data-parallel collectives
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """all_gather of every rank's rows along dim 0, in rank order."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank(group)
        ctx.world = dist.get_world_size(group)
        out = x.new_empty((ctx.world * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # Every rank computes the same loss from the same gathered rows,
        # so the gradient of its own rows summed over the ranks (the
        # all_gather's adjoint) is world x its own slice of g: no
        # collective needed. The caller averages parameter gradients
        # over the ranks, which turns that factor back into 1 while
        # counting a parameter the loss reads directly (logit_scale)
        # once.
        mine = g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]
        return (mine * ctx.world if ctx.world > 1 else mine), None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, ...] on each of w ranks -> [w * n, ...] on every rank, with a
    backward for :func:`all_reduce_mean_`-averaged parameter gradients
    (see ``_GatherRows.backward``)."""
    return _GatherRows.apply(x, group or dist.group.WORLD)


def all_reduce_mean_(tensors, group=None) -> None:
    """Average tensors over the ranks of ``group``, in place: one
    all-reduce of their flat concatenation."""
    tensors = list(tensors)
    if not tensors:
        return
    group = group or dist.group.WORLD
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    w = dist.get_world_size(group)
    if w > 1:
        flat.div_(w)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
