"""ZeRO-1: optimizer-state sharding over the data axis (port of the ZeRO-1
half of ``vlm_clip_tpu/parallel/sharding.py``, :228-266).

Each trainable leaf shards on its first dim that is at least the data
axis's size and divisible by it; every other leaf is replicated
(:func:`zero1_specs`, the reference's rule). :class:`Zero1Optimizer`
keeps only this rank's shard of each sharded leaf's optimizer state:
a step reduce-scatters each gradient along its dim, updates the shard,
and all-gathers the updated params, which is what the reference's GSPMD
constraints compile to. The tensor-parallel partition rules and
``shard_params`` (the reference's :28-225) are model parallelism, not
ported yet (``parallel/mesh.MESH_NOT_PORTED``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from vlm_clip_tpu_torch.bridge import tree_map
from vlm_clip_tpu_torch.parallel.distributed import all_reduce_mean_
from vlm_clip_tpu_torch.parallel.mesh import (DATA_AXIS, axis_coordinate,
                                              axis_group, axis_size)


def zero1_specs(tree: Any, mesh, axis: Optional[str] = None) -> Any:
    """DTensor placement per leaf of ``tree`` for ZeRO-1 optimizer-state
    (and gradient) sharding: ``Shard(i)`` on the leaf's first dim i that
    is >= the axis size n and divisible by it, else ``Replicate()``."""
    n = axis_size(mesh, axis or DATA_AXIS)

    def spec(x):
        for i, d in enumerate(getattr(x, "shape", ())):
            if d >= n and d % n == 0 and n > 1:
                return Shard(i)
        return Replicate()

    return tree_map(spec, tree)


class Zero1Optimizer:
    """A torch optimizer over this rank's shards of the sharded params
    (the replicated ones whole), bound to the full params.

    :meth:`step` takes the params' local gradients, averages them over
    the data axis (a reduce-scatter along each sharded leaf's dim, one
    all-reduce of the replicated leaves), clips by the global norm,
    updates the shards and all-gathers them into the params.
    :meth:`state_dict` gathers the sharded state on the axis's rank 0
    (there it is the plain optimizer's ``state_dict`` over the full
    params); :meth:`load_state_dict` takes such a dict and keeps this
    rank's shard. Both are collective: every rank of the axis calls them.
    Params loaded from outside reach the shards by :meth:`sync_shards`.
    """

    def __init__(self, params: List[torch.Tensor],
                 make: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                 mesh, axis: Optional[str] = None):
        axis = axis or DATA_AXIS
        self.params = list(params)
        self.group = axis_group(mesh, axis)
        self.rank, self.world = axis_coordinate(mesh, axis)
        self.specs = zero1_specs(self.params, mesh, axis)
        self.shards = [self._narrow(p.detach(), s).clone()
                       if isinstance(s, Shard) else p
                       for p, s in zip(self.params, self.specs)]
        self.optimizer = make(self.shards)

    def _narrow(self, t: torch.Tensor, spec: Shard) -> torch.Tensor:
        k = t.shape[spec.dim] // self.world
        return t.narrow(spec.dim, self.rank * k, k)

    def _sharded(self):
        return [i for i, s in enumerate(self.specs) if isinstance(s, Shard)]

    @torch.no_grad()
    def step(self, tx, count: int) -> torch.Tensor:
        """One update from the params' ``.grad`` (``tx``: the
        ``train/optim.Optimizer`` recipe, update number ``count``);
        returns the global gradient norm before clipping."""
        sharded = self._sharded()
        grads = [p.grad for p in self.params]
        all_reduce_mean_([g for g, s in zip(grads, self.specs)
                          if not isinstance(s, Shard)], self.group)
        for i in sharded:
            d = self.specs[i].dim
            full = grads[i].movedim(d, 0).contiguous()
            out = full.new_empty((full.shape[0] // self.world,
                                  *full.shape[1:]))
            dist.reduce_scatter_tensor(out, full, group=self.group)
            if self.world > 1:
                out.div_(self.world)
            self.shards[i].grad = out.movedim(0, d).contiguous()
        opt_grads = [s.grad for s in self.shards]
        # the global norm: each leaf's square sum in param order, a
        # shard's summed over the axis
        terms = [(g.float() ** 2).sum() for g in opt_grads]
        if sharded:
            part = torch.stack([terms[i] for i in sharded])
            dist.all_reduce(part, group=self.group)
            for j, i in enumerate(sharded):
                terms[i] = part[j]
        gnorm = torch.sqrt(sum(terms))
        tx.update(self.optimizer, count, opt_grads, gnorm)
        for i in sharded:
            d = self.specs[i].dim
            src = self.shards[i].movedim(d, 0).contiguous()
            out = src.new_empty((src.shape[0] * self.world, *src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=self.group)
            self.params[i].copy_(out.movedim(0, d))
        return gnorm

    def _state_tensors(self, i: int, state: dict, shape) -> List[str]:
        """The keys of leaf i's state that hold a tensor of ``shape``
        (its moments; not Adam's scalar step)."""
        return [k for k in sorted(state) if torch.is_tensor(state[k])
                and state[k].dim() > 0 and state[k].shape == shape]

    def state_dict(self) -> dict:
        sd = self.optimizer.state_dict()
        state = dict(sd["state"])  # entries alias the live state: copy
        for i in self._sharded():
            st = dict(state.get(i, {}))
            for k in self._state_tensors(i, st, self.shards[i].shape):
                st[k] = self._gather(st[k], self.specs[i].dim)
            if st:
                state[i] = st
        return {"state": state, "param_groups": sd["param_groups"]}

    def _gather(self, t: torch.Tensor, d: int) -> torch.Tensor:
        src = t.movedim(d, 0).contiguous()
        root = dist.get_global_rank(self.group, 0)
        if self.rank != 0:
            dist.gather(src, None, dst=root, group=self.group)
            return t
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.gather(src, parts, dst=root, group=self.group)
        return torch.cat(parts).movedim(0, d).contiguous()

    def load_state_dict(self, sd: dict) -> None:
        state = dict(sd["state"])
        for i in self._sharded():
            st = dict(state.get(i, {}))
            for k in self._state_tensors(i, st, self.params[i].shape):
                st[k] = self._narrow(st[k], self.specs[i]).clone()
            if st:
                state[i] = st
        self.optimizer.load_state_dict(
            {"state": state, "param_groups": sd["param_groups"]})
        self.sync_shards()

    @torch.no_grad()
    def sync_shards(self) -> None:
        """Copy this rank's rows of the params into the shards the
        optimizer updates: call it after the params were loaded from
        outside (:meth:`load_state_dict` does)."""
        for i in self._sharded():
            self.shards[i].copy_(self._narrow(self.params[i],
                                              self.specs[i]))


def zero1_place(opt: torch.optim.Optimizer, mesh, tx,
                axis: Optional[str] = None) -> Zero1Optimizer:
    """``opt`` (typically fresh) as a :class:`Zero1Optimizer` built by the
    recipe ``tx`` over the same params, its state carried over: each
    rank then holds 1/data of every sharded moment."""
    params = [p for g in opt.param_groups for p in g["params"]]
    z = Zero1Optimizer(params, tx.init, mesh, axis)
    z.load_state_dict(opt.state_dict())
    return z
