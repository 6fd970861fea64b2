"""Parameter partition rules (tensor parallelism) and ZeRO-1 (port of
``vlm_clip_tpu/parallel/sharding.py``).

Tensor parallelism (the reference's :28-225). The rules map '/'-joined
parameter paths (dict keys; a quantized or NF4 linear's fields by name)
to specs, first match wins, with the reference's regexes and specs.
Specs are written as the reference's axis tuples: one entry per array
dim, an axis name or None, ``()`` replicated (``P(None, 'model')`` is
``(None, 'model')``). Stacked per-layer leaves carry a leading [L] dim,
hence the rules' leading None.

Where the reference attaches ``NamedSharding``s and GSPMD partitions the
program, :func:`cut_params` returns one rank's tree, a pure function of
(tree, rules, axis sizes, rank coordinate): each linear whose rule
shards it becomes a ``tensor_parallel.TPLinear`` holding this rank's
logical rows or columns (``ops/quant.shard_quantized`` and
``ops/nf4.shard_nf4`` cut quantized leaves), every other leaf is whole.
:func:`shard_params` cuts this rank's tree over a mesh. A linear shards
when

1. the rule for its kernel (``qweight`` of a quantized or NF4 linear)
   names an axis of size > 1 on its input or output dim;
2. the reference's fallbacks do not replicate it: a rule longer than
   the array (written for stacked [L, ...] leaves, met by an unstacked
   one), or a sharded dim the axis does not divide, tested on the
   reference's shapes (an int4 weight's tile pad included);
3. the port's own hold, since each rank computes its shard alone: the
   logical dim divides into equal shares, of whole row pairs for int4
   and whole blocks for NF4 on the input dim, and of whole heads
   (``head_dim``) on the attention q/k/v outputs. So at 2 kv heads and
   ``model`` 4, k/v replicate (the rules' GQA note) where the
   reference's array test would split their 256 columns mid-head, and
   each rank picks the kv heads of its q heads
   (``vlm/qwen_model.local_heads``).

A column shard's output stays local when its consumer in the same
block (attention ``o``/``out``/``proj``, MLP ``down``/``fc2``) is
row-sharded and its co-producers are sharded too (k/v follow q);
otherwise, the untied LM head among them, its output is all-gathered.
The int4 ``pallas_ok`` demotion is not ported: each rank launches K7 on
its own shard.

ZeRO-1 (the reference's :228-266). Each trainable leaf shards on its
first dim that is at least the data axis's size and divisible by it;
every other leaf is replicated (:func:`zero1_specs`, the reference's
rule). :class:`Zero1Optimizer` keeps only this rank's shard of each
sharded leaf's optimizer state: a step reduce-scatters each gradient
along its dim, updates the shard, and all-gathers the updated params,
which is what the reference's GSPMD constraints compile to.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from vlm_clip_tpu_torch.bridge import tree_map
from vlm_clip_tpu_torch.ops.nf4 import NF4Linear, shard_nf4
from vlm_clip_tpu_torch.ops.quant import QuantizedLinear, shard_quantized
from vlm_clip_tpu_torch.parallel import tensor_parallel as TP
from vlm_clip_tpu_torch.parallel.distributed import all_reduce_mean_
from vlm_clip_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                              axis_coordinate, axis_group,
                                              axis_size)

Spec = Tuple[Optional[str], ...]
Rules = Tuple[Tuple[str, Spec], ...]

# (regex over '/'-joined path) -> spec. First match wins. Stacked
# per-layer params carry a leading layer axis.
CLIP_PARAM_RULES: Rules = (
    (r"(?:.*/)?layers/attn/(q|k|v)/kernel$", (None, None, MODEL_AXIS)),
    (r"(?:.*/)?layers/attn/(q|k|v)/bias$", (None, MODEL_AXIS)),
    (r"(?:.*/)?layers/attn/out/kernel$", (None, MODEL_AXIS, None)),
    (r"(?:.*/)?layers/attn/out/bias$", (None,)),
    (r"(?:.*/)?layers/mlp/fc1/kernel$", (None, None, MODEL_AXIS)),
    (r"(?:.*/)?layers/mlp/fc1/bias$", (None, MODEL_AXIS)),
    (r"(?:.*/)?layers/mlp/fc2/kernel$", (None, MODEL_AXIS, None)),
    (r"(?:.*/)?layers/mlp/fc2/bias$", (None,)),
    (r".*", ()),  # everything else replicated
)


def clip_param_rules() -> Rules:
    return CLIP_PARAM_RULES


# Qwen2.5-VL (the reference's, with its notes): quantized leaves keep the
# [in, out] layout (int4 packs row pairs, so its in dim is in/2 padded);
# scale is per output channel, sharded with the output dim and
# replicated when the input dim is the sharded one. The vision tower's
# fused qkv stays replicated (its [3H] output concatenates q|k|v, so a
# cut would split across that boundary); its mlp and proj input shard.
# The untied LM head shards its vocabulary (the largest tensor a decode
# step streams); the tied embedding head stays replicated (it is also
# the embedding's gather table). The decode-fused ``qkv`` and ``gateup``
# of the text layers match no rule and stay replicated.
QWEN_PARAM_RULES: Rules = (
    (r"(?:.*/)?layers/attn/(q|k|v)/(kernel|qweight)$",
     (None, None, MODEL_AXIS)),
    (r"(?:.*/)?layers/attn/(q|k|v)/(bias|scale)$", (None, MODEL_AXIS)),
    (r"(?:.*/)?layers/attn/o/(kernel|qweight)$", (None, MODEL_AXIS, None)),
    (r"(?:.*/)?layers/attn/o/scale$", (None,)),
    (r"(?:.*/)?layers/mlp/(gate|up)/(kernel|qweight)$",
     (None, None, MODEL_AXIS)),
    (r"(?:.*/)?layers/mlp/(gate|up)/scale$", (None, MODEL_AXIS)),
    (r"(?:.*/)?layers/mlp/down/(kernel|qweight)$",
     (None, MODEL_AXIS, None)),
    (r"(?:.*/)?layers/mlp/down/scale$", (None,)),
    (r"(?:.*/)?blocks/attn/qkv/(kernel|qweight|bias|scale)$", ()),
    (r"(?:.*/)?blocks/attn/proj/(kernel|qweight)$",
     (None, MODEL_AXIS, None)),
    (r"(?:.*/)?blocks/mlp/(gate|up)/(kernel|qweight)$",
     (None, None, MODEL_AXIS)),
    (r"(?:.*/)?blocks/mlp/(gate|up)/(bias|scale)$", (None, MODEL_AXIS)),
    (r"(?:.*/)?blocks/mlp/down/(kernel|qweight)$",
     (None, MODEL_AXIS, None)),
    (r"(?:.*/)?lm_head/(kernel|qweight)$", (None, MODEL_AXIS)),
    (r"(?:.*/)?lm_head/scale$", (MODEL_AXIS,)),
    (r".*", ()),
)


def qwen_param_rules() -> Rules:
    return QWEN_PARAM_RULES


def spec_for_path(path: str, rules: Rules = CLIP_PARAM_RULES) -> Spec:
    for pat, spec in rules:
        if re.match(pat, path):
            return spec
    return ()


_LINEAR_FIELDS = {QuantizedLinear: ("qweight", "scale", "bias"),
                  NF4Linear: ("qweight", "absmax_q", "dq_scale",
                              "dq_offset", "bias")}


def _path_str(keys) -> str:
    """'/'-joined path of dict keys, sequence indices and a quantized
    linear's field names."""
    return "/".join(str(k) for k in keys)


def _is_linear(node) -> bool:
    return isinstance(node, (QuantizedLinear, NF4Linear)) or (
        isinstance(node, dict) and torch.is_tensor(node.get("kernel")))


def partition_specs(params: Any, rules: Rules = CLIP_PARAM_RULES):
    """A tree of specs mirroring ``params`` (a quantized or NF4 linear's
    tensor fields as a dict of the same names)."""

    def walk(node, keys):
        if type(node) in _LINEAR_FIELDS:
            return {f: spec_for_path(_path_str(keys + [f]), rules)
                    for f in _LINEAR_FIELDS[type(node)]
                    if getattr(node, f) is not None}
        if isinstance(node, dict):
            return {k: walk(v, keys + [k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keys + [i])
                              for i, v in enumerate(node))
        return spec_for_path(_path_str(keys), rules)

    return walk(params, [])


# attention outputs that are heads: a share must hold whole ones
_HEAD_OUT = re.compile(r"(?:.*/)?(layers|blocks)/attn/(q|k|v)$")
# (producers, consumer) of one block: producers stay local when the
# consumer is row-sharded and they are all sharded
_GROUPS = ((("q", "k", "v"), "out"), (("q",), "o"), (("gate", "up"), "down"),
           (("gateup",), "down"), (("fc1",), "fc2"), (("qkv",), "proj"))


def _kernel(node) -> torch.Tensor:
    return node["kernel"] if isinstance(node, dict) else node.qweight


def _head_dim(head_dim: Dict[str, int], path: str) -> int:
    """The head width of the attention at ``path``: ``head_dim`` maps path
    prefixes to widths, the longest prefix wins and ``""`` matches every
    path."""
    best = None
    for k in head_dim:
        if (k == "" or path == k or path.startswith(k + "/")) and (
                best is None or len(k) > len(best)):
            best = k
    if best is None:
        raise ValueError(f"head_dim {head_dim} names no prefix of {path}")
    return head_dim[best]


def _decide(node, path: str, rules: Rules, sizes: Dict[str, int],
            coords: Dict[str, int], head_dim):
    """(kind, start, stop, full, size) of a linear's shard, or None."""
    kern = _kernel(node)
    spec = spec_for_path(path + ("/kernel" if isinstance(node, dict)
                                 else "/qweight"), rules)
    if len(spec) > kern.dim():
        return None
    for d, a in enumerate(spec):
        if a is not None and kern.shape[d] % sizes.get(a, 1):
            return None
    cut = [(d, a) for d, a in enumerate(spec)
           if a is not None and sizes.get(a, 1) > 1]
    if len(cut) != 1:
        return None
    d, axis = cut[0]
    if d == kern.dim() - 1:
        kind = TP.COLUMN
        full = (kern.shape[-1] if isinstance(node, dict)
                else node.logical_out)
        unit = _head_dim(head_dim, path) if _HEAD_OUT.match(path) else 1
    elif d == kern.dim() - 2:
        kind = TP.ROW
        full = kern.shape[-2] if isinstance(node, dict) else node.logical_in
        unit = (node.block if isinstance(node, NF4Linear) else
                2 if isinstance(node, QuantizedLinear) and node.bits == 4
                else 1)
    else:
        return None
    size = sizes[axis]
    if full % (size * unit):
        return None
    share = full // size
    r = coords.get(axis, 0)
    return kind, r * share, (r + 1) * share, full, size, axis


def _cut_linear(node, dec, group) -> TP.TPLinear:
    kind, start, stop, full, size, _ = dec
    dim = -1 if kind != TP.ROW else -2
    bias = None
    if isinstance(node, dict):
        k = node["kernel"]
        sl = [slice(None)] * k.dim()
        sl[dim] = slice(start, stop)
        inner = {"kernel": k[tuple(sl)].clone(
            memory_format=torch.contiguous_format)}
        if node.get("bias") is not None:
            if kind == TP.ROW:
                bias = node["bias"]
            else:
                inner["bias"] = node["bias"][..., start:stop].clone()
    else:
        cut = (shard_nf4 if isinstance(node, NF4Linear)
               else shard_quantized)
        inner = cut(node, dim, start, stop)
        if kind == TP.ROW and node.bias is not None:
            bias = node.bias
            inner = dataclasses.replace(inner, bias=None)
    return TP.TPLinear(inner, kind, start, stop, full, size, bias, group)


def _settle(decisions: Dict[str, Any]) -> None:
    """Local or gathered, per block (see the module docstring)."""
    for producers, consumer in _GROUPS:
        names = [n for n in producers if n in decisions]
        if consumer not in decisions or not names:
            continue
        cons = decisions[consumer]
        local = (cons is not None and cons[0] == TP.ROW
                 and all(decisions[n] is not None for n in names))
        if consumer == "o" and local:
            continue  # k/v: local when sharded, else picked per q head
        for n in names + (["k", "v"] if consumer == "o" else []):
            dec = decisions.get(n)
            if dec is not None and not local:
                decisions[n] = (TP.VOCAB,) + tuple(dec[1:])
    for n, dec in decisions.items():  # a column shard with no consumer
        if dec is not None and dec[0] == TP.COLUMN and not any(
                n in producers + (("k", "v") if c == "o" else ())
                and c in decisions for producers, c in _GROUPS):
            decisions[n] = (TP.VOCAB,) + tuple(dec[1:])


def cut_params(params: Any, rules: Rules, sizes: Dict[str, int],
               coords: Dict[str, int], head_dim: Dict[str, int],
               groups: Optional[Dict[str, Any]] = None) -> Any:
    """This rank's tree (see the module docstring): ``sizes`` the ranks
    along each mesh axis, ``coords`` this rank's index along each,
    ``head_dim`` {path prefix: head width} for the whole-heads check
    (``""`` for every path; :func:`clip_head_dims`, :func:`qwen_head_dims`),
    ``groups`` each axis's process group (None: a cut for inspection,
    whose sharded linears refuse to run)."""
    groups = groups or {}

    def walk(node, keys):
        if isinstance(node, dict) and not _is_linear(node):
            decisions = {k: _decide(v, _path_str(keys + [k]), rules, sizes,
                                    coords, head_dim)
                         for k, v in node.items() if _is_linear(v)}
            _settle(decisions)
            out = {}
            for k, v in node.items():
                dec = decisions.get(k)
                if dec is not None:
                    out[k] = _cut_linear(v, dec, groups.get(dec[-1]))
                else:
                    out[k] = walk(v, keys + [k])
            return out
        if isinstance(node, (list, tuple)) and not _is_linear(node):
            return type(node)(walk(v, keys + [i])
                              for i, v in enumerate(node))
        return node

    if _is_linear(params):
        raise ValueError("cut_params takes a tree of linears, not one")
    return walk(params, [])


def shard_params(params: Any, mesh, rules: Rules = CLIP_PARAM_RULES, *,
                 head_dim: Dict[str, int]):
    """This rank's shard of ``params`` over ``mesh``'s ``model`` axis
    (the tree on this rank's device as it was given), its sharded
    linears bound to the axis's process group; ``head_dim`` as
    :func:`cut_params` takes it."""
    rank, size = axis_coordinate(mesh, MODEL_AXIS)
    groups = {MODEL_AXIS: axis_group(mesh, MODEL_AXIS)} if size > 1 else {}
    return cut_params(params, rules, {MODEL_AXIS: size}, {MODEL_AXIS: rank},
                      head_dim, groups)


def clip_head_dims(cfg) -> Dict[str, int]:
    """The head dims of a CLIPConfig's towers, for :func:`shard_params`."""
    return {"vision": cfg.vision.hidden_size // cfg.vision.num_heads,
            "text": cfg.text.hidden_size // cfg.text.num_heads}


def qwen_head_dims(cfg) -> Dict[str, int]:
    """The head dims of a QwenVLConfig's text and vision trees."""
    return {"text": cfg.text.head_dim, "vision": cfg.vision.head_dim}


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding over the data axis
# ---------------------------------------------------------------------------

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
