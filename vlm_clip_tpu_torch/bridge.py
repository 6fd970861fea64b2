"""Numpy bridge between the JAX package's param trees and the port's.

Both packages keep params as nested dicts with the same keys and layout,
so a tree crosses by converting its leaves. The JAX side hands over
``jax.tree.map(np.asarray, tree)`` (any array-like leaf works); the port
gets tensors on ``device``. A quantized linear (the JAX package's
``QuantizedLinear`` or the port's: anything with ``qweight``, ``scale``
and ``bits``) crosses as the port's
:class:`~vlm_clip_tpu_torch.ops.quant.QuantizedLinear`, and an NF4
linear (anything with ``qweight`` and ``absmax_q``) as the port's
:class:`~vlm_clip_tpu_torch.ops.nf4.NF4Linear`, their integer tensors
keeping their types.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn


def _is_quantized(node) -> bool:
    return hasattr(node, "qweight") and hasattr(node, "bits")


def _is_nf4(node) -> bool:
    return hasattr(node, "qweight") and hasattr(node, "absmax_q")


_NF4_TENSORS = ("qweight", "absmax_q", "dq_scale", "dq_offset", "bias")


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple tree (the
    tensors of a quantized or NF4 linear are leaves too)."""
    if _is_quantized(tree):
        from vlm_clip_tpu_torch.ops.quant import QuantizedLinear

        return QuantizedLinear(
            qweight=fn(tree.qweight), scale=fn(tree.scale), bits=tree.bits,
            bias=None if tree.bias is None else fn(tree.bias),
            in_features=tree.in_features, out_features=tree.out_features)
    if _is_nf4(tree):
        from vlm_clip_tpu_torch.ops.nf4 import NF4Linear

        return NF4Linear(
            **{f: None if getattr(tree, f) is None else fn(getattr(tree, f))
               for f in _NF4_TENSORS},
            in_features=tree.in_features, out_features=tree.out_features,
            block=tree.block,
            **{f: getattr(tree, f, 0)
               for f in ("dq_cols", "dq_row0", "dq_col0")})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple tree, in insertion order."""
    if _is_quantized(tree):
        return [t for t in (tree.qweight, tree.scale, tree.bias)
                if t is not None]
    if _is_nf4(tree):
        return [getattr(tree, f) for f in _NF4_TENSORS
                if getattr(tree, f) is not None]
    if hasattr(tree, "inner") and hasattr(tree, "map"):  # a TP shard
        return tree_leaves(tree.inner) + (
            [] if tree.bias is None else [tree.bias])
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_to_torch(np_tree: Any, device="cpu",
                  dtype: Optional[torch.dtype] = None) -> Any:
    """Array-like leaves -> tensors on ``device``; floating leaves are
    cast to ``dtype`` when it is given, integer leaves keep their type."""

    def conv(a):
        t = torch.from_numpy(np.array(a))  # copy: jax buffers are read-only
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(conv, np_tree)


def tree_to_numpy(tree: Any) -> Any:
    """Tensor leaves -> numpy arrays (bf16 leaves widen to float32, which
    numpy lacks)."""

    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(conv, tree)


class TreeModule(nn.Module):
    """An nn.Module that owns nested-dict param trees (the attributes
    named in ``_trees``): ``.to()``/``.cuda()`` map every leaf."""

    _trees: tuple = ()

    def _apply(self, fn, recurse=True):
        for name in self._trees:
            setattr(self, name, tree_map(fn, getattr(self, name)))
        return super()._apply(fn, recurse)
