"""The collectives of a tensor-parallel forward (no reference counterpart:
GSPMD inserts these in ``vlm_clip_tpu``, whose model code holds no
``psum``).

``parallel/sharding.cut_params`` replaces each linear that a rule shards
over ``model`` by a :class:`TPLinear`: this rank's shard of the weight
(an fp ``{'kernel'[, 'bias']}`` dict, a ``QuantizedLinear`` or an
``NF4Linear``, cut on its logical rows or columns) and what the forward
needs to know about it. The model code calls its ``linear`` on a
sharded tree as on an unsharded one; ``linear`` hands a
:class:`TPLinear` to :func:`apply` (Megatron style):

- ``column`` (the output dim is cut): the local product, whose output
  stays local (a rank's heads, or its slice of the MLP's hidden width);
- ``row`` (the input dim is cut): the input columns of this rank's rows
  (sliced here when the activation is replicated, as it is behind a
  replicated fused ``qkv`` or ``gateup``), the local product in fp32,
  ``all_reduce(SUM)`` over ``model``, then the bias once and the output
  in the activation's dtype. An fp or int8 shard's operands are widened
  to fp32; K7 and the NF4 row-pair route take bf16 rows and return fp32.
  The int4 and NF4 routes of bulk prefill (more than 1,024 and 4,096
  rows) multiply in bf16 on the card, as the unsharded layer does, so
  there each partial carries a bf16 rounding;
- ``vocab`` (the untied LM head's vocabulary is cut): the local product,
  ``all_gather`` over ``model`` and the result in vocabulary order.

Forward only: the reference has no tensor-parallel backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from vlm_clip_tpu_torch.parallel.distributed import gather_rows

COLUMN, ROW, VOCAB = "column", "row", "vocab"


def map_linear(node, fn):
    """``fn`` over every tensor of a linear leaf (fp dict, quantized or
    NF4), keeping its type."""
    if isinstance(node, dict):
        return {k: fn(v) for k, v in node.items()}
    return node.map(fn)


@dataclasses.dataclass
class TPLinear:
    """One rank's shard of a linear sharded over ``model``.

    ``inner``: the shard (no bias when ``kind`` is ``row``; the bias is
    ``bias`` then, replicated and added once after the all-reduce).
    ``start``/``stop``: the logical rows (``row``) or columns this rank
    holds of ``full``. ``size``: ranks along ``model``. ``group``: the
    ``model`` axis's process group (None for a cut without one, which
    :func:`apply` refuses). Stacked layers keep their leading [L] axis
    on every tensor.
    """
    inner: Any
    kind: str
    start: int
    stop: int
    full: int
    size: int
    bias: Optional[torch.Tensor] = None
    group: Any = None

    def map(self, fn) -> "TPLinear":
        """A copy with ``fn`` applied to every tensor (a layer slice)."""
        return dataclasses.replace(
            self, inner=map_linear(self.inner, fn),
            bias=None if self.bias is None else fn(self.bias))


def apply(p: TPLinear, x: torch.Tensor,
          local: Callable[[Any, torch.Tensor], torch.Tensor],
          out_dtype=None) -> torch.Tensor:
    """``p``'s linear of ``x`` across the ``model`` ranks. ``local(inner,
    x)`` is the unsharded linear of the model code (a new tensor).
    The ranks' shares are equal (``cut_params`` shards only where they
    are), so the gathered logits are the logical vocabulary."""
    if p.size > 1 and p.group is None:
        raise RuntimeError(
            "a tensor-parallel shard without its process group: cut the "
            "tree with parallel.sharding.shard_params(params, mesh)")
    out_dtype = out_dtype or x.dtype
    if p.kind == ROW:
        if x.shape[-1] == p.full and p.stop - p.start != p.full:
            x = x[..., p.start:p.stop]  # a replicated activation
        if isinstance(p.inner, dict) or getattr(p.inner, "bits", 0) == 8:
            # fp and int8 shards multiply in x's dtype: widened, so that
            # no rank rounds its partial to bf16 before the sum
            x = x.float()
        y = local(p.inner, x).float()
        if p.size > 1:
            dist.all_reduce(y, group=p.group)
        if p.bias is not None:
            y = y + p.bias.float()
        return y.to(out_dtype)
    y = local(p.inner, x)
    if p.kind == VOCAB and p.size > 1:
        y = gather_rows(y.movedim(-1, 0), p.group).movedim(0, -1)
    return y.to(out_dtype)
