"""Small API-parity helpers (port of ``vlm_clip_tpu/utils/misc.py``;
reference utils.py:15-20)."""

from __future__ import annotations

from typing import Any

import torch

from vlm_clip_tpu_torch.bridge import tree_leaves


def get_device(name: str = "cuda") -> torch.device:
    """The first card, ``cuda:0`` (reference get_device, utils.py:15-16);
    raises without one unless ``name`` is ``"cpu"``."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; ask for "
                           "get_device('cpu') to run on the CPU")
    return torch.device("cuda:0")


def count_trainable_params(params: Any) -> int:
    """Total parameter count of a tree of tensors (reference
    count_trainable_params, utils.py:19-20 — 'trainable' is whatever
    subtree you pass, since freezing is a partition choice)."""
    return sum(t.numel() for t in tree_leaves(params))
