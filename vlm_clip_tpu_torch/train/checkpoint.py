"""Adapter checkpoints in the reference's file formats (the
adapter-export half of ``vlm_clip_tpu/train/checkpoint.py``).

- Pipeline M: a ``torch.save`` of ``{"text_adapter": sd,
  "vision_adapter": sd, "shared_adapters": {"<layer>.<key>": tensor}}``
  with torch layouts. Loading validates strictly: every adapter kind
  enabled in the config must be in the file, and every kind in the file
  must be enabled.
- Pipelines T and V: ``{"<name>_adapter_state_dict": {"fc1.weight", ...}}``
  for name in visual / text / context (V) or visual / text (T). The V load
  takes whichever adapters are present; the T load requires both of its
  own (a V file qualifies; its context adapter is ignored).

The JAX package writes and reads the same files. Full train-state resume
is not ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

from vlm_clip_tpu_torch.bridge import tree_map
from vlm_clip_tpu_torch.convert import adapters as CA
from vlm_clip_tpu_torch.core.config import AdapterConfig
from vlm_clip_tpu_torch.models.layers import (layer_slice, num_layers,
                                              stack_trees)

Params = Dict[str, Any]


def _m_adapters_to_torch_dicts(adapter_params: Params) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    for name in ("text_adapter", "vision_adapter"):
        if name in adapter_params:
            out[name] = CA.seq_adapter_to_torch(adapter_params[name])
    if "shared_adapters" in adapter_params:
        stacked = adapter_params["shared_adapters"]
        sd: Dict[str, torch.Tensor] = {}
        for i in range(num_layers(stacked)):
            for k, v in CA.cross_modal_adapter_to_torch(
                    layer_slice(stacked, i)).items():
                sd[f"{i}.{k}"] = v
        out["shared_adapters"] = sd
    return out


def _m_adapters_from_torch_dicts(sd: Mapping[str, Mapping]) -> Params:
    out: Params = {}
    for name in ("text_adapter", "vision_adapter"):
        if name in sd:
            out[name] = CA.seq_adapter_from_torch(sd[name])
    if "shared_adapters" in sd:
        flat = sd["shared_adapters"]
        n_layers = 1 + max(int(k.split(".", 1)[0]) for k in flat)
        layers = []
        for i in range(n_layers):
            prefix = f"{i}."
            layers.append(CA.cross_modal_adapter_from_torch(
                {k[len(prefix):]: v for k, v in flat.items()
                 if k.startswith(prefix)}))
        out["shared_adapters"] = stack_trees(layers)
    return out


def save_adapter_weights(save_path: str, adapter_params: Params) -> None:
    """Adapter-only export in the reference's file format. Raises if no
    adapters are present."""
    dicts = _m_adapters_to_torch_dicts(adapter_params)
    if not dicts:
        raise ValueError("No adapters enabled to save")
    d = os.path.dirname(save_path)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.save({name: {k: v.detach().float().cpu() for k, v in sd.items()}
                for name, sd in dicts.items()}, save_path)


def load_adapter_weights(load_path: str, acfg: AdapterConfig,
                         device="cpu") -> Params:
    """Load + strictly validate an adapter checkpoint onto ``device``."""
    if not os.path.exists(load_path):
        raise FileNotFoundError(f"No adapter weights found at {load_path}")
    sd = torch.load(load_path, map_location="cpu", weights_only=True)
    checks = (
        ("text_adapter", acfg.use_text_adapter, "Text adapter"),
        ("vision_adapter", acfg.use_vision_adapter, "Vision adapter"),
        ("shared_adapters", acfg.use_shared_adapters, "Shared adapters"),
    )
    for key, enabled, label in checks:
        verb = "are" if key.endswith("s") else "is"
        if key in sd and not enabled:
            raise ValueError(f"{label} weights found but {label.lower()} "
                             f"{verb} not enabled")
        if enabled and key not in sd:
            raise ValueError(f"{label} {verb} enabled but no weights found "
                             "in checkpoint")
    return tree_map(lambda t: t.to(device), _m_adapters_from_torch_dicts(sd))


_FEATURE_ADAPTERS = ("visual", "text", "context")


def save_v_adapters(save_path: str, adapter_params: Params) -> None:
    """Pipeline-V one-shot export: the visual/text/context feature
    adapters present, as torch state dicts."""
    d = os.path.dirname(save_path)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.save({f"{name}_adapter_state_dict":
                {k: v.detach().float().cpu() for k, v in
                 CA.feature_adapter_to_torch(adapter_params[name]).items()}
                for name in _FEATURE_ADAPTERS if name in adapter_params},
               save_path)


def load_v_adapters(load_path: str, device="cpu") -> Params:
    """The feature adapters present in a T/V checkpoint, onto ``device``."""
    sd = torch.load(load_path, map_location="cpu", weights_only=True)
    return {name: tree_map(lambda t: t.to(device),
                           CA.feature_adapter_from_torch(
                               sd[f"{name}_adapter_state_dict"]))
            for name in _FEATURE_ADAPTERS
            if f"{name}_adapter_state_dict" in sd}


def save_t_adapters(save_path: str, adapter_params: Params) -> None:
    """Pipeline-T adapter export (visual + text feature adapters), the V
    file format without the context adapter."""
    for name in ("visual", "text"):
        if name not in adapter_params:
            raise ValueError(f"T adapters must contain '{name}'")
    save_v_adapters(save_path, adapter_params)


def load_t_adapters(load_path: str, device="cpu") -> Params:
    """Strict T-adapter load: both adapters must be present (a V export
    also qualifies; its context adapter is ignored)."""
    out = load_v_adapters(load_path, device)
    missing = [n for n in ("visual", "text") if n not in out]
    if missing:
        raise ValueError(
            f"{load_path} is not a T/V adapter checkpoint: missing "
            f"{missing} (found {sorted(out)})")
    return {"visual": out["visual"], "text": out["text"]}
