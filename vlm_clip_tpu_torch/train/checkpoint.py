"""Checkpoints (port of ``vlm_clip_tpu/train/checkpoint.py``): full
train-state resume, and adapter checkpoints in the reference's file
formats.

Full resume (:func:`save_train_state`, :class:`AsyncTrainStateSaver`,
:func:`restore_train_state`): the port's own file, a ``torch.save`` of
``{"format", "adapter_params", "clip_params", "optimizer", "step"}`` —
the adapter params, the CLIP params when they train (``None`` when
frozen), the torch optimizer's ``state_dict`` (Adam's moments and step
counts) and the train step. The reference writes an orbax checkpoint
of its whole TrainState; orbax is not on the card's machine, and the
two formats are not interchangeable (ROADMAP.md, section 3). A restore
copies into the live state's tensors, so a restored trainer continues
bit for bit as if it had not stopped. Under a process group the save is
collective: a ZeRO-1 state gathers its moment shards on rank 0, rank 0
alone writes the file, and every rank waits at a barrier until it is
written; each rank's restore reads the whole file and keeps its shard.

Adapter export:

- Pipeline M: a ``torch.save`` of ``{"text_adapter": sd,
  "vision_adapter": sd, "shared_adapters": {"<layer>.<key>": tensor}}``
  with torch layouts. Loading validates strictly: every adapter kind
  enabled in the config must be in the file, and every kind in the file
  must be enabled.
- Pipelines T and V: ``{"<name>_adapter_state_dict": {"fc1.weight", ...}}``
  for name in visual / text / context (V) or visual / text (T). The V load
  takes whichever adapters are present; the T load requires both of its
  own (a V file qualifies; its context adapter is ignored).

The JAX package writes and reads the same adapter files.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from vlm_clip_tpu_torch.bridge import tree_leaves, tree_map
from vlm_clip_tpu_torch.convert import adapters as CA
from vlm_clip_tpu_torch.core.config import AdapterConfig
from vlm_clip_tpu_torch.models.layers import (layer_slice, num_layers,
                                              stack_trees)
from vlm_clip_tpu_torch.parallel.distributed import is_primary

Params = Dict[str, Any]
TRAIN_STATE_FORMAT = "vlm_clip_tpu_torch.train_state/1"


# ---------------------------------------------------------------------------
# full train-state resume
# ---------------------------------------------------------------------------

def _state_tree(state) -> Dict[str, Any]:
    """What a full save holds, as a tree of the live tensors."""
    clip = state.clip_params if any(
        p.requires_grad for p in tree_leaves(state.clip_params)) else None
    return {"format": TRAIN_STATE_FORMAT,
            "adapter_params": state.adapter_params, "clip_params": clip,
            "optimizer": state.opt_state.state_dict(), "step": state.step}


def _map_tensors(fn, tree):
    """fn on the tensors of a tree; its other leaves (the optimizer's
    settings, the step) as they are."""
    return tree_map(lambda t: fn(t) if isinstance(t, torch.Tensor) else t,
                    tree)


def _write(path: str, tree) -> None:
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def _barrier() -> None:
    """Every rank waits here (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def save_train_state(path: str, state) -> None:
    """Write the full train state to ``path`` and return when it is on
    disk (collective under a process group: rank 0 writes)."""
    tree = _state_tree(state)
    if is_primary():
        _write(path, _map_tensors(lambda t: t.detach().cpu(), tree))
    _barrier()


class AsyncTrainStateSaver:
    """Background full-state saves: overlap checkpoint writes with
    training.

    ``save`` snapshots the state on the device (a copy on the current
    stream, so the next step may update the live tensors at once) and
    returns; a thread then copies the snapshot to pinned host memory on
    a side stream that waits for the snapshot, and writes the file. At
    most one save is in flight: a new ``save`` first waits for the
    previous one. Call ``wait`` before reading the file or exiting. The
    file is the one :func:`save_train_state` writes (restore with
    :func:`restore_train_state`). Under a process group every rank calls
    ``save`` and ``wait``: rank 0 writes, and ``wait`` ends at a barrier
    once the file is written.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False  # a save started on every rank

    def save(self, path: str, state) -> None:
        self.wait()  # at most one in flight
        tree = _state_tree(state)
        self._pending = True
        if not is_primary():
            return
        snap = _map_tensors(lambda t: t.detach().clone(), tree)
        ready = None
        dev = next(t.device for t in tree_leaves(state.adapter_params))
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        self._thread = threading.Thread(target=self._run,
                                        args=(path, snap, dev, ready),
                                        daemon=True)
        self._thread.start()

    def _run(self, path, snap, dev, ready) -> None:
        try:
            host = snap
            if ready is not None:
                with torch.cuda.device(dev):
                    side = torch.cuda.Stream(dev)
                    side.wait_event(ready)
                    with torch.cuda.stream(side):
                        host = _map_tensors(self._to_pinned, snap)
                        done = torch.cuda.Event()
                        done.record(side)
                    # snap, on the device, stays referenced until here
                    done.synchronize()
            _write(path, host)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    @staticmethod
    def _to_pinned(t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background train-state save failed") \
                from err

    def close(self) -> None:
        self.wait()


def copy_into(dst, src) -> None:
    """Copy the tensors of tree src into those of tree dst, in place
    (the optimizer stays bound to dst's)."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"param keys differ: {sorted(dst)} against "
                             f"{sorted(src)}")
        for k, v in dst.items():
            copy_into(v, src[k])
        return
    if dst.shape != src.shape:
        raise ValueError(f"param shape {tuple(src.shape)} does not match "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def restore_train_state(path: str, state):
    """``state`` with the saved params copied into its tensors (the
    optimizer stays bound to them), the optimizer's state loaded and the
    step restored. The configuration must match the saved one."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    if saved.get("format") != TRAIN_STATE_FORMAT:
        raise ValueError(f"{path} is not a {TRAIN_STATE_FORMAT} file")
    trains_clip = any(p.requires_grad
                      for p in tree_leaves(state.clip_params))
    if (saved["clip_params"] is not None) != trains_clip:
        raise ValueError("the saved state and this one disagree on "
                         "whether the CLIP params train")
    with torch.no_grad():
        copy_into(state.adapter_params, saved["adapter_params"])
        if trains_clip:
            copy_into(state.clip_params, saved["clip_params"])
    state.opt_state.load_state_dict(saved["optimizer"])
    return state._replace(step=int(saved["step"]))


# ---------------------------------------------------------------------------
# adapter export in the reference's formats
# ---------------------------------------------------------------------------


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
                         device="cuda") -> Params:
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


def load_v_adapters(load_path: str, device="cuda") -> Params:
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


def load_t_adapters(load_path: str, device="cuda") -> Params:
    """Strict T-adapter load: both adapters must be present (a V export
    also qualifies; its context adapter is ignored)."""
    out = load_v_adapters(load_path, "cpu")
    missing = [n for n in ("visual", "text") if n not in out]
    if missing:
        raise ValueError(
            f"{load_path} is not a T/V adapter checkpoint: missing "
            f"{missing} (found {sorted(out)})")
    return {name: tree_map(lambda t: t.to(device), out[name])
            for name in ("visual", "text")}
