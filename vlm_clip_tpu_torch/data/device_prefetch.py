"""Host->device prefetch: overlap H2D transfer with device compute (port
of ``vlm_clip_tpu/data/device_prefetch.py``).

Wraps a host batch iterator so that the copies of the next batches are
already issued when the train loop asks for them. On a CUDA device each
array goes through pinned memory and is copied with ``non_blocking`` on
a side stream; the stream that takes the batch waits for its copies (an
event, not a host sync). On the CPU the arrays are moved plainly.
Sharding the batch over a mesh is not ported (:data:`MESH_NOT_PORTED`).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from vlm_clip_tpu_torch.bridge import tree_map

MESH_NOT_PORTED = (
    "sharding over a device mesh is not ported to vlm_clip_tpu_torch yet "
    "(ROADMAP.md, modules to port, items 7-8: data and model parallelism)")


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))


class _Copier:
    """Issues one tree's copies to ``device``; on CUDA on its own stream,
    with an event the consuming stream waits on."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def put(self, tree):
        if self.stream is None:
            return tree_map(lambda x: _as_tensor(x).to(self.device),
                            tree), None
        host = tree_map(lambda x: _as_tensor(x).pin_memory(), tree)
        with torch.cuda.stream(self.stream):
            out = tree_map(lambda t: t.to(self.device, non_blocking=True),
                           host)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def take(self, item):
        tree, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            # the copies' memory belongs to the side stream's pool: mark
            # its use on the consuming stream so it is not reused early
            tree_map(lambda t: t.record_stream(stream), tree)
        return tree


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       mesh: Optional[object] = None,
                       transform: Optional[Callable] = None,
                       device="cuda") -> Iterator:
    """Yield items with their device copies issued ``size`` steps ahead.

    ``transform`` maps the host item to a tree (dicts, lists, tuples) of
    numpy arrays or CPU tensors before the copy (e.g. lambda b:
    {'images': b.images, 'labels': b.labels}).
    """
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    copier = _Copier(torch.device(device))
    queue: collections.deque = collections.deque()
    for item in iterator:
        tree = transform(item) if transform is not None else item
        queue.append(copier.put(tree))
        if len(queue) >= size:
            yield copier.take(queue.popleft())
    while queue:
        yield copier.take(queue.popleft())
