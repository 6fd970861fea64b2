"""Host->device prefetch: overlap H2D transfer with device compute (port
of ``vlm_clip_tpu/data/device_prefetch.py``).

Wraps a host batch iterator so that the copies of the next batches are
already issued when the train loop asks for them. On a CUDA device each
array goes through pinned memory and is copied with ``non_blocking`` on
a side stream; the stream that takes the batch waits for its copies (an
event, not a host sync). On the CPU the arrays are moved plainly. With a
mesh, each rank copies only its rows along the mesh's data axis (the
reference puts each row on its data shard).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from vlm_clip_tpu_torch.bridge import tree_map
from vlm_clip_tpu_torch.parallel.mesh import axis_coordinate

def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))


def _rows(x, mesh):
    """This rank's rows of x along the mesh's data axis."""
    r, w = axis_coordinate(mesh)
    n = x.shape[0]
    if n % w:
        raise ValueError(f"{n} rows do not divide among the {w} ranks of "
                         "the data axis")
    return x[r * n // w:(r + 1) * n // w]


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
    {'images': b.images, 'labels': b.labels}). ``mesh``: a
    ``parallel.mesh`` device mesh; rank r of its data axis of size w
    copies rows [r*n/w, (r+1)*n/w) of each array (n must divide by w).
    """
    copier = _Copier(torch.device(device))
    queue: collections.deque = collections.deque()
    for item in iterator:
        tree = transform(item) if transform is not None else item
        if mesh is not None:
            tree = tree_map(lambda x: _rows(x, mesh), tree)
        queue.append(copier.put(tree))
        if len(queue) >= size:
            yield copier.take(queue.popleft())
    while queue:
        yield copier.take(queue.popleft())
