"""Tracing, profiling and numerical-debug utilities (port of
``vlm_clip_tpu/utils/profiling.py``, on ``torch.profiler``).

- :func:`trace` — a ``torch.profiler`` trace of the scope (host ops,
  and the card's kernels where CUDA is visible) written as a
  Chrome/Perfetto JSON file (``ui.perfetto.dev`` or ``chrome://tracing``);
- :class:`StepTimer` — host-side per-step wall timing with warmup skip
  and percentile summary; ``tick(sync=True)`` waits for the card first,
  so a step's time includes its device work;
- :func:`annotate` — a named ``record_function`` scope, so a region
  shows up labeled in the trace;
- :func:`debug_mode` — autograd anomaly detection with its NaN check,
  plus :func:`check_nans` for a step's outputs: the closest torch has to
  ``jax_debug_nans``, which raises at the first NaN any op produces.
  Anomaly mode checks the outputs of every backward function; forward
  ops are not checked, so :func:`check_nans` is called on what a step
  returns (ROADMAP.md, section 3).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

from vlm_clip_tpu_torch.bridge import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the scope and write ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named scope visible in profiler traces."""
    return torch.profiler.record_function(name)


def check_nans(tree, what: str = "output") -> None:
    """Raise FloatingPointError (as ``jax_debug_nans`` does) if a
    floating-point tensor of ``tree`` (a tensor, or dicts, lists and
    tuples of them) holds a NaN. Reads the result back to the host."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in {what} "
                                     f"(shape {tuple(t.shape)})")


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Autograd anomaly detection with its NaN check for the scope
    (``nans=False`` turns both off); yields :func:`check_nans`."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(nans, check_nan=nans)
    try:
        yield check_nans
    finally:
        torch.autograd.set_detect_anomaly(*prev)


class StepTimer:
    """Wall-clock step timing; call tick() once per step."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._last: Optional[float] = None
        self._count = 0

    def tick(self, sync: bool = False) -> None:
        """Mark a step's end; ``sync`` waits for the card's queued work
        first (no effect without CUDA)."""
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._times.append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        import numpy as np

        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "steps_per_s": float(1.0 / t.mean()),
        }
