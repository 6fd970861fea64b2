"""Tracing, profiling and numerical-debug utilities (port of
``vlm_clip_tpu/utils/profiling.py``, on ``torch.profiler``).

- the program's spans and counters: :func:`annotate` times a named
  region and :func:`count` adds to a named counter while tracing is on:
  in the :func:`tracing` scope, and while a ``torch.profiler`` session
  collects (as ``record_function`` does; read from torch's private
  ``torch.autograd.profiler._is_profiler_enabled``), so that a region
  profiled without :func:`tracing` holds the program's spans too;
  :func:`take` hands over what was recorded, with the op modules'
  kernel launches since the last take. A span is ``(id, parent_id,
  name, start_ns, end_ns)``: the parent is the enclosing open span of
  the same thread (``None`` at the top), and the times come from
  :func:`clock_ns`, the clock of the profiler's records, so a span lines
  up with the kernels it launched. With tracing off, :func:`annotate`
  returns one shared no-op context manager and :func:`count` does
  nothing;
- :func:`trace` — a ``torch.profiler`` trace of the scope (host ops,
  and the card's kernels where CUDA is visible) with tracing on, written
  as a Chrome/Perfetto JSON file (``ui.perfetto.dev`` or
  ``chrome://tracing``) that holds the program's spans (category
  ``program``) and the counters the scope added;
- :func:`debug_mode` — autograd anomaly detection with its NaN check,
  plus :func:`check_nans` for a step's outputs: the closest torch has to
  ``jax_debug_nans``, which raises at the first NaN any op produces.
  Anomaly mode checks the outputs of every backward function; forward
  ops are not checked, so :func:`check_nans` is called on what a step
  returns (ROADMAP.md, section 3).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from vlm_clip_tpu_torch.bridge import tree_leaves

Span = Tuple[int, Optional[int], str, int, int]

_on = False
_spans: List[Span] = []
_counts: Dict[str, int] = {}
_launch_base: Dict[str, int] = {}  # the op modules' counts at the last take
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()  # counters are read, added to and cleared


def clock_ns() -> int:
    """Nanoseconds on the clock of ``torch.profiler``'s records
    (``kineto_results.events()``' ``start_ns()``): the Unix time, to
    which the profiler converts its host and device records. Its host
    records agree with it to a few microseconds; its device records'
    mapping jitters by tens of microseconds (on an H100, a kernel traced
    up to 0.1 ms before the span that launched it), which no correction
    here can take out. ``h100_bench/tests/test_hb_clock.py`` checks it on
    a card."""
    return time.time_ns()


class _Off:
    """The no-op span of tracing off (one shared instance)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        t1 = clock_ns()
        _local.stack.pop()
        _spans.append((self.id, self.parent, self.name, self.t0, t1))
        return False


def annotate(name: str):
    """The program's span ``name`` over a ``with`` block; with tracing
    off, the shared no-op context manager."""
    if _on or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing with tracing off)."""
    if _on or _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def tracing():
    """Tracing on for the scope (then as it was before)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def _launches_since_take() -> Dict[str, int]:
    """The op modules' kernel launches since the last take (their
    ``launch_counts()``, which a replayed decode graph credits with the
    launches it holds: ``vlm/qwen._DecodeGraph``), as
    ``launches.<kernel>``. A module whose count went down was reset
    (``reset_launch_counts()``) since: its whole count is new."""
    from vlm_clip_tpu_torch.ops import (attention, contrastive,
                                        decode_attention, fused_adapter,
                                        quant)

    out = {}
    for m in (fused_adapter, attention, contrastive, quant,
              decode_attention):
        for k, v in m.launch_counts().items():
            key = f"launches.{k}"
            base = _launch_base.get(key, 0)
            out[key] = v - base if v >= base else v
            _launch_base[key] = v
    return out


def take() -> dict:
    """The spans closed and the counters added since the last take,
    cleared: ``{"spans": [(id, parent_id, name, start_ns, end_ns)],
    "counts": {name: n}}``; the counts also hold the op modules' kernel
    launches since the last take as ``launches.<kernel>`` (the first
    take's: since the process started)."""
    spans = _spans[:]
    del _spans[:len(spans)]
    with _lock:
        counts = dict(_counts)
        _counts.clear()
        counts.update(_launches_since_take())
    return {"spans": spans, "counts": counts}


def _write_program_events(path: str, spans: List[Span],
                          counts: Dict[str, int]) -> None:
    """Add the spans (and the counters, as one counter event at the last
    span's end) to a Chrome trace exported by ``torch.profiler``."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for sid, parent, name, t0, t1 in spans:
        events.append({"ph": "X", "cat": "program", "name": name,
                       "pid": pid, "tid": pid, "ts": (t0 - base) / 1e3,
                       "dur": (t1 - t0) / 1e3,
                       "args": {"id": sid, "parent": parent}})
    if counts:
        end = max((s[4] for s in spans), default=clock_ns())
        events.append({"ph": "C", "cat": "program", "name": "program",
                       "pid": pid, "tid": pid, "ts": (end - base) / 1e3,
                       "args": counts})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the scope with tracing on and write ``<logdir>/trace.json``
    with the program's spans and counters in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with _lock:
        n0, counts0 = len(_spans), dict(_counts)
    with tracing():
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with _lock:
        added = {k: v - counts0.get(k, 0) for k, v in _counts.items()
                 if v != counts0.get(k, 0)}
    _write_program_events(path, _spans[min(n0, len(_spans)):], added)


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
