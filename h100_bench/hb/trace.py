"""Reading a torch.profiler trace: kernels, the benchmark's own spans,
the device's busy time (the union of its operations' intervals), the
operations that took most time, and the longest idle gaps labelled by
the span the host was in.

The spans are the benchmark's own (``Recorder.span(name)`` around each
call into the program: step, sync, prefill, generate), on the host's
wall clock, which is the profiler's; the program has none of its own
yet. Only the device's activity is traced. Profiler traces can drop
records, so a count taken from one is a floor.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (same unit out)."""
    total, end = 0.0, float("-inf")
    start = None
    for a, b in sorted(intervals):
        if start is None or a > end:
            if start is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if start is not None:
        total += end - start
    return total


def merged(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """The union of the intervals as sorted disjoint [start, end] pairs."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Recorder:
    """The benchmark's host spans, kept while a profile is on: (name,
    start, end) in seconds of the wall clock, the profiler's clock."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []
        self.on = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0 * 1e-9, time.time_ns() * 1e-9))


@contextlib.contextmanager
def profiled(rec: Recorder):
    """Profile the block's device activity (the host's ops are not
    traced: that would slow the launch path it measures); yields a
    holder whose ``summary`` is set to a :class:`Trace` of the device's
    operations and ``rec``'s spans after the block ends."""
    acts = [torch.profiler.ProfilerActivity.CUDA
            if torch.cuda.is_available()
            else torch.profiler.ProfilerActivity.CPU]
    holder = type("Holder", (), {"summary": None})()
    rec.spans, rec.on = [], True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield holder
    finally:
        rec.on = False
    holder.summary = Trace.from_profiler(prof, rec.spans)


class Trace:
    """Device operations [(name, start_s, end_s)] and host spans
    [(name, start_s, end_s)] of one profiled block, on one clock."""

    def __init__(self, ops: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]]):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.spans = sorted(spans, key=lambda s: s[1])

    @classmethod
    def from_profiler(cls, prof, spans) -> "Trace":
        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA \
                    and not e.is_user_annotation():
                t0 = e.start_ns() * 1e-9
                ops.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
        return cls(ops, list(spans))

    def kernels(self) -> List[Tuple[str, float, float]]:
        """Device operations that are kernels (not copies or fills)."""
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    def window(self) -> Optional[Tuple[float, float]]:
        """From the first span's or operation's start to the last one's
        end."""
        pts = self.spans + self.ops
        if not pts:
            return None
        return min(p[1] for p in pts), max(p[2] for p in pts)

    def busy_seconds(self) -> float:
        """Union of the device operations' intervals inside the window."""
        w = self.window()
        if w is None:
            return 0.0
        return union_seconds([(max(a, w[0]), min(b, w[1]))
                              for _, a, b in self.ops
                              if b > w[0] and a < w[1]])

    def device_seconds(self, names) -> float:
        """Summed device time of the operations whose name holds one of
        ``names`` (not a union: each operation's own duration)."""
        return sum(b - a for n, a, b in self.ops
                   if any(f in n for f in names))

    def count(self, names=None) -> int:
        return sum(1 for n, _, _ in self.kernels()
                   if names is None or any(f in n for f in names))

    def top_ops(self, n: int = 10) -> List[list]:
        acc: Dict[str, float] = {}
        for name, a, b in self.ops:
            acc[name] = acc.get(name, 0.0) + (b - a)
        return [[k[:120], v] for k, v in
                sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches of the window with no device
        operation, each labelled by the innermost span that holds its
        midpoint ("none" outside every span)."""
        w = self.window()
        if w is None:
            return []
        busy = merged([(max(a, w[0]), min(b, w[1])) for _, a, b in self.ops
                       if b > w[0] and a < w[1]])
        edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) / 2
            inside = [s for s in self.spans if s[1] <= mid <= s[2]]
            label = min(inside, key=lambda s: s[2] - s[1])[0] if inside \
                else "none"
            out.append([label, b - a])
        return out
