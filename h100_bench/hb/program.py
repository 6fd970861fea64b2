"""The program's own spans in a traced run, for the readers of the
program's layers.

The port (``vlm_clip_tpu_torch.utils.profiling``) records its spans while
a ``torch.profiler`` session collects, so a kind's profiled passes hold
them, on the clock of the device's records. The first reader to call
:func:`program` takes them from the program, keeps the spans that lie
inside the run's trace (its last profiled pass) and merges them into
that trace's spans, beside the benchmark's own: the breakdown's idle
gaps are then labelled by the innermost program span.

That merge is a side effect of the first call, and ``run.py`` builds the
breakdown after it has read every metric of the cell. So a cell's gaps
carry program span names only where one of its metrics calls
:func:`program` (``prefill_device_ms.gen`` in ctx_gen_b32); in a cell
with no such metric (m_train_b96) they keep the benchmark's labels. Only
device time is read from these passes: the profiler slows the host's
launch path, so a span's own length there is not the unprofiled
program's. A program without the tracer gives nothing.
"""

from __future__ import annotations

from typing import Optional


def program(ctx: dict) -> Optional[list]:
    """The program's spans ``[(name, start_s, end_s, id, parent_id)]``
    inside the run's trace, or None (no trace, or a program that records
    no spans)."""
    if "program_spans" in ctx:
        return ctx["program_spans"]
    ctx["program_spans"] = None
    t = ctx.get("trace")
    w = t.window() if t is not None else None
    if w is None:
        return None
    from vlm_clip_tpu_torch.utils import profiling

    take = getattr(profiling, "take", None)
    if take is None:
        return None
    spans = [(name, a * 1e-9, b * 1e-9, sid, parent)
             for sid, parent, name, a, b in take()["spans"]
             if w[0] <= a * 1e-9 and b * 1e-9 <= w[1]]
    if not spans:
        return None
    t.spans = sorted(t.spans + [s[:3] for s in spans], key=lambda s: s[1])
    ctx["program_spans"] = spans
    return spans


def named(spans: list, name: str) -> list:
    """The spans called ``name``, in order of their start."""
    return sorted((s for s in spans if s[0] == name), key=lambda s: s[1])
