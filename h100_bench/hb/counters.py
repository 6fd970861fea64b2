"""The program's counters in a traced run, for the readers of the
program's counts.

The port (``vlm_clip_tpu_torch.utils.profiling``) adds to its counters
while a ``torch.profiler`` session collects, so a kind's profiled passes
hold them. ``take()`` hands over the spans and the counters recorded
since the last take and clears them, so the first reader to call
:func:`counts` takes once and keeps the whole take, spans and counters,
in ``ctx["program_take"]`` for every later reader. A program without the
tracer gives nothing.
"""

from __future__ import annotations


def counts(ctx: dict) -> dict:
    """The counters of the run's one take (empty where the program
    records none)."""
    if "program_take" not in ctx:
        from vlm_clip_tpu_torch.utils import profiling

        take = getattr(profiling, "take", None)
        ctx["program_take"] = take() if take is not None else None
    t = ctx["program_take"]
    return t["counts"] if t else {}
