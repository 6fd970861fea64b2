"""Share of an unprofiled step in which the device is idle: 1 - the
traced busy time a step (the union of the device operations' intervals
over the traced steps, over their number) over the unprofiled window's
wall time a step. The profiler stretches a step's host time, so the
traced window's own idle share would read high."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.ops or not ctx["steps"]:
        return None
    busy = t.busy_seconds() / ctx["traced_steps"]
    return 100.0 * (1.0 - busy / (ctx["window_s"] / ctx["steps"]))
