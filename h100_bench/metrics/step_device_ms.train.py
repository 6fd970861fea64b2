"""Device time a training step, from the trace: the union of the device
operations' intervals over the traced steps, over their number."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.ops:
        return None
    return 1e3 * t.busy_seconds() / ctx["traced_steps"]
