"""Share of an unprofiled batch in which the device is idle: 1 - the
traced busy time a batch (the union of the device operations' intervals
over the traced batches, over their number) over the window's mean batch
wall time. The profiler stretches the host's time, so the traced
window's own idle share would read high."""


def read(ctx):
    t = ctx.get("trace")
    walls = ctx.get("batch_walls")
    if t is None or not t.ops or not walls:
        return None
    busy = t.busy_seconds() / ctx["traced_batches"]
    return 100.0 * (1.0 - busy / (sum(walls) / len(walls)))
