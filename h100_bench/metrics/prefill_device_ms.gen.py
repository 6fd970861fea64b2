"""Device time of the traced batch's prefill (vision tower, embed
scatter, prefill, first sampling): the union of the device operations
that start between the program's ``qwen.prefill`` span's start and the
end of the first ``qwen.stop_check`` after it, which waits for them
before any decode forward is launched."""

from hb.program import named, program
from hb.trace import union_seconds


def read(ctx):
    p = program(ctx)
    if p is None:
        return None
    pre = named(p, "qwen.prefill")
    if not pre:
        return None
    a = pre[0][1]
    checks = [s for s in named(p, "qwen.stop_check") if s[1] >= a]
    if not checks:
        return None
    b = checks[0][2]
    ops = [(x, y) for _, x, y in ctx["trace"].ops if a <= x <= b]
    return 1e3 * union_seconds(ops) if ops else None
