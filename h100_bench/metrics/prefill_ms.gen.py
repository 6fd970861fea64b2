"""Host time, synchronised before and after, of the generator's vision
tower, embed scatter and prefill of one batch (median of three)."""


def read(ctx):
    return ctx.get("prefill_ms")
