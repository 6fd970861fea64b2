"""Kernel launches a decode forward: the kernels of one traced batch
less those of a traced prefill of the same batch, over the batch's
decode forwards. Traces can drop records: a floor."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or "prefill_kernels" not in ctx:
        return None
    new = ctx["traffic"]["max_new_tokens"]
    m = max(ctx["traced_lens"])
    fwd = new - 1 if m == new else m
    return (t.count() - ctx["prefill_kernels"]) / fwd
