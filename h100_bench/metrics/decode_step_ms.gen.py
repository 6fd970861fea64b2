"""The window's batches' wall time less their prefills, over their
decode forwards (a batch runs until its longest row ends)."""


def read(ctx):
    if ctx.get("prefill_ms") is None:
        return None
    B, new = ctx["traffic"]["batch"], ctx["traffic"]["max_new_tokens"]
    lens = ctx["decoded"]
    fwd = 0
    for i in range(len(ctx["batch_walls"])):
        m = max(lens[i * B:(i + 1) * B])
        fwd += new - 1 if m == new else m
    wall_ms = 1e3 * sum(ctx["batch_walls"])
    return (wall_ms - len(ctx["batch_walls"]) * ctx["prefill_ms"]) / fwd
