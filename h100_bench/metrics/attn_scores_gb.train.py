"""Attention scores the towers write to device memory a training step,
in GB (1e9 B): the program's counter ``layers.attn_score_bytes`` (the
bytes of the score tensors its unfused attention builds, 0 for a fused
call) over its counter ``m.steps``, both of the traced steps' take.
None where the program lacks either counter."""

from hb.counters import counts


def read(ctx):
    c = counts(ctx)
    if "layers.attn_score_bytes" not in c or not c.get("m.steps"):
        return None
    return c["layers.attn_score_bytes"] / c["m.steps"] / 1e9
