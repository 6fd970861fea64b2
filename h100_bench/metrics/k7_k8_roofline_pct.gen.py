"""Share of their roofline that the int4 head's GEMV (K7, ops/quant) and
the decode attention (K8, ops/decode_attention) reach over one traced
batch: their calls' summed bound (each live row's head product and
cache columns, bytes over the HBM bandwidth or operations over the bf16
peak) over their summed device time."""

from hb.costs import bound_s, k7_bytes, k7_flops, k8_bytes, k8_flops

K7 = ("qmm4_",)
K8 = ("decode_attention",)


def read(ctx):
    t = ctx.get("trace")
    if t is None or "traced_lens" not in ctx:
        return None
    cfg, lens, T = ctx["config"], ctx["traced_lens"], ctx["prompt_len"]
    new = ctx["traffic"]["max_new_tokens"]
    m = max(lens)
    fwd = new - 1 if m == new else m
    bound = bound_s(k7_flops(cfg, len(lens)), k7_bytes(cfg, len(lens)))
    for s in range(fwd):
        live = [T + s for n in lens if n > s]
        if not live:
            continue
        bound += bound_s(k7_flops(cfg, len(live)), k7_bytes(cfg, len(live)))
        bound += cfg["num_hidden_layers"] * bound_s(k8_flops(cfg, live),
                                                    k8_bytes(cfg, live))
    dev_s = t.device_seconds(K7 + K8)
    return 100.0 * bound / dev_s if dev_s > 0 else None
