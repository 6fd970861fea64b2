"""Model operations of the window's work over its wall time, as a share
of the bf16 peak: for every request prefilled, its image's vision tower
and its prompt's prefill; for every token decoded after a request's
first, one forward attending its depth; no padding and no finished
row's work."""

from hb.common import PEAK_BF16_FLOPS
from hb.costs import (qwen_decode_token_flops, qwen_prefill_flops,
                      qwen_vision_flops)


def read(ctx):
    cfg, T = ctx["config"], ctx["prompt_len"]
    per_req = qwen_vision_flops(cfg, ctx["traffic"]["image_size"]) \
        + qwen_prefill_flops(cfg, T)
    flops = ctx["installs"] * per_req
    for n in ctx["decoded"]:
        flops += sum(qwen_decode_token_flops(cfg, T + i)
                     for i in range(max(0, n - 1)))
    return 100.0 * flops / ctx["window_s"] / PEAK_BF16_FLOPS
