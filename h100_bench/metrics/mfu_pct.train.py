"""Model operations of the window's steps (towers forward, adapters
forward and backward, loss; no recompute) over its wall time, as a share
of the bf16 peak."""

from hb.common import PEAK_BF16_FLOPS
from hb.costs import m_step_flops


def read(ctx):
    flops = m_step_flops(ctx["config"], ctx["batch"]) * ctx["steps"]
    return 100.0 * flops / ctx["window_s"] / PEAK_BF16_FLOPS
