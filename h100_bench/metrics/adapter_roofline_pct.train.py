"""Share of their roofline that the adapter kernels (K1-K3 forward and
backward, ``ops/fused_adapter``) reach: the summed bound of a step's
calls over their summed device time a step in the trace."""

from hb.costs import adapter_step_bound_s

# kernel-name fragments of ops/fused_adapter's K1-K3 (csrc/fused_adapter.cu)
ADAPTER_KERNELS = (
    "seq_adapter_fwd", "seqfwd_", "seq_adapter_bwd", "seqbwd_",
    "cross_attn_block_fwd", "cab_fwd", "cross_attn_block_bwd", "cab_bwd",
    "prenorm_mlp_fwd", "pnmlp_fwd", "prenorm_mlp_bwd", "pnmlp_ln_fwd",
    "pnmlp_bwd", "wgrad_kernel", "wgrad_mma_kernel", "wgrad_tf32_kernel",
    "split_sum_kernel", "colsum_kernel")


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    dev_s = t.device_seconds(ADAPTER_KERNELS) / ctx["traced_steps"]
    if dev_s <= 0:
        return None
    return 100.0 * adapter_step_bound_s(ctx["config"], ctx["batch"]) / dev_s
