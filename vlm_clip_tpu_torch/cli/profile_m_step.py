"""Where the pipeline-M train step's time goes on the card.

Runs bench.py's step (ViT-B/16, adapters 256/256/2, FAST, Adam 3e-4, one
fixed random batch, B=96 by default) with the kernels (``impl="auto"``)
and with their plain versions (``impl="torch"``), with the contrastive
head plain (``fused_loss=False``, the reference's default) or through K4
(``--fused-loss on``), or both in one call (``--fused-loss both``): per
step the host-clock
time over 10 steps after 3 warmup steps, then ``torch.profiler`` over 3
steps for the device time by kernel, grouped. The device busy share is
the device time of a profiled step (the union of its kernels' device
intervals) over the host-clock time of an unprofiled one: the profiler's
own host overhead stretches a profiled step.

    python -m vlm_clip_tpu_torch.cli.profile_m_step [--batch-size 96]
        [--fused-loss off|on|both]

Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

# kernel-name fragments -> group, first match wins (the port's kernels
# before the library fragments: a name with "gemm" or "sm90_" in it would
# otherwise count as cuBLAS). In bf16, K3 fwd is three kernels
# (pnmlp_fwd_*), K3 bwd four (pnmlp_ln_fwd, pnmlp_bwd_*), K2 fwd five
# (cab_fwd_*) and K2 bwd eight (cab_bwd_*); on the TF32 tensor cores K1
# fwd is three (seqfwd_*) and K1 bwd five (seqbwd_*); the weight
# gradients are wgrad_kernel (CUDA cores), wgrad_mma_kernel (bf16 tensor
# cores), wgrad_tf32_kernel (compensated TF32) and split_sum_kernel,
# which adds their row chunks. K4's backward is one cluster kernel
# (contrastive_bwd_cluster_kernel) up to its batch limit, past it eight
# (its forward's norm, gemm and lse kernels, then dz, two gemms,
# norm_bwd, dls); its forward four (norm, gemm, lse, loss): their
# demangled names carry no file name, so each is named (and the
# backward's by its mangled length prefix too). K6 (pipeline T)
# is one cluster kernel a direction.
GROUPS = (
    ("K1 fwd", ("seq_adapter_fwd", "seqfwd_")),
    ("K1 bwd", ("seq_adapter_bwd", "seqbwd_")),
    ("K2 fwd", ("cross_attn_block_fwd", "cab_fwd")),
    ("K2 bwd", ("cross_attn_block_bwd", "cab_bwd")),
    ("K3 fwd", ("prenorm_mlp_fwd", "pnmlp_fwd")),
    ("K3 bwd", ("prenorm_mlp_bwd", "pnmlp_ln_fwd", "pnmlp_bwd")),
    ("K1-K3 bwd weight grads", ("wgrad_kernel", "wgrad_mma_kernel",
                                "wgrad_tf32_kernel", "split_sum_kernel")),
    ("K1-K3 bwd column sums", "colsum_kernel"),
    ("K4 bwd", ("contrastive_bwd", "::dz_kernel", "::dls_kernel",
                "::norm_bwd_kernel", "9dz_kernel", "10dls_kernel",
                "15norm_bwd_kernel")),
    ("K4 fwd", ("contrastive", "::norm_kernel", "::gemm_kernel",
                "::lse_kernel", "::loss_kernel")),
    ("K6 fwd", "feature_adapter_fwd"),
    ("K6 bwd", "feature_adapter_bwd"),
    ("cuBLAS/cuDNN products", ("gemm", "xmma", "cutlass", "sm90_", "cublas",
                               "nvjet")),
    ("softmax", "softmax"), ("reductions", "reduce"),
    ("elementwise and copies", ("elementwise", "copy", "fill", "index",
                                "cat", "memcpy", "memset")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, frags in GROUPS:
        frags = (frags,) if isinstance(frags, str) else frags
        if any(f in low for f in frags):
            return group
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile(step, state, batch, n: int = 3):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, m = step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    by_group = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        g = by_group[_group(e.name)]
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    return state, busy / n / 1e3, len(kernels) / n, {
        k: (v[0] / n / 1e3, v[1] / n) for k, v in by_group.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch-size", type=int, default=96)
    p.add_argument("--fused-loss", choices=("off", "on", "both"),
                   default="off", help="the contrastive head through K4 "
                   "(on), plain (off, the reference's default), or each "
                   "in turn in this call (both)")
    args = p.parse_args(argv)
    import torch

    from vlm_clip_tpu_torch.core.config import AdapterConfig, clip_preset
    from vlm_clip_tpu_torch.core.dtypes import FAST
    from vlm_clip_tpu_torch.models.clip import init_clip
    from vlm_clip_tpu_torch.train import optim
    from vlm_clip_tpu_torch.train.steps import (init_train_state,
                                                make_m_train_step)

    if not torch.cuda.is_available():
        raise SystemExit("profile_m_step needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    B, dev = args.batch_size, torch.device("cuda")
    cfg = clip_preset("vit-base-patch16")
    acfg = AdapterConfig(text_adapter_size=256, vision_adapter_size=256,
                         shared_adapter_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    clip = init_clip(gen, cfg, device=dev)
    batch = {
        "input_ids": torch.randint(1, cfg.text.vocab_size, (B, 77),
                                   generator=gen, device=dev),
        "attention_mask": torch.ones(B, 77, dtype=torch.int32, device=dev),
        "pixel_values": torch.randn(
            B, 3, cfg.vision.image_size, cfg.vision.image_size,
            generator=gen, device=dev).to(torch.bfloat16),
    }
    tx = optim.adam(3e-4)
    losses = {"off": (False,), "on": (True,),
              "both": (False, True)}[args.fused_loss]
    for impl, fused in [(i, f) for i in ("auto", "torch", "auto", "torch")
                        for f in losses]:
        state = init_train_state(torch.Generator(device=dev).manual_seed(1),
                                 cfg, acfg, tx, clip_params=clip,
                                 device=dev)
        step = make_m_train_step(cfg, acfg, tx, FAST, freeze_clip=True,
                                 impl=impl, fused_loss=fused)
        for _ in range(3):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            state, m = step(state, batch)
        float(m.loss)
        ms = (time.perf_counter() - t0) * 100
        state, dev_ms, launches, groups = profile(step, state, batch)
        label = ("kernels" if impl == "auto" else "plain versions") + (
            f", K4 {'on' if fused else 'off'}" if len(losses) > 1 else "")
        print(f"\n{label}: step {ms:.2f} ms ({B * 1e3 / ms:.1f} pairs/s), "
              f"device time {dev_ms:.2f} ms a step, device busy "
              f"{100 * min(dev_ms / ms, 1.0):.1f}%, {launches:.0f} device "
              f"kernels a step", flush=True)
        for g, (gms, cnt) in sorted(groups.items(),
                                    key=lambda kv: -kv[1][0]):
            print(f"  {g:28s} {gms:8.3f} ms  {cnt:6.0f} launches",
                  flush=True)


if __name__ == "__main__":
    main()
