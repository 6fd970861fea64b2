"""Benchmark the Qwen2.5-VL vision tower on the card.

Port of ``vlm_clip_tpu/cli/bench_vision.py``: times the shipped tower
path, ``qwen_model.vision_forward`` as ``QwenVLGenerator._embed_prefill``
calls it, on random 3B-shape weights made on the device from a seed, at
the fixed 448x448 resolution policy (grid 32x32: S = 1024 patches, 16
uniform windows).

    python -m vlm_clip_tpu_torch.cli.bench_vision --dtype bf16 --batch 1 \\
        [--quant int8] [--path masked] [--device cpu]

Prints ms per call and per image; ``main`` returns them.
"""

from __future__ import annotations

import argparse
import time

import torch


def synth_vision_params(cfg, seed: int = 0, dtype=None, device="cuda"):
    """Random vision params in ``init_vision``'s tree (stacked [depth, ...]
    blocks), sized by ``cfg``, made on ``device`` (the card unless the
    caller asks for the CPU); ``dtype`` recasts the fp32 leaves."""
    from vlm_clip_tpu_torch.vlm.qwen_model import init_vision

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_vision(gen, cfg, device=device)
    if dtype is None:
        return params

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(dtype) if tree.dtype == torch.float32 else tree

    return cast(params)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--dtype", default="fp32", choices=("fp32", "bf16"),
                   help="weight storage dtype (activations always bf16)")
    p.add_argument("--quant", default="none", choices=("none", "int8"),
                   help="weight-only quantized linears (the extractor's "
                        "default is int8)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--size", type=int, default=448)
    p.add_argument("--reps", type=int, default=10, help="timed calls")
    p.add_argument("--path", default="fast", choices=("fast", "masked"),
                   help="fast = batched block-diagonal window attention "
                        "(the default for uniform grids); masked = dense "
                        "[S, S] additive-mask attention")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from vlm_clip_tpu_torch.cli.common import resolve_device
    from vlm_clip_tpu_torch.vlm.qwen_model import (qwen25vl_3b,
                                                   vision_forward)
    from vlm_clip_tpu_torch.vlm.qwen_process import prepare_vision_inputs

    dev = resolve_device(args.device)
    cfg = qwen25vl_3b().vision
    params = synth_vision_params(
        cfg, dtype=torch.bfloat16 if args.dtype == "bf16" else None,
        device=dev)
    if args.quant == "int8":
        from vlm_clip_tpu_torch.vlm.qwen_convert import quantize_qwen_params

        params = quantize_qwen_params({"vision": params}, 8)["vision"]

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (args.size, args.size, 3), np.uint8)
    vin = prepare_vision_inputs(img, cfg, fixed_resolution=args.size)
    S = vin.patches.shape[0]
    uw = vin.uniform_window if args.path == "fast" else None
    print(f"S={S} patches, grid={vin.grid}, uniform_window={uw}",
          flush=True)
    pat = torch.from_numpy(np.broadcast_to(
        vin.patches, (args.batch,) + vin.patches.shape).copy()).to(dev)
    rope = torch.from_numpy(vin.rot_pos_emb).to(dev)
    wmask = fmask = None
    if uw is None:
        wmask = torch.from_numpy(vin.window_mask).to(dev)
        fmask = torch.from_numpy(vin.full_mask).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def run():
        return vision_forward(params, pat.to(torch.bfloat16), rope, wmask,
                              fmask, cfg, uniform_window=uw)

    t0 = time.perf_counter()
    out = run()
    sync()
    print(f"first call: {time.perf_counter() - t0:.1f}s", flush=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = run()
        sync()
        times.append((time.perf_counter() - t0) / args.reps)
    dt = min(times)
    line = (f"dtype={args.dtype} quant={args.quant} B={args.batch} "
            f"size={args.size} path={args.path}: {dt * 1e3:.1f} ms/call -> "
            f"{dt / args.batch * 1e3:.2f} ms/image, "
            f"{args.batch / dt:.1f} img/s")
    print(line, flush=True)
    return {"line": line, "ms_per_call": dt * 1e3,
            "ms_per_image": dt / args.batch * 1e3,
            "shape": tuple(out.shape),
            "finite": bool(torch.isfinite(out.float()).all())}


if __name__ == "__main__":
    main()
