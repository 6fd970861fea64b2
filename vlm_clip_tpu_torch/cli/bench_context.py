"""End-to-end VLM context extraction bench on the card.

Port of ``vlm_clip_tpu/cli/bench_context.py``: times the whole public
path pipeline V pays per image (host preprocessing -> vision tower ->
prefill -> decode) through ``QwenVLGenerator.generate_from_ids`` /
``generate_batch_from_ids`` on random 3B-shape weights made on the
device (the reference's checkpoint dims).

    python -m vlm_clip_tpu_torch.cli.bench_context --bits 8h4 --batch 8 \\
        [--u8] [--kv-bits 8] [--device cpu]

Prints seconds a call and an image and contexts an hour; ``main``
returns them.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--bits", default="8h4",
                   choices=("4", "8", "8h4", "mixed"))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--new", type=int, default=200,
                   help="tokens to decode (reference max_new_tokens=200)")
    p.add_argument("--size", type=int, default=448)
    p.add_argument("--max-len", type=int, default=1536,
                   help="KV-cache rows (the 448px, 200-token path needs "
                        "483)")
    p.add_argument("--u8", action="store_true",
                   help="raw uint8 patches and a normalization-folded "
                        "patch embed (the extractor's default)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="vision + prefill in sub-batches of this size "
                        "feeding one full-batch decode loop")
    p.add_argument("--kv-bits", type=int, default=16, choices=(8, 16),
                   help="8 = int8 KV cache")
    p.add_argument("--reps", type=int, default=3, help="timed calls")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from vlm_clip_tpu_torch.cli.bench_decode import \
        synth_quantized_text_params
    from vlm_clip_tpu_torch.cli.bench_vision import synth_vision_params
    from vlm_clip_tpu_torch.cli.common import resolve_device
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator
    from vlm_clip_tpu_torch.vlm.qwen_convert import (
        fold_qwen_patch_normalization, quantize_qwen_params)
    from vlm_clip_tpu_torch.vlm.qwen_model import qwen25vl_3b
    from vlm_clip_tpu_torch.vlm.qwen_process import prepare_vision_inputs

    dev = resolve_device(args.device)
    bits = args.bits if args.bits in ("mixed", "8h4") else int(args.bits)
    head_bits = 4 if bits in ("mixed", "8h4") else 0
    if bits == "8h4":  # int8 layers and an int4 untied head
        bits = 8
    cfg = qwen25vl_3b()
    if head_bits:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, tie_word_embeddings=False))
    print(f"synthesizing 3B-shape params (bits={bits}) ...", flush=True)
    text = synth_quantized_text_params(cfg.text, bits, head_bits,
                                       fused=True, device=dev)
    vision = synth_vision_params(cfg.vision, device=dev)
    if args.u8:
        vision = fold_qwen_patch_normalization(vision, cfg.vision)
    vision = quantize_qwen_params({"vision": vision}, 8)["vision"]
    gen = QwenVLGenerator({"text": text, "vision": vision}, cfg,
                          max_len=args.max_len, kv_bits=args.kv_bits)
    gen.u8_patches = args.u8

    rng = np.random.default_rng(0)
    vins = [prepare_vision_inputs(
        rng.integers(0, 255, (args.size, args.size, 3), np.uint8),
        cfg.vision, fixed_resolution=args.size, raw_uint8=args.u8)
        for _ in range(args.batch)]
    n_vis = vins[0].num_vision_tokens
    ids = np.asarray(
        [11, 22, cfg.vision_start_token_id] + [cfg.image_token_id] * n_vis
        + list(rng.integers(1, 10000, 24)), np.int64)
    print(f"prompt {len(ids)} tokens ({n_vis} vision) + {args.new} new",
          flush=True)

    def run():
        if args.batch == 1:
            return [gen.generate_from_ids(ids, vins[0],
                                          max_new_tokens=args.new)]
        return gen.generate_batch_from_ids(
            ids, vins, max_new_tokens=args.new,
            prefill_chunk=args.prefill_chunk)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    out = run()
    sync()
    print(f"first call: {time.perf_counter() - t0:.1f}s", flush=True)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = run()
        sync()
        times.append(time.perf_counter() - t0)
    n_tok = sum(len(o) for o in out) / len(out)
    dt = min(times)
    per_img = dt / args.batch
    line = (f"bits={args.bits} B={args.batch} u8={args.u8} "
            f"kv={args.kv_bits}: {dt:.2f} s/call -> {per_img:.3f} s/image "
            f"({n_tok:.0f} tokens), {3600 / per_img:.0f} contexts/hour")
    print(line, flush=True)
    return {"line": line, "s_per_call": dt, "s_per_image": per_img,
            "tokens": out}


if __name__ == "__main__":
    main()
