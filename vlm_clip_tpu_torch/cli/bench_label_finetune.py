"""BASELINE config 5: ViT-L/14@336 adapter fine-tune with LLM-augmented
labels, driven end to end as one flow (port of
``vlm_clip_tpu/cli/bench_label_finetune.py``).

The reference README advertises the flow (gen_label -> adapter
fine-tune, README.md:14-27) but ships no runner for it; BASELINE.json
config 5 defines it as a benchmark. This CLI drives the whole thing:

1. a RAF-DB-shaped folder tree (synthetic JPEGs at source resolution,
   or ``--data-root`` for a real one);
2. ``cli/gen_label.py`` over the train split -> {path, emotion,
   caption} jsonl (the LLM-augmented labels; ``--vlm-backend qwen``
   with real weights, stub otherwise — caption TEXT does not affect
   train throughput, every caption tokenizes to the same padded 77);
3. decoded-uint8 pixel-cache build at 336 (data/pixel_cache.py — the
   deployment data path: epochs read mmap, host cores decode once);
4. pipeline-M adapter fine-tune (frozen ViT-L/14@336 towers forward in
   the FAST policy + adapter backward + AdamW; K1 and K3 on the card,
   K2's plain version past its 256 shared rows) with the jsonl captions
   routed in via ``RAFDBDataset(captions_jsonl=...)`` and the batches
   copied ahead by ``device_prefetch=2``.

Reports label-generation rate, cache-build rate, train pairs/s per
epoch (the first includes warmup) and the device-resident step: the
trainer's step on one batch already on the device, timed with CUDA
events on the card (the host clock on the CPU). Plus ``--device``
(default ``cuda``; ``--device cpu`` for a host without a card).

    python -m vlm_clip_tpu_torch.cli.bench_label_finetune --per-class 48
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional

RESIDENT_STEPS = 20  # timed steps of the device-resident rate


def synth_tree(root: str, per_class: int, res: int, val_per_class: int = 4
               ) -> int:
    """RAF-DB-shaped train/val tree of synthetic JPEGs; returns #train."""
    import numpy as np
    from PIL import Image

    from vlm_clip_tpu_torch.core.config import EMOTIONS

    rng = np.random.default_rng(0)
    n = 0
    for split, k in (("train", per_class), ("val", val_per_class)):
        for emo in EMOTIONS:
            d = os.path.join(root, split, emo)
            os.makedirs(d, exist_ok=True)
            for i in range(k):
                # smooth random field: JPEG-compressible, non-trivial
                x = rng.integers(0, 255, (res // 8, res // 8, 3),
                                 dtype=np.uint8)
                img = Image.fromarray(x).resize((res, res))
                img.save(os.path.join(d, f"{i:04d}.jpg"), quality=90)
                n += split == "train"
    return n


def _step_ms(step, state, batch, n_steps: int, device):
    """(ms a step over n_steps steps after one warmup step, the state
    after them): CUDA events on the card, the host clock on the CPU."""
    import torch

    state, m = step(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(n_steps):
            state, m = step(state, batch)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n_steps, state
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, m = step(state, batch)
    float(m.loss)
    return (time.perf_counter() - t0) * 1e3 / n_steps, state


def main(argv: Optional[List[str]] = None) -> dict:
    """Print the lines; returns the rates, the step count and the
    trainer (its state after the timed steps) with the resident batch."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default=None,
                   help="existing RAF-DB-shaped root (train/val splits); "
                        "default: synthesize one")
    p.add_argument("--per-class", type=int, default=48)
    p.add_argument("--source-res", type=int, default=448,
                   help="synthetic JPEG resolution (decode work)")
    p.add_argument("--model", default="vit-large-patch14-336")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--vlm-backend", default="stub",
                   choices=("stub", "qwen"))
    p.add_argument("--qwen-weights", default=None)
    p.add_argument("--tmpdir", default=None,
                   help="work directory (default: a fresh temporary one)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card")
    args = p.parse_args(argv)

    from vlm_clip_tpu_torch.cli import gen_label
    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.core.config import AdapterConfig
    from vlm_clip_tpu_torch.core.dtypes import FAST
    from vlm_clip_tpu_torch.data import native_loader
    from vlm_clip_tpu_torch.data.pixel_cache import PixelCache
    from vlm_clip_tpu_torch.data.rafdb import BatchLoader, RAFDBDataset
    from vlm_clip_tpu_torch.train.trainer_m import (CLIPAdapterTrainer,
                                                    device_batches)

    device = resolve_device(args.device)
    tmpdir = args.tmpdir or tempfile.mkdtemp(prefix="bench_config5")
    os.makedirs(tmpdir, exist_ok=True)
    out = {}
    root = args.data_root
    if root is None:
        root = os.path.join(tmpdir, "rafdb")
        t0 = time.perf_counter()
        n = synth_tree(root, args.per_class, args.source_res)
        print(f"synth tree: {n} train JPEGs @ {args.source_res}px "
              f"({time.perf_counter() - t0:.1f}s) -> {root}", flush=True)

    # --- 1. LLM-augmented labels (the gen_label CLI itself) ---------------
    jsonl = os.path.join(tmpdir, "labels.jsonl")
    t0 = time.perf_counter()
    gl_args = ["--data-dir", os.path.join(root, "train"), "--out", jsonl,
               "--vlm-backend", args.vlm_backend,
               "--clip-model-name", args.model, "--device", args.device]
    if args.qwen_weights:
        gl_args += ["--qwen-weights", args.qwen_weights]
    gen_label.main(gl_args)
    dt = time.perf_counter() - t0
    with open(jsonl) as f:
        n_lab = sum(1 for _ in f)
    out["labels_per_s"] = n_lab / dt
    print(f"gen_label ({args.vlm_backend}): {n_lab} labels in {dt:.1f}s "
          f"-> {out['labels_per_s']:.1f} labels/s", flush=True)

    # --- 2. backbone + datasets + pixel cache ------------------------------
    clip_params, cfg = load_backbone(args.model, device=device)
    size = cfg.vision.image_size
    tokenizer = make_tokenizer(cfg)
    train_ds = RAFDBDataset(root, "train", tokenizer, image_size=size,
                            captions_jsonl=jsonl)
    if not train_ds.captions:
        raise SystemExit("no captions loaded from the jsonl")
    t0 = time.perf_counter()
    cache = PixelCache.for_dataset(
        train_ds, os.path.join(tmpdir, f"pixcache{size}"))
    dt = time.perf_counter() - t0
    decoder = "native" if native_loader.native_available() else \
        f"PIL ({native_loader.unavailable_reason()})"
    out["cache_img_per_s"] = len(train_ds) / dt
    out["cache_mb"] = cache.pixels.nbytes / 1e6
    print(f"pixel cache @ {size}px: {len(train_ds)} images in {dt:.1f}s "
          f"-> {out['cache_img_per_s']:.0f} img/s ({out['cache_mb']:.0f} "
          f"MB mmap; {decoder} decoder)", flush=True)
    loader = BatchLoader(train_ds, args.batch, shuffle=True,
                         drop_last=True)

    # --- 3. adapter fine-tune ---------------------------------------------
    acfg = AdapterConfig(text_adapter_size=256, vision_adapter_size=256,
                         shared_adapter_layers=2)
    trainer = CLIPAdapterTrainer(
        clip_params, cfg, acfg, loader, val_dataloader=None,
        warmup_steps=10, output_dir=os.path.join(tmpdir, "ckpt"),
        num_epochs_hint=args.epochs, freeze_clip=True, policy=FAST,
        device_prefetch=2)
    hist = trainer.train(args.epochs, save_every=10 ** 6,
                         eval_every=10 ** 6)
    steps = len(loader)
    pairs = steps * args.batch
    out["epoch_pairs_per_s"] = [pairs / h["seconds"] for h in hist]
    out["losses"] = [h["train_loss"] for h in hist]
    for h, rate in zip(hist, out["epoch_pairs_per_s"]):
        print(f"  epoch {h['epoch']}: {h['seconds']:.1f}s ({rate:.1f} "
              f"pairs/s, loss {h['train_loss']:.4f})"
              + ("  <- includes warmup" if h["epoch"] == 1 else ""),
              flush=True)
    best = max(out["epoch_pairs_per_s"][1:] or out["epoch_pairs_per_s"])
    print(f"config 5 (ViT-L/14@{size} adapter fine-tune, LLM-augmented "
          f"labels, B={args.batch}): {best:.1f} pairs/s e2e", flush=True)

    # --- device-resident step rate ----------------------------------------
    # The epochs above pay each batch's upload; the trainer's step on one
    # batch already on the device gives the device's own rate.
    batch = next(device_batches(
        [train_ds.get_batch(list(range(args.batch)))], device))
    ms, trainer.state = _step_ms(trainer._step, trainer.state, batch,
                                 RESIDENT_STEPS, device)
    out["step_ms"] = ms
    out["step_pairs_per_s"] = args.batch * 1e3 / ms
    print(f"device-resident step: {ms:.2f} ms -> "
          f"{out['step_pairs_per_s']:.1f} pairs/s (H2D excluded; "
          f"{'CUDA events' if device.type == 'cuda' else 'host clock'})",
          flush=True)
    out["steps"] = args.epochs * steps + 1 + RESIDENT_STEPS
    out["trainer"], out["batch"] = trainer, batch
    return out


if __name__ == "__main__":
    main()
