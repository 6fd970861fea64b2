"""LLM-augmented label generator (port of ``vlm_clip_tpu/cli/gen_label.py``).

For every image of a folder-per-class tree, a VLM description, written
as a jsonl of ``{path, emotion, caption}`` records usable as contrastive
captions (pipeline M) or contexts (pipeline V). Images go in chunks of
``--chunk``, each one batched extraction where the backend has one.

Each chunk is decoded by the threaded C++ batch decoder
(``data/native_loader``, bilinear) where it builds, else, and with
``--no-native``, image by image with PIL (bicubic, as CLIPProcessor).

One difference from the reference: where a chunk's batched extraction
raises, the chunk is retried one image at a time, so one bad image
leaves only its own caption null (the reference nulls the whole
chunk's captions). Plus ``--device`` (default ``cuda``; ``--device
cpu`` for a host without a card).

    python -m vlm_clip_tpu_torch.cli.gen_label --data-dir root/ \\
        --out labels.jsonl [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def _captions(extractor, imgs) -> list:
    """One caption (or None) an image: the batched extraction where the
    backend has one, and where it raises, each image alone (None where
    that raises too)."""
    if hasattr(extractor, "extract_contexts_batch"):
        try:
            return list(extractor.extract_contexts_batch(imgs))
        except Exception as e:
            print(f"  batched extraction failed ({e}); retrying the "
                  f"chunk's {len(imgs)} images one at a time", flush=True)
    out = []
    for im in imgs:
        try:
            out.append(extractor.extract_context_from_image(im))
        except Exception:
            out.append(None)  # None-on-error contract
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    """Write the jsonl; returns {"records", "captions"}."""
    p = argparse.ArgumentParser(description="Generate LLM-augmented "
                                            "labels/captions per image")
    p.add_argument("--data-dir", required=True,
                   help="root/{emotion}/ image tree")
    p.add_argument("--out", required=True, help="output jsonl path")
    p.add_argument("--clip-model-name", default="vit-large-patch14")
    p.add_argument("--vlm-backend", default="stub",
                   choices=["stub", "qwen"])
    p.add_argument("--qwen-weights", default=None)
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--chunk", type=int, default=64,
                   help="decode + extract batch size")
    p.add_argument("--no-native", action="store_true",
                   help="per-image PIL decode instead of the threaded "
                        "C++ batch decoder")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card")
    args = p.parse_args(argv)

    from pathlib import Path

    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.cli.main_v import make_extractor
    from vlm_clip_tpu_torch.core.config import EMOTIONS
    from vlm_clip_tpu_torch.data import native_loader
    from vlm_clip_tpu_torch.data.preprocess import load_and_resize
    from vlm_clip_tpu_torch.data.rafdb import scan_class_folders

    device = resolve_device(args.device)
    clip_params, cfg = load_backbone(args.clip_model_name, device=device)
    tokenizer = make_tokenizer(cfg)
    extractor = make_extractor(args.vlm_backend, clip_params, cfg,
                               tokenizer, qwen_weights=args.qwen_weights)

    samples = scan_class_folders(Path(args.data_dir))
    use_native = not args.no_native and native_loader.native_available()
    n_ok = 0
    with open(args.out, "w") as f:
        for off in range(0, len(samples), args.chunk):
            group = samples[off:off + args.chunk]
            imgs = [None] * len(group)
            if use_native:
                batch, ok = native_loader.load_batch_native(
                    [p for p, _ in group], args.image_size)
                for j, good in enumerate(ok):
                    if good:
                        imgs[j] = batch[j]
            else:
                for j, (path, _) in enumerate(group):
                    try:
                        imgs[j] = load_and_resize(path, args.image_size)
                    except Exception:
                        imgs[j] = None
            valid = [j for j, im in enumerate(imgs) if im is not None]
            caps = [None] * len(group)
            if valid:
                got = _captions(extractor, [imgs[j] for j in valid])
                for j, c in zip(valid, got):
                    caps[j] = c
            for (path, label), caption in zip(group, caps):
                f.write(json.dumps({"path": path,
                                    "emotion": EMOTIONS[label],
                                    "caption": caption}) + "\n")
                n_ok += caption is not None
            done = off + len(group)
            if done % 256 < args.chunk:
                print(f"  {done}/{len(samples)} labeled", flush=True)
    print(f"wrote {len(samples)} records ({n_ok} with captions, "
          f"{'native' if use_native else 'PIL'} decode) -> {args.out}")
    return {"records": len(samples), "captions": n_ok}


if __name__ == "__main__":
    main()
