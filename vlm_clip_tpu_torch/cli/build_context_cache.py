"""Offline VLM context-cache builder (port of
``vlm_clip_tpu/cli/build_context_cache.py``).

Run once ahead of training, then train with ``--vlm-backend=cache``: the
VLM never runs inside the data loader. Writes ``<out>/contexts.json``
(key -> description | null) and ``<out>/features.npz`` (key -> [P]
normalized CLIP text features). Every entry is recorded under BOTH
``CachedContextExtractor`` keys:

- the image PATH hash, the training pipeline's key;
- the decoded-and-resized uint8 CONTENT hash, the serving key
  (``cli/serve`` sees only uploaded bytes and resizes them with the same
  ``load_and_resize``, so the content hash matches when ``--image-size``
  equals the serving model's image size).

Extraction is batched (``--batch-size`` images a batched decode where the
backend has one) and the ragged tail goes per image. The reference's
flags plus ``--device`` (default ``cuda``; ``--device cpu`` for a host
without a card).

    python -m vlm_clip_tpu_torch.cli.build_context_cache \\
        --data-dir root/ --out-dir cache/ [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Precompute VLM context "
                                            "descriptions + CLIP features")
    p.add_argument("--data-dir", required=True,
                   help="root/{emotion}/ image tree")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--clip-model-name", default="vit-large-patch14")
    p.add_argument("--vlm-backend", default="stub",
                   choices=["stub", "qwen"])
    p.add_argument("--qwen-weights", default=None,
                   help="dir with Qwen2.5-VL safetensors + tokenizer.json "
                        "for --vlm-backend=qwen")
    p.add_argument("--qwen-kv-bits", type=int, default=16,
                   choices=(8, 16),
                   help="8 = int8 KV cache (halves decode cache reads)")
    p.add_argument("--qwen-quant-bits", default="8h4",
                   choices=["0", "4", "8", "8h4", "mixed"],
                   help="8h4 = int8 layers + int4 untied head; mixed = "
                        "int4 gate/up too")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=8,
                   help="images per batched VLM decode")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    """Build the cache; returns {"images", "keys", "failures"}."""
    args = build_parser().parse_args(argv)
    from pathlib import Path

    import numpy as np

    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.cli.main_v import make_extractor
    from vlm_clip_tpu_torch.data.preprocess import load_and_resize
    from vlm_clip_tpu_torch.data.rafdb import scan_class_folders
    from vlm_clip_tpu_torch.vlm.extractor import CachedContextExtractor

    device = resolve_device(args.device)
    clip_params, cfg = load_backbone(args.clip_model_name, seed=args.seed,
                                     device=device)
    tokenizer = make_tokenizer(cfg)
    extractor = make_extractor(args.vlm_backend, clip_params, cfg,
                               tokenizer, qwen_weights=args.qwen_weights,
                               qwen_quant_bits=args.qwen_quant_bits,
                               qwen_kv_bits=args.qwen_kv_bits)

    samples = scan_class_folders(Path(args.data_dir))
    texts, feats = {}, {}
    n_fail = 0
    batched = hasattr(extractor, "extract_contexts_batch") \
        and args.batch_size > 1

    def record(keys, desc):
        nonlocal n_fail
        f = extractor.encode_context_descriptions(desc)
        if f is None:
            n_fail += 1
        for key in keys:
            texts[key] = desc
            if f is not None:
                feats[key] = np.asarray(f, np.float32).reshape(-1)

    pending = []  # (keys, img) awaiting a batched decode
    for i, (path, _label) in enumerate(samples):
        pkey = CachedContextExtractor.key_for(path)
        try:
            img = load_and_resize(path, args.image_size)
        except Exception:
            texts[pkey] = None
            n_fail += 1
            continue
        # path key for training lookups + content key for serving
        keys = (pkey, CachedContextExtractor.key_for(img))
        if batched:
            pending.append((keys, img))
            if len(pending) == args.batch_size:
                descs = extractor.extract_contexts_batch(
                    [im for _, im in pending])
                for (ks, _), d in zip(pending, descs):
                    record(ks, d)
                pending = []
        else:
            record(keys, extractor.extract_context_from_image(img))
        if (i + 1) % 100 == 0:
            print(f"  {i + 1}/{len(samples)} contexts built")
    for ks, im in pending:  # ragged tail: per-image path
        record(ks, extractor.extract_context_from_image(im))

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "contexts.json"), "w") as f:
        json.dump(texts, f)
    np.savez(os.path.join(args.out_dir, "features.npz"), **feats)
    print(f"cached {len(samples)} images under {len(texts)} keys "
          f"({n_fail} failures) -> {args.out_dir}")
    return {"images": len(samples), "keys": len(texts), "failures": n_fail}


if __name__ == "__main__":
    main()
