"""Pipeline-T entry: zero-shot vs adapter comparison (port of
``vlm_clip_tpu/cli/compare_t.py``).

Builds the zero-shot baseline and the CLIP-Adapter on the same backbone
(``cli/common.load_backbone``: HF weights, else a seeded random init),
trains the
adapters, then runs the 2x2 {model} x {avg, all-descriptions} comparison
with plots. Same flags as the reference plus ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu`` is given).

    python -m vlm_clip_tpu_torch.cli.compare_t --train-dir train/ \\
        --test-dir test/ [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Zero-shot vs CLIP-Adapter "
                                            "comparison (pipeline T)")
    p.add_argument("--train-dir", required=True,
                   help="flat root/{emotion}/ train folder")
    p.add_argument("--test-dir", required=True)
    p.add_argument("--clip-model-name", default="vit-large-patch14")
    p.add_argument("--bottleneck-dim", type=int, default=64)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--beta", type=float, default=0.2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-epochs", type=int, default=5)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--image-size", type=int, default=None,
                   help="defaults to the model config image size")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the "
                        "kernels' plain versions")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Train and compare; prints and returns the accuracy dict (with the
    trained model's per-epoch losses under ``"losses"``)."""
    args = build_parser().parse_args(argv)
    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.data.rafdb import BatchLoader, FolderDataset
    from vlm_clip_tpu_torch.eval.compare import compare_models
    from vlm_clip_tpu_torch.models.model_t import (CLIPAdapterT,
                                                   ZeroShotEmotionRecognition)
    from vlm_clip_tpu_torch.utils.logging import (seed_everything,
                                                  setup_logging)

    device = resolve_device(args.device)
    setup_logging(name="compare_t")
    seed_everything(args.seed)

    clip_params, cfg = load_backbone(args.clip_model_name, seed=args.seed,
                                     device=device)
    tokenizer = make_tokenizer(cfg)
    image_size = args.image_size or cfg.vision.image_size
    zero_shot = ZeroShotEmotionRecognition(clip_params, cfg, tokenizer)
    adapter = CLIPAdapterT(clip_params, cfg, tokenizer, alpha=args.alpha,
                           beta=args.beta,
                           bottleneck_dim=args.bottleneck_dim,
                           seed=args.seed)

    train_ds = FolderDataset(args.train_dir, image_size=image_size)
    test_ds = FolderDataset(args.test_dir, image_size=image_size)
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               drop_last=True, seed=args.seed)
    test_loader = BatchLoader(test_ds, args.batch_size)

    losses = adapter.train(train_loader, num_epochs=args.num_epochs,
                           learning_rate=args.learning_rate)
    results = compare_models(adapter, zero_shot, test_loader,
                             use_all_descriptions=True,
                             plots=not args.no_plots, out_dir=args.out_dir)
    print(results)
    return {**results, "losses": losses}


if __name__ == "__main__":
    main()
