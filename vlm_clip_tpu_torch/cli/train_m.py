"""Pipeline-M training entry (port of ``vlm_clip_tpu/cli/train_m.py``).

Same flags as the reference, plus ``--device`` (default ``cuda``; without
a card it raises unless ``--device cpu`` is given). The backbone is HF
weights where ``--clip-model-name`` loads (a checkpoint directory or a
hub id in the HF cache), else a seeded random init, logged as such, and
the tokenizer the best available (the hash fallback when no CLIP vocab
is installed beside random weights). After training, the test split's
contrastive loss is logged.

Data parallelism: launched under a PyTorch launcher's variables
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; e.g. ``torchrun --nproc-per-node N``), every rank (one
GPU) takes its rows of each ``--batch-size`` batch and the step computes
the global-batch loss; ``--zero1`` also shards Adam's moments over the
ranks. Without a launcher there is one rank, and ``--zero1`` keeps the
whole state on it.

    python -m vlm_clip_tpu_torch.cli.train_m --data-root RAF-DB/ \\
        [--device cpu]
    torchrun --nproc-per-node 8 -m vlm_clip_tpu_torch.cli.train_m \\
        --data-root RAF-DB/ --zero1
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Contrastive CLIP-adapter "
                                            "fine-tuning (pipeline M)")
    p.add_argument("--data-root", required=True,
                   help="RAF-DB root with train/val/test split dirs")
    p.add_argument("--clip-model-name", default="vit-base-patch32")
    p.add_argument("--text-adapter-size", type=int, default=256)
    p.add_argument("--vision-adapter-size", type=int, default=256)
    p.add_argument("--shared-adapter-layers", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-epochs", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=5e-5)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--output-dir", default="./clip_adapter_checkpoints")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--full-finetune", action="store_true",
                   help="unfreeze the CLIP backbone")
    p.add_argument("--schedule", default="linear",
                   choices=["constant", "linear", "cosine"],
                   help="cosine + --full-finetune = the AdamW+cosine "
                        "full fine-tune recipe")
    p.add_argument("--image-size", type=int, default=None,
                   help="defaults to the model config image size")
    p.add_argument("--captions", default=None,
                   help="jsonl of generated captions ({path, emotion, "
                        "caption}); images present in it train against "
                        "their caption instead of a prompt-bank draw")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--zero1", action="store_true",
                   help="shard the Adam moments over the ranks of the "
                        "process group (ZeRO-1; one rank per GPU)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the "
                        "kernels' plain versions")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    """Train, then evaluate on the test split; returns the epoch history
    and the test loss."""
    args = build_parser().parse_args(argv)
    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.parallel.distributed import (global_mesh,
                                                         maybe_initialize)

    device = resolve_device(args.device)
    # multi-process: before the first use of the card
    distributed = maybe_initialize(device=device.type)
    from vlm_clip_tpu_torch.core.config import AdapterConfig
    from vlm_clip_tpu_torch.data.rafdb import create_dataloaders
    from vlm_clip_tpu_torch.train.trainer_m import CLIPAdapterTrainer
    from vlm_clip_tpu_torch.utils.logging import (seed_everything,
                                                  setup_logging)

    setup_logging(name="train_m")
    seed_everything(args.seed)
    log = logging.getLogger(__name__)

    clip_params, cfg = load_backbone(args.clip_model_name, seed=args.seed,
                                     device=device)
    tokenizer = make_tokenizer(cfg)
    image_size = args.image_size or cfg.vision.image_size
    acfg = AdapterConfig(text_adapter_size=args.text_adapter_size,
                         vision_adapter_size=args.vision_adapter_size,
                         shared_adapter_layers=args.shared_adapter_layers)
    loaders = create_dataloaders(args.data_root, tokenizer,
                                 batch_size=args.batch_size,
                                 image_size=image_size,
                                 captions_jsonl=args.captions)
    trainer = CLIPAdapterTrainer(
        clip_params, cfg, acfg, loaders["train"],
        val_dataloader=loaders.get("val"),
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, max_grad_norm=args.max_grad_norm,
        output_dir=args.output_dir, num_epochs_hint=args.num_epochs,
        freeze_clip=not args.full_finetune, schedule=args.schedule,
        seed=args.seed, zero1_mesh=global_mesh(device=device.type)
        if args.zero1 and distributed else None)
    history = trainer.train(args.num_epochs, save_every=args.save_every,
                            eval_every=args.eval_every)
    log.info("training history: %s", history)

    trainer.val_dataloader = loaders["test"]
    test_loss = trainer.evaluate()
    log.info("test loss: %.4f", test_loss)
    return {"history": history, "test_loss": test_loss}


if __name__ == "__main__":
    main()
