"""EMOTIC training entry: adapter + VAD head over frozen CLIP (port of
``vlm_clip_tpu/cli/train_emotic.py``).

Data layout: ``--data-dir`` holding the npy arrays written by ``python -m
vlm_clip_tpu_torch.data.emotic_mat`` ({split}_{context,body,cat,cont}
_arr.npy). The reference's flags plus ``--device`` (default ``cuda``;
without a card it raises unless ``--device cpu`` is given). Trains, saves
the head (the reference's npz format), then evaluates mAP on
``--eval-split``. On a card the head's adapter runs kernel K6, forward
and backward.

    python -m vlm_clip_tpu_torch.cli.train_emotic --data-dir ./emotic_npy \\
        --num-epochs 10 --output ./emotic_head.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="EMOTIC multi-label + VAD training (frozen CLIP)")
    p.add_argument("--data-dir", required=True,
                   help="dir with emotic_mat converter npy outputs")
    p.add_argument("--clip-model-name", default="vit-base-patch16")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-epochs", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--alpha", type=float, default=0.2,
                   help="adapter blend (reference model_v.py alpha)")
    p.add_argument("--bottleneck", type=int, default=192)
    p.add_argument("--vad-weight", type=float, default=0.5)
    p.add_argument("--no-vad", action="store_true",
                   help="categories only (skip the VAD regression head)")
    p.add_argument("--output", default="./emotic_head.npz")
    p.add_argument("--eval-split", default="test",
                   choices=["val", "test", "none"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the "
                        "kernels' plain versions")
    return p


def main(argv=None) -> dict:
    """Returns the head, the per-epoch losses and seconds, and the eval
    result (None with ``--eval-split none``)."""
    args = build_parser().parse_args(argv)
    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.data import emotic as E
    from vlm_clip_tpu_torch.data.rafdb import BatchLoader
    from vlm_clip_tpu_torch.eval.emotic import evaluate_emotic
    from vlm_clip_tpu_torch.train.trainer_emotic import (save_emotic_head,
                                                         train_emotic)
    from vlm_clip_tpu_torch.utils.logging import (seed_everything,
                                                  setup_logging)

    device = resolve_device(args.device)
    setup_logging(name="train_emotic")
    seed_everything(args.seed)
    log = logging.getLogger(__name__)

    clip_params, cfg = load_backbone(args.clip_model_name, seed=args.seed,
                                     device=device)
    tokenizer = make_tokenizer(cfg)

    train_ds = E.EmoticPreDataset.from_dir(args.data_dir, "train")
    log.info("train: %d samples", len(train_ds))
    seconds = []
    head, losses = train_emotic(
        clip_params, cfg, tokenizer, train_ds,
        num_epochs=args.num_epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate, alpha=args.alpha,
        bottleneck=args.bottleneck, vad_weight=args.vad_weight,
        with_vad=not args.no_vad, seed=args.seed, epoch_seconds=seconds)
    log.info("final epoch loss: %.4f", losses[-1])
    save_emotic_head(args.output, head)
    log.info("saved head to %s", args.output)

    res = None
    if args.eval_split != "none":
        eval_ds = E.EmoticPreDataset.from_dir(args.data_dir,
                                              args.eval_split)
        loader = BatchLoader(eval_ds, batch_size=args.batch_size,
                             collate_fn=E.emotic_collate)
        res = evaluate_emotic(clip_params, cfg, tokenizer, loader,
                              adapter_params=head, alpha=args.alpha)
        log.info("%s split: mAP %.4f over %d samples", args.eval_split,
                 res["mAP"], res["num_samples"])
    return {"head": head, "losses": losses, "epoch_seconds": seconds,
            "eval": res}


if __name__ == "__main__":
    main()
