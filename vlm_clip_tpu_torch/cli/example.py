"""Worked example (port of ``vlm_clip_tpu/cli/example.py``; reference
example.py:8-112): param-count report, short pipeline-M adapter training
(``train/trainer_m``: kernels K1-K3 forward and backward on a card),
best-checkpoint reload, and a text<->image cosine-retrieval demo on the
test loader. The reference's flags plus ``--device`` (default ``cuda``;
without a card it raises unless ``--device cpu`` is given).

    python -m vlm_clip_tpu_torch.cli.example --data-root RAF-DB/ \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    """Returns the parameter counts, the training history and the demo's
    [4, n_captions] similarities."""
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--clip-model-name", default="vit-base-patch32")
    p.add_argument("--num-epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--output-dir", default="./example_checkpoints")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the "
                        "kernels' plain versions")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.core.config import AdapterConfig
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.data.captions import all_descriptions_flat
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch
    from vlm_clip_tpu_torch.data.rafdb import create_dataloaders
    from vlm_clip_tpu_torch.models import layers as L
    from vlm_clip_tpu_torch.models import model_m as M
    from vlm_clip_tpu_torch.train.trainer_m import CLIPAdapterTrainer
    from vlm_clip_tpu_torch.utils.misc import count_trainable_params

    device = resolve_device(args.device)
    clip_params, cfg = load_backbone(args.clip_model_name, device=device)
    tokenizer = make_tokenizer(cfg)
    acfg = AdapterConfig()

    # parameter-count report (example.py:31-35)
    n_clip = count_trainable_params(clip_params)
    adapters = M.init_m_adapters(torch.Generator(device=device).manual_seed(0),
                                 cfg, acfg, device=device)
    n_adapt = count_trainable_params(adapters)
    print(f"Frozen CLIP parameters:     {n_clip:,}")
    print(f"Trainable adapter params:   {n_adapt:,} "
          f"({100.0 * n_adapt / (n_clip + n_adapt):.2f}%)")

    loaders = create_dataloaders(args.data_root, tokenizer,
                                 batch_size=args.batch_size,
                                 image_size=cfg.vision.image_size)
    trainer = CLIPAdapterTrainer(
        clip_params, cfg, acfg, loaders["train"],
        val_dataloader=loaders.get("val"), output_dir=args.output_dir,
        num_epochs_hint=args.num_epochs)
    history = trainer.train(args.num_epochs)

    best = os.path.join(args.output_dir, "best_adapter")
    if os.path.exists(best):
        trainer.load_model(best)
        print(f"reloaded best checkpoint from {best}")

    # retrieval demo (example.py:80-109): rank captions for test images
    captions = all_descriptions_flat()
    ids, mask = tokenizer(captions)
    state = trainer.state
    with torch.no_grad():
        txt = M.m_get_text_features(state.clip_params, state.adapter_params,
                                    torch.from_numpy(ids).to(device),
                                    torch.from_numpy(mask).to(device), cfg,
                                    acfg, BF16)
        txt = L.l2_normalize(txt).float()
        batch = next(iter(loaders["test"]))
        px = normalize_batch(torch.from_numpy(batch.images[:4]).to(device))
        img = M.m_get_image_features(state.clip_params,
                                     state.adapter_params, px, cfg, acfg,
                                     BF16)
        img = L.l2_normalize(img).float()
        sims = (img @ txt.T).cpu().numpy()
    for i in range(sims.shape[0]):
        top = np.argsort(-sims[i])[:3]
        print(f"\nimage {i} (true: "
              f"{batch.paths[i] if batch.paths else '?'}):")
        for r, j in enumerate(top):
            print(f"  {r + 1}. [{sims[i, j]:.3f}] {captions[j]}")
    return {"n_clip": n_clip, "n_adapt": n_adapt, "history": history,
            "sims": sims}


if __name__ == "__main__":
    main()
