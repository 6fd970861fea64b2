"""Single-image demo (port of ``vlm_clip_tpu/cli/predict_image.py``): one
image -> per-class probabilities, printed with the prompt bank used, plus
a probability bar-chart png where matplotlib is installed.

Same flags as the reference plus ``--device`` (default ``cuda``; without
a card it raises unless ``--device cpu`` is given). ``--adapter-ckpt``
takes a T (or V) feature-adapter checkpoint, loaded as the reference
loads it here: the adapters present replace the fresh ones, the rest
stay (no strict check).

    python -m vlm_clip_tpu_torch.cli.predict_image face.jpg \\
        [--adapter-ckpt t.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Classify one image; returns its [7] probabilities."""
    p = argparse.ArgumentParser(description="Classify one image with the "
                                            "zero-shot / adapter models")
    p.add_argument("image")
    p.add_argument("--clip-model-name", default="vit-large-patch14")
    p.add_argument("--adapter-ckpt", default=None,
                   help="T-style adapter checkpoint (fc1/fc2 dicts); "
                        "omit for pure zero-shot")
    p.add_argument("--all-descriptions", action="store_true")
    p.add_argument("--plot-out", default="single_image_probs.png")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the "
                        "kernels' plain versions")
    args = p.parse_args(argv)

    import torch

    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.core.config import EMOTIONS
    from vlm_clip_tpu_torch.data.captions import get_emotion_descriptions
    from vlm_clip_tpu_torch.data.preprocess import preprocess_host
    from vlm_clip_tpu_torch.models.model_t import (CLIPAdapterT,
                                                   ZeroShotEmotionRecognition)

    device = resolve_device(args.device)
    clip_params, cfg = load_backbone(args.clip_model_name, device=device)
    tokenizer = make_tokenizer(cfg)
    if args.adapter_ckpt:
        from vlm_clip_tpu_torch.train.checkpoint import load_v_adapters

        model = CLIPAdapterT(clip_params, cfg, tokenizer)
        loaded = load_v_adapters(args.adapter_ckpt, device=device)
        if loaded:
            model.adapter_params.update(loaded)
        model.update_emotion_embeddings()
    else:
        model = ZeroShotEmotionRecognition(clip_params, cfg, tokenizer)

    px = torch.from_numpy(preprocess_host(args.image,
                                          cfg.vision.image_size)[None])
    px = px.to(device)
    if args.all_descriptions:
        probs = model.predict_with_all_descriptions(px)
    else:
        probs = model.predict(px)
    probs = probs.float().cpu().numpy()[0]

    print(f"\nPredictions for {args.image}:")
    order = np.argsort(-probs)
    for i in order:
        bar = "#" * int(probs[i] * 40)
        print(f"  {EMOTIONS[i]:>9}: {probs[i]:.4f} {bar}")
    print(f"\nPredicted: {EMOTIONS[order[0]]} "
          f"(confidence {probs[order[0]]:.4f})")

    print("\nPrompt bank used:")
    for emotion, descs in get_emotion_descriptions().items():
        print(f"  {emotion}:")
        for d in descs:
            print(f"    - {d}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4))
        ax.bar(list(EMOTIONS), probs)
        ax.set_ylabel("probability")
        ax.set_title(f"Emotion probabilities — {args.image}")
        plt.xticks(rotation=45)
        fig.savefig(args.plot_out, bbox_inches="tight", dpi=120)
        print(f"\nsaved probability chart to {args.plot_out}")
    except Exception as e:  # headless/plot-less environments
        print(f"(skipping plot: {e})")
    return probs


if __name__ == "__main__":
    main()
