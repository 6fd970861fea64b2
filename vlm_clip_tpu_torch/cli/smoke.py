"""Smoke test entry (port of ``vlm_clip_tpu/cli/smoke.py``; reference
utest.py:1-52): build the full CLIPWithAdapters, run a dummy red image +
one caption through pipeline M's contrastive forward (kernels K1-K3 on a
card), print loss and feature shapes. Hermetic by default (random tiny
towers); ``--clip-model-name`` loads a backbone through
``cli/common.load_backbone`` (a checkpoint directory's vocab is picked
up). ``--device`` defaults to ``cuda`` and raises without a card.

    python -m vlm_clip_tpu_torch.cli.smoke [--clip-model-name DIR] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Any, NamedTuple


class SmokeInputs(NamedTuple):
    clip_params: Any
    cfg: Any
    adapter_params: Any
    acfg: Any
    input_ids: Any
    attention_mask: Any
    pixel_values: Any


def build(clip_model_name, device) -> SmokeInputs:
    """The backbone (tiny random towers, or ``clip_model_name`` through
    ``load_backbone``), the adapters from seed 1, the red image and the
    caption, on ``device``."""
    import torch
    from PIL import Image

    from vlm_clip_tpu_torch.cli.common import load_backbone, make_tokenizer
    from vlm_clip_tpu_torch.core.config import (AdapterConfig, CLIPConfig,
                                                TextConfig, VisionConfig)
    from vlm_clip_tpu_torch.data.preprocess import preprocess_host
    from vlm_clip_tpu_torch.data.tokenizer import get_tokenizer
    from vlm_clip_tpu_torch.models import model_m as M
    from vlm_clip_tpu_torch.models.clip import init_clip

    if clip_model_name:
        clip_params, cfg = load_backbone(clip_model_name, device=device)
        tok = make_tokenizer(cfg, require_real=False)
    else:
        cfg = CLIPConfig(
            vision=VisionConfig(hidden_size=64, intermediate_size=128,
                                num_layers=2, num_heads=4, image_size=224,
                                patch_size=32),
            text=TextConfig(hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4),
            projection_dim=64, name="tiny")
        clip_params = init_clip(torch.Generator(device=device).manual_seed(0),
                                cfg, device=device)
        tok = get_tokenizer(vocab_size=cfg.text.vocab_size)

    acfg = AdapterConfig(text_adapter_size=32, vision_adapter_size=32,
                         shared_adapter_layers=2, shared_num_heads=4)
    adapter_params = M.init_m_adapters(
        torch.Generator(device=device).manual_seed(1), cfg, acfg,
        device=device)

    # dummy solid-red image + one caption (utest.py:25-26)
    img = Image.new("RGB", (cfg.vision.image_size, cfg.vision.image_size),
                    (255, 0, 0))
    px = torch.from_numpy(preprocess_host(img, cfg.vision.image_size)[None])
    ids, mask = tok(["a photo of a red square"])
    return SmokeInputs(clip_params, cfg, adapter_params, acfg,
                       torch.from_numpy(ids).to(device),
                       torch.from_numpy(mask).to(device), px.to(device))


def forward(s: SmokeInputs, impl: str = "auto"):
    """Pipeline M's forward with the loss, bf16 (``impl="torch"``: the
    kernels' plain versions)."""
    import torch

    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.models import model_m as M

    with torch.no_grad():
        return M.m_forward(s.clip_params, s.adapter_params, s.input_ids,
                           s.attention_mask, s.pixel_values, s.cfg, s.acfg,
                           BF16, return_loss=True, impl=impl)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--clip-model-name", default=None,
                   help="preset, HF id or checkpoint dir; default: "
                        "hermetic tiny towers")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the "
                        "kernels' plain versions")
    args = p.parse_args(argv)

    import numpy as np

    from vlm_clip_tpu_torch.cli.common import resolve_device

    out = forward(build(args.clip_model_name, resolve_device(args.device)))
    loss = float(out.loss)
    print(f"loss: {loss:.4f}")
    print(f"text_features: {tuple(out.text_features.shape)}")
    print(f"image_features: {tuple(out.image_features.shape)}")
    print(f"logits_per_text: {tuple(out.logits_per_text.shape)}")
    assert np.isfinite(loss)
    print("smoke test OK")
    return {"loss": loss, "text_features": tuple(out.text_features.shape),
            "image_features": tuple(out.image_features.shape)}


if __name__ == "__main__":
    main()
