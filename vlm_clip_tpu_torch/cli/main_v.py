"""Pipeline-V entry: the VLM-context-enhanced adapter workflow (port of
``vlm_clip_tpu/cli/main_v.py``).

Flow: logging and seeding -> context extractor (none, stub, cache or
qwen backend) -> ``EnhancedCLIPAdapterV`` on the backbone
``cli/common.load_backbone`` gives -> the enhanced datasets (contexts
resolved once, train cap 200 images, test cap 50) -> adapter training
-> the 3-adapter export -> evaluation -> the context report -> the VLM
quality analytics. The reference's flags and defaults, plus ``--device``
(default ``cuda``; without a card it raises unless ``--device cpu`` is
given) and ``--no-plots`` (the confusion-matrix png needs matplotlib).
Under a PyTorch launcher's variables the process group comes up first
(``parallel/distributed.maybe_initialize``) and only rank 0 logs, as in
the reference.

    python -m vlm_clip_tpu_torch.cli.main_v --train-dir train/ \\
        --test-dir test/ [--vlm-backend stub] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VLM-context-enhanced CLIP "
                                            "adapter workflow (pipeline V)")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--test-dir", required=True)
    p.add_argument("--clip-model-name", default="vit-large-patch14")
    p.add_argument("--vlm-backend", default="stub",
                   choices=["stub", "cache", "qwen", "none"])
    p.add_argument("--context-cache-dir", default=None,
                   help="cache dir for --vlm-backend=cache")
    p.add_argument("--qwen-weights", default=None,
                   help="dir with Qwen2.5-VL safetensors + tokenizer.json "
                        "for --vlm-backend=qwen")
    p.add_argument("--qwen-kv-bits", type=int, default=16,
                   choices=(8, 16),
                   help="8 = int8 KV cache for context extraction")
    p.add_argument("--qwen-quant-bits", default="8h4",
                   choices=["0", "4", "8", "8h4", "mixed"],
                   help="weight-only quantization for the VLM (0=fp; "
                        "8h4=int8 layers + int4 untied head; mixed=int4 "
                        "gate/up + int4 untied head, int8 rest)")
    p.add_argument("--bottleneck-dim", type=int, default=192)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--beta", type=float, default=0.2)
    p.add_argument("--gamma", type=float, default=0.3)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-epochs", type=int, default=5)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--max-train-images", type=int, default=200)
    p.add_argument("--max-test-images", type=int, default=50)
    p.add_argument("--image-size", type=int, default=None,
                   help="defaults to the model config image size")
    p.add_argument("--adapter-out", default="enhanced_adapters.pt")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the "
                        "kernels' plain versions")
    p.add_argument("--no-plots", action="store_true",
                   help="skip the confusion-matrix png (matplotlib)")
    return p


def make_extractor(backend: str, clip_params, cfg, tokenizer,
                   cache_dir=None, qwen_weights=None, qwen_quant_bits=8,
                   qwen_kv_bits=16):
    """The context extractor of a backend: None for ``none``; the stub and
    the Qwen one encode their descriptions with the CLIP params' device;
    ``qwen`` refuses without a weights directory."""
    if backend == "none":
        return None
    if backend == "stub":
        from vlm_clip_tpu_torch.vlm.extractor import StubContextExtractor

        return StubContextExtractor(clip_params, cfg, tokenizer)
    if backend == "cache":
        from vlm_clip_tpu_torch.vlm.extractor import CachedContextExtractor

        if not cache_dir:
            raise SystemExit("--context-cache-dir required for cache backend")
        return CachedContextExtractor(cache_dir)
    if backend == "qwen":
        from vlm_clip_tpu_torch.vlm.qwen import QwenVLContextExtractor

        if qwen_quant_bits not in ("mixed", "8h4"):
            qwen_quant_bits = int(qwen_quant_bits) or None
        return QwenVLContextExtractor(
            clip_params, cfg, tokenizer, weights_path=qwen_weights,
            quant_bits=qwen_quant_bits, kv_bits=qwen_kv_bits,
            device=clip_params["logit_scale"].device)
    raise ValueError(backend)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train, export and evaluate; returns the per-epoch losses
    (``"losses"``), the evaluation (``"results"``, an EvalResult) and the
    context statistics (``"context_stats"``)."""
    args = build_parser().parse_args(argv)
    from vlm_clip_tpu_torch.cli.common import (load_backbone, make_tokenizer,
                                               resolve_device)
    from vlm_clip_tpu_torch.data.enhanced import (
        EnhancedFolderDataset, EnhancedFolderDatasetWithContext)
    from vlm_clip_tpu_torch.data.rafdb import BatchLoader
    from vlm_clip_tpu_torch.eval.reporting import (
        analyze_context_quality, display_results_with_contexts,
        evaluate_enhanced_model)
    from vlm_clip_tpu_torch.models.model_v import EnhancedCLIPAdapterV
    from vlm_clip_tpu_torch.parallel.distributed import maybe_initialize
    from vlm_clip_tpu_torch.train import checkpoint as ckpt
    from vlm_clip_tpu_torch.train.trainer_v import train_model
    from vlm_clip_tpu_torch.utils.logging import (seed_everything,
                                                  setup_logging)

    device = resolve_device(args.device)
    maybe_initialize(device=device.type)  # before the first use of the card
    setup_logging(name="training")
    seed_everything(args.seed)
    log = logging.getLogger(__name__)

    clip_params, cfg = load_backbone(args.clip_model_name, seed=args.seed,
                                     device=device)
    tokenizer = make_tokenizer(cfg)
    image_size = args.image_size or cfg.vision.image_size
    extractor = make_extractor(args.vlm_backend, clip_params, cfg,
                               tokenizer, args.context_cache_dir,
                               args.qwen_weights, args.qwen_quant_bits,
                               args.qwen_kv_bits)

    model = EnhancedCLIPAdapterV(
        clip_params, cfg, tokenizer, alpha=args.alpha, beta=args.beta,
        gamma=args.gamma, bottleneck_dim=args.bottleneck_dim,
        vlm_context_extractor=extractor, seed=args.seed)
    model.encode_emotion_descriptions()
    model.print_model_structure()

    train_ds = EnhancedFolderDataset(
        args.train_dir, extractor, mode="train",
        max_images=args.max_train_images, image_size=image_size,
        feature_dim=cfg.projection_dim, seed=args.seed)
    test_ds = EnhancedFolderDatasetWithContext(
        args.test_dir, extractor, mode="test",
        max_images=args.max_test_images, image_size=image_size,
        feature_dim=cfg.projection_dim, seed=args.seed)

    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                               drop_last=True, seed=args.seed)
    test_loader = BatchLoader(test_ds, args.batch_size)

    losses = train_model(model, train_loader, num_epochs=args.num_epochs,
                         learning_rate=args.learning_rate, seed=args.seed)
    ckpt.save_v_adapters(args.adapter_out, model.adapter_params)
    log.info("saved adapters to %s", args.adapter_out)

    results = evaluate_enhanced_model(model, test_loader)
    display_results_with_contexts(results, plots=not args.no_plots)
    stats = analyze_context_quality(results.contexts, results.labels)
    return {"losses": losses, "results": results, "context_stats": stats}


if __name__ == "__main__":
    main()
