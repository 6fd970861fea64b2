"""Real-weight golden validation (port of
``vlm_clip_tpu/cli/validate_parity.py``): the port's towers against
HF's torch models at fp32, and the eval legs on real weights.

1. loads a CLIP checkpoint (HF name or local dir) and compares the
   port's text/image features + logits against HF's torch ``CLIPModel``
   on fixed inputs (max abs/rel diff, pass/fail at --tol). Both sides
   are torch, at fp32 with TF32 off;
2. optionally compares Qwen2.5-VL text-decoder logits the same way
   (``--qwen DIR``);
3. optionally runs RAF-DB zero-shot accuracy (``--rafdb DIR``) and
   EMOTIC mAP (``--emotic-npy DIR``) on ``--clip`` loaded through the
   port's own loader (``convert/hf.load_hf_clip``), on ``--device`` —
   REFUSING the hash tokenizer unless ``--allow-hash-tokenizer``. When
   ``--clip`` is a local dir its vocab.json/merges.txt are picked up;
4. appends a markdown result block to ``--append``.

Only the CLIP and Qwen logit legs need ``transformers`` (imported inside
their functions; without it they raise an error naming it). The card's
machine has none: there ``--eval-only`` runs legs 3 alone.
``--tiny-fixture`` covers ALL FOUR legs with no downloads — tiny random
HF CLIP logits parity, tiny random HF Qwen2.5-VL text-logits parity,
RAF-DB zero-shot over a generated 7-class JPEG tree, and EMOTIC mAP over
synthetic npy arrays.

    python -m vlm_clip_tpu_torch.cli.validate_parity \\
        --clip /data/clip-vit-large-patch14 --rafdb /data/rafdb \\
        --emotic-npy /data/emotic_pre --append BENCH.md [--device cpu]
    python -m vlm_clip_tpu_torch.cli.validate_parity \\
        --qwen /data/Qwen2.5-VL-3B-Instruct --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime
from typing import Dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--clip", default=None,
                   help="HF CLIP checkpoint name or local dir")
    p.add_argument("--qwen", default=None,
                   help="local Qwen2.5-VL weights dir (safetensors)")
    p.add_argument("--rafdb", default=None,
                   help="RAF-DB root (flat {emotion}/ folders) for "
                        "zero-shot accuracy")
    p.add_argument("--emotic-npy", default=None,
                   help="EMOTIC preprocessed npy dir for mAP")
    p.add_argument("--tol", type=float, default=5e-3,
                   help="max |diff| allowed on logits (fp32 gate)")
    p.add_argument("--append", default=None,
                   help="markdown file to append results to")
    p.add_argument("--tiny-fixture", action="store_true",
                   help="hermetic self-test: all four legs on tiny "
                        "random fixtures (no downloads)")
    p.add_argument("--allow-hash-tokenizer", action="store_true",
                   help="let the RAF-DB/EMOTIC legs run with the "
                        "non-CLIP hash tokenizer (hermetic drives only)")
    p.add_argument("--eval-only", action="store_true",
                   help="with --clip: only the RAF-DB/EMOTIC legs (no "
                        "transformers needed)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port runs (cuda, the default, needs a "
                        "card); the HF models run on the CPU")
    return p


def _force_fp32_matmuls():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError(
            "this parity leg compares against HF's torch models and needs "
            "the `transformers` package, which is not installed; the "
            "RAF-DB/EMOTIC legs run without it (--eval-only)") from e
    return transformers


def _diffs(a, b) -> Dict:
    import numpy as np

    d = np.abs(a - b)
    return {"max_abs": float(d.max()),
            "rel": float(d.max() / (np.abs(b).max() + 1e-12))}


def validate_clip(hf_model, params, cfg, seed: int = 0) -> Dict:
    """Max diffs between the port's towers (on the params' device) and
    HF's torch model (CPU) on fixed random inputs, fp32."""
    import numpy as np
    import torch

    from vlm_clip_tpu_torch.core.dtypes import FP32
    from vlm_clip_tpu_torch.models import layers as L
    from vlm_clip_tpu_torch.models.clip import (get_image_features,
                                                get_text_features)

    rng = np.random.default_rng(seed)
    B = 4
    ids = rng.integers(1, cfg.text.vocab_size - 2, (B, 12))
    ids = np.concatenate(
        [ids, np.full((B, 1), cfg.text.eos_token_id)], axis=1)
    mask = np.ones_like(ids)
    px = rng.normal(size=(B, 3, cfg.vision.image_size,
                          cfg.vision.image_size)).astype(np.float32)

    with torch.no_grad():
        t_txt = hf_model.get_text_features(
            input_ids=torch.from_numpy(ids),
            attention_mask=torch.from_numpy(mask)).numpy()
        t_img = hf_model.get_image_features(
            pixel_values=torch.from_numpy(px)).numpy()
        t_logits = hf_model(input_ids=torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask),
                            pixel_values=torch.from_numpy(px)
                            ).logits_per_image.numpy()

        dev = params["logit_scale"].device
        p_txt = get_text_features(params, torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(mask).to(dev), cfg, FP32)
        p_img = get_image_features(params, torch.from_numpy(px).to(dev),
                                   cfg, FP32)
        # clip_logits: exp(logit_scale) * img_n @ txt_n^T
        p_logits = params["logit_scale"].exp() * (
            L.l2_normalize(p_img) @ L.l2_normalize(p_txt).T)

    return {"text_features": _diffs(p_txt.cpu().numpy(), t_txt),
            "image_features": _diffs(p_img.cpu().numpy(), t_img),
            "logits_per_image": _diffs(p_logits.cpu().numpy(), t_logits)}


def validate_qwen_model(hf, params, cfg, seed: int = 0) -> Dict:
    """Text-decoder logits: the port's params vs the torch model."""
    import numpy as np
    import torch

    from vlm_clip_tpu_torch.vlm.qwen_model import text_forward

    rng = np.random.default_rng(seed)
    T = 16
    ids = rng.integers(1, min(10000, cfg.text.vocab_size - 1), (1, T))
    with torch.no_grad():
        t_logits = hf(input_ids=torch.from_numpy(ids),
                      attention_mask=torch.ones(1, T, dtype=torch.long)
                      ).logits.numpy()
        emb = params["text"]["embed_tokens"]
        dev = emb.device
        embeds = emb[torch.from_numpy(ids).to(dev)]
        pos = torch.arange(T, device=dev).expand(3, 1, T)
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
        m = torch.zeros(1, 1, T, T, device=dev).masked_fill(
            ~causal, torch.finfo(torch.float32).min)
        p_logits, _ = text_forward(params["text"], embeds, pos, cfg.text, m)
    return {"text_logits": _diffs(p_logits.float().cpu().numpy(),
                                  t_logits)}


def validate_qwen(weights_dir: str, device="cuda", seed: int = 0) -> Dict:
    """Dir wrapper: HF's model and the port's conversion from the same
    safetensors dir (read by the port's own reader)."""
    import torch

    Q = _transformers()
    from vlm_clip_tpu_torch.vlm.qwen import load_safetensors_dir
    from vlm_clip_tpu_torch.vlm.qwen_convert import convert_qwen_vl
    from vlm_clip_tpu_torch.vlm.qwen_model import qwen25vl_3b

    hf = Q.Qwen2_5_VLForConditionalGeneration.from_pretrained(
        weights_dir, torch_dtype=torch.float32).eval()
    cfg = qwen25vl_3b()
    params = convert_qwen_vl(load_safetensors_dir(weights_dir), cfg,
                             device=device)
    return validate_qwen_model(hf, params, cfg, seed)


def zero_shot_rafdb(params, cfg, root: str, tokenizer) -> Dict:
    from vlm_clip_tpu_torch.core.dtypes import FP32
    from vlm_clip_tpu_torch.data.rafdb import BatchLoader, FolderDataset
    from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer
    from vlm_clip_tpu_torch.eval.evaluate import evaluate_model
    from vlm_clip_tpu_torch.models.model_t import ZeroShotEmotionRecognition

    model = ZeroShotEmotionRecognition(params, cfg, tokenizer, policy=FP32)
    loader = BatchLoader(FolderDataset(root, cfg.vision.image_size), 64)
    res = evaluate_model(model, loader)
    return {"accuracy": float(res.accuracy),
            "tokenizer_degraded": isinstance(tokenizer, HashTokenizer),
            "num_images": int(len(res.labels))}


def emotic_map(params, cfg, npy_dir: str, tokenizer) -> Dict:
    from vlm_clip_tpu_torch.data.emotic import EmoticPreDataset, emotic_collate
    from vlm_clip_tpu_torch.data.rafdb import BatchLoader
    from vlm_clip_tpu_torch.eval.emotic import evaluate_emotic

    ds = EmoticPreDataset.from_dir(npy_dir, "test")
    loader = BatchLoader(ds, batch_size=64, collate_fn=emotic_collate)
    out = evaluate_emotic(params, cfg, tokenizer, loader)
    return {"mAP": out["mAP"], "num_samples": out["num_samples"]}


def _tiny_hf_clip(device="cpu"):
    """(hf_model, params, cfg) — tiny random HF CLIP, converted."""
    import torch

    T = _transformers()
    from vlm_clip_tpu_torch.convert.hf import (clip_config_from_hf,
                                               convert_hf_clip)

    torch.manual_seed(0)
    tc = T.CLIPTextConfig(hidden_size=64, intermediate_size=128,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=77, vocab_size=99,
                          eos_token_id=2)
    vc = T.CLIPVisionConfig(hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=32, patch_size=16)
    hf = T.CLIPModel(T.CLIPConfig(text_config=tc.to_dict(),
                                  vision_config=vc.to_dict(),
                                  projection_dim=32)).eval()
    cfg = clip_config_from_hf(hf.config)
    return hf, convert_hf_clip(hf.state_dict(), cfg, device), cfg


def _tiny_hf_qwen(device="cpu"):
    """(hf_model, params, cfg) — tiny random HF Qwen2.5-VL, converted
    (the reference harness's fixture)."""
    import torch

    T = _transformers()
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import \
        Qwen2_5_VLVisionConfig

    from vlm_clip_tpu_torch.vlm.qwen_convert import convert_qwen_vl
    from vlm_clip_tpu_torch.vlm.qwen_model import (QwenTextConfig,
                                                   QwenVisionConfig,
                                                   QwenVLConfig)

    torch.manual_seed(0)
    tc = T.Qwen2_5_VLTextConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        vocab_size=256, tie_word_embeddings=True,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        rope_theta=1000000.0, rms_norm_eps=1e-6)
    vc = Qwen2_5_VLVisionConfig(
        hidden_size=32, intermediate_size=64, out_hidden_size=64, depth=3,
        num_heads=4, patch_size=4, temporal_patch_size=2,
        spatial_merge_size=2, window_size=16, fullatt_block_indexes=[1],
        hidden_act="silu")
    hf = T.Qwen2_5_VLForConditionalGeneration(
        T.Qwen2_5_VLConfig(text_config=tc.to_dict(),
                           vision_config=vc.to_dict(),
                           image_token_id=250, vision_start_token_id=249,
                           vision_end_token_id=249, eos_token_id=251,
                           bos_token_id=0)).eval()
    cfg = QwenVLConfig(
        text=QwenTextConfig(hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            head_dim=16, vocab_size=256,
                            mrope_section=(2, 3, 3),
                            tie_word_embeddings=True),
        vision=QwenVisionConfig(hidden_size=32, intermediate_size=64,
                                out_hidden_size=64, depth=3, num_heads=4,
                                patch_size=4, temporal_patch_size=2,
                                spatial_merge_size=2, window_size=16,
                                fullatt_block_indexes=(1,)),
        image_token_id=250, vision_start_token_id=249, eos_token_id=251)
    return hf, convert_qwen_vl(hf.state_dict(), cfg, device=device), cfg


def _fixture_rafdb_tree(root: str, image_size: int, per_class: int = 2
                        ) -> None:
    """Tiny 7-class JPEG tree (flat {emotion}/ layout)."""
    import numpy as np
    from PIL import Image

    from vlm_clip_tpu_torch.core.config import EMOTIONS

    rng = np.random.default_rng(0)
    for emo in EMOTIONS:
        d = os.path.join(root, emo)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.integers(0, 255, (image_size, image_size, 3),
                               dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i}.jpg"))


def _fixture_emotic_npy(root: str, image_size: int, n: int = 8) -> None:
    """Synthetic preprocessed-EMOTIC arrays (test split)."""
    import numpy as np

    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    np.save(os.path.join(root, "test_context_arr.npy"),
            rng.integers(0, 255, (n, image_size, image_size, 3),
                         dtype=np.uint8))
    np.save(os.path.join(root, "test_body_arr.npy"),
            rng.integers(0, 255, (n, 16, 16, 3), dtype=np.uint8))
    cat = np.zeros((n, 26), np.float32)
    cat[np.arange(n), rng.integers(0, 26, n)] = 1.0
    np.save(os.path.join(root, "test_cat_arr.npy"), cat)
    np.save(os.path.join(root, "test_cont_arr.npy"),
            rng.uniform(0, 10, (n, 3)).astype(np.float32))


def _clip_dir_config(path: str):
    """A checkpoint's own config (config.json), for arbitrary dims."""
    from vlm_clip_tpu_torch.convert.hf import (clip_config_from_hf,
                                               resolve_checkpoint_dir)

    with open(os.path.join(resolve_checkpoint_dir(path), "config.json"),
              encoding="utf-8") as f:
        return clip_config_from_hf(json.load(f))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    _force_fp32_matmuls()
    from vlm_clip_tpu_torch.cli.common import resolve_device

    device = resolve_device(args.device)

    results: Dict[str, Dict] = {}
    checked = []

    if args.tiny_fixture:
        import tempfile

        from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer

        hf, params, cfg = _tiny_hf_clip(device)
        results["clip(tiny-fixture)"] = validate_clip(hf, params, cfg)
        checked.append("clip(tiny-fixture)")
        qhf, qparams, qcfg = _tiny_hf_qwen(device)
        results["qwen(tiny-fixture)"] = validate_qwen_model(qhf, qparams,
                                                            qcfg)
        checked.append("qwen(tiny-fixture)")
        tok = HashTokenizer(cfg.text.vocab_size)  # hermetic by design
        with tempfile.TemporaryDirectory() as td:
            rafdb = os.path.join(td, "rafdb")
            _fixture_rafdb_tree(rafdb, cfg.vision.image_size)
            results["rafdb-zeroshot(tiny-fixture)"] = zero_shot_rafdb(
                params, cfg, rafdb, tok)
            emotic = os.path.join(td, "emotic")
            _fixture_emotic_npy(emotic, cfg.vision.image_size)
            results["emotic-mAP(tiny-fixture)"] = emotic_map(
                params, cfg, emotic, tok)
    elif args.clip:
        from vlm_clip_tpu_torch.convert.hf import load_hf_clip

        cfg = _clip_dir_config(args.clip)
        params, cfg = load_hf_clip(args.clip, cfg, device=device)
        if not args.eval_only:
            T = _transformers()
            hf = T.CLIPModel.from_pretrained(args.clip).eval()
            results[f"clip({args.clip})"] = validate_clip(hf, params, cfg)
            checked.append(f"clip({args.clip})")
        if args.rafdb or args.emotic_npy:
            from vlm_clip_tpu_torch.cli.common import make_tokenizer

            # real weights: refuse the hash fallback unless explicitly
            # allowed; a local --clip dir supplies vocab.json/merges.txt
            tok = make_tokenizer(
                cfg,
                checkpoint_dir=args.clip if os.path.isdir(args.clip)
                else None,
                require_real=not args.allow_hash_tokenizer)
            if args.rafdb:
                results["rafdb-zeroshot"] = zero_shot_rafdb(
                    params, cfg, args.rafdb, tok)
            if args.emotic_npy:
                results["emotic-mAP"] = emotic_map(params, cfg,
                                                   args.emotic_npy, tok)

    if args.qwen:
        results[f"qwen({args.qwen})"] = validate_qwen(args.qwen, device)
        checked.append(f"qwen({args.qwen})")

    if not results:
        print("nothing to validate: pass --clip/--qwen/--tiny-fixture")
        return 2

    ok = True
    for name in checked:
        for part, d in results[name].items():
            passed = d["max_abs"] <= args.tol
            ok &= passed
            print(f"{name}/{part}: max_abs={d['max_abs']:.2e} "
                  f"rel={d['rel']:.2e} "
                  f"{'PASS' if passed else 'FAIL'} (tol {args.tol})")
    for name in set(results) - set(checked):
        print(f"{name}: {json.dumps(results[name])}")

    if args.append:
        with open(args.append, "a", encoding="utf-8") as f:
            f.write(f"\n### Parity validation "
                    f"({datetime.now():%Y-%m-%d %H:%M})\n\n")
            f.write(f"```json\n{json.dumps(results, indent=2)}\n```\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
