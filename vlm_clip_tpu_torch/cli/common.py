"""Shared CLI plumbing: backbone loading and tokenizer selection (port of
``vlm_clip_tpu/cli/common.py``).

Loading HF CLIP checkpoints (``convert/hf.py``) is not ported yet, so
every backbone is a seeded random init. The refusal stays: with
``require_real=True`` (serving without ``--allow-random-weights``)
:func:`load_backbone` raises instead of coming up with random weights.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from vlm_clip_tpu_torch.core.config import CLIPConfig, clip_preset

log = logging.getLogger(__name__)


def load_backbone(model_name: str, hf_checkpoint: Optional[str] = None,
                  seed: int = 0, require_real: bool = False,
                  device="cpu") -> Tuple[dict, CLIPConfig]:
    """CLIP params for a preset name on ``device``: seeded random init
    with a loud warning, or an error with ``require_real=True``."""
    from vlm_clip_tpu_torch.models.clip import init_clip

    cfg = clip_preset(model_name)
    source = hf_checkpoint or model_name
    if require_real:
        raise RuntimeError(
            f"could not load HF weights for {source} (HF checkpoint "
            "loading is not yet ported to vlm_clip_tpu_torch, ROADMAP.md) "
            "and require_real is set — refusing to fall back to random "
            "init. Pass --allow-random-weights for a hermetic drive.")
    log.warning("no HF weights for %s; using RANDOM INIT (seed %d) — "
                "results will not be meaningful", source, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_clip(gen, cfg, device=device), cfg


def resolve_device(name: str) -> torch.device:
    """The entry points' ``--device``: ``cuda`` (the default) raises when
    no card is visible rather than falling back to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA card is visible; "
                           "pass --device cpu to run on the CPU")
    return torch.device(name)


def make_tokenizer(cfg: CLIPConfig):
    """Best tokenizer for this run: the package's installed CLIP BPE
    vocab, else one in the HF cache, else the hash fallback (warned)."""
    from vlm_clip_tpu_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=cfg.text.vocab_size)
    log.info("tokenizer backend: %s", type(tok).__name__)
    return tok
