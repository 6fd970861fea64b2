"""Shared CLI plumbing: backbone loading and tokenizer selection (port of
``vlm_clip_tpu/cli/common.py``).

Real-weight runs are correct by construction, as in the reference:

- :func:`load_backbone` loads HF CLIP weights through the port's own
  reader (``convert/hf.py``: a local checkpoint directory or a hub id in
  the HF cache, no ``transformers``), remembers whether real weights
  loaded and, when the source is a local directory, remembers it so
  :func:`make_tokenizer` picks up the ``vocab.json``/``merges.txt`` every
  HF CLIP checkpoint ships;
- a run that loaded REAL weights but would tokenize with the hermetic
  :class:`HashTokenizer` raises instead of producing garbage zero-shot
  logits; random-init runs keep the warning-only behaviour;
- with ``require_real=True`` (serving without ``--allow-random-weights``)
  a source that does not load is an error, not a random init.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

from vlm_clip_tpu_torch.core.config import CLIPConfig, clip_preset

log = logging.getLogger(__name__)

# Provenance of the most recent load_backbone call in this process:
# real_weights — HF weights actually loaded (vs random init);
# checkpoint_dir — the local dir they came from, if the source was one.
_last_load = {"real_weights": False, "checkpoint_dir": None}


def last_backbone_was_real() -> bool:
    return bool(_last_load["real_weights"])


def load_backbone(model_name: str, hf_checkpoint: Optional[str] = None,
                  seed: int = 0, require_real: bool = False,
                  device="cuda") -> Tuple[dict, CLIPConfig]:
    """CLIP params on ``device`` (the card unless the caller asks for the
    CPU) for a preset name: HF-converted weights when available (local
    path / cache), else a seeded random init with a loud warning — or an
    error with ``require_real=True``."""
    from vlm_clip_tpu_torch.convert.hf import load_hf_clip
    from vlm_clip_tpu_torch.models.clip import init_clip

    # zero-egress environment: any HF tooling a caller runs in this
    # process stays on the local cache
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

    cfg = clip_preset(model_name)
    source = hf_checkpoint or model_name
    _last_load["checkpoint_dir"] = source if os.path.isdir(source) else None
    try:
        params, cfg = load_hf_clip(source, cfg, device=device)
        _last_load["real_weights"] = True
        log.info("loaded HF weights from %s", source)
        return params, cfg
    except Exception as e:
        _last_load["real_weights"] = False
        if require_real:
            raise RuntimeError(
                f"could not load HF weights for {source} ({e}) and "
                "require_real is set — refusing to fall back to random "
                "init. Provide a local checkpoint dir/cache, or pass "
                "--allow-random-weights for a hermetic drive.") from e
        log.warning("could not load HF weights for %s (%s); "
                    "using RANDOM INIT (seed %d) — results will not be "
                    "meaningful until real weights are provided",
                    source, e, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_clip(gen, cfg, device=device), cfg


def resolve_device(name: str) -> torch.device:
    """The entry points' ``--device``: ``cuda`` (the default) raises when
    no card is visible rather than falling back to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA card is visible; "
                           "pass --device cpu to run on the CPU")
    return torch.device(name)


def make_tokenizer(cfg: CLIPConfig, vocab_json: Optional[str] = None,
                   merges_txt: Optional[str] = None,
                   checkpoint_dir: Optional[str] = None,
                   require_real: Optional[bool] = None):
    """Best tokenizer for this run; refuses to pair real weights with the
    hash fallback.

    Probe order: explicit vocab/merges files -> ``checkpoint_dir`` (or
    the directory the backbone was just loaded from) -> package asset
    dir / HF cache (data/tokenizer.get_tokenizer). ``require_real``:
    True -> raise unless a real BPE tokenizer is found; False -> never
    raise; None (default) -> raise exactly when the last
    :func:`load_backbone` call loaded REAL weights.
    """
    from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer, get_tokenizer

    ckpt = checkpoint_dir or _last_load["checkpoint_dir"]
    if not (vocab_json and merges_txt) and ckpt:
        vj = os.path.join(ckpt, "vocab.json")
        mt = os.path.join(ckpt, "merges.txt")
        if os.path.isfile(vj) and os.path.isfile(mt):
            vocab_json, merges_txt = vj, mt
            log.info("tokenizer vocab from checkpoint dir %s", ckpt)
    tok = get_tokenizer(vocab_json, merges_txt, cfg.text.vocab_size)
    if require_real is None:
        require_real = last_backbone_was_real()
    if require_real and isinstance(tok, HashTokenizer):
        raise RuntimeError(
            "real CLIP weights are loaded but no BPE vocab was found — "
            "HashTokenizer ids are not in CLIP's vocabulary, so text/"
            "zero-shot results would be garbage. Install the vocab once "
            "with `python -m vlm_clip_tpu_torch.cli.install_tokenizer "
            "<vocab source>`, point --hf-checkpoint at a directory "
            "containing vocab.json + merges.txt, or pass "
            "--allow-hash-tokenizer for a hermetic drive.")
    log.info("tokenizer backend: %s", type(tok).__name__)
    return tok
