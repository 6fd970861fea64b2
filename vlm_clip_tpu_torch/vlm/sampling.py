"""Token sampling for Qwen generation: the HF logits-processor chain.

Port of ``vlm_clip_tpu/vlm/sampling.py``: repetition penalty ->
temperature -> top-k -> top-p -> categorical, in HF's order, on fp32
logits [B, V]. ``sample_token`` draws from a ``torch.Generator``, so its
draws differ from the JAX package's; every deterministic part
(``warp_logits``, greedy argmax) matches it. Draws read nothing back to
the host (:func:`draw`), so a decode step on the card never waits on it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling spec with HF ``GenerationConfig`` semantics: with
    ``do_sample=False`` the warpers are ignored and decoding is argmax;
    ``repetition_penalty`` applies in both modes. ``extra_eos`` holds stop
    ids beyond the model's primary eos."""

    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0          # 0 disables
    top_p: float = 1.0      # 1.0 disables
    repetition_penalty: float = 1.0
    extra_eos: Tuple[int, ...] = ()

    @property
    def needs_presence(self) -> bool:
        return self.repetition_penalty != 1.0


GREEDY = SamplingConfig()


def load_generation_config(weights_dir: str,
                           primary_eos: Optional[int] = None
                           ) -> SamplingConfig:
    """A SamplingConfig from ``generation_config.json`` as HF
    ``generate()`` reads it; a missing file or field falls back to HF's
    defaults (greedy; top_k 50 when sampling and the field is absent)."""
    path = os.path.join(weights_dir, "generation_config.json")
    if not os.path.isfile(path):
        return GREEDY
    with open(path, encoding="utf-8") as f:
        gc = json.load(f)
    eos = gc.get("eos_token_id", [])
    if isinstance(eos, int):
        eos = [eos]
    return SamplingConfig(
        do_sample=bool(gc.get("do_sample", False)),
        temperature=float(gc.get("temperature", 1.0)),
        top_k=int(gc.get("top_k", 50) or 0),
        top_p=float(gc.get("top_p", 1.0)),
        repetition_penalty=float(gc.get("repetition_penalty", 1.0)),
        extra_eos=tuple(e for e in eos if e != primary_eos),
    )


def warp_logits(logits: torch.Tensor, presence: torch.Tensor,
                scfg: SamplingConfig) -> torch.Tensor:
    """The HF processor chain on fp32 logits [B, V]; ``presence`` [B, V]
    marks tokens already seen (read only for a repetition penalty)."""
    if scfg.repetition_penalty != 1.0:
        p = scfg.repetition_penalty
        penalized = torch.where(logits > 0, logits / p, logits * p)
        logits = torch.where(presence, penalized, logits)
    if not scfg.do_sample:
        return logits
    if scfg.temperature != 1.0:
        logits = logits / scfg.temperature
    if scfg.top_k and scfg.top_k > 0:
        k = min(scfg.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if scfg.top_p < 1.0:
        sorted_logits, sorted_idx = torch.sort(logits, dim=-1, stable=True)
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        remove_sorted = cum <= (1.0 - scfg.top_p)
        remove_sorted[..., -1:] = False  # min_tokens_to_keep=1
        remove = remove_sorted.scatter(-1, sorted_idx, remove_sorted)
        logits = logits.masked_fill(remove, NEG_INF)
    return logits


def draw(probs: torch.Tensor,
         generator: Optional[torch.Generator]) -> torch.Tensor:
    """One index along the last axis of probabilities [..., V], drawn as
    ``torch.multinomial(probs, 1)`` draws it (argmax of p / q with q ~
    Exp(1): the same indices from the same generator state) but without
    multinomial's check of the inputs, which reads them back to the
    host."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(dim=-1)


def sample_token(logits: torch.Tensor, presence: torch.Tensor,
                 generator: Optional[torch.Generator],
                 scfg: SamplingConfig) -> torch.Tensor:
    """One decode step's tokens [B] (int64) from fp32 logits [B, V]."""
    logits = warp_logits(logits, presence, scfg)
    if scfg.do_sample:
        return draw(torch.softmax(logits, dim=-1), generator)
    return logits.argmax(dim=-1)
