"""Pipeline V — the VLM-context-fused CLIP adapter (port of
``vlm_clip_tpu/models/model_v.py``).

- adapters: three feature bottleneck adapters, visual (alpha), text
  (beta) and context (gamma), each ``fc2(dropout(relu(fc1(x))))``
  blended and renormed through ``models/adapters.adapt_features`` (K6 on
  a CUDA tensor, with its in-kernel counter-hash dropout in training);
- class embeddings: one prompt a class, "A person expressing {e}", in one
  batched text forward, L2-normalized; the adapted tensor is refreshed by
  :meth:`EnhancedCLIPAdapterV.update_emotion_embeddings`;
- forward: normalized frozen-tower image features -> visual alpha-blend
  -> context gamma-blend -> average fusion and renorm -> text beta-blend
  (dynamic in training, the cached adapted embeddings in eval) ->
  ``exp(logit_scale) * combined @ txt.T`` in fp32;
- a context whose width differs from the image features' is dropped
  with the reference's warning; zero-vector contexts (the extractor's
  failure fallback) still flow through the context adapter;
- ``predict_probs`` = softmax of the eval-mode logits.

Dropout seeds come from an explicit ``torch.Generator``, one draw per
adapter call in the order visual, context, text (the reference splits a
JAX key three ways; the masks differ from the reference's, their
distribution does not).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from vlm_clip_tpu_torch.bridge import TreeModule, tree_leaves
from vlm_clip_tpu_torch.core.config import CLIPConfig, EMOTIONS
from vlm_clip_tpu_torch.core.dtypes import BF16, DTypePolicy
from vlm_clip_tpu_torch.data.captions import single_prompt
from vlm_clip_tpu_torch.models import adapters as A
from vlm_clip_tpu_torch.models import clip as C
from vlm_clip_tpu_torch.models import layers as L
from vlm_clip_tpu_torch.models.model_t import _encode_images_norm

Params = Dict[str, Any]


def init_v_adapters(gen: torch.Generator, feature_dim: int, bottleneck: int,
                    device="cuda") -> Params:
    return {name: A.init_feature_adapter(gen, feature_dim, bottleneck,
                                         device)
            for name in ("visual", "text", "context")}


@torch.no_grad()
def encode_single_prompt_embeddings(clip_params: Params, cfg: CLIPConfig,
                                    tokenizer, policy: DTypePolicy = BF16,
                                    emotions=EMOTIONS) -> torch.Tensor:
    """[C, P] normalized single-prompt class embeddings, one batched text
    forward."""
    ids, mask = tokenizer([single_prompt(e) for e in emotions])
    device = clip_params["logit_scale"].device
    feats = C.get_text_features(clip_params,
                                torch.as_tensor(ids, device=device),
                                torch.as_tensor(mask, device=device), cfg,
                                policy)
    return L.l2_normalize(feats).float()


def v_forward(adapter_params: Params, image_features_norm: torch.Tensor,
              emotion_emb: torch.Tensor, logit_scale,
              context_features: Optional[torch.Tensor] = None,
              alpha: float = 0.2, beta: float = 0.2, gamma: float = 0.3,
              dropout: float = 0.1, deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              cached_text_emb: Optional[torch.Tensor] = None,
              impl: str = "auto") -> torch.Tensor:
    """Logits [B, C] for a batch.

    ``image_features_norm``: [B, P] normalized frozen-tower features.
    ``context_features``: [B, P] (zeros where the extractor failed) or
    None to skip the context branch. ``cached_text_emb`` replaces the
    dynamic text branch (eval).
    """
    kw = dict(dropout=dropout, generator=generator,
              deterministic=deterministic, impl=impl)
    img = A.adapt_features(adapter_params["visual"], image_features_norm,
                           alpha, **kw)
    combined = img
    if context_features is not None:
        if context_features.shape[-1] != image_features_norm.shape[-1]:
            print("Warning: Context feature dimension mismatch. Expected "
                  f"{image_features_norm.shape[-1]}, got "
                  f"{context_features.shape[-1]}. Skipping context.")
        else:
            ctx = A.adapt_features(adapter_params["context"],
                                   context_features, gamma, **kw)
            combined = L.l2_normalize((img + ctx) / 2.0)  # average fusion
    if cached_text_emb is not None:
        txt = cached_text_emb
    else:
        txt = A.adapt_features(adapter_params["text"], emotion_emb.detach(),
                               beta, **kw)
    scale = torch.exp(torch.as_tensor(logit_scale).float())
    return scale * (combined.float() @ txt.float().T)


def v_loss_fn(adapter_params: Params, image_features_norm: torch.Tensor,
              context_features: Optional[torch.Tensor],
              labels: torch.Tensor, emotion_emb: torch.Tensor, logit_scale,
              generator: Optional[torch.Generator], alpha: float,
              beta: float, gamma: float, dropout: float,
              impl: str = "auto") -> torch.Tensor:
    """Mean cross-entropy of :func:`v_forward`'s logits against the class
    labels; dropout is active when a generator is given."""
    logits = v_forward(adapter_params, image_features_norm, emotion_emb,
                       logit_scale, context_features, alpha, beta, gamma,
                       dropout=dropout, deterministic=generator is None,
                       generator=generator, impl=impl)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def _count(tree) -> int:
    return sum(int(np.prod(t.shape)) for t in tree_leaves(tree))


class EnhancedCLIPAdapterV(TreeModule):
    """The reference API (EnhancedCLIPAdapter): CLIP params, the three
    feature adapters and the class embeddings, on the CLIP params'
    device. ``impl`` picks the adapters' implementation
    (models/adapters.py)."""

    _trees = ("clip_params", "adapter_params")

    def __init__(self, clip_params: Params, cfg: CLIPConfig, tokenizer,
                 alpha: float = 0.2, beta: float = 0.2, gamma: float = 0.3,
                 bottleneck_dim: int = 192, dropout: float = 0.1,
                 vlm_context_extractor=None, policy: DTypePolicy = BF16,
                 seed: int = 0, impl: str = "auto"):
        super().__init__()
        self.clip_params = clip_params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.dropout = dropout
        self.policy = policy
        self.impl = impl
        self.feature_dim = cfg.projection_dim
        self.text_feature_dim = cfg.projection_dim
        self.vlm_context_extractor = vlm_context_extractor
        device = self.device
        self.adapter_params = init_v_adapters(
            torch.Generator(device=device).manual_seed(seed),
            self.feature_dim, bottleneck_dim, device)
        self.emotion_embedding_tensor: Optional[torch.Tensor] = None
        self.adapted_emotion_embedding_tensor: Optional[torch.Tensor] = None

    def _apply(self, fn, recurse=True):
        for name in ("emotion_embedding_tensor",
                     "adapted_emotion_embedding_tensor"):
            if getattr(self, name) is not None:
                setattr(self, name, fn(getattr(self, name)))
        return super()._apply(fn, recurse)

    @property
    def device(self) -> torch.device:
        return self.clip_params["logit_scale"].device

    def encode_emotion_descriptions(self, emotions=EMOTIONS) -> None:
        self.emotion_embedding_tensor = encode_single_prompt_embeddings(
            self.clip_params, self.cfg, self.tokenizer, self.policy,
            emotions)
        self.update_emotion_embeddings()

    @torch.no_grad()
    def update_emotion_embeddings(self) -> None:
        if self.emotion_embedding_tensor is None:
            print("Warning: Original emotion embeddings not encoded. "
                  "Call encode_emotion_descriptions first.")
            return
        self.adapted_emotion_embedding_tensor = A.adapt_features(
            self.adapter_params["text"], self.emotion_embedding_tensor,
            self.beta, impl=self.impl)

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Normalized pooled image features (frozen tower, no grad)."""
        return _encode_images_norm(self.clip_params, pixel_values, self.cfg,
                                   self.policy)

    @torch.no_grad()
    def forward(self, pixel_values: torch.Tensor, context_features=None,
                use_adapters_for_training: bool = True) -> torch.Tensor:
        """Eval-mode logits (dropout off, the cached adapted class
        embeddings); ``context_features`` a [B, P] array or tensor, or
        None."""
        del use_adapters_for_training  # eval-mode dropout is always off
        feats = self.encode_images(pixel_values)
        ctx = None if context_features is None else torch.as_tensor(
            context_features, dtype=torch.float32, device=self.device)
        return v_forward(self.adapter_params, feats,
                         self.emotion_embedding_tensor,
                         self.clip_params["logit_scale"], ctx, self.alpha,
                         self.beta, self.gamma, dropout=0.0,
                         cached_text_emb=self.adapted_emotion_embedding_tensor,
                         impl=self.impl)

    @torch.no_grad()
    def predict_probs(self, pixel_values: torch.Tensor,
                      context_features=None) -> torch.Tensor:
        return torch.softmax(self.forward(pixel_values, context_features),
                             dim=-1)

    def predict(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The evaluation harness's protocol (no contexts)."""
        return self.predict_probs(pixel_values)

    def get_trainable_parameters(self) -> Params:
        return self.adapter_params

    def count_trainable_params(self) -> int:
        return _count(self.adapter_params)

    def print_model_structure(self) -> None:
        """Param-count report."""
        print("Model structure:")
        print(f"  frozen CLIP params: {_count(self.clip_params):,}")
        for name, sub in self.adapter_params.items():
            print(f"  {name}_adapter (trainable): {_count(sub):,}")
        print(f"  total trainable: {self.count_trainable_params():,}")
