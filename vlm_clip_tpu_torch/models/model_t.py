"""Pipeline T — CLIP-Adapter with class-text-embedding CE training, and
the zero-shot baseline (port of ``vlm_clip_tpu/models/model_t.py``).

- prompt bank: 5 descriptions per class; each description's text
  features are L2-normalized and the class embedding is the
  **unrenormalized mean** of the normalized features;
- adapter math: ``f = r*MLP(x) + (1-r)*x`` then renorm (K6, through
  ``models/adapters.adapt_features``), visual ratio alpha, text ratio beta;
- training: frozen towers, CE over ``exp(logit_scale) * img @ txt.T``
  against the class labels, the logit scale read once as a Python float;
- predict: ``softmax(100 * img @ class_emb.T)`` — the hard-coded 100, not
  the learned logit scale;
- predict_with_all_descriptions: per class the max over its 5
  descriptions' similarities, then a softmax over the 7 maxima, as one
  [B, P] x [P, 35] product;
- the frozen towers run without autograd; their pooled image features
  are what the trainer caches (``train/trainer_t.py``).

Pipeline V, which adds a VLM context branch, is ``model_v.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from vlm_clip_tpu_torch.bridge import TreeModule
from vlm_clip_tpu_torch.core.config import CLIPConfig, EMOTIONS
from vlm_clip_tpu_torch.core.dtypes import BF16, DTypePolicy
from vlm_clip_tpu_torch.data.captions import (NUM_DESCRIPTIONS_PER_CLASS,
                                              get_emotion_descriptions)
from vlm_clip_tpu_torch.models import adapters as A
from vlm_clip_tpu_torch.models import clip as C
from vlm_clip_tpu_torch.models import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass
class EmotionBank:
    """Pre-encoded class-text embeddings."""
    per_description: torch.Tensor  # [C, K, P], L2-normalized
    mean: torch.Tensor             # [C, P], mean of normalized (NOT renormed)


@torch.no_grad()
def encode_emotion_bank(clip_params: Params, cfg: CLIPConfig, tokenizer,
                        policy: DTypePolicy = BF16,
                        emotions=EMOTIONS) -> EmotionBank:
    """Encode the 7x5 prompt bank in one batched text forward."""
    bank = get_emotion_descriptions()
    texts = [d for e in emotions for d in bank[e]]
    ids, mask = tokenizer(texts)
    device = clip_params["logit_scale"].device
    feats = C.get_text_features(clip_params, torch.as_tensor(ids, device=device),
                                torch.as_tensor(mask, device=device), cfg,
                                policy)
    feats = L.l2_normalize(feats).float()
    per_desc = feats.reshape(len(emotions), NUM_DESCRIPTIONS_PER_CLASS, -1)
    return EmotionBank(per_description=per_desc, mean=per_desc.mean(dim=1))


def init_t_adapters(gen: torch.Generator, feature_dim: int, bottleneck: int,
                    device="cuda") -> Params:
    return {"visual": A.init_feature_adapter(gen, feature_dim, bottleneck,
                                             device),
            "text": A.init_feature_adapter(gen, feature_dim, bottleneck,
                                           device)}


# ---------------------------------------------------------------------------
# functional forward / loss
# ---------------------------------------------------------------------------

def adapted_class_embeddings(adapter_params: Params, mean_emb: torch.Tensor,
                             beta: float, impl: str = "auto") -> torch.Tensor:
    """beta-blend + renorm of the class means."""
    return A.adapt_features(adapter_params["text"], mean_emb, beta,
                            impl=impl)


def t_logits(adapter_params: Params, image_features_norm: torch.Tensor,
             mean_emb: torch.Tensor, alpha: float, beta: float,
             scale, impl: str = "auto") -> torch.Tensor:
    """Training-path logits from precomputed normalized image features."""
    img = A.adapt_features(adapter_params["visual"], image_features_norm,
                           alpha, impl=impl)
    txt = adapted_class_embeddings(adapter_params, mean_emb, beta, impl)
    return scale * (img.float() @ txt.float().T)


def t_loss_fn(adapter_params: Params, image_features_norm: torch.Tensor,
              labels: torch.Tensor, mean_emb: torch.Tensor, alpha: float,
              beta: float, scale, impl: str = "auto") -> torch.Tensor:
    logits = t_logits(adapter_params, image_features_norm, mean_emb, alpha,
                      beta, scale, impl)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def predict_probs(adapter_params: Optional[Params],
                  image_features_norm: torch.Tensor,
                  class_emb: torch.Tensor, alpha: float,
                  impl: str = "auto") -> torch.Tensor:
    """softmax(100 * img @ class_emb.T); with ``adapter_params=None`` the
    zero-shot path (class_emb then the raw means)."""
    img = image_features_norm
    if adapter_params is not None:
        img = A.adapt_features(adapter_params["visual"], img, alpha,
                               impl=impl)
    sims = 100.0 * (img.float() @ class_emb.float().T)
    return torch.softmax(sims, dim=-1)


def predict_probs_all_descriptions(adapter_params: Optional[Params],
                                   image_features_norm: torch.Tensor,
                                   per_desc_emb: torch.Tensor, alpha: float,
                                   beta: float,
                                   impl: str = "auto") -> torch.Tensor:
    """All-descriptions mode: with adapters, each description embedding
    is beta-blended; a class scores the max over its K descriptions of
    100*cosine; softmax over the classes."""
    Ccls, K, P = per_desc_emb.shape
    txt = per_desc_emb.reshape(Ccls * K, P)
    img = image_features_norm
    if adapter_params is not None:
        img = A.adapt_features(adapter_params["visual"], img, alpha,
                               impl=impl)
        txt = A.adapt_features(adapter_params["text"], txt, beta, impl=impl)
    sims = 100.0 * (img.float() @ txt.float().T)
    sims = sims.reshape(-1, Ccls, K).amax(dim=-1)
    return torch.softmax(sims, dim=-1)


@torch.no_grad()
def _encode_images_norm(clip_params: Params, pixel_values: torch.Tensor,
                        cfg: CLIPConfig, policy: DTypePolicy) -> torch.Tensor:
    feats = C.get_image_features(clip_params, pixel_values, cfg, policy)
    return L.l2_normalize(feats).float()


# ---------------------------------------------------------------------------
# stateful wrappers mirroring the reference class API
# ---------------------------------------------------------------------------

class CLIPAdapterT(TreeModule):
    """CLIPAdapter(model_name, alpha, beta, ...): CLIP params, the two
    feature adapters and the encoded prompt bank, on the CLIP params'
    device. ``impl`` picks the adapters' implementation
    (models/adapters.py)."""

    _trees = ("clip_params", "adapter_params")

    def __init__(self, clip_params: Params, cfg: CLIPConfig, tokenizer,
                 alpha: float = 0.2, beta: float = 0.2,
                 bottleneck_dim: int = 64, policy: DTypePolicy = BF16,
                 seed: int = 0, impl: str = "auto"):
        super().__init__()
        self.clip_params = clip_params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.alpha = alpha
        self.beta = beta
        self.policy = policy
        self.impl = impl
        self.feature_dim = cfg.projection_dim
        device = clip_params["logit_scale"].device
        self.adapter_params = init_t_adapters(
            torch.Generator(device=device).manual_seed(seed),
            self.feature_dim, bottleneck_dim, device)
        # frozen scalar temperature, read once as the reference reads it
        # (exp in float32)
        self.temperature = float(np.exp(np.float32(
            float(clip_params["logit_scale"]))))
        self.bank = encode_emotion_bank(clip_params, cfg, tokenizer, policy)
        self.adapted_class_emb: Optional[torch.Tensor] = None

    def _apply(self, fn, recurse=True):
        self.bank = EmotionBank(fn(self.bank.per_description),
                                fn(self.bank.mean))
        if self.adapted_class_emb is not None:
            self.adapted_class_emb = fn(self.adapted_class_emb)
        return super()._apply(fn, recurse)

    @property
    def device(self) -> torch.device:
        return self.clip_params["logit_scale"].device

    # -- features ---------------------------------------------------------
    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Normalized pooled image features (frozen tower, no grad)."""
        return _encode_images_norm(self.clip_params, pixel_values, self.cfg,
                                   self.policy)

    # -- embeddings -------------------------------------------------------
    @torch.no_grad()
    def update_emotion_embeddings(self) -> None:
        self.adapted_class_emb = adapted_class_embeddings(
            self.adapter_params, self.bank.mean, self.beta, self.impl)

    # -- inference --------------------------------------------------------
    @torch.no_grad()
    def predict(self, pixel_values: torch.Tensor) -> torch.Tensor:
        feats = self.encode_images(pixel_values)
        emb = self.adapted_class_emb if self.adapted_class_emb is not None \
            else self.bank.mean
        return predict_probs(self.adapter_params, feats, emb, self.alpha,
                             self.impl)

    @torch.no_grad()
    def predict_with_all_descriptions(self, pixel_values: torch.Tensor
                                      ) -> torch.Tensor:
        feats = self.encode_images(pixel_values)
        return predict_probs_all_descriptions(
            self.adapter_params, feats, self.bank.per_description,
            self.alpha, self.beta, self.impl)

    def train(self, train_loader=None, num_epochs: int = 5,
              learning_rate: float = 3e-4,
              cache_image_features: bool = True) -> list:
        """Adapter-only training (train/trainer_t.py); returns the
        per-epoch mean losses. (``train(mode)`` of ``nn.Module`` is not
        used by this class: a bool argument keeps that meaning.)"""
        if train_loader is None or isinstance(train_loader, bool):
            return super().train(train_loader is not False)
        from vlm_clip_tpu_torch.train.trainer_t import train_t_adapters

        self.adapter_params, losses = train_t_adapters(
            self, train_loader, num_epochs=num_epochs,
            learning_rate=learning_rate,
            cache_image_features=cache_image_features)
        self.update_emotion_embeddings()
        return losses

    # -- checkpoints (the T adapter .pt of train/checkpoint.py) -----------
    def save_adapters(self, path: str) -> None:
        from vlm_clip_tpu_torch.train.checkpoint import save_t_adapters

        save_t_adapters(path, self.adapter_params)

    def load_adapters(self, path: str) -> None:
        from vlm_clip_tpu_torch.train.checkpoint import load_t_adapters

        self.adapter_params = load_t_adapters(path, device=self.device)
        self.update_emotion_embeddings()


class ZeroShotEmotionRecognition(TreeModule):
    """No-adapter baseline: prompt-bank class embeddings vs image
    features."""

    _trees = ("clip_params",)

    def __init__(self, clip_params: Params, cfg: CLIPConfig, tokenizer,
                 policy: DTypePolicy = BF16):
        super().__init__()
        self.clip_params = clip_params
        self.cfg = cfg
        self.policy = policy
        self.bank = encode_emotion_bank(clip_params, cfg, tokenizer, policy)

    def _apply(self, fn, recurse=True):
        self.bank = EmotionBank(fn(self.bank.per_description),
                                fn(self.bank.mean))
        return super()._apply(fn, recurse)

    @torch.no_grad()
    def predict(self, pixel_values: torch.Tensor) -> torch.Tensor:
        feats = _encode_images_norm(self.clip_params, pixel_values, self.cfg,
                                    self.policy)
        return predict_probs(None, feats, self.bank.mean, 0.0)

    @torch.no_grad()
    def predict_with_all_descriptions(self, pixel_values: torch.Tensor
                                      ) -> torch.Tensor:
        feats = _encode_images_norm(self.clip_params, pixel_values, self.cfg,
                                    self.policy)
        return predict_probs_all_descriptions(
            None, feats, self.bank.per_description, 0.0, 0.0)
