"""Pipeline M — CLIPWithAdapters (port of
``vlm_clip_tpu/models/model_m.py``).

Reference quirks kept:

- text path: text tower ``last_hidden_state`` (final-layernormed) ->
  sequence adapter -> the cross-modal adapters, whose "image" is the
  **vision position-embedding table** as a batch-1 pseudo sequence
  (197x768 at ViT-B/16) -> ``[:, 0, :]`` CLS-slice pooling -> text
  projection;
- image path: vision tower ``last_hidden_state`` **without** the
  post-layernorm -> sequence adapter -> ``[:, 0, :]`` -> visual
  projection;
- loss: L2-normalize, ``logits_per_text = txt @ img.T * exp(scale)``,
  symmetric CE against ``arange(B)`` (plain, used by tests).

``impl`` is passed to the adapters (see models/adapters.py); the fused
adapters carry gradients (backward kernels on the card). ``remat=True``
checkpoints each tower layer. ``freeze_clip=True`` runs the towers under
``torch.no_grad()``: gradients then reach the adapters only and no tower
graph is kept (the reference's frozen ``static_clip`` argument). The
shared adapters' loop runs in the span ``m.cross_modal``
(``utils/profiling``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from vlm_clip_tpu_torch.bridge import TreeModule
from vlm_clip_tpu_torch.core.config import AdapterConfig, CLIPConfig
from vlm_clip_tpu_torch.core.dtypes import BF16, DTypePolicy
from vlm_clip_tpu_torch.models import adapters as A
from vlm_clip_tpu_torch.models import clip as C
from vlm_clip_tpu_torch.models import layers as L
from vlm_clip_tpu_torch.utils.profiling import annotate

Params = Dict[str, Any]


def init_m_adapters(gen: torch.Generator, clip_cfg: CLIPConfig,
                    acfg: AdapterConfig, device="cuda") -> Params:
    """Init the M adapter set; only enabled kinds get entries."""
    params: Params = {}
    if acfg.use_text_adapter:
        params["text_adapter"] = A.init_seq_adapter(
            gen, clip_cfg.text.hidden_size, acfg.text_adapter_size, device)
    if acfg.use_vision_adapter:
        params["vision_adapter"] = A.init_seq_adapter(
            gen, clip_cfg.vision.hidden_size, acfg.vision_adapter_size,
            device)
    if acfg.use_shared_adapters:
        params["shared_adapters"] = L.stack_trees([
            A.init_cross_modal_adapter(
                gen, text_dim=clip_cfg.text.hidden_size,
                image_dim=clip_cfg.vision.hidden_size,
                hidden=clip_cfg.text.hidden_size, device=device)
            for _ in range(acfg.shared_adapter_layers)])
    return params


def _towers(freeze_clip: bool):
    return torch.no_grad() if freeze_clip else contextlib.nullcontext()


def m_get_text_features(clip_params: Params, adapter_params: Params,
                        input_ids: torch.Tensor,
                        attention_mask: Optional[torch.Tensor],
                        cfg: CLIPConfig, acfg: AdapterConfig,
                        policy: DTypePolicy = BF16, remat: bool = False,
                        impl: str = "auto",
                        freeze_clip: bool = False) -> torch.Tensor:
    with _towers(freeze_clip):
        out = C.text_tower(clip_params["text"], input_ids, attention_mask,
                           cfg.text, policy, remat)
    x = out.last_hidden_state
    if acfg.use_text_adapter:
        x = A.seq_adapter(adapter_params["text_adapter"], x,
                          cfg.text.layer_norm_eps, impl)
    if acfg.use_shared_adapters:
        # pseudo image sequence = vision position-embedding table, batch 1
        img = clip_params["vision"]["position_embedding"][None].to(x.dtype)
        shared = adapter_params["shared_adapters"]
        with annotate("m.cross_modal"):
            for i in range(L.num_layers(shared)):
                x = A.cross_modal_adapter(L.layer_slice(shared, i), x, img,
                                          acfg.shared_num_heads, impl=impl)
    pooled = x[:, 0, :]  # CLS-slice quirk
    return C.project(clip_params["text_projection"], pooled)


def m_get_image_features(clip_params: Params, adapter_params: Params,
                         pixel_values: torch.Tensor, cfg: CLIPConfig,
                         acfg: AdapterConfig, policy: DTypePolicy = BF16,
                         remat: bool = False, impl: str = "auto",
                         freeze_clip: bool = False) -> torch.Tensor:
    with _towers(freeze_clip):
        out = C.vision_tower(clip_params["vision"], pixel_values,
                             cfg.vision, policy, remat)
    x = out.last_hidden_state  # un-post-layernormed (quirk)
    if acfg.use_vision_adapter:
        x = A.seq_adapter(adapter_params["vision_adapter"], x,
                          cfg.vision.layer_norm_eps, impl)
    pooled = x[:, 0, :]
    return C.project(clip_params["visual_projection"], pooled)


class MForwardOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    text_features: Optional[torch.Tensor]
    image_features: Optional[torch.Tensor]
    logits_per_text: Optional[torch.Tensor]
    logits_per_image: Optional[torch.Tensor]


def contrastive_loss(text_features: torch.Tensor,
                     image_features: torch.Tensor,
                     logit_scale: torch.Tensor):
    """Symmetric InfoNCE. Returns (loss, txt_n, img_n, logits_per_text,
    logits_per_image), fp32 throughout."""
    txt = L.l2_normalize(text_features).float()
    img = L.l2_normalize(image_features).float()
    logits_per_text = (txt @ img.T) * torch.exp(logit_scale.float())
    logits_per_image = logits_per_text.T
    labels = torch.arange(txt.shape[0], device=txt.device)
    loss_t = nn.functional.cross_entropy(logits_per_text, labels)
    loss_i = nn.functional.cross_entropy(logits_per_image, labels)
    return (loss_t + loss_i) / 2.0, txt, img, logits_per_text, \
        logits_per_image


class CLIPWithAdapters(TreeModule):
    """Reference-API wrapper: get_text_features / get_image_features /
    forward / save_adapter_weights / load_adapter_weights over the
    functional pipeline; the adapters run the kernels for CUDA params."""

    _trees = ("clip_params", "adapter_params")

    def __init__(self, clip_params: Params, cfg: CLIPConfig,
                 text_adapter_size: int = 256,
                 vision_adapter_size: int = 256,
                 shared_adapter_layers: int = 2,
                 use_text_adapter: bool = True,
                 use_vision_adapter: bool = True,
                 use_shared_adapters: bool = True,
                 policy: DTypePolicy = BF16, seed: int = 0):
        super().__init__()
        self.clip_params = clip_params
        self.cfg = cfg
        self.acfg = AdapterConfig(
            text_adapter_size=text_adapter_size,
            vision_adapter_size=vision_adapter_size,
            shared_adapter_layers=shared_adapter_layers,
            use_text_adapter=use_text_adapter,
            use_vision_adapter=use_vision_adapter,
            use_shared_adapters=use_shared_adapters)
        self.policy = policy
        device = clip_params["logit_scale"].device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.adapter_params = init_m_adapters(gen, cfg, self.acfg,
                                              device=device)

    @property
    def device(self) -> torch.device:
        return self.clip_params["logit_scale"].device

    def get_text_features(self, input_ids, attention_mask) -> torch.Tensor:
        return m_get_text_features(
            self.clip_params, self.adapter_params,
            torch.as_tensor(input_ids, device=self.device),
            torch.as_tensor(attention_mask, device=self.device), self.cfg,
            self.acfg, self.policy)

    def get_image_features(self, pixel_values) -> torch.Tensor:
        return m_get_image_features(
            self.clip_params, self.adapter_params,
            torch.as_tensor(pixel_values, device=self.device), self.cfg,
            self.acfg, self.policy)

    def forward(self, input_ids=None, attention_mask=None,
                pixel_values=None, return_loss: bool = True) -> dict:
        txt = None if input_ids is None else self.get_text_features(
            input_ids, attention_mask)
        img = None if pixel_values is None else self.get_image_features(
            pixel_values)
        if return_loss and txt is not None and img is not None:
            loss, txt_n, img_n, lpt, lpi = contrastive_loss(
                txt, img, self.clip_params["logit_scale"])
            return {"loss": loss, "text_features": txt_n,
                    "image_features": img_n, "logits_per_text": lpt,
                    "logits_per_image": lpi}
        return {"text_features": txt, "image_features": img}

    def save_adapter_weights(self, save_path: str) -> None:
        from vlm_clip_tpu_torch.train.checkpoint import save_adapter_weights

        save_adapter_weights(save_path, self.adapter_params)

    def load_adapter_weights(self, load_path: str) -> None:
        from vlm_clip_tpu_torch.train.checkpoint import load_adapter_weights

        self.adapter_params = load_adapter_weights(load_path, self.acfg,
                                                   device=self.device)


def m_forward(clip_params: Params, adapter_params: Params,
              input_ids: Optional[torch.Tensor],
              attention_mask: Optional[torch.Tensor],
              pixel_values: Optional[torch.Tensor], cfg: CLIPConfig,
              acfg: AdapterConfig, policy: DTypePolicy = BF16,
              return_loss: bool = True, remat: bool = False,
              impl: str = "auto", freeze_clip: bool = False
              ) -> MForwardOutput:
    """forward(input_ids, attention_mask, pixel_values, return_loss):
    features of whichever inputs are given, and with both the symmetric
    InfoNCE loss with normalized features and logits."""
    text_features = image_features = None
    if input_ids is not None:
        text_features = m_get_text_features(
            clip_params, adapter_params, input_ids, attention_mask, cfg,
            acfg, policy, remat, impl, freeze_clip)
    if pixel_values is not None:
        image_features = m_get_image_features(
            clip_params, adapter_params, pixel_values, cfg, acfg, policy,
            remat, impl, freeze_clip)
    if return_loss and text_features is not None \
            and image_features is not None:
        return MForwardOutput(*contrastive_loss(
            text_features, image_features, clip_params["logit_scale"]))
    return MForwardOutput(None, text_features, image_features, None, None)
