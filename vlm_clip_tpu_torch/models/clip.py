"""CLIP dual towers in functional PyTorch (port of
``vlm_clip_tpu/models/clip.py``).

Same semantics as the reference (HF ``CLIPModel`` to fp32 tolerance):

- vision tower: patchify (flattened in (ph, pw, c) order) -> one matmul
  patch embedding, class token, learned positions, pre-LN, pre-norm
  encoder layers; ``last_hidden_state`` is returned **un**-post-
  layernormed and ``pooled`` = post_LN(x[:, 0]);
- the uint8 path: :func:`fold_image_normalization` folds the per-channel
  ``(x/255 - mean)/std`` into the patch-embed weights and a bias, so
  :func:`vision_tower_u8` / :func:`get_image_features_u8` take raw uint8
  HWC batches (4x fewer bytes to the card than fp32 pixels, no float
  image materialized); its patch product accumulates in fp32 and the
  folded bias is added before the cast to the compute dtype;
- text tower: token + position embeddings, additive causal + padding
  mask, final LN, pooled at argmax(input_ids);
- projections are bias-free linears; ``logit_scale`` a learned scalar.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from vlm_clip_tpu_torch.core.config import CLIPConfig, TextConfig, VisionConfig
from vlm_clip_tpu_torch.core.dtypes import DTypePolicy, FP32
from vlm_clip_tpu_torch.models import layers as L

Params = Dict[str, Any]


class TowerOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # [B, T, H]
    pooled: torch.Tensor             # [B, H]


# ---------------------------------------------------------------------------
# init (same shapes and scales as the reference; other random numbers)
# ---------------------------------------------------------------------------

def _normal(gen, shape, scale, device):
    return torch.randn(*shape, generator=gen, device=device) * scale


def init_vision(gen: torch.Generator, cfg: VisionConfig,
                device="cuda") -> Params:
    s = cfg.hidden_size ** -0.5
    H = cfg.hidden_size
    return {
        "class_embedding": _normal(gen, (H,), s, device),
        # patch kernel kept in [P, P, 3, H]; flattened to one matmul
        "patch_embedding": {"kernel": _normal(
            gen, (cfg.patch_size, cfg.patch_size, 3, H), s, device)},
        "position_embedding": _normal(gen, (cfg.seq_len, H), s, device),
        "pre_layernorm": L.init_layernorm(H, device),
        "post_layernorm": L.init_layernorm(H, device),
        "layers": L.init_encoder_stack(gen, cfg.num_layers, H,
                                       cfg.intermediate_size, device),
    }


def init_text(gen: torch.Generator, cfg: TextConfig, device="cuda") -> Params:
    H = cfg.hidden_size
    return {
        "token_embedding": _normal(gen, (cfg.vocab_size, H), 0.02, device),
        "position_embedding": _normal(gen, (cfg.max_positions, H), 0.01,
                                      device),
        "final_layernorm": L.init_layernorm(H, device),
        "layers": L.init_encoder_stack(gen, cfg.num_layers, H,
                                       cfg.intermediate_size, device),
    }


def init_clip(gen: torch.Generator, cfg: CLIPConfig,
              device="cuda") -> Params:
    vh, th = cfg.vision.hidden_size, cfg.text.hidden_size
    return {
        "vision": init_vision(gen, cfg.vision, device),
        "text": init_text(gen, cfg.text, device),
        "visual_projection": {"kernel": _normal(
            gen, (vh, cfg.projection_dim), vh ** -0.5, device)},
        "text_projection": {"kernel": _normal(
            gen, (th, cfg.projection_dim), th ** -0.5, device)},
        "logit_scale": torch.tensor(cfg.logit_scale_init, device=device),
    }


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------

def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, 3, S, S] (NCHW) -> [B, N, patch*patch*3], flattened in
    (ph, pw, c) order to match the [P, P, 3, H] kernel layout."""
    B, C, H, W = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values.reshape(B, C, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 3, 5, 1)  # [B, gh, gw, ph, pw, C]
    return x.reshape(B, gh * gw, patch * patch * C)


def vision_tower(p: Params, pixel_values: torch.Tensor, cfg: VisionConfig,
                 policy: DTypePolicy = FP32,
                 remat: bool = False) -> TowerOutput:
    B = pixel_values.shape[0]
    if tuple(pixel_values.shape[-2:]) != (cfg.image_size, cfg.image_size):
        raise ValueError(
            f"pixel_values spatial shape {tuple(pixel_values.shape[-2:])} "
            f"does not match the model's image_size {cfg.image_size}; "
            f"resize inputs to {cfg.image_size} "
            "(data/preprocess.load_and_resize) or pick a matching "
            "VisionConfig")
    cd = policy.compute_dtype
    x = patchify(pixel_values.to(cd), cfg.patch_size)
    kernel = p["patch_embedding"]["kernel"].reshape(-1, cfg.hidden_size)
    x = torch.matmul(x, kernel.to(cd))
    return _vision_tower_tail(p, x, B, cfg, policy, remat)


def fold_image_normalization(vision_params: Params, mean=None,
                             std=None) -> Params:
    """Fold ``(x/255 - mean)/std`` into the patch-embed weights.

    Normalization is a per-channel affine map and the patch embedding is
    linear, so ``norm(x) @ W = x @ W' + b'`` with ``W'[(c)] =
    W[(c)]/(255*std_c)`` and ``b' = -sum_c (mean_c/std_c) * W[(c)]``.
    Use with :func:`vision_tower_u8` / :func:`get_image_features_u8`.
    """
    from vlm_clip_tpu_torch.core.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

    kernel = vision_params["patch_embedding"]["kernel"].float()
    mean = torch.tensor(mean if mean is not None else CLIP_IMAGE_MEAN,
                        dtype=torch.float32, device=kernel.device)
    std = torch.tensor(std if std is not None else CLIP_IMAGE_STD,
                       dtype=torch.float32, device=kernel.device)
    # kernel layout [P, P, 3, H]
    scaled = kernel / (255.0 * std)[None, None, :, None]
    bias = -torch.einsum("c,pqch->h", mean / std, kernel)
    out = dict(vision_params)
    out["patch_embedding"] = {"kernel": scaled, "bias": bias}
    return out


def patchify_hwc(u8: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, S, S, 3] (HWC, uint8 or float) -> [B, N, patch*patch*3] with
    the same (ph, pw, c) flattening order as :func:`patchify`."""
    B, H, W, C = u8.shape
    gh, gw = H // patch, W // patch
    x = u8.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, ph, pw, C]
    return x.reshape(B, gh * gw, patch * patch * C)


def vision_tower_u8(p_folded: Params, u8_hwc: torch.Tensor,
                    cfg: VisionConfig, policy: DTypePolicy = FP32,
                    remat: bool = False) -> TowerOutput:
    """Vision tower on raw uint8 HWC batches; requires params through
    :func:`fold_image_normalization`."""
    B = u8_hwc.shape[0]
    if tuple(u8_hwc.shape[1:3]) != (cfg.image_size, cfg.image_size):
        raise ValueError(
            f"uint8 batch spatial shape {tuple(u8_hwc.shape[1:3])} does "
            f"not match the model's image_size {cfg.image_size}")
    cd = policy.compute_dtype
    # the operands in the compute dtype (0..255 are exact in bf16), their
    # product accumulated and returned in fp32, then the folded bias
    x = patchify_hwc(u8_hwc, cfg.patch_size).to(cd).float()
    kernel = p_folded["patch_embedding"]["kernel"].reshape(
        -1, cfg.hidden_size).to(cd).float()
    x = torch.matmul(x, kernel)
    x = (x + p_folded["patch_embedding"]["bias"].float()).to(cd)
    return _vision_tower_tail(p_folded, x, B, cfg, policy, remat)


def _vision_tower_tail(p: Params, x: torch.Tensor, B: int,
                       cfg: VisionConfig, policy: DTypePolicy,
                       remat: bool) -> TowerOutput:
    """Class token, positions, pre-LN, encoder layers and the pooled
    post-LN over patch embeddings x [B, N, H] in the compute dtype."""
    cd = policy.compute_dtype
    cls = p["class_embedding"].to(cd).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + p["position_embedding"].to(cd)[None]
    x = L.layer_norm(p["pre_layernorm"], x, cfg.layer_norm_eps,
                     policy.stable_dtype)
    x = L.encoder_stack(p["layers"], x, cfg.num_heads, cfg.layer_norm_eps,
                        cfg.hidden_act, mask=None,
                        stable_dtype=policy.stable_dtype, remat=remat)
    pooled = L.layer_norm(p["post_layernorm"], x[:, 0, :],
                          cfg.layer_norm_eps, policy.stable_dtype)
    return TowerOutput(last_hidden_state=x, pooled=pooled)


# ---------------------------------------------------------------------------
# text tower
# ---------------------------------------------------------------------------

def text_mask(attention_mask: Optional[torch.Tensor], T: int,
              device="cpu") -> torch.Tensor:
    """Additive [B|1, 1, T, T] mask: causal plus optional key padding."""
    causal = torch.triu(torch.full((T, T), L.NEG_INF, device=device),
                        diagonal=1)
    mask = causal[None, None]
    if attention_mask is not None:
        pad = (1.0 - attention_mask.float())[:, None, None, :]
        mask = mask + pad * L.NEG_INF
    return mask


def text_tower(p: Params, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], cfg: TextConfig,
               policy: DTypePolicy = FP32,
               remat: bool = False) -> TowerOutput:
    B, T = input_ids.shape
    cd = policy.compute_dtype
    ids = input_ids.long()
    x = p["token_embedding"][ids].to(cd)
    x = x + p["position_embedding"][:T].to(cd)[None]
    mask = text_mask(attention_mask, T, device=x.device)
    x = L.encoder_stack(p["layers"], x, cfg.num_heads, cfg.layer_norm_eps,
                        cfg.hidden_act, mask=mask,
                        stable_dtype=policy.stable_dtype, remat=remat)
    x = L.layer_norm(p["final_layernorm"], x, cfg.layer_norm_eps,
                     policy.stable_dtype)
    if cfg.pool_by_argmax_ids:
        eos_pos = torch.argmax(ids, dim=-1)
    else:
        eos_pos = torch.argmax((ids == cfg.eos_token_id).int(), dim=-1)
    pooled = x[torch.arange(B, device=x.device), eos_pos]
    return TowerOutput(last_hidden_state=x, pooled=pooled)


# ---------------------------------------------------------------------------
# projected features (HF get_image_features / get_text_features)
# ---------------------------------------------------------------------------

def project(kernel_holder: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, kernel_holder["kernel"].to(x.dtype))


def get_image_features(params: Params, pixel_values: torch.Tensor,
                       cfg: CLIPConfig,
                       policy: DTypePolicy = FP32) -> torch.Tensor:
    out = vision_tower(params["vision"], pixel_values, cfg.vision, policy)
    return project(params["visual_projection"], out.pooled)


def get_image_features_u8(params: Params, u8_hwc: torch.Tensor,
                          cfg: CLIPConfig,
                          policy: DTypePolicy = FP32) -> torch.Tensor:
    """Projected image features from raw uint8 HWC batches; ``params``
    must hold a vision subtree through :func:`fold_image_normalization`."""
    out = vision_tower_u8(params["vision"], u8_hwc, cfg.vision, policy)
    return project(params["visual_projection"], out.pooled)


def get_text_features(params: Params, input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor],
                      cfg: CLIPConfig,
                      policy: DTypePolicy = FP32) -> torch.Tensor:
    out = text_tower(params["text"], input_ids, attention_mask, cfg.text,
                     policy)
    return project(params["text_projection"], out.pooled)
