"""HF Qwen2.5-VL checkpoint -> the port's param trees, and weight-only
quantization presets.

Port of ``vlm_clip_tpu/vlm/qwen_convert.py``. ``convert_qwen_vl`` takes
any mapping of HF state-dict names to arrays (a live ``state_dict()`` or
safetensors shards loaded as numpy) and returns tensors on ``device``. HF
name roots: ``model.language_model.*`` / ``model.visual.*`` (transformers
>= 4.52) and the legacy ``model.*`` / ``visual.*``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vlm_clip_tpu_torch.ops.nf4 import quantize_nf4, quantize_nf4_stacked
from vlm_clip_tpu_torch.ops.quant import quantize_weight
from vlm_clip_tpu_torch.vlm.qwen_model import (QwenTextConfig,
                                               QwenVisionConfig,
                                               QwenVLConfig)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


class _Conv:
    def __init__(self, sd, device):
        self.sd, self.device = sd, device

    def t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def lin(self, prefix, bias=True):
        p = {"kernel": self.t(_np(self.sd[prefix + ".weight"]).T)}
        if bias and prefix + ".bias" in self.sd:
            p["bias"] = self.t(_np(self.sd[prefix + ".bias"]))
        return p

    def norm(self, prefix):
        return {"scale": self.t(_np(self.sd[prefix + ".weight"]))}


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _root(sd: Mapping[str, Any]) -> Dict[str, str]:
    if any(k.startswith("model.language_model.") for k in sd):
        return {"text": "model.language_model", "vision": "model.visual"}
    return {"text": "model", "vision": "visual"}


def convert_qwen_text(sd: Mapping[str, Any], cfg: QwenTextConfig,
                      root: Optional[str] = None,
                      device="cuda") -> Dict[str, Any]:
    root = root or _root(sd)["text"]
    c = _Conv(sd, device)
    layers = []
    for i in range(cfg.num_layers):
        b = f"{root}.layers.{i}"
        layers.append({
            "attn": {"q": c.lin(b + ".self_attn.q_proj"),
                     "k": c.lin(b + ".self_attn.k_proj"),
                     "v": c.lin(b + ".self_attn.v_proj"),
                     "o": c.lin(b + ".self_attn.o_proj", bias=False)},
            "mlp": {"gate": c.lin(b + ".mlp.gate_proj", bias=False),
                    "up": c.lin(b + ".mlp.up_proj", bias=False),
                    "down": c.lin(b + ".mlp.down_proj", bias=False)},
            "ln1": c.norm(b + ".input_layernorm"),
            "ln2": c.norm(b + ".post_attention_layernorm"),
        })
    params = {"embed_tokens": c.t(_np(sd[f"{root}.embed_tokens.weight"])),
              "layers": _stack(layers),
              "final_norm": c.norm(f"{root}.norm")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": c.t(_np(sd["lm_head.weight"]).T)}
    return params


def convert_qwen_vision(sd: Mapping[str, Any], cfg: QwenVisionConfig,
                        root: Optional[str] = None,
                        device="cuda") -> Dict[str, Any]:
    root = root or _root(sd)["vision"]
    c = _Conv(sd, device)
    # Conv3d weight [H, C, t, P, P] -> [C*t*P*P, H], the (C, t, ph, pw)
    # patch flatten order of qwen_process.image_to_patches
    conv = _np(sd[f"{root}.patch_embed.proj.weight"])
    blocks = []
    for i in range(cfg.depth):
        b = f"{root}.blocks.{i}"
        blocks.append({
            "attn": {"qkv": c.lin(b + ".attn.qkv"),
                     "proj": c.lin(b + ".attn.proj")},
            "mlp": {"gate": c.lin(b + ".mlp.gate_proj"),
                    "up": c.lin(b + ".mlp.up_proj"),
                    "down": c.lin(b + ".mlp.down_proj")},
            "ln1": c.norm(b + ".norm1"),
            "ln2": c.norm(b + ".norm2"),
        })
    return {
        "patch_embed": {"kernel": c.t(conv.reshape(conv.shape[0], -1).T)},
        "blocks": _stack(blocks),
        "merger": {"ln_q": c.norm(f"{root}.merger.ln_q"),
                   "fc1": c.lin(f"{root}.merger.mlp.0"),
                   "fc2": c.lin(f"{root}.merger.mlp.2")},
    }


def convert_qwen_vl(sd: Mapping[str, Any], cfg: QwenVLConfig,
                    device="cuda") -> Dict[str, Any]:
    return {"text": convert_qwen_text(sd, cfg.text, device=device),
            "vision": convert_qwen_vision(sd, cfg.vision, device=device)}


def fold_qwen_patch_normalization(vision_params: Dict[str, Any],
                                  cfg: QwenVisionConfig,
                                  mean=None, std=None) -> Dict[str, Any]:
    """Fold ``(x/255 - mean)/std`` into the patch embed so raw uint8
    patches can be shipped: ``norm(x) @ W = u8 @ (W * a[:, None]) +
    (-shift) @ W`` with per-channel blocks of t*P*P rows. Computed in
    numpy fp32, as the reference does."""
    from vlm_clip_tpu_torch.core.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

    mean = np.asarray(mean if mean is not None else CLIP_IMAGE_MEAN,
                      np.float32)
    std = np.asarray(std if std is not None else CLIP_IMAGE_STD, np.float32)
    k_t = vision_params["patch_embed"]["kernel"]
    kernel = k_t.detach().float().cpu().numpy()
    tpp = kernel.shape[0] // 3
    a = np.repeat(1.0 / (255.0 * std), tpp)
    shift = np.repeat(mean / std, tpp)
    out = dict(vision_params)
    out["patch_embed"] = {
        "kernel": torch.from_numpy(np.ascontiguousarray(
            kernel * a[:, None])).to(k_t.device),
        "bias": torch.from_numpy(np.ascontiguousarray(
            -shift @ kernel)).to(k_t.device)}
    return out


# int4 only on the text gate/up (wide-N GEMVs), int8 elsewhere; with
# head_bits=4 the untied head is int4 too. Text-scoped keys: the vision
# tower stays int8.
MIXED_DECODE_BITS: Dict[str, int] = {"text/layers/mlp/gate": 4,
                                     "text/layers/mlp/up": 4,
                                     "text/layers/mlp/gateup": 4,
                                     "default": 8}


def _fuse_decode_layers(layers: Dict[str, Any]) -> Dict[str, Any]:
    """Concat q/k/v -> qkv and gate/up -> gateup on the stacked fp
    kernels (last axis). Per-output-channel scales are unchanged by
    concatenation, so fused-then-quantized equals quantized-then-
    concatenated."""
    def cat(nodes):
        out = {"kernel": torch.cat([n["kernel"] for n in nodes], dim=-1)}
        if all(n.get("bias") is not None for n in nodes):
            out["bias"] = torch.cat([n["bias"] for n in nodes], dim=-1)
        return out

    attn, mlp = layers["attn"], layers["mlp"]
    return {**layers,
            "attn": {"qkv": cat([attn["q"], attn["k"], attn["v"]]),
                     "o": attn["o"]},
            "mlp": {"gateup": cat([mlp["gate"], mlp["up"]]),
                    "down": mlp["down"]}}


def quantize_qwen_params(params: Dict[str, Any], bits=8,
                         head_bits=0,
                         fuse_decode: bool = False) -> Dict[str, Any]:
    """Quantize every linear kernel (weight-only); embeddings, norms and
    the patch embed stay fp.

    ``bits``: 4, 8, ``"nf4"`` (blockwise NF4 with double quantization,
    ``ops/nf4.py``), or a {path-substring: bits} mapping with a "default"
    key (e.g. :data:`MIXED_DECODE_BITS`) matched against slash-joined
    paths like ``text/layers/mlp/gate``. Stacked [L, in, out] kernels are
    quantized one layer at a time and stacked. ``head_bits`` (4, 8 or
    ``"nf4"``): also quantize the tied head (``embed_tokens.T``) into an
    untied ``lm_head``; run the model with ``tie_word_embeddings=False``
    then. ``fuse_decode``: concat text q/k/v and gate/up before
    quantizing.
    """
    if fuse_decode and "text" in params:
        params = dict(params)
        params["text"] = dict(params["text"])
        params["text"]["layers"] = _fuse_decode_layers(
            params["text"]["layers"])

    def bits_for(path: str):
        if isinstance(bits, (int, str)):
            return bits
        for key, b in bits.items():
            if key != "default" and key in path:
                return b
        return bits["default"]

    def quantize_node(node, path):
        b, kernel, bias = bits_for(path), node["kernel"], node.get("bias")
        if b != "nf4":
            return quantize_weight(kernel, b, bias)
        if kernel.dim() == 2:
            return quantize_nf4(kernel, bias)
        return quantize_nf4_stacked(kernel, bias)

    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and node["kernel"].dim() in (2, 3):
                return quantize_node(node, path)
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return node

    out = {}
    for tower, sub in params.items():
        out[tower] = {name: (val if name in ("embed_tokens", "final_norm",
                                             "patch_embed")
                             else walk(val, f"{tower}/{name}"))
                      for name, val in sub.items()}
    if head_bits and "text" in out and "lm_head" not in out["text"]:
        head_w = params["text"]["embed_tokens"].float().T
        out["text"]["lm_head"] = quantize_nf4(head_w) \
            if head_bits == "nf4" else quantize_weight(head_w, head_bits)
    return out
