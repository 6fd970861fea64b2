"""HF CLIP checkpoint -> the port's parameter tree (port of
``vlm_clip_tpu/convert/hf.py``).

Works from any mapping of HF ``CLIPModel`` state-dict names to arrays:
torch tensors (a live ``state_dict()`` or ``pytorch_model.bin``), numpy
arrays, or the mix ``convert/safetensors_io.py`` reads (numpy, BF16 as
torch). The reference loads through ``CLIPModel.from_pretrained``; the
port reads the checkpoint directory itself, so no ``transformers`` is
needed, with the same result bit for bit.

Layout transforms:
- torch linear weights ``[out, in]`` -> ``[in, out]``;
- patch-embedding conv weight ``[H, 3, P, P]`` -> ``[P, P, 3, H]``
  (the (ph, pw, c) patch-flattening order of models/clip.py);
- per-layer tensors stacked on a leading layer axis.
:func:`convert_hf_clip` keeps each tensor's dtype; :func:`load_hf_clip`
reads floating-point weights as fp32, as ``from_pretrained`` does when
given no dtype, so an fp16 or bf16 checkpoint gives the same fp32 tower.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vlm_clip_tpu_torch.bridge import tree_map
from vlm_clip_tpu_torch.core.config import (CLIPConfig, TextConfig,
                                            VisionConfig, clip_preset)

Params = Dict[str, Any]

# transformers' CLIPTextConfig / CLIPVisionConfig / CLIPConfig defaults:
# save_pretrained writes only the values that differ from them
_TEXT_DEFAULTS = dict(vocab_size=49408, hidden_size=512,
                      intermediate_size=2048, num_hidden_layers=12,
                      num_attention_heads=8, max_position_embeddings=77,
                      hidden_act="quick_gelu", layer_norm_eps=1e-5,
                      eos_token_id=49407)
_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072,
                        num_hidden_layers=12, num_attention_heads=12,
                        image_size=224, patch_size=32,
                        hidden_act="quick_gelu", layer_norm_eps=1e-5)
_CLIP_DEFAULTS = dict(projection_dim=512, logit_scale_init_value=2.6592)

WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.asarray(x))


def _linear(sd: Mapping[str, Any], prefix: str) -> Params:
    return {"kernel": _t(sd[prefix + ".weight"]).T.contiguous(),
            "bias": _t(sd[prefix + ".bias"]).clone()}


def _layernorm(sd: Mapping[str, Any], prefix: str) -> Params:
    return {"scale": _t(sd[prefix + ".weight"]).clone(),
            "bias": _t(sd[prefix + ".bias"]).clone()}


def _stack_layers(sd: Mapping[str, Any], tower: str,
                  num_layers: int) -> Params:
    """Per-layer params stacked into [L, ...] tensors."""
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "out": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    per = {k: [] for k in (*names, "ln1", "ln2")}
    for i in range(num_layers):
        base = f"{tower}.encoder.layers.{i}"
        for k, n in names.items():
            per[k].append(_linear(sd, f"{base}.{n}"))
        per["ln1"].append(_layernorm(sd, base + ".layer_norm1"))
        per["ln2"].append(_layernorm(sd, base + ".layer_norm2"))

    def stack(dicts):
        return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}

    return {"attn": {k: stack(per[k]) for k in ("q", "k", "v", "out")},
            "mlp": {k: stack(per[k]) for k in ("fc1", "fc2")},
            "ln1": stack(per["ln1"]), "ln2": stack(per["ln2"])}


def convert_hf_clip(sd: Mapping[str, Any], cfg: CLIPConfig,
                    device="cuda") -> Params:
    """An HF CLIPModel state dict -> the port's parameter tree on
    ``device``."""
    patch_w = _t(sd["vision_model.embeddings.patch_embedding.weight"])
    params = {
        "vision": {
            "class_embedding": _t(
                sd["vision_model.embeddings.class_embedding"]).clone(),
            "patch_embedding": {
                "kernel": patch_w.permute(2, 3, 1, 0).contiguous()},
            "position_embedding": _t(
                sd["vision_model.embeddings.position_embedding.weight"]
            ).clone(),
            # sic: HF's param really is named "pre_layrnorm"
            "pre_layernorm": _layernorm(sd, "vision_model.pre_layrnorm"),
            "post_layernorm": _layernorm(sd, "vision_model.post_layernorm"),
            "layers": _stack_layers(sd, "vision_model",
                                    cfg.vision.num_layers),
        },
        "text": {
            "token_embedding": _t(
                sd["text_model.embeddings.token_embedding.weight"]).clone(),
            "position_embedding": _t(
                sd["text_model.embeddings.position_embedding.weight"]
            ).clone(),
            "final_layernorm": _layernorm(sd, "text_model.final_layer_norm"),
            "layers": _stack_layers(sd, "text_model", cfg.text.num_layers),
        },
        "visual_projection": {
            "kernel": _t(sd["visual_projection.weight"]).T.contiguous()},
        "text_projection": {
            "kernel": _t(sd["text_projection.weight"]).T.contiguous()},
        "logit_scale": _t(sd["logit_scale"]).clone(),
    }
    if torch.device(device).type == "cpu":
        return params
    return tree_map(lambda t: t.to(device), params)


def _get(c, key: str, defaults: Dict):
    if isinstance(c, Mapping):
        return c.get(key, defaults[key])
    return getattr(c, key)


def clip_config_from_hf(hf_config) -> CLIPConfig:
    """CLIPConfig from a transformers CLIPConfig object or the plain dict
    of a checkpoint's ``config.json`` (any dims, not just the presets);
    a dict's missing keys take transformers' defaults, as
    ``from_pretrained`` does."""
    if isinstance(hf_config, Mapping):
        tc = hf_config.get("text_config") or {}
        vc = hf_config.get("vision_config") or {}
        name = hf_config.get("_name_or_path") or "hf-clip"
    else:
        tc, vc = hf_config.text_config, hf_config.vision_config
        name = getattr(hf_config, "name_or_path", "hf-clip") or "hf-clip"

    def t(k):
        return _get(tc, k, _TEXT_DEFAULTS)

    def v(k):
        return _get(vc, k, _VISION_DEFAULTS)

    return CLIPConfig(
        vision=VisionConfig(
            hidden_size=v("hidden_size"),
            intermediate_size=v("intermediate_size"),
            num_layers=v("num_hidden_layers"),
            num_heads=v("num_attention_heads"),
            image_size=v("image_size"), patch_size=v("patch_size"),
            layer_norm_eps=v("layer_norm_eps"), hidden_act=v("hidden_act")),
        text=TextConfig(
            hidden_size=t("hidden_size"),
            intermediate_size=t("intermediate_size"),
            num_layers=t("num_hidden_layers"),
            num_heads=t("num_attention_heads"),
            vocab_size=t("vocab_size"),
            max_positions=t("max_position_embeddings"),
            layer_norm_eps=t("layer_norm_eps"), hidden_act=t("hidden_act"),
            eos_token_id=t("eos_token_id")),
        projection_dim=_get(hf_config, "projection_dim", _CLIP_DEFAULTS),
        logit_scale_init=float(_get(hf_config, "logit_scale_init_value",
                                    _CLIP_DEFAULTS)),
        name=name)


def hub_cache_dir() -> str:
    """The HF hub cache: ``HF_HUB_CACHE``, else ``$HF_HOME/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.path.expanduser(
        os.environ.get("HF_HOME", "~/.cache/huggingface"))
    return os.path.join(home, "hub")


def resolve_checkpoint_dir(model_name_or_path: str) -> str:
    """A local checkpoint directory as is; a hub id (``org/name``) as its
    snapshot in the HF cache (``refs/main``'s, else the newest). Raises
    FileNotFoundError when neither exists (nothing is downloaded)."""
    if os.path.isdir(model_name_or_path):
        return model_name_or_path
    repo = os.path.join(hub_cache_dir(), "models--"
                        + model_name_or_path.replace("/", "--"))
    snaps = os.path.join(repo, "snapshots")
    if os.path.isdir(snaps):
        ref = os.path.join(repo, "refs", "main")
        if os.path.isfile(ref):
            with open(ref, encoding="utf-8") as f:
                d = os.path.join(snaps, f.read().strip())
            if os.path.isdir(d):
                return d
        found = sorted((os.path.getmtime(os.path.join(snaps, s)), s)
                       for s in os.listdir(snaps))
        if found:
            return os.path.join(snaps, found[-1][1])
    raise FileNotFoundError(
        f"{model_name_or_path} is neither a local checkpoint directory nor "
        f"a model in the HF cache ({hub_cache_dir()})")


def _fp32(x):
    """A floating-point entry as fp32; any other as it is."""
    if isinstance(x, torch.Tensor):
        return x.float() if x.is_floating_point() else x
    return x.astype(np.float32, copy=False) \
        if np.issubdtype(x.dtype, np.floating) else x


def read_state_dict(ckpt_dir: str) -> Dict[str, Any]:
    """The weights of a checkpoint directory: ``model.safetensors``
    through the port's reader, else ``pytorch_model.bin`` through
    ``torch.load(weights_only=True)``; floating-point entries as fp32."""
    st = os.path.join(ckpt_dir, "model.safetensors")
    pt = os.path.join(ckpt_dir, "pytorch_model.bin")
    if os.path.isfile(st):
        from vlm_clip_tpu_torch.convert.safetensors_io import load_file

        sd = load_file(st)
    elif os.path.isfile(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{ckpt_dir} holds none of {WEIGHT_FILES}")
    return {k: _fp32(v) for k, v in sd.items()}


def load_hf_clip(model_name_or_path: str, cfg: Optional[CLIPConfig] = None,
                 device="cuda") -> Tuple[Params, CLIPConfig]:
    """Load and convert an HF CLIP checkpoint (a local directory or a hub
    id in the HF cache) onto ``device``; returns (params, cfg). ``cfg``
    defaults to the preset the name names, else the checkpoint's
    ``config.json``."""
    ckpt = resolve_checkpoint_dir(model_name_or_path)
    if cfg is None:
        try:
            cfg = clip_preset(model_name_or_path)
        except ValueError:
            with open(os.path.join(ckpt, "config.json"),
                      encoding="utf-8") as f:
                cfg = clip_config_from_hf(json.load(f))
    return convert_hf_clip(read_state_dict(ckpt), cfg, device), cfg
