"""Adapter state dicts: reference ``.pt`` layout <-> the port's trees
(port of ``vlm_clip_tpu/convert/adapters.py``).

Key layouts (torch ``nn.Linear`` weights are ``[out, in]``; the trees
keep ``kernel`` as ``[in, out]``):

- feature adapter (T/V): fc1 / fc2
- sequence adapter:    down_project / up_project / layer_norm
- cross-modal adapter: text_proj / image_proj / cross_attn (packed
  in_proj) / norm1-3 / mlp.{0,2}
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

Params = Dict[str, Any]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach()


def _lin(sd: Mapping, prefix: str) -> Params:
    return {"kernel": _t(sd[f"{prefix}.weight"]).T.contiguous(),
            "bias": _t(sd[f"{prefix}.bias"]).clone()}


def _ln(sd: Mapping, prefix: str) -> Params:
    return {"scale": _t(sd[f"{prefix}.weight"]).clone(),
            "bias": _t(sd[f"{prefix}.bias"]).clone()}


def _lin_sd(p: Params, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": p["kernel"].detach().T.contiguous(),
            f"{prefix}.bias": p["bias"].detach().clone()}


def _ln_sd(p: Params, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": p["scale"].detach().clone(),
            f"{prefix}.bias": p["bias"].detach().clone()}


def feature_adapter_from_torch(sd: Mapping[str, Any]) -> Params:
    return {"fc1": _lin(sd, "fc1"), "fc2": _lin(sd, "fc2")}


def feature_adapter_to_torch(p: Params) -> Dict[str, torch.Tensor]:
    return {**_lin_sd(p["fc1"], "fc1"), **_lin_sd(p["fc2"], "fc2")}


def seq_adapter_from_torch(sd: Mapping[str, Any]) -> Params:
    return {"down": _lin(sd, "down_project"), "up": _lin(sd, "up_project"),
            "ln": _ln(sd, "layer_norm")}


def seq_adapter_to_torch(p: Params) -> Dict[str, torch.Tensor]:
    return {**_lin_sd(p["down"], "down_project"),
            **_lin_sd(p["up"], "up_project"),
            **_ln_sd(p["ln"], "layer_norm")}


def cross_modal_adapter_from_torch(sd: Mapping[str, Any]) -> Params:
    """torch nn.MultiheadAttention packs q/k/v as in_proj_{weight,bias}."""
    in_w = _t(sd["cross_attn.in_proj_weight"])  # [3H, H]
    in_b = _t(sd["cross_attn.in_proj_bias"])    # [3H]
    H = in_w.shape[1]
    attn = {name: {"kernel": in_w[i * H:(i + 1) * H].T.contiguous(),
                   "bias": in_b[i * H:(i + 1) * H].clone()}
            for i, name in enumerate(("q", "k", "v"))}
    attn["out"] = _lin(sd, "cross_attn.out_proj")
    return {
        "text_proj": _lin(sd, "text_proj"),
        "image_proj": _lin(sd, "image_proj"),
        "attn": attn,
        "norm1": _ln(sd, "norm1"),
        "norm2": _ln(sd, "norm2"),
        "norm3": _ln(sd, "norm3"),
        "mlp": {"fc1": _lin(sd, "mlp.0"), "fc2": _lin(sd, "mlp.2")},
    }


def cross_modal_adapter_to_torch(p: Params) -> Dict[str, torch.Tensor]:
    a = p["attn"]
    return {
        **_lin_sd(p["text_proj"], "text_proj"),
        **_lin_sd(p["image_proj"], "image_proj"),
        "cross_attn.in_proj_weight": torch.cat(
            [a[n]["kernel"].detach().T for n in ("q", "k", "v")], dim=0),
        "cross_attn.in_proj_bias": torch.cat(
            [a[n]["bias"].detach() for n in ("q", "k", "v")]),
        **_lin_sd(a["out"], "cross_attn.out_proj"),
        **_ln_sd(p["norm1"], "norm1"),
        **_ln_sd(p["norm2"], "norm2"),
        **_ln_sd(p["norm3"], "norm3"),
        **_lin_sd(p["mlp"]["fc1"], "mlp.0"),
        **_lin_sd(p["mlp"]["fc2"], "mlp.2"),
    }
