"""Plain PyTorch reference of pipeline M's training step: CLIP ViT towers
(frozen), the text and vision sequence adapters, the shared cross-modal
adapters, CLS-slice pooling, projections, symmetric InfoNCE and Adam.

Written from the model's published description (HF ``CLIPModel``; the
adapters of the source paper's ``train.py``), in float32 with TF32 off.
It imports nothing of the program. ``prec="fp8"`` rounds every product's
operands to float8 e4m3 (one scale a tensor) and accumulates in float32:
the control, one precision below the configuration's bf16.

Params use the benchmark's tree layout: linear kernels [in, out], LayerNorm
``{"scale", "bias"}``, tower layers and the shared adapters stacked on a
leading axis, the patch kernel [P, P, 3, H].
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

NEG = torch.finfo(torch.float32).min


def _q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale (amax / 448), in fp32."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    if x.requires_grad:
        return _Q8.apply(x, s)
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Q8(torch.autograd.Function):
    """Rounding with a straight-through gradient (rounded too)."""

    @staticmethod
    def forward(ctx, x, s):
        return (x / s).to(torch.float8_e4m3fn).float() * s

    @staticmethod
    def backward(ctx, g):
        return _q8(g.contiguous()), None


class Prec:
    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"prec must be fp32 or fp8, got {name!r}")
        self.name = name

    def r(self, x):
        return _q8(x) if self.name == "fp8" else x

    def mm(self, a, b):
        return torch.matmul(self.r(a), self.r(b))


def _lin(P: Prec, p, x):
    y = P.mm(x, p["kernel"])
    return y + p["bias"] if "bias" in p else y


def _ln(p, x, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _attention(P: Prec, q, k, v, heads, mask=None):
    """q [B, Tq, H]; k, v [B|1, Tk, H]."""
    B, Tq, H = q.shape
    hd = H // heads
    qh = q.reshape(B, Tq, heads, hd).transpose(1, 2)
    kh = k.reshape(k.shape[0], -1, heads, hd).transpose(1, 2)
    vh = v.reshape(v.shape[0], -1, heads, hd).transpose(1, 2)
    s = P.mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        s = s + mask
    o = P.mm(torch.softmax(s, dim=-1), vh)
    return o.transpose(1, 2).reshape(B, Tq, H)


def _encoder(P: Prec, layers, x, heads, eps, mask=None):
    n = layers["ln1"]["scale"].shape[0]
    for i in range(n):
        p = _layer(layers, i)
        h = _ln(p["ln1"], x, eps)
        a = p["attn"]
        x = x + _lin(P, a["out"], _attention(
            P, _lin(P, a["q"], h), _lin(P, a["k"], h), _lin(P, a["v"], h),
            heads, mask))
        h = _ln(p["ln2"], x, eps)
        u = _lin(P, p["mlp"]["fc1"], h)
        x = x + _lin(P, p["mlp"]["fc2"], u * torch.sigmoid(1.702 * u))
    return x


def vision_hidden(P: Prec, p, pixels, v):
    """[B, 3, S, S] -> the last layer's hidden states [B, 1+N, H] (no
    post-LayerNorm: pipeline M reads them before it)."""
    B = pixels.shape[0]
    ps, H = v["patch_size"], v["hidden_size"]
    g = v["image_size"] // ps
    x = pixels.float().reshape(B, 3, g, ps, g, ps).permute(0, 2, 4, 3, 5, 1)
    x = P.mm(x.reshape(B, g * g, ps * ps * 3),
             p["patch_embedding"]["kernel"].reshape(-1, H))
    cls = p["class_embedding"].reshape(1, 1, H).expand(B, 1, H)
    x = torch.cat([cls, x], dim=1) + p["position_embedding"][None]
    x = _ln(p["pre_layernorm"], x, v["layer_norm_eps"])
    return _encoder(P, p["layers"], x, v["num_attention_heads"],
                    v["layer_norm_eps"])


def text_hidden(P: Prec, p, ids, mask, t):
    """The final-LayerNormed last hidden states [B, T, H]."""
    B, T = ids.shape
    x = p["token_embedding"][ids] + p["position_embedding"][:T][None]
    causal = torch.triu(torch.full((T, T), NEG, device=ids.device), 1)
    pad = (1.0 - mask.float())[:, None, None, :] * NEG
    x = _encoder(P, p["layers"], x, t["num_attention_heads"],
                 t["layer_norm_eps"], causal[None, None] + pad)
    return _ln(p["final_layernorm"], x, t["layer_norm_eps"])


def seq_adapter(P: Prec, p, x, eps):
    h = F.gelu(_lin(P, p["down"], x))
    return _ln(p["ln"], x + _lin(P, p["up"], h), eps)


def cross_modal(P: Prec, p, x, image, heads, eps=1e-5):
    """Text [B, T, D] attends a batch-shared image sequence [Tk, Di]: the
    projected text is normed and is the residual; then a pre-norm 4H
    GELU MLP with its residual."""
    kv = _ln(p["norm1"], _lin(P, p["image_proj"], image), eps)[None]
    u = _ln(p["norm2"], _lin(P, p["text_proj"], x), eps)
    a = p["attn"]
    o = _attention(P, _lin(P, a["q"], u), _lin(P, a["k"], kv),
                   _lin(P, a["v"], kv), heads)
    h = u + _lin(P, a["out"], o)
    m = p["mlp"]
    return h + _lin(P, m["fc2"], F.gelu(_lin(P, m["fc1"],
                                             _ln(p["norm3"], h, eps))))


def features(P: Prec, clip, adapters, txt_hidden, img_hidden, cfg):
    """(text, image) features from the towers' hidden states."""
    t, v = cfg["text_config"], cfg["vision_config"]
    x = seq_adapter(P, adapters["text_adapter"], txt_hidden,
                    t["layer_norm_eps"])
    image = clip["vision"]["position_embedding"]
    sh = adapters["shared_adapters"]
    for i in range(sh["norm1"]["scale"].shape[0]):
        x = cross_modal(P, _layer(sh, i), x, image,
                        cfg["adapters"]["shared_num_heads"])
    txt = P.mm(x[:, 0], clip["text_projection"]["kernel"])
    y = seq_adapter(P, adapters["vision_adapter"], img_hidden,
                    v["layer_norm_eps"])
    img = P.mm(y[:, 0], clip["visual_projection"]["kernel"])
    return txt, img


def info_nce(txt, img, logit_scale):
    txt = txt / txt.norm(dim=-1, keepdim=True)
    img = img / img.norm(dim=-1, keepdim=True)
    logits = txt @ img.T * logit_scale.exp()
    labels = torch.arange(txt.shape[0], device=txt.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2


def leaves(tree, prefix="") -> Dict[str, torch.Tensor]:
    """Path -> tensor of a nested dict, in insertion order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _rebuild(tree, flat, prefix=""):
    return {k: (_rebuild(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[f"{prefix}{k}"]) for k, v in tree.items()}


@torch.no_grad()
def tower_hidden(P: Prec, clip, batch, cfg):
    return (text_hidden(P, clip["text"], batch["input_ids"],
                        batch["attention_mask"], cfg["text_config"]),
            vision_hidden(P, clip["vision"], batch["pixel_values"],
                          cfg["vision_config"]))


def train(clip, adapters, batches: List[dict], cfg: dict,
          prec: str = "fp32") -> dict:
    """Adam steps on the adapters, one a batch (towers frozen): each
    step's loss, each leaf's first gradient norm and its change after
    the last step, by leaf path."""
    P = Prec(prec)
    o = cfg["optimizer"]
    b1, b2, eps, lr = o["b1"], o["b2"], o["eps"], o["learning_rate"]
    p0 = {k: t.detach().float().clone() for k, t in leaves(adapters).items()}
    params = {k: t.clone().requires_grad_(True) for k, t in p0.items()}
    m = {k: torch.zeros_like(t) for k, t in p0.items()}
    vv = {k: torch.zeros_like(t) for k, t in p0.items()}
    clip32 = _float_tree(clip)
    losses, first = [], {}
    for step, batch in enumerate(batches, 1):
        th, ih = tower_hidden(P, clip32, batch, cfg)
        tree = _rebuild(adapters, params)
        txt, img = features(P, clip32, tree, th, ih, cfg)
        loss = info_nce(txt, img, clip32["logit_scale"])
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                if step == 1:
                    first[k] = float(g.norm())
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                vv[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** step)
                vh = vv[k] / (1 - b2 ** step)
                p.sub_(lr * mh / (vh.sqrt() + eps))
    change = {k: float((params[k].detach() - p0[k]).norm()) for k in p0}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def _float_tree(tree):
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    return tree.detach().float()
