"""The adapters of pipelines T and M (port of
``vlm_clip_tpu/models/adapters.py``; the unused peclip set is not
ported).

- Feature bottleneck adapter (T/V): ``fc2(dropout(relu(fc1(x))))`` on
  pooled features, blended ``r*adapter(x) + (1-r)*x`` and L2-renormed
  (:func:`adapt_features`) -> kernel K6 for [N, D] features.
- Sequence (Houlsby) adapter: ``LN(x + up(gelu(down(x))))`` over the
  full [B, T, H] hidden state -> kernel K1.
- Cross-modal attention adapter: project text; pre-norm MHA with the
  text as query and a batch-shared image sequence as key/value; the
  residual is the *normed* projected text (a reference quirk kept here);
  then a pre-norm 4xH GELU MLP with residual -> kernels K2 and K3.

``impl`` picks the implementation: ``"auto"`` launches the kernels for
CUDA tensors and takes the plain versions for CPU tensors; ``"torch"``
forces the plain versions; ``"kernel"`` forces the kernels and raises on
a CPU tensor. Where the reference computes the cross-modal block plainly
(a shared K/V longer than its ATTN_SEG_MAX), ``"auto"`` takes K2's plain
version too (``F.cross_attn_block_supported``) and ``"kernel"`` raises.
The image side (projection, norm1, k/v projections of the batch-1 image
sequence) is plain torch and runs once per call, not per row.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from vlm_clip_tpu_torch.models import layers as L
from vlm_clip_tpu_torch.ops import fused_adapter as F

Params = Dict[str, Any]

IMPLS = ("auto", "torch", "kernel")


def _pick(impl: str, x: torch.Tensor, kernel_fn, torch_fn,
          supported: bool = True):
    """The function to call: ``supported`` is False where the reference
    computes plainly (K2's shape gate). Under "auto" a CUDA call there
    takes the plain version (a static route decided before any launch; a
    kernel that fails to build or launch still raises)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "torch":
        return torch_fn
    if impl == "kernel" and x.device.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got one on "
                         f"{x.device}")
    if impl == "auto" and x.device.type == "cuda" and not supported:
        return torch_fn
    return kernel_fn


# ---------------------------------------------------------------------------
# feature bottleneck adapter (T/V)
# ---------------------------------------------------------------------------

def init_feature_adapter(gen: torch.Generator, dim: int, bottleneck: int,
                         device="cpu") -> Params:
    b1 = (1.0 / dim) ** 0.5
    b2 = (1.0 / bottleneck) ** 0.5
    return {
        "fc1": {"kernel": L.uniform(gen, (dim, bottleneck), b1, device),
                "bias": torch.zeros(bottleneck, device=device)},
        "fc2": {"kernel": L.uniform(gen, (bottleneck, dim), b2, device),
                "bias": torch.zeros(dim, device=device)},
    }


def feature_adapter(p: Params, x: torch.Tensor, *, dropout: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """fc2(dropout(relu(fc1(x)))); dropout only when not deterministic,
    drawn from ``generator`` (which must then be given)."""
    h = torch.relu(L.linear(p["fc1"], x))
    if dropout > 0.0 and not deterministic:
        if generator is None:
            raise ValueError("dropout requires a generator")
        keep = torch.rand(h.shape, generator=generator,
                          device=h.device) < 1.0 - dropout
        h = torch.where(keep, h / (1.0 - dropout), 0.0).to(h.dtype)
    return L.linear(p["fc2"], h)


def residual_blend(adapted: torch.Tensor, original: torch.Tensor,
                   ratio: float) -> torch.Tensor:
    """r*adapted + (1-r)*original in fp32, then L2 renorm."""
    mixed = ratio * adapted.float() + (1.0 - ratio) * original.float()
    return L.l2_normalize(mixed).to(original.dtype)


def adapt_features(p: Params, x: torch.Tensor, ratio: float, *,
                   dropout: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = True,
                   impl: str = "auto") -> torch.Tensor:
    """The T/V feature-branch op: adapter -> ratio blend -> renorm.

    ``impl``: ``"auto"`` takes the fused op K6 for 2-D ``x`` (its kernel
    on a CUDA tensor, its plain version on a CPU one); ``"kernel"`` the
    same, refusing a CPU tensor; ``"torch"`` the plain composition
    (:func:`feature_adapter` then :func:`residual_blend`). With dropout
    active, K6 takes a seed drawn from ``generator`` and applies the TPU
    kernel's hash mask; without a generator the call raises.
    """
    dropout_active = dropout > 0.0 and not deterministic
    fused = _pick(impl, x, True, False)
    if fused and x.dim() == 2 and (not dropout_active
                                   or generator is not None):
        seed = None
        if dropout_active:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=generator,
                                     device=generator.device))
        return F.feature_adapter_blend_fused(
            x, p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
            p["fc2"]["bias"], ratio, dropout if dropout_active else 0.0,
            seed)
    return residual_blend(
        feature_adapter(p, x, dropout=dropout, generator=generator,
                        deterministic=deterministic), x, ratio)


# ---------------------------------------------------------------------------
# sequence (Houlsby) adapter
# ---------------------------------------------------------------------------

def init_seq_adapter(gen: torch.Generator, hidden: int, adapter_size: int,
                     device="cpu") -> Params:
    b1 = (1.0 / hidden) ** 0.5
    b2 = (1.0 / adapter_size) ** 0.5
    return {
        "down": {"kernel": L.uniform(gen, (hidden, adapter_size), b1,
                                     device),
                 "bias": torch.zeros(adapter_size, device=device)},
        "up": {"kernel": L.uniform(gen, (adapter_size, hidden), b2, device),
               "bias": torch.zeros(hidden, device=device)},
        "ln": L.init_layernorm(hidden, device),
    }


def seq_adapter(p: Params, x: torch.Tensor, eps: float = 1e-5,
                impl: str = "auto") -> torch.Tensor:
    """LN(x + up(gelu(down(x)))) over [..., H], on the flattened rows."""
    fn = _pick(impl, x, F.seq_adapter_fused, F.seq_adapter_torch)
    y = fn(x.reshape(-1, x.shape[-1]), p["down"]["kernel"], p["down"]["bias"],
           p["up"]["kernel"], p["up"]["bias"], p["ln"]["scale"],
           p["ln"]["bias"], eps)
    return y.reshape(x.shape)


# ---------------------------------------------------------------------------
# cross-modal attention adapter
# ---------------------------------------------------------------------------

def init_mlp_gelu(gen: torch.Generator, hidden: int,
                  device="cpu") -> Params:
    b1 = (1.0 / hidden) ** 0.5
    b2 = (1.0 / (4 * hidden)) ** 0.5
    return {
        "fc1": {"kernel": L.uniform(gen, (hidden, 4 * hidden), b1, device),
                "bias": torch.zeros(4 * hidden, device=device)},
        "fc2": {"kernel": L.uniform(gen, (4 * hidden, hidden), b2, device),
                "bias": torch.zeros(hidden, device=device)},
    }


def init_cross_modal_adapter(gen: torch.Generator, text_dim: int = 512,
                             image_dim: int = 768, hidden: int = 512,
                             device="cpu") -> Params:
    return {
        "text_proj": L.init_linear(gen, text_dim, hidden, device=device),
        "image_proj": L.init_linear(gen, image_dim, hidden, device=device),
        "attn": L.init_mha(gen, hidden, device),
        "norm1": L.init_layernorm(hidden, device),  # image side
        "norm2": L.init_layernorm(hidden, device),  # text side
        "norm3": L.init_layernorm(hidden, device),  # pre-MLP
        "mlp": init_mlp_gelu(gen, hidden, device),
    }


def shared_kv(p: Params, image: torch.Tensor, eps: float = 1e-5):
    """k, v [Tk, H] of the batch-1 image sequence: image_proj -> norm1 ->
    the attention's k/v projections, in the image's dtype."""
    if image.shape[0] != 1:
        raise ValueError("cross_modal_adapter takes a batch-shared image "
                         f"sequence [1, Tk, D]; got {tuple(image.shape)}")
    kv = L.layer_norm(p["norm1"], L.linear(p["image_proj"], image[0]), eps)
    return L.linear(p["attn"]["k"], kv), L.linear(p["attn"]["v"], kv)


def cross_modal_adapter(p: Params, text: torch.Tensor, image: torch.Tensor,
                        num_heads: int = 8, eps: float = 1e-5,
                        impl: str = "auto") -> torch.Tensor:
    """SharedMHSAttentionAdapter forward on text [B, T, Din] against a
    batch-shared image [1, Tk, image_dim]: the attention half (K2) then
    the pre-norm MLP half (K3), each over the flattened [B*T] rows."""
    k, v = shared_kv(p, image, eps)
    attn_fn = _pick(impl, text, F.cross_attn_block_fused,
                    F.cross_attn_block_torch,
                    F.cross_attn_block_supported(k.shape[0]))
    mlp_fn = _pick(impl, text, F.prenorm_mlp_fused, F.prenorm_mlp_torch)
    B, T = text.shape[:2]
    ap, mp = p["attn"], p["mlp"]
    h = attn_fn(text.reshape(B * T, -1), p["text_proj"]["kernel"],
                p["text_proj"]["bias"], p["norm2"]["scale"],
                p["norm2"]["bias"], ap["q"]["kernel"], ap["q"]["bias"], k, v,
                ap["out"]["kernel"], ap["out"]["bias"], num_heads, eps)
    out = mlp_fn(h, mp["fc1"]["kernel"], mp["fc1"]["bias"],
                 mp["fc2"]["kernel"], mp["fc2"]["bias"], p["norm3"]["scale"],
                 p["norm3"]["bias"], eps)
    return out.reshape(B, T, -1)
