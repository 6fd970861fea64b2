"""Functional NN primitives on parameter trees (port of
``vlm_clip_tpu/models/layers.py``).

Plain functions over nested-dict params. Layout as in the reference:
linear kernels ``[in, out]``, LayerNorm ``{'scale', 'bias'}``, encoder
layers stacked on a leading layer axis (run here as a Python loop).

Precision follows the reference's rounding points: a matmul whose fp32
result the reference rounds straight to the compute dtype runs as a
matmul in that dtype (same value: fp32 accumulation, one rounding);
where the reference keeps the fp32 result (attention scores) the
operands are widened to fp32 first. One deviation: ``linear`` adds a
bf16 bias through ``addmm`` (the bias is rounded to bf16 before the fp32
add; the reference adds the fp32 bias).

A tensor-parallel rank's tree (``parallel/sharding.shard_params`` with
the CLIP rules) runs through the same functions: ``linear`` hands a
sharded leaf to ``parallel/tensor_parallel.apply`` (column-parallel
q/k/v and ``fc1``, row-parallel ``out`` and ``fc2``), and :func:`mha`
attends over the heads its q/k/v shards hold.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vlm_clip_tpu_torch.ops import attention as fa
from vlm_clip_tpu_torch.parallel import tensor_parallel as TP
from vlm_clip_tpu_torch.utils import profiling

Params = Dict[str, Any]

NEG_INF = torch.finfo(torch.float32).min  # matches HF mask fill


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

# Params are fp32 (the reference's param_dtype), created on ``device``.

def init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                std: Optional[float] = None, device="cpu") -> Params:
    if std is None:
        std = in_dim ** -0.5
    return {
        "kernel": torch.randn(in_dim, out_dim, generator=gen,
                              device=device) * std,
        "bias": torch.zeros(out_dim, device=device),
    }


def init_layernorm(dim: int, device="cpu") -> Params:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def uniform(gen: torch.Generator, shape, bound: float,
            device="cpu") -> torch.Tensor:
    """U(-bound, bound), the reference's kaiming-uniform-flavored init."""
    u = torch.rand(*shape, generator=gen, device=device)
    return (u * 2.0 - 1.0) * bound


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel + bias in x's dtype; a tensor-parallel shard across its
    ranks."""
    if isinstance(p, TP.TPLinear):
        return TP.apply(p, x, _linear)
    return _linear(p, x)


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    k = p["kernel"].to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    y = (torch.addmm(p["bias"].to(x.dtype), x2, k) if "bias" in p
         else x2 @ k)  # a row shard's bias is added after its all-reduce
    return y.reshape(*x.shape[:-1], k.shape[-1])


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5,
               stable_dtype=torch.float32) -> torch.Tensor:
    """LayerNorm with statistics in ``stable_dtype`` (bf16 under FAST)."""
    xs = x.to(stable_dtype)
    mean = xs.mean(dim=-1, keepdim=True)
    d = xs - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + torch.tensor(eps, dtype=stable_dtype))
    y = y * p["scale"].to(stable_dtype) + p["bias"].to(stable_dtype)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    # CLIP's activation: x * sigmoid(1.702 x)
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu_exact,
               "relu": torch.relu}


def fused_route(device: str, dtype: torch.dtype, head_dim: int,
                self_attention: bool, mask: Optional[torch.Tensor], T: int,
                grad: bool, fused: Optional[bool]) -> bool:
    """Whether :func:`mha` takes K5 for attention over heads of
    ``head_dim`` columns on ``device`` (its type) in ``dtype``:
    self-attention (k's batch and length equal q's) under a mask layout K5
    supports, and then under ``fused=True`` or the global toggle, or else
    by itself where the kernel computes the same function at no lower
    precision and nothing is lost: on a CUDA device in bf16, at heads the
    tensor-core kernel takes, with no input needing a gradient (``grad``
    False: K5's backward is a plain recompute). ``fused=False`` never
    takes it. So the CPU, fp32, trained towers and cross-attention keep
    the unfused branch unless asked."""
    if fused is False or not (self_attention and fa.supports(mask, T)):
        return False
    if fused or fa.fused_attention_enabled():
        return True
    return (device == "cuda" and dtype == torch.bfloat16
            and fa.kernel_width(head_dim) <= 128 and not grad)


def mha(p: Params, q_in: torch.Tensor, kv_in: torch.Tensor, num_heads: int,
        mask: Optional[torch.Tensor] = None,
        stable_dtype=torch.float32,
        fused: Optional[bool] = None) -> torch.Tensor:
    """Multi-head attention. q_in [B,Tq,H], kv_in [B,Tk,H] or [1,Tk,H].

    ``mask`` is an additive bias broadcastable to [B, heads, Tq, Tk].
    With a batch-1 ``kv_in`` and a batch-N query, k/v are projected once
    and broadcast inside the products (the reference's ``khd`` branch).
    Softmax runs in fp32, or max-subtracted in bf16 when ``stable_dtype``
    is bf16 (FAST).

    Self-attention takes the fused attention K5 (``ops/attention.py``,
    fp32 softmax whatever ``stable_dtype``) where :func:`fused_route`
    says: by itself on the card in bf16 when no input needs a gradient
    (the frozen towers), everywhere it applies under ``fused=True`` or the
    global toggle ``set_fused_attention``, never under ``fused=False``.
    K5 reads q, k and v as the projections leave them and writes its
    output where the out-projection reads it. Tensor-parallel q/k/v
    shards give this rank's heads.

    While tracing is on (``utils/profiling``) a call adds the bytes of the
    attention scores it writes out to the counter
    ``layers.attn_score_bytes``: the scores tensor of the unfused branch,
    0 for K5, which keeps its scores on chip.
    """
    B, Tq, H = q_in.shape
    hd = H // num_heads
    scale = hd ** -0.5
    q = linear(p["q"], q_in).reshape(B, Tq, -1, hd).transpose(1, 2)
    h = q.shape[1]  # this rank's heads
    k = linear(p["k"], kv_in).reshape(kv_in.shape[0], -1, h, hd)
    v = linear(p["v"], kv_in).reshape(kv_in.shape[0], -1, h, hd)
    k, v = k.transpose(1, 2), v.transpose(1, 2)  # [Bk, h, Tk, hd]
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, mask))
    if fused_route(q.device.type, q.dtype, hd,
                   B == k.shape[0] and Tq == k.shape[2], mask, Tq, grad,
                   fused):
        out = fa.fused_attention(q, k, v, scale, mask)
        profiling.count("layers.attn_score_bytes", 0)
        return linear(p["out"], out.transpose(1, 2).reshape(B, Tq, h * hd))
    if k.shape[0] == 1 and B != 1:
        k, v = k[0], v[0]  # [h, Tk, hd], broadcast over the batch
    if stable_dtype == torch.float32:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if mask is not None:
            scores = scores + mask.float()
        probs = torch.softmax(scores, dim=-1)
    else:
        q = q * scale
        scores = torch.matmul(q, k.transpose(-1, -2)).to(stable_dtype)
        if mask is not None:
            scores = scores + mask.to(scores.dtype)
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        probs = e / e.sum(dim=-1, keepdim=True)
    profiling.count("layers.attn_score_bytes",
                    scores.numel() * scores.element_size())
    out = torch.matmul(probs.to(q_in.dtype), v)  # [B, h, Tq, hd]
    out = out.transpose(1, 2).reshape(B, Tq, h * hd)
    return linear(p["out"], out)


def init_mha(gen: torch.Generator, dim: int, device="cpu") -> Params:
    return {name: init_linear(gen, dim, dim, device=device)
            for name in ("q", "k", "v", "out")}


def mlp(p: Params, x: torch.Tensor, act: str = "quick_gelu") -> torch.Tensor:
    return linear(p["fc2"], ACTIVATIONS[act](linear(p["fc1"], x)))


def init_mlp(gen: torch.Generator, dim: int, hidden: int,
             device="cpu") -> Params:
    return {"fc1": init_linear(gen, dim, hidden, device=device),
            "fc2": init_linear(gen, hidden, dim, device=device)}


# ---------------------------------------------------------------------------
# pre-norm transformer encoder layer (CLIP style) + stacked layers
# ---------------------------------------------------------------------------

def encoder_layer(p: Params, x: torch.Tensor, num_heads: int, eps: float,
                  act: str, mask: Optional[torch.Tensor] = None,
                  stable_dtype=torch.float32) -> torch.Tensor:
    h = layer_norm(p["ln1"], x, eps, stable_dtype)
    x = x + mha(p["attn"], h, h, num_heads, mask, stable_dtype)
    x = x + mlp(p["mlp"], layer_norm(p["ln2"], x, eps, stable_dtype), act)
    return x


def init_encoder_layer(gen: torch.Generator, dim: int, hidden: int,
                       device="cpu") -> Params:
    return {
        "attn": init_mha(gen, dim, device),
        "mlp": init_mlp(gen, dim, hidden, device),
        "ln1": init_layernorm(dim, device),
        "ln2": init_layernorm(dim, device),
    }


def stack_trees(trees: list) -> Params:
    """Per-layer trees -> one tree with a leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_slice(v, i) for k, v in stacked.items()}
    if isinstance(stacked, TP.TPLinear):
        return stacked.map(lambda t: t[i])
    return stacked[i]


def num_layers(stacked: Params) -> int:
    while isinstance(stacked, (dict, TP.TPLinear)):
        stacked = (stacked.inner if isinstance(stacked, TP.TPLinear)
                   else next(iter(stacked.values())))
    return int(stacked.shape[0])


def init_encoder_stack(gen: torch.Generator, n_layers: int, dim: int,
                       hidden: int, device="cpu") -> Params:
    """Stacked layer params with a leading layer axis."""
    return stack_trees([init_encoder_layer(gen, dim, hidden, device)
                        for _ in range(n_layers)])


def encoder_stack(p: Params, x: torch.Tensor, num_heads: int, eps: float,
                  act: str, mask: Optional[torch.Tensor] = None,
                  stable_dtype=torch.float32,
                  remat: bool = False) -> torch.Tensor:
    """The reference's ``lax.scan`` over stacked layers, as a loop.
    ``remat=True`` checkpoints each layer (its activations are recomputed
    in the backward instead of kept), as the reference's ``remat``."""
    for i in range(num_layers(p)):
        args = (layer_slice(p, i), x, num_heads, eps, act, mask,
                stable_dtype)
        if remat and torch.is_grad_enabled():
            x = checkpoint(encoder_layer, *args, use_reentrant=False)
        else:
            x = encoder_layer(*args)
    return x


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 0.0) -> torch.Tensor:
    """L2 normalization in fp32 (matches torch `x / x.norm(dim=-1)`)."""
    x32 = x.float()
    return (x32 / (x32.norm(dim=dim, keepdim=True) + eps)).to(x.dtype)
