"""Fused kernels for the adapters of pipelines M and T, forward and
backward, with plain versions.

Port of ``vlm_clip_tpu/ops/fused_adapter.py``. Kernels written by hand in
CUDA C++ for Hopper in ``vlm_clip_tpu_torch/csrc/fused_adapter.cu``:

- :func:`seq_adapter_fused`      ``y = LN(x + gelu(x@W1+b1)@W2+b2)``
  (forward replaces ``_seq_fwd_kernel``, fused_adapter.py:310; backward
  ``_seq_bwd_kernel``, :328);
- :func:`cross_attn_block_fused` ``u = LN(x@Wt+bt)``,
  ``y = u + MHA(u@Wq+bq; shared k, v)@Wo+bo`` (``_cab_fwd_kernel`` :796,
  ``_cab_bwd_kernel`` :807);
- :func:`prenorm_mlp_fused`      ``y = x + gelu(LN(x)@W1+b1)@W2+b2``
  (``_pnmlp_fwd_kernel`` :532, ``_pnmlp_bwd_kernel`` :550);
- :func:`feature_adapter_blend_fused`
  ``y = l2norm(r*(relu(x@W1+b1)*mask)@W2+b2 + (1-r)*x)``, the T/V
  feature adapter with the TPU kernel's counter-hash dropout
  (``_feat_fwd_kernel`` :109, ``_feat_bwd_kernel`` :127).

Each wrapper launches its kernel for a CUDA tensor and takes the plain
version beside it (``*_torch``, differentiated by autograd) only for a
CPU tensor. K1 and K3 take every width; K2 takes what the reference's
fused path takes (any widths, at most MAX_SHARED_KV shared K/V rows:
:func:`cross_attn_block_supported`, which ``models/adapters.py`` reads to
route a longer K/V to the plain version under ``impl="auto"``, as the
reference does). A wrapper raises on a CUDA tensor whose shapes its
kernels do not take. In bf16, K3 and K2 (forward and backward) run on
the tensor cores, each as a few passes behind one C call, at the widths
:func:`prenorm_mlp_tensor_cores` and :func:`cross_attn_block_tensor_cores`
admit, and on the CUDA-core kernels that fp32 takes at the others. K1
(fp32 math in both dtypes, forward and backward) runs its products as
error-compensated TF32 on the tensor cores (split big + small, three
passes, two where the operand is a bf16 x) at the widths
:func:`seq_adapter_tensor_cores` admits, and so do the fp32 weight
gradients of the others (:func:`_wgrad`). K6, forward and backward, is
one launch of thread-block clusters each. On CUDA, a call that
needs a gradient goes through a
``torch.autograd.Function`` whose forward launches the forward kernel and
saves only the inputs (as the TPU rules do), and whose backward launches
the backward kernel (``*_bwd_cuda``), which recomputes the rest. The
plain backwards (``*_bwd_torch``) write out the TPU kernels' formulas;
the card tests hold the backward kernels against them.

The plain versions compute what the TPU kernels compute, rounding point
for rounding point: K1 and K6 in fp32 with fp32 weights; K2 and K3 with every
matmul operand rounded to ``x.dtype`` and fp32 accumulation, LN and
softmax in fp32. Differences from the TPU kernels: the softmax max is
taken per head (the TPU kernel takes one max per row over all heads,
which can underflow a head far below another), the shared K/V is passed
as ``[Tk, H]`` (no block-diagonal packing), and GELU and its derivative
are exact (erf) where the TPU kernels use an erf polynomial. Each wrapper
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from vlm_clip_tpu_torch.ops.build import aligned16, load_library

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint


def _lib() -> ctypes.CDLL:
    lib = load_library("fused_adapter")
    if not getattr(lib, "_typed", False):
        lib.vct_seq_adapter_fwd.argtypes = [_I] + [_P] * 7 + [_F, _P, _P] \
            + [_I] * 3 + [_P]
        lib.vct_prenorm_mlp_fwd.argtypes = [_I] + [_P] * 7 + [_F, _P] \
            + [_I] * 3 + [_P]
        lib.vct_cross_attn_block_fwd.argtypes = [_I] + [_P] * 12 \
            + [_F, _F, _P, _P] + [_I] * 5 + [_P]
        lib.vct_seq_adapter_bwd.argtypes = [_I] + [_P] * 7 + [_F] \
            + [_P] * 5 + [_I] * 3 + [_P]
        lib.vct_prenorm_mlp_bwd.argtypes = [_I] + [_P] * 7 + [_F] \
            + [_P] * 6 + [_I] * 3 + [_P]
        lib.vct_prenorm_mlp_bwd_bf16.argtypes = [_P] * 7 + [_F] \
            + [_P] * 6 + [_I] * 4 + [_P]
        lib.vct_cross_attn_block_bwd.argtypes = [_I] + [_P] * 11 \
            + [_F, _F] + [_P] * 10 + [_I] * 5 + [_P]
        lib.vct_prenorm_mlp_fwd_bf16.argtypes = [_P] * 7 + [_F] \
            + [_P] * 2 + [_I] * 3 + [_P]
        lib.vct_cross_attn_block_bwd_bf16.argtypes = [_P] * 11 \
            + [_F, _F] + [_P] * 3 + [_I] * 5 + [_P]
        lib.vct_wgrad.argtypes = [_I, _I, _P, _I, _I, _P, _I, _I, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _P,
                                  ctypes.c_size_t, _P]
        lib.vct_wgrad_tf32.argtypes = [_I, _P, _I, _I, _P, _I, _I, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _P,
                                       ctypes.c_size_t, _P]
        lib.vct_seq_adapter_bwd_tf32.argtypes = [_I] + [_P] * 7 + [_F] \
            + [_P] * 5 + [_I] * 3 + [_P]
        lib.vct_colsum.argtypes = [_P, _I, _I, _P, _P]
        feat = [_F, _U, _U, _F]  # ratio, seed, dropout threshold, 1/keep
        lib.vct_feature_adapter_fwd.argtypes = [_I] + [_P] * 5 + feat \
            + [_P] * 2 + [_I] * 3 + [_P]
        lib.vct_feature_adapter_bwd.argtypes = [_I] + [_P] * 5 + feat \
            + [_P] * 4 + [_I] * 3 + [_P]
        for fn in (lib.vct_seq_adapter_fwd, lib.vct_prenorm_mlp_fwd,
                   lib.vct_cross_attn_block_fwd, lib.vct_seq_adapter_bwd,
                   lib.vct_prenorm_mlp_bwd, lib.vct_prenorm_mlp_bwd_bf16,
                   lib.vct_cross_attn_block_bwd,
                   lib.vct_prenorm_mlp_fwd_bf16,
                   lib.vct_cross_attn_block_bwd_bf16,
                   lib.vct_wgrad, lib.vct_wgrad_tf32,
                   lib.vct_seq_adapter_bwd_tf32, lib.vct_colsum,
                   lib.vct_feature_adapter_fwd, lib.vct_feature_adapter_bwd):
            fn.restype = _I
        lib.vct_seq_adapter_smem.argtypes = [_I, _I]
        lib.vct_prenorm_mlp_smem.argtypes = [_I]
        lib.vct_cross_attn_block_smem.argtypes = [_I, _I]
        lib.vct_seq_adapter_bwd_smem.argtypes = [_I, _I]
        lib.vct_prenorm_mlp_bwd_smem.argtypes = [_I]
        lib.vct_cross_attn_block_bwd_smem.argtypes = [_I, _I]
        lib.vct_cross_attn_block_bwd_rows.argtypes = [_I, _I]
        lib.vct_cross_attn_block_bwd_rows.restype = _I
        lib.vct_prenorm_mlp_fwd_bf16_ws.argtypes = [_I] * 3
        lib.vct_prenorm_mlp_bwd_ws.argtypes = [_I] * 2
        lib.vct_seq_adapter_bwd_tf32_ws.argtypes = [_I] * 3
        lib.vct_seq_adapter_fwd_ws.argtypes = [_I] * 3
        lib.vct_feature_adapter_bwd_ws.argtypes = [_I] * 3
        lib.vct_feature_adapter_fwd_ws.argtypes = [_I] * 3
        lib.vct_cross_attn_block_bwd_bf16_ws.argtypes = [_I] * 5
        lib.vct_cross_attn_block_fwd_ws.argtypes = [_I] * 6
        for fn in (lib.vct_seq_adapter_smem, lib.vct_prenorm_mlp_smem,
                   lib.vct_cross_attn_block_smem,
                   lib.vct_seq_adapter_bwd_smem,
                   lib.vct_prenorm_mlp_bwd_smem,
                   lib.vct_cross_attn_block_bwd_smem,
                   lib.vct_prenorm_mlp_fwd_bf16_ws,
                   lib.vct_prenorm_mlp_bwd_ws,
                   lib.vct_seq_adapter_bwd_tf32_ws,
                   lib.vct_seq_adapter_fwd_ws,
                   lib.vct_feature_adapter_bwd_ws,
                   lib.vct_feature_adapter_fwd_ws,
                   lib.vct_cross_attn_block_bwd_bf16_ws,
                   lib.vct_cross_attn_block_fwd_ws):
            fn.restype = ctypes.c_size_t
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' semantics; used on the CPU)
# ---------------------------------------------------------------------------

def _ln32(z, ls, lb, eps):
    """fp32 LayerNorm, statistics as the TPU kernels take them."""
    mean = z.mean(dim=-1, keepdim=True)
    zc = z - mean
    var = (zc * zc).mean(dim=-1, keepdim=True)
    return zc * torch.rsqrt(var + eps) * ls.float() + lb.float()


def _r(a, dt):
    """Round to the matmul operand type, then widen to fp32."""
    return a.to(dt).float()


def seq_adapter_torch(x, w1, b1, w2, b2, ls, lb, eps: float = 1e-5):
    xf = x.float()
    h = F.gelu(xf @ w1.float() + b1.float())
    z = xf + h @ w2.float() + b2.float()
    return _ln32(z, ls, lb, eps).to(x.dtype)


def prenorm_mlp_torch(x, w1, b1, w2, b2, ls, lb, eps: float = 1e-5):
    mm = x.dtype
    xf = x.float()
    um = _r(_ln32(xf, ls, lb, eps), mm)
    h = _r(F.gelu(um @ _r(w1, mm) + b1.float()), mm)
    return ((xf + b2.float()) + h @ _r(w2, mm)).to(mm)


def cross_attn_block_torch(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo,
                           heads: int, eps: float = 1e-5):
    mm = x.dtype
    t = _r(x, mm) @ _r(wt, mm) + bt.float()
    u = _ln32(t, ls, lb, eps)
    q = _r(u, mm) @ _r(wq, mm) + bq.float()
    N, H = q.shape
    Tk, hd = k.shape[0], H // heads
    qh = _r(q, mm).reshape(N, heads, hd).transpose(0, 1)   # [h, N, hd]
    kh = _r(k, mm).reshape(Tk, heads, hd).transpose(0, 1)  # [h, Tk, hd]
    vh = _r(v, mm).reshape(Tk, heads, hd).transpose(0, 1)
    probs = torch.softmax((qh @ kh.transpose(1, 2)) * hd ** -0.5, dim=-1)
    o = (_r(probs, mm) @ vh).transpose(0, 1).reshape(N, H)
    return (u + (_r(o, mm) @ _r(wo, mm) + bo.float())).to(mm)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact GELU: Phi(x) + x phi(x)."""
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) \
        + x * 0.3989422804014327 * torch.exp(-0.5 * x * x)


def _ln_stats(z, eps):
    """(xhat, inv) of an fp32 LayerNorm, as the kernels take them."""
    mean = z.mean(dim=-1, keepdim=True)
    zc = z - mean
    inv = torch.rsqrt((zc * zc).mean(dim=-1, keepdim=True) + eps)
    return zc * inv, inv


def _ln_bwd(dxhat, xhat, inv):
    """LayerNorm backward from d(xhat): the TPU kernels' formula."""
    return inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))


def seq_adapter_bwd_torch(x, w1, b1, w2, b2, ls, lb, g, eps: float = 1e-5,
                          need_dx: bool = True):
    """Gradients of :func:`seq_adapter_torch` for the cotangent g, as
    ``_seq_bwd_kernel`` computes them (fp32 throughout): (dx, dw1, db1,
    dw2, db2, dls, dlb), dx in x's dtype (None unless need_dx), the rest
    fp32. ``lb`` does not enter the gradients."""
    del lb
    xf, w1f, w2f, gf = x.float(), w1.float(), w2.float(), g.float()
    pre = xf @ w1f + b1.float()
    h = F.gelu(pre)
    xhat, inv = _ln_stats(xf + h @ w2f + b2.float(), eps)
    dz = _ln_bwd(gf * ls.float(), xhat, inv)
    dpre = (dz @ w2f.T) * gelu_grad(pre)
    dx = (dz + dpre @ w1f.T).to(x.dtype) if need_dx else None
    return (dx, xf.T @ dpre, dpre.sum(0), h.T @ dz, dz.sum(0),
            (gf * xhat).sum(0), gf.sum(0))


def prenorm_mlp_bwd_torch(x, w1, b1, w2, b2, ls, lb, g, eps: float = 1e-5,
                          need_dx: bool = True):
    """Gradients of :func:`prenorm_mlp_torch`, as ``_pnmlp_bwd_kernel``
    computes them: g, dpre, u and h rounded to x.dtype before each
    product, fp32 accumulation, dx = g + dx_ln kept in fp32 until the
    final cast. Returns (dx, dw1, db1, dw2, db2, dls, dlb)."""
    del b2
    mm = x.dtype
    xf, gf = x.float(), g.float()
    xhat, inv = _ln_stats(xf, eps)
    um = _r(xhat * ls.float() + lb.float(), mm)
    gm = _r(gf, mm)
    w1m, w2m = _r(w1, mm), _r(w2, mm)
    pre = um @ w1m + b1.float()
    dpre = (gm @ w2m.T) * gelu_grad(pre)
    dpm = _r(dpre, mm)
    du = dpm @ w1m.T
    dx = (gf + _ln_bwd(du * ls.float(), xhat, inv)).to(mm) if need_dx \
        else None
    return (dx, um.T @ dpm, dpre.sum(0), _r(F.gelu(pre), mm).T @ gm,
            gf.sum(0), (du * xhat).sum(0), du.sum(0))


def cross_attn_block_bwd_torch(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo, g,
                               heads: int, eps: float = 1e-5,
                               need_dx: bool = True):
    """Gradients of :func:`cross_attn_block_torch`, per head against k, v
    [Tk, H], rounding o, g, probs, do, ds, q, u, dq, x and dt to x.dtype
    before each product as ``_cab_bwd_kernel`` does. Returns (dx, dwt,
    dbt, dls, dlb, dwq, dbq, dk, dv, dwo, dbo); dk, dv are [Tk, H]."""
    del bo
    mm = x.dtype
    N, H = x.shape[0], wt.shape[1]
    Tk, hd = k.shape[0], H // heads
    scale = hd ** -0.5
    xm, wtm, wqm, wom = _r(x, mm), _r(wt, mm), _r(wq, mm), _r(wo, mm)
    xhat, inv = _ln_stats(xm @ wtm + bt.float(), eps)
    um = _r(xhat * ls.float() + lb.float(), mm)
    qm = _r(um @ wqm + bq.float(), mm)
    qh = qm.reshape(N, heads, hd).transpose(0, 1)          # [h, N, hd]
    kh = _r(k, mm).reshape(Tk, heads, hd).transpose(0, 1)  # [h, Tk, hd]
    vh = _r(v, mm).reshape(Tk, heads, hd).transpose(0, 1)
    p = torch.softmax((qh @ kh.transpose(1, 2)) * scale, dim=-1)
    pm = _r(p, mm)
    om = _r((pm @ vh).transpose(0, 1).reshape(N, H), mm)
    gf = g.float()
    gm = _r(gf, mm)
    dom = _r(gm @ wom.T, mm)
    domh = dom.reshape(N, heads, hd).transpose(0, 1)
    dv = (pm.transpose(1, 2) @ domh).transpose(0, 1).reshape(Tk, H)
    dp = domh @ vh.transpose(1, 2)
    dsm = _r(p * (dp - (dp * p).sum(-1, keepdim=True)) * scale, mm)
    dk = (dsm.transpose(1, 2) @ qh).transpose(0, 1).reshape(Tk, H)
    dqp = (dsm @ kh).transpose(0, 1).reshape(N, H)
    dqm = _r(dqp, mm)
    du = gf + dqm @ wqm.T
    dt = _ln_bwd(du * ls.float(), xhat, inv)
    dtm = _r(dt, mm)
    dx = (dtm @ wtm.T).to(mm) if need_dx else None
    return (dx, xm.T @ dtm, dt.sum(0), (du * xhat).sum(0), du.sum(0),
            um.T @ dqm, dqp.sum(0), dk, dv, om.T @ gm, gf.sum(0))


ROW_TILE = 256  # K6's row tile on the TPU: its dropout hash keys on it
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``b``, in halves so that no product leaves int64."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _M32


def dropout_constants(dropout: float):
    """(uint32 threshold, fp32 scale of a kept element) of K6's dropout:
    ``uint32(keep * 4294967295.0)`` with the product in double, truncated,
    and ``float32(1) / float32(keep)``, as the TPU kernel computes them."""
    keep = 1.0 - dropout
    return (int(keep * 4294967295.0),
            float(np.float32(1.0) / np.float32(keep)))


def feature_dropout_mask(n: int, k: int, seed: int, dropout: float,
                         device="cpu") -> torch.Tensor:
    """K6's dropout mask [n, k] (0 or 1/keep, fp32), bit for bit the TPU
    kernel's ``_dropout_mask`` (fused_adapter.py:87-106): a murmur-style
    hash of (row within its 256-row tile, column, seed + tile * 1000003)
    in wrapping uint32 arithmetic, kept where it is below the threshold.
    int64 masked to 32 bits stands in for uint32."""
    threshold, scale = dropout_constants(dropout)
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    key = ((int(seed) & _M32) + (rows // ROW_TILE) * 1000003) & _M32
    h = _mul32(rows % ROW_TILE, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA77) \
        ^ _mul32(key, 0xC2B2AE3D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    return (h < threshold).float() * scale


def _feat_hidden(xf, w1, b1, dropout, seed):
    """(pre, mask or None, h = relu(pre) * mask) of K6, fp32."""
    pre = xf @ w1.float() + b1.float()
    h = torch.relu(pre)
    mask = None
    if dropout > 0.0:
        mask = feature_dropout_mask(xf.shape[0], h.shape[1], seed or 0,
                                    dropout, xf.device)
        h = h * mask
    return pre, mask, h


def feature_adapter_blend_torch(x, w1, b1, w2, b2, ratio: float,
                                dropout: float = 0.0, seed=None):
    """y = l2norm(r*(relu(x@w1+b1)*mask)@w2+b2 + (1-r)*x) in fp32, y in
    x's dtype; the norm is rsqrt(sum z^2) with no eps, as the TPU
    kernel's."""
    xf = x.float()
    _, _, h = _feat_hidden(xf, w1, b1, dropout, seed)
    z = ratio * (h @ w2.float() + b2.float()) + (1.0 - ratio) * xf
    return (z * torch.rsqrt((z * z).sum(-1, keepdim=True))).to(x.dtype)


def feature_adapter_blend_bwd_torch(x, w1, b1, w2, b2, ratio: float, g,
                                    dropout: float = 0.0, seed=None,
                                    need_dx: bool = True):
    """Gradients of :func:`feature_adapter_blend_torch` for the cotangent
    g, as ``_feat_bwd_kernel`` (fused_adapter.py:137-176) computes them in
    fp32: dz = (g - y<g, y>) inv, da = r dz, dh = da w2^T * mask where
    pre > 0, dx = (1-r) dz + dh w1^T. Returns (dx, dw1, db1, dw2, db2), dx
    in x's dtype (None unless need_dx), the rest fp32."""
    xf, gf = x.float(), g.float()
    pre, mask, h = _feat_hidden(xf, w1, b1, dropout, seed)
    z = ratio * (h @ w2.float() + b2.float()) + (1.0 - ratio) * xf
    inv = torch.rsqrt((z * z).sum(-1, keepdim=True))
    y = z * inv
    dz = (gf - y * (gf * y).sum(-1, keepdim=True)) * inv
    da = ratio * dz
    dh = da @ w2.float().T
    if mask is not None:
        dh = dh * mask
    dh = torch.where(pre > 0.0, dh, 0.0)
    dx = ((1.0 - ratio) * dz + dh @ w1.float().T).to(x.dtype) if need_dx \
        else None
    return dx, xf.T @ dh, dh.sum(0), h.T @ da, da.sum(0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor; False for a CPU one (plain version)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _check_shapes(name, x, expected):
    """Raise unless x is [rows, features] and each (label, tensor, shape)
    has its shape: the kernels read every parameter at the length x's
    width implies, so a short bias would be read past its end."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [rows, features], got "
                         f"{tuple(x.shape)}")
    bad = [f"{label} {tuple(t.shape)} (want {want})"
           for label, t, want in expected if tuple(t.shape) != want]
    if bad:
        raise ValueError(f"{name}: for x {tuple(x.shape)}, wrong shapes: "
                         + ", ".join(bad))


def _check_mlp_shapes(name, x, w1, b1, w2, b2, ls, lb):
    H, K = x.shape[-1], w1.shape[-1]
    _check_shapes(name, x, [("w1", w1, (H, K)), ("b1", b1, (K,)),
                            ("w2", w2, (K, H)), ("b2", b2, (H,)),
                            ("ls", ls, (H,)), ("lb", lb, (H,))])


def _check_inputs(name, x, tensors):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, "
                             f"got one on {t.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _as(t, dtype):
    return t.to(dtype).contiguous()


def _launch(name, fn, smem, x, *args):
    """Launch on the current stream of x's device; raise on a refused
    launch (e.g. more shared memory than the device allows a block; smem:
    the bytes a block asks for, None for a chain of kernels)."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(int(x.dtype == torch.bfloat16), *args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}" + (
                               "" if smem is None else
                               f" ({smem} B of shared memory per block)"))


def _check_err(name, err):
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


SMS = 132  # H100 SXM streaming multiprocessors


def _splits(n: int, tiles: int) -> int:
    """Row chunks for a weight gradient on the CUDA cores: enough blocks
    for two waves of the card, no chunk under 256 rows, at most 16."""
    return max(1, min(16, -(-2 * SMS // tiles), n // 256))


def _tc_splits(n: int, tiles: int) -> int:
    """Row chunks for a weight gradient on the tensor cores (two blocks
    fit an SM): at most one wave of the card, no chunk under 256 rows, at
    most 16. A second wave that is mostly empty would take as long as
    the first."""
    return max(1, min(16, 2 * SMS // tiles, n // 256))


def _tf32_route(a, b, p, q, lda, sa, ldb, sb) -> bool:
    """Whether a weight gradient with an fp32 b takes the error-compensated
    TF32 tensor cores: every row of both operands copies in 16-byte
    chunks (4 fp32 or 8 bf16 elements) from a 16-byte aligned start."""
    ea = 8 if a.dtype == torch.bfloat16 else 4
    return (b.dtype == torch.float32 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0
            and all(v % ea == 0 for v in (lda, sa, p))
            and all(v % 4 == 0 for v in (ldb, sb, q)))


def _bf16_tc_route(a, b, p, q, lda, sa, ldb, sb) -> bool:
    """Whether a weight gradient with two bf16 operands takes the bf16
    tensor cores: every row of both operands copies in 16-byte chunks
    (8 elements) from a 16-byte aligned start, and p and q are multiples
    of 8. vct_wgrad makes the same choice in C."""
    return (a.dtype == b.dtype == torch.bfloat16
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            and all(v % 8 == 0 for v in (lda, sa, ldb, sb, p, q)))


def _wgrad(a, b, out, p, q, *, lda=None, sa=0, ldb=None, sb=0, ldo=None,
           so=0, z=1):
    """out[z*so + i*ldo + j] = sum_r a[r, z*sa + i] * b[r, z*sb + j] for
    i < p, j < q: a weight gradient summed over every row, in fp32. Two
    bf16 operands whose rows copy in 16-byte chunks
    (:func:`_bf16_tc_route`) take the bf16 tensor cores (128 x 128 output
    tiles); an fp32 b whose rows copy in 16-byte chunks
    (:func:`_tf32_route`) the error-compensated TF32 tensor cores (128 x
    64 tiles: three passes, two with a bf16 a); the others the CUDA cores
    (64 x 64)."""
    n = a.shape[0]
    lda, ldb = lda or a.shape[1], ldb or b.shape[1]
    bf16 = _bf16_tc_route(a, b, p, q, lda, sa, ldb, sb)
    tf32 = not bf16 and _tf32_route(a, b, p, q, lda, sa, ldb, sb)
    if bf16:
        splits = _tc_splits(n, -(-p // 128) * -(-q // 128) * z)
    elif tf32:
        splits = _tc_splits(n, -(-p // 128) * -(-q // 64) * z)
    else:
        splits = _splits(n, -(-p // 64) * -(-q // 64) * z)
    work = torch.empty(splits * out.numel() if splits > 1 else 0,
                       dtype=torch.float32, device=a.device)
    args = (a.data_ptr(), lda, sa, b.data_ptr(), ldb, sb, out.data_ptr(),
            ldo or out.shape[-1], so, n, p, q, z, splits, work.data_ptr(),
            out.numel(), _stream(a))
    a_bf16 = int(a.dtype == torch.bfloat16)
    with torch.cuda.device(a.device):
        if tf32:
            _check_err("wgrad", _lib().vct_wgrad_tf32(a_bf16, *args))
        else:
            _check_err("wgrad", _lib().vct_wgrad(
                a_bf16, int(b.dtype == torch.bfloat16), *args))
    return out


def _colsum(part, out=None):
    """The row passes' per-tile column sums [tiles, V] -> [V] (into out,
    a contiguous fp32 [V], when given), in tile order."""
    if out is None:
        out = torch.empty(part.shape[1], dtype=torch.float32,
                          device=part.device)
    with torch.cuda.device(part.device):
        _check_err("colsum", _lib().vct_colsum(
            part.data_ptr(), part.shape[0], part.shape[1], out.data_ptr(),
            _stream(part)))
    return out


def _grads_like(grads, inputs, needs):
    """Each gradient in its input's dtype, None where none is needed."""
    return tuple(g.to(t.dtype) if (n and g is not None) else None
                 for g, t, n in zip(grads, inputs, needs))


MAX_SHARED_KV = 256  # rows of the batch-shared K/V K2 takes
ROWS = 32      # row tile of the K1/K3 kernels
TC_ROWS = 128  # row tile of K3's bf16 backward products (its db1 partials)
LN_ROWS = 32   # row tile of K3's bf16 LN backward (db2, dls, dlb partials)


# --- shape gate -------------------------------------------------------------
#
# K2 takes the reference's fused path's shapes: at most MAX_SHARED_KV
# shared K/V rows (its ATTN_SEG_MAX, past which the reference computes
# the block plainly). models/adapters.py reads this predicate to route
# such a call to the plain version under impl="auto", before any launch
# (as ops/decode_attention.py routes K8); the wrapper raises on it. K1 and
# K3 take every width, as the reference's kernels do.

def cross_attn_block_supported(tk: int) -> bool:
    """K2 takes 0 < Tk <= MAX_SHARED_KV shared K/V rows."""
    return 0 < tk <= MAX_SHARED_KV


# --- K1: sequence adapter --------------------------------------------------

def seq_adapter_tensor_cores(h: int, k: int) -> bool:
    """K1, forward and backward, runs on the TF32 tensor cores where every
    row copies in 16-byte chunks (h a multiple of 8, k of 4), else on the
    CUDA cores (``seq_adapter_fwd_kernel``, ``seq_adapter_bwd_kernel``):
    both compute the same fp32 function."""
    return h % 8 == 0 and k % 4 == 0


def _seq_fwd_launch(x, w1, b1, w2, b2, ls, lb, eps):
    """K1's forward: three error-compensated TF32 passes (h = gelu(x W1 +
    b1), z = (x + h W2) + b2, y = LN(z)) through one workspace at the
    widths :func:`seq_adapter_tensor_cores` admits, the CUDA-core kernel
    at the others; one C call either way."""
    name = "seq_adapter_fused"
    N, H = x.shape
    K = w1.shape[1]
    x = aligned16(x)
    w1, b1, w2, b2, ls, lb = (aligned16(_as(t, torch.float32))
                              for t in (w1, b1, w2, b2, ls, lb))
    y = torch.empty_like(x)
    if N:
        lib = _lib()
        tc = seq_adapter_tensor_cores(H, K)
        ws = torch.empty(lib.vct_seq_adapter_fwd_ws(N, H, K),
                         dtype=torch.uint8, device=x.device)
        _launch(name, lib.vct_seq_adapter_fwd,
                None if tc else lib.vct_seq_adapter_smem(H, K), x,
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), ls.data_ptr(), lb.data_ptr(), float(eps),
                y.data_ptr(), ws.data_ptr(), N, H, K)
        seq_adapter_fused.launches += 1
    return y


def seq_adapter_bwd_cuda(x, w1, b1, w2, b2, ls, lb, g, eps: float = 1e-5,
                         need_dx: bool = True):
    """Backward kernel of K1: same results as :func:`seq_adapter_bwd_torch`
    (dx in x's dtype, the rest fp32), for CUDA tensors. Its products run
    as error-compensated TF32 on the tensor cores (about 2^-22 relative a
    product; two passes where one operand is a bf16 x, three otherwise)
    at the widths :func:`seq_adapter_tensor_cores` admits, fp32 FMAs
    on the CUDA cores at the others."""
    name = "seq_adapter_bwd"
    N, H = x.shape
    K = w1.shape[1]
    x = aligned16(x)
    g = aligned16(_as(g, x.dtype))
    w1, b1, w2, b2, ls = (aligned16(_as(t, torch.float32))
                          for t in (w1, b1, w2, b2, ls))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    alloc = torch.empty if N else torch.zeros  # the kernels write all
    dw1, dw2 = alloc(H, K, **f32), alloc(K, H, **f32)
    vec = alloc(K + 3 * H, **f32)
    lib = _lib()
    if N and seq_adapter_tensor_cores(H, K):
        ws = torch.empty(lib.vct_seq_adapter_bwd_tf32_ws(N, H, K),
                         dtype=torch.uint8, device=x.device)
        with torch.cuda.device(x.device):
            _check_err(name, lib.vct_seq_adapter_bwd_tf32(
                int(x.dtype == torch.bfloat16), x.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ls.data_ptr(),
                g.data_ptr(), float(eps),
                None if dx is None else dx.data_ptr(), dw1.data_ptr(),
                dw2.data_ptr(), vec.data_ptr(), ws.data_ptr(), N, H, K,
                _stream(x)))
        seq_adapter_bwd_cuda.launches += 1
    elif N:
        hb, dpre = torch.empty(N, K, **f32), torch.empty(N, K, **f32)
        dz = torch.empty(N, H, **f32)
        part = torch.empty(-(-N // ROWS), K + 3 * H, **f32)
        _launch(name, lib.vct_seq_adapter_bwd,
                lib.vct_seq_adapter_bwd_smem(H, K), x, x.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                ls.data_ptr(), g.data_ptr(), float(eps),
                None if dx is None else dx.data_ptr(), hb.data_ptr(),
                dpre.data_ptr(), dz.data_ptr(), part.data_ptr(), N, H, K)
        _wgrad(x, dpre, dw1, H, K)
        _wgrad(hb, dz, dw2, K, H)
        vec = _colsum(part)
        seq_adapter_bwd_cuda.launches += 1
    db1, db2, dls, dlb = vec.split([K, H, H, H])
    return dx, dw1, db1, dw2, db2, dls, dlb


class _SeqAdapterFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ls, lb, eps):
        ctx.save_for_backward(x, w1, b1, w2, b2, ls, lb)
        ctx.eps = eps
        return _seq_fwd_launch(x, w1, b1, w2, b2, ls, lb, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[:7]
        grads = seq_adapter_bwd_cuda(*inputs, g, ctx.eps, need_dx=needs[0])
        return _grads_like(grads, inputs, needs) + (None,)


def seq_adapter_fused(x, w1, b1, w2, b2, ls, lb, eps: float = 1e-5):
    """y = LN(x + gelu(x@w1+b1)@w2+b2) over [N, H] rows, fp32 math."""
    name = "seq_adapter_fused"
    params = (w1, b1, w2, b2, ls, lb)
    _check_mlp_shapes(name, x, *params)
    if not _on_cuda(x, name):
        return seq_adapter_torch(x, *params, eps)
    _check_inputs(name, x, params)
    if _needs_grad(x, *params):
        return _SeqAdapterFn.apply(x, *params, eps)
    return _seq_fwd_launch(x, *params, eps)


# --- K3: pre-norm MLP ------------------------------------------------------

def prenorm_mlp_tensor_cores(h: int, k: int) -> bool:
    """K3 in bf16 runs on the tensor cores, forward and backward, where
    every row copies in 16-byte chunks (h and k multiples of 8), else on
    the CUDA cores (``prenorm_mlp_fwd_kernel``, ``prenorm_mlp_bwd_kernel``,
    which fp32 takes at every width): both compute the same function."""
    return h % 8 == 0 and k % 8 == 0


def _pnmlp_fwd_launch(x, w1, b1, w2, b2, ls, lb, eps):
    name = "prenorm_mlp_fused"
    N, H = x.shape
    K = w1.shape[1]
    x = x.contiguous()
    w1, w2 = _as(w1, x.dtype), _as(w2, x.dtype)
    b1, b2, ls, lb = (_as(t, torch.float32) for t in (b1, b2, ls, lb))
    y = torch.empty_like(x)
    if N and x.dtype == torch.bfloat16 and prenorm_mlp_tensor_cores(H, K):
        # the tensor-core passes, one call: LN, the hidden product with
        # its GELU epilogue, the output product with the residual; um and
        # hm in one scratch buffer
        lib = _lib()
        x, w1, w2 = (aligned16(t) for t in (x, w1, w2))
        ws = torch.empty(lib.vct_prenorm_mlp_fwd_bf16_ws(N, H, K),
                         dtype=torch.uint8, device=x.device)
        with torch.cuda.device(x.device):
            _check_err(name, lib.vct_prenorm_mlp_fwd_bf16(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), ls.data_ptr(), lb.data_ptr(), float(eps),
                y.data_ptr(), ws.data_ptr(), N, H, K, _stream(x)))
        prenorm_mlp_fused.launches += 1
    elif N:
        lib = _lib()
        _launch(name, lib.vct_prenorm_mlp_fwd, lib.vct_prenorm_mlp_smem(H),
                x, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), ls.data_ptr(), lb.data_ptr(),
                float(eps), y.data_ptr(), N, H, K)
        prenorm_mlp_fused.launches += 1
    return y


def prenorm_mlp_bwd_cuda(x, w1, b1, w2, b2, ls, lb, g, eps: float = 1e-5,
                         need_dx: bool = True):
    """Backward kernel of K3: same results as
    :func:`prenorm_mlp_bwd_torch`, for CUDA tensors. bf16 at the widths of
    :func:`prenorm_mlp_tensor_cores` runs on the tensor cores (LN forward,
    the dual product with its GELU epilogue, du = dpm W1^T, the LN
    backward, then the weight gradients), fp32 and the other bf16 widths
    on the CUDA cores (one row pass, then CUDA-core weight gradients);
    both then sum their ordered partials."""
    name = "prenorm_mlp_bwd"
    N, H = x.shape
    K = w1.shape[1]
    x = x.contiguous()
    mm = x.dtype
    g = _as(g, mm)
    w1, w2 = _as(w1, mm), _as(w2, mm)
    b1, ls, lb = (_as(t, torch.float32) for t in (b1, ls, lb))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    alloc = torch.empty if N else torch.zeros  # the kernels write every
    dw1, dw2 = alloc(H, K, **f32), alloc(K, H, **f32)  # element
    vec = alloc(K + 3 * H, **f32)
    if N and mm == torch.bfloat16 and prenorm_mlp_tensor_cores(H, K):
        # the tensor-core passes, one call: bf16 um, hm, dpm and fp32 du,
        # LN stats, db1 partials per 128-row tile, [db2 | dls | dlb]
        # partials per 32-row tile and the weight gradients' row chunks
        x, g, w1, w2 = (aligned16(t) for t in (x, g, w1, w2))
        splits = _tc_splits(N, -(-H // 128) * -(-K // 128))
        act = torch.empty(N * (H + 2 * K), dtype=mm, device=x.device)
        scratch = torch.empty(N * H + 2 * N + -(-N // TC_ROWS) * K
                              + -(-N // LN_ROWS) * 3 * H
                              + (splits * H * K if splits > 1 else 0), **f32)
        with torch.cuda.device(x.device):
            _check_err(name, _lib().vct_prenorm_mlp_bwd_bf16(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                ls.data_ptr(), lb.data_ptr(), g.data_ptr(), float(eps),
                None if dx is None else dx.data_ptr(), dw1.data_ptr(),
                dw2.data_ptr(), vec.data_ptr(), act.data_ptr(),
                scratch.data_ptr(), splits, N, H, K, _stream(x)))
        prenorm_mlp_bwd_cuda.launches += 1
    elif N:
        lib = _lib()
        um = torch.empty(N, H, dtype=mm, device=x.device)
        hm = torch.empty(N, K, dtype=mm, device=x.device)
        dpm = torch.empty(N, K, dtype=mm, device=x.device)
        part = torch.empty(-(-N // ROWS), K + 3 * H, **f32)
        # its [32, H] row tiles past shared memory (H over 519): a slice
        # of this workspace a block
        ws = lib.vct_prenorm_mlp_bwd_ws(N, H)
        rows = torch.empty(ws // 4, **f32) if ws else None
        _launch(name, lib.vct_prenorm_mlp_bwd,
                lib.vct_prenorm_mlp_bwd_smem(H), x, x.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), ls.data_ptr(),
                lb.data_ptr(), g.data_ptr(), float(eps),
                None if dx is None else dx.data_ptr(), um.data_ptr(),
                hm.data_ptr(), dpm.data_ptr(), part.data_ptr(),
                None if rows is None else rows.data_ptr(), N, H, K)
        _wgrad(um, dpm, dw1, H, K)
        _wgrad(hm, g, dw2, K, H)
        _colsum(part, vec)
        prenorm_mlp_bwd_cuda.launches += 1
    db1, db2, dls, dlb = vec.split([K, H, H, H])
    return dx, dw1, db1, dw2, db2, dls, dlb


class _PrenormMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ls, lb, eps):
        ctx.save_for_backward(x, w1, b1, w2, b2, ls, lb)
        ctx.eps = eps
        return _pnmlp_fwd_launch(x, w1, b1, w2, b2, ls, lb, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[:7]
        grads = prenorm_mlp_bwd_cuda(*inputs, g, ctx.eps, need_dx=needs[0])
        return _grads_like(grads, inputs, needs) + (None,)


def prenorm_mlp_fused(x, w1, b1, w2, b2, ls, lb, eps: float = 1e-5):
    """y = x + gelu(LN(x)@w1+b1)@w2+b2 over [N, H] rows; matmul operands
    in x.dtype, fp32 accumulation, LN in fp32."""
    name = "prenorm_mlp_fused"
    params = (w1, b1, w2, b2, ls, lb)
    _check_mlp_shapes(name, x, *params)
    if not _on_cuda(x, name):
        return prenorm_mlp_torch(x, *params, eps)
    _check_inputs(name, x, params)
    if _needs_grad(x, *params):
        return _PrenormMlpFn.apply(x, *params, eps)
    return _pnmlp_fwd_launch(x, *params, eps)


# --- K2: cross-modal attention block ---------------------------------------

def cross_attn_block_tensor_cores(h: int, heads: int) -> bool:
    """K2 in bf16 runs on the tensor cores, forward and backward, where
    its heads are a multiple of 8 columns, at most 128 (the attention
    pass zero-fills a head to 64 or 128 columns); the text width is
    zero-padded to a multiple of 8 there. At other head widths the bf16
    forward and backward run the CUDA-core kernels fp32 takes at every
    width (``cross_attn_block_fwd_kernel``, ``cross_attn_block_bwd_kernel``
    and CUDA-core weight gradients)."""
    hd = h // heads
    return hd % 8 == 0 and hd <= 128


def _pad_din(x, wt):
    """x's columns and wt's rows zero-padded to a multiple of 8, for the
    tensor-core passes' 16-byte tile loads; the zeros change no
    product."""
    pad = -x.shape[1] % 8
    if pad:
        x = F.pad(x, (0, pad))
        wt = F.pad(wt, (0, 0, 0, pad))
    return x, wt


def _cab_fwd_launch(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo, heads, eps):
    """K2's forward, one C call: in bf16 at the widths of
    :func:`cross_attn_block_tensor_cores`, the five tensor-core passes
    with their scratch; otherwise the CUDA-core kernel (K^T [H, Tk])."""
    name = "cross_attn_block_fused"
    N = x.shape[0]
    H, Tk = wt.shape[1], k.shape[0]
    x = x.contiguous()
    mm = x.dtype
    wt, wq, wo, k, v = (_as(t, mm) for t in (wt, wq, wo, k, v))
    bt, ls, lb, bq, bo = (_as(t, torch.float32) for t in (bt, ls, lb, bq,
                                                          bo))
    y = torch.empty((N, H), dtype=mm, device=x.device)
    if not N:
        return y
    lib = _lib()
    tc = mm == torch.bfloat16 and cross_attn_block_tensor_cores(H, heads)
    if tc:
        x, wt = _pad_din(x, wt)
        x, wt, wq, wo, k, v = (aligned16(t) for t in (x, wt, wq, wo, k, v))
        kt = None
    else:
        kt = _as(k.t(), mm)  # [H, Tk]: the scores' weight, read row-major
    din = x.shape[1]
    ws = torch.empty(lib.vct_cross_attn_block_fwd_ws(1, N, din, H, heads,
                                                     Tk),
                     dtype=torch.uint8, device=x.device) if tc else None
    _launch(name, lib.vct_cross_attn_block_fwd,
            None if tc else lib.vct_cross_attn_block_smem(din, H), x,
            x.data_ptr(), wt.data_ptr(), bt.data_ptr(), ls.data_ptr(),
            lb.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            k.data_ptr() if tc else None,
            None if kt is None else kt.data_ptr(), v.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), float(eps),
            float((H // heads) ** -0.5), y.data_ptr(),
            None if ws is None else ws.data_ptr(), N, din, H, heads, Tk)
    cross_attn_block_fused.launches += 1
    return y


def _cab_bwd_bf16(x, wt, bt, ls, lb, wq, bq, k, v, wo, g, heads, eps,
                  need_dx):
    """K2 backward's tensor-core passes, one call (bf16, N > 0): the
    gradients in one fp32 buffer, the intermediates in one scratch
    buffer. x's columns (and wt's rows) are zero-padded to a multiple of 8
    for the 16-byte tile loads, which changes no product. Returns (dx,
    dwt, dbt, dls, dlb, dwq, dbq, dk, dv, dwo, dbo)."""
    name = "cross_attn_block_bwd"
    N, Din = x.shape
    H, Tk = wt.shape[1], k.shape[0]
    hd = H // heads
    x, wt = _pad_din(x, wt)
    din = x.shape[1]
    tkp = -(-Tk // 8) * 8  # each head's keys in pm, dsm, dk, dv
    x, g, wt, wq, wo, k, v = (aligned16(t)
                              for t in (x, g, wt, wq, wo, k, v))
    lib = _lib()
    ws = torch.empty(lib.vct_cross_attn_block_bwd_bf16_ws(N, din, H, heads,
                                                          Tk),
                     dtype=torch.uint8, device=x.device)
    sizes = [din * H, H * H, H * H, tkp * H, tkp * H, 5 * H]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    with torch.cuda.device(x.device):
        _check_err(name, lib.vct_cross_attn_block_bwd_bf16(
            x.data_ptr(), wt.data_ptr(), bt.data_ptr(), ls.data_ptr(),
            lb.data_ptr(), wq.data_ptr(), bq.data_ptr(), k.data_ptr(),
            v.data_ptr(), wo.data_ptr(), g.data_ptr(), float(eps),
            float(hd ** -0.5), None if dx is None else dx.data_ptr(),
            grads.data_ptr(), ws.data_ptr(), N, din, H, heads, Tk,
            _stream(x)))
    dwt, dwq, dwo, dk, dv, vec = grads.split(sizes)
    dbo, dls, dlb, dbt, dbq = vec.split([H] * 5)
    if dx is not None and din != Din:
        dx = dx[:, :Din].contiguous()
    return (dx, dwt.view(din, H)[:Din], dbt, dls, dlb, dwq.view(H, H), dbq,
            dk.view(tkp, H)[:Tk], dv.view(tkp, H)[:Tk], dwo.view(H, H), dbo)


def cross_attn_block_bwd_cuda(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo, g,
                              heads: int, eps: float = 1e-5,
                              need_dx: bool = True):
    """Backward kernel of K2: same results as
    :func:`cross_attn_block_bwd_torch` (dk, dv [Tk, H]), for CUDA
    tensors. bf16 at the widths of :func:`cross_attn_block_tensor_cores`
    runs on the tensor cores (the products t, q, dom, du and dx, the LN
    passes, one attention pass per row tile and head, then the weight
    gradients), fp32 and the other bf16 head widths on the CUDA cores (one
    row pass, with every intermediate in x's dtype, then CUDA-core weight
    gradients); both then sum their ordered partials."""
    name = "cross_attn_block_bwd"
    N, Din = x.shape
    H, Tk = wt.shape[1], k.shape[0]
    hd = H // heads
    x = x.contiguous()
    mm = x.dtype
    g = _as(g, mm)
    wt, wq, wo, k, v = (_as(t, mm) for t in (wt, wq, wo, k, v))
    bt, ls, lb, bq = (_as(t, torch.float32) for t in (bt, ls, lb, bq))
    if N and mm == torch.bfloat16 and cross_attn_block_tensor_cores(H, heads):
        out = _cab_bwd_bf16(x, wt, bt, ls, lb, wq, bq, k, v, wo, g, heads,
                            eps, need_dx)
        cross_attn_block_bwd_cuda.launches += 1
        return out
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    dwt = torch.zeros(Din, H, **f32)
    dwq, dwo = torch.zeros(H, H, **f32), torch.zeros(H, H, **f32)
    dk, dv = torch.zeros(Tk, H, **f32), torch.zeros(Tk, H, **f32)
    vec = torch.zeros(5 * H, **f32)
    if N:
        lib = _lib()
        um, qm, om, dom, dqm, dtm = (
            torch.empty(N, H, dtype=mm, device=x.device) for _ in range(6))
        pm, dsm = (torch.empty(N, heads * Tk, dtype=mm, device=x.device)
                   for _ in range(2))
        rows = lib.vct_cross_attn_block_bwd_rows(Din, H)  # its row tile
        part = torch.empty(-(-N // rows), 5 * H, **f32)
        _launch(name, lib.vct_cross_attn_block_bwd,
                lib.vct_cross_attn_block_bwd_smem(Din, H), x, x.data_ptr(),
                wt.data_ptr(), bt.data_ptr(), ls.data_ptr(), lb.data_ptr(),
                wq.data_ptr(), bq.data_ptr(), k.data_ptr(), v.data_ptr(),
                wo.data_ptr(), g.data_ptr(), float(eps), float(hd ** -0.5),
                None if dx is None else dx.data_ptr(), um.data_ptr(),
                qm.data_ptr(), om.data_ptr(), dom.data_ptr(), pm.data_ptr(),
                dsm.data_ptr(), dqm.data_ptr(), dtm.data_ptr(),
                part.data_ptr(), N, Din, H, heads, Tk)
        # the CUDA cores: bf16 heads here need not copy in 16-byte rows
        _wgrad(om, g, dwo, H, H)
        # per head (z): dv_h = pm_h^T dom_h, dk_h = dsm_h^T qm_h
        _wgrad(pm, dom, dv, Tk, hd, sa=Tk, sb=hd, so=hd, z=heads)
        _wgrad(dsm, qm, dk, Tk, hd, sa=Tk, sb=hd, so=hd, z=heads)
        _wgrad(um, dqm, dwq, H, H)
        _wgrad(x, dtm, dwt, Din, H)
        vec = _colsum(part)
        cross_attn_block_bwd_cuda.launches += 1
    dbo, dbq, dls, dlb, dbt = vec.split([H] * 5)
    return dx, dwt, dbt, dls, dlb, dwq, dbq, dk, dv, dwo, dbo


class _CrossAttnBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wt, bt, ls, lb, wq, bq, k, v, wo, bo, heads, eps):
        ctx.save_for_backward(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo)
        ctx.heads, ctx.eps = heads, eps
        return _cab_fwd_launch(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo,
                               heads, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[:11]
        grads = cross_attn_block_bwd_cuda(*inputs, g, ctx.heads, ctx.eps,
                                          need_dx=needs[0])
        return _grads_like(grads, inputs, needs) + (None, None)


def cross_attn_block_fused(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo,
                           heads: int, eps: float = 1e-5):
    """u = LN(x@wt+bt); y = u + MHA(u@wq+bq; k, v)@wo+bo over [N, Din]
    rows, against a K/V [Tk, H] shared by every row. Matmul operands in
    x.dtype, fp32 accumulation, LN and softmax in fp32. Gradients reach
    k and v as [Tk, H]."""
    name = "cross_attn_block_fused"
    params = (wt, bt, ls, lb, wq, bq, k, v, wo, bo)
    Din, H, Tk = x.shape[-1], wt.shape[-1], k.shape[0]
    _check_shapes(name, x, [
        ("wt", wt, (Din, H)), ("bt", bt, (H,)), ("ls", ls, (H,)),
        ("lb", lb, (H,)), ("wq", wq, (H, H)), ("bq", bq, (H,)),
        ("k", k, (Tk, H)), ("v", v, (Tk, H)), ("wo", wo, (H, H)),
        ("bo", bo, (H,))])
    if not _on_cuda(x, name):
        return cross_attn_block_torch(x, *params, heads, eps)
    _check_inputs(name, x, params)
    if H % heads:
        raise ValueError(f"{name}: H {H} is not a multiple of heads "
                         f"{heads}")
    if not cross_attn_block_supported(Tk):
        raise ValueError(f"{name}: the kernel takes 0 < Tk <= "
                         f"{MAX_SHARED_KV} shared K/V rows; got Tk {Tk}")
    if _needs_grad(x, *params):
        return _CrossAttnBlockFn.apply(x, *params, heads, eps)
    return _cab_fwd_launch(x, *params, heads, eps)


# --- K6: feature adapter blend ---------------------------------------------

def _feat_args(ratio, dropout, seed):
    """The kernels' (ratio, seed, threshold, 1/keep) arguments."""
    threshold, scale = dropout_constants(dropout) if dropout > 0.0 \
        else (0, 1.0)
    return (float(ratio), (int(seed or 0) & _M32) if dropout > 0.0 else 0,
            threshold, scale)


def _f32(t):
    """t as a contiguous fp32 tensor: itself when it is one already (the
    weights of the T path are), so the wrapper makes no copy or call."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


@functools.lru_cache(maxsize=256)
def _feat_bwd_ws(n: int, d: int, k: int) -> int:
    """Bytes of scratch K6's backward needs at these shapes (0 within one
    group of rows whose buffers fit shared memory), asked of the library
    once a shape."""
    return _lib().vct_feature_adapter_bwd_ws(n, d, k)


@functools.lru_cache(maxsize=256)
def _feat_fwd_ws(n: int, d: int, k: int) -> int:
    """Bytes of scratch K6's forward needs: 0 unless a block's row
    buffers do not fit its shared memory (D / 8 + K past some 3,370)."""
    return _lib().vct_feature_adapter_fwd_ws(n, d, k)


def _scratch(nbytes: int, device):
    return torch.empty(nbytes, dtype=torch.uint8, device=device) \
        if nbytes else None


def _feat_fwd_launch(x, w1, b1, w2, b2, ratio, dropout, seed):
    """K6's forward: one launch of 8-block clusters (a cluster per group
    of rows, each block an eighth of D), one C call; only y is
    allocated, and a workspace for the widest shapes."""
    name = "feature_adapter_blend_fused"
    N, D = x.shape
    K = w1.shape[1]
    x = x if x.is_contiguous() else x.contiguous()
    w1, b1, w2, b2 = _f32(w1), _f32(b1), _f32(w2), _f32(b2)
    y = torch.empty_like(x)
    if N:
        ws = _scratch(_feat_fwd_ws(N, D, K), x.device)
        _launch(name, _lib().vct_feature_adapter_fwd, None, x, x.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                *_feat_args(ratio, dropout, seed), y.data_ptr(),
                None if ws is None else ws.data_ptr(), N, D, K)
        feature_adapter_blend_fused.launches += 1
    return y


def feature_adapter_blend_bwd_cuda(x, w1, b1, w2, b2, ratio: float, g,
                                   dropout: float = 0.0, seed=None,
                                   need_dx: bool = True):
    """Backward kernel of K6: same results as
    :func:`feature_adapter_blend_bwd_torch`, for CUDA tensors. One launch
    of 8-block thread-block clusters, a cluster per group of up to 64 rows
    (each block an eighth of D), writes dx and the weight and bias
    gradients, views of one flat fp32 buffer; past one group, one more
    launch adds the groups' partials in group order. Every D and K: where
    a block's row buffers do not fit its shared memory they live in the
    workspace."""
    name = "feature_adapter_blend_bwd"
    N, D = x.shape
    K = w1.shape[1]
    x = x if x.is_contiguous() else x.contiguous()
    g = g if g.dtype == x.dtype and g.is_contiguous() else _as(g, x.dtype)
    w1, b1, w2, b2 = _f32(w1), _f32(b1), _f32(w2), _f32(b2)
    dx = torch.empty_like(x) if need_dx else None
    alloc = torch.empty if N else torch.zeros  # the kernel writes all
    flat = alloc(2 * D * K + K + D, dtype=torch.float32, device=x.device)
    if N:
        ws = _scratch(_feat_bwd_ws(N, D, K), x.device)
        _launch(name, _lib().vct_feature_adapter_bwd, None, x, x.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                *_feat_args(ratio, dropout, seed), g.data_ptr(),
                None if dx is None else dx.data_ptr(), flat.data_ptr(),
                None if ws is None else ws.data_ptr(), N, D, K)
        feature_adapter_blend_bwd_cuda.launches += 1
    dw1, db1, dw2, db2 = flat.split([D * K, K, K * D, D])
    return dx, dw1.view(D, K), db1, dw2.view(K, D), db2


class _FeatureAdapterFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ratio, dropout, seed):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.ratio, ctx.dropout, ctx.seed = ratio, dropout, seed
        return _feat_fwd_launch(x, w1, b1, w2, b2, ratio, dropout, seed)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        grads = feature_adapter_blend_bwd_cuda(
            *inputs, ctx.ratio, g, ctx.dropout, ctx.seed, need_dx=needs[0])
        return _grads_like(grads, inputs, needs) + (None, None, None)


def feature_adapter_blend_fused(x, w1, b1, w2, b2, ratio: float,
                                dropout: float = 0.0, seed=None):
    """y = l2norm(r*(relu(x@w1+b1)*mask)@w2+b2 + (1-r)*x) over [N, D]
    rows, fp32 math, y in x's dtype. With ``dropout`` > 0 the mask is the
    TPU kernel's counter hash of ``seed`` (an int), which the backward
    regenerates."""
    name = "feature_adapter_blend_fused"
    params = (w1, b1, w2, b2)
    D, K = x.shape[-1], w1.shape[-1]
    _check_shapes(name, x, [("w1", w1, (D, K)), ("b1", b1, (K,)),
                            ("w2", w2, (K, D)), ("b2", b2, (D,))])
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"{name}: dropout must be in [0, 1), got "
                         f"{dropout}")
    seed = None if seed is None else int(seed)
    if not _on_cuda(x, name):
        return feature_adapter_blend_torch(x, *params, ratio, dropout, seed)
    _check_inputs(name, x, params)
    if _needs_grad(x, *params):
        return _FeatureAdapterFn.apply(x, *params, ratio, dropout, seed)
    return _feat_fwd_launch(x, *params, ratio, dropout, seed)


seq_adapter_fused.launches = 0
prenorm_mlp_fused.launches = 0
cross_attn_block_fused.launches = 0
seq_adapter_bwd_cuda.launches = 0
cross_attn_block_bwd_cuda.launches = 0
prenorm_mlp_bwd_cuda.launches = 0
feature_adapter_blend_fused.launches = 0
feature_adapter_blend_bwd_cuda.launches = 0

FORWARD = (seq_adapter_fused, cross_attn_block_fused, prenorm_mlp_fused)
BACKWARD = (seq_adapter_bwd_cuda, cross_attn_block_bwd_cuda,
            prenorm_mlp_bwd_cuda)
M_KERNELS = FORWARD + BACKWARD  # pipeline M's adapters (K1-K3)
T_KERNELS = (feature_adapter_blend_fused, feature_adapter_blend_bwd_cuda)
KERNELS = M_KERNELS + T_KERNELS


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts(kernels=KERNELS) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}
