"""Short-sequence attention of the frozen CLIP towers (K5), with its plain
version.

Port of ``vlm_clip_tpu/ops/attention.py``. :func:`fused_attention`
computes ``softmax(q k^T * scale + mask) v`` over ``[B, h, T, d]`` q, k,
v: scores in fp32, the mask added in fp32, the softmax in fp32 (whatever
the caller's ``stable_dtype``), p rounded to v's dtype after it is
normalized, ``p v`` accumulated in fp32, the output in q's dtype. On a
CUDA tensor it launches the kernel written by hand for Hopper in
``vlm_clip_tpu_torch/csrc/attention.cu`` (replaces ``_attn_kernel_nomask``
:59 and ``_attn_kernel_mask`` :63; heads of any width): in bf16 with
heads up to 128 wide on the tensor cores, two passes over 64-key chunks
(row max and sum, then p rounded after it is normalized, times v); in
fp32, and in bf16 with heads of 129-256 columns, on the CUDA cores with
the same passes and rounding points; heads wider than 256 on the CUDA
cores too, streamed in column chunks of at most 256 (the scores summed
over the chunks, the output written one column chunk at a time), with
the same passes and rounding points. On a CPU
tensor it takes :func:`fused_attention_torch` (the reference's
``_xla_attention``).

Masks: none, ``[T, T]`` or ``[B|1, 1, T, T]`` (:func:`supports`); a
batch-broadcast ``[1, 1, T, T]`` mask is expanded to B before the kernel
reads it. The kernels take heads of 64, 128 and 256 columns, and past
256 any multiple of 64; a head runs zero-padded to the next of these
widths (:func:`kernel_width`; zero columns change no score). The
backward is the
reference's plain recompute (:func:`fused_attention_bwd_torch`,
attention.py:160-189) inside a ``torch.autograd.Function``, mask
cotangent included: the reference has no backward kernel, so the port
has none either.

The kernels read q, k and v, and write the output, through their batch,
head and row strides (each row's columns contiguous): the [B, h, T, d]
views of [B, T, h d] projections are read where they lie, and the output
takes q's layout, so the out-projection reads it without a copy. A view
whose rows the tensor-core kernel's 16-byte copies cannot take is copied
first.

The towers' self-attention takes this path on the card in bf16, at heads
the tensor-core kernel takes and with no input needing a gradient
(``models/layers.fused_route``: the frozen towers under ``no_grad``);
``set_fused_attention(True)`` or ``mha(..., fused=True)`` takes it
wherever it applies, on the CPU too (the reference's opt-in, off by
default there). ``fused_attention.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from vlm_clip_tpu_torch.ops.build import aligned16, load_library

HEAD_DIMS = (64, 128, 256)  # the kernels' head widths (every CLIP preset: 64)
WIDE_STEP = 64  # past 256: the column-chunk kernel's widths, multiples of 64


def kernel_width(d: int) -> int:
    """The kernel width a head of d columns runs at, zero-padded: the
    least of HEAD_DIMS that is at least d, past 256 the least multiple of
    WIDE_STEP (the column-chunk route)."""
    for w in HEAD_DIMS:
        if d <= w:
            return w
    return -(-d // WIDE_STEP) * WIDE_STEP

_ENABLED = False


def set_fused_attention(on: bool) -> None:
    """Global opt-in consulted by models/layers.py:mha: on, mha takes K5
    wherever it applies; off (the default), only where
    ``layers.fused_route`` routes it by itself."""
    global _ENABLED
    _ENABLED = bool(on)


def fused_attention_enabled() -> bool:
    return _ENABLED


def supports(mask: Optional[torch.Tensor], T: int) -> bool:
    """Mask layouts this kernel handles."""
    if mask is None:
        return True
    if mask.dim() == 2:
        return tuple(mask.shape) == (T, T)
    if mask.dim() == 4:
        return mask.shape[1] == 1 and tuple(mask.shape[2:]) == (T, T)
    return False


def _lib() -> ctypes.CDLL:
    lib = load_library("attention")
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.vct_attention_fwd.argtypes = [
            ctypes.c_int, P, P, P, ctypes.POINTER(ctypes.c_longlong), P,
            ctypes.c_longlong, ctypes.c_float, P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, P]
        lib.vct_attention_fwd.restype = ctypes.c_int
        lib.vct_attention_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.vct_attention_smem.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _scores(q, k, scale, mask):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s + (mask if mask.dim() == 4 else mask[None, None]).float()
    return s


def fused_attention_torch(q, k, v, scale: float,
                          mask: Optional[torch.Tensor] = None):
    """The plain version (the reference's ``_xla_attention``)."""
    p = torch.softmax(_scores(q, k, scale, mask), dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def fused_attention_bwd_torch(q, k, v, scale: float,
                              mask: Optional[torch.Tensor], g):
    """The reference's recompute backward (attention.py:160-189): (dq, dk,
    dv, dmask) in the inputs' dtypes; dmask is None without a mask, summed
    over batch and heads for a [T, T] mask, over heads (and the batch,
    for a batch-broadcast one) for a 4-D mask."""
    p = torch.softmax(_scores(q, k, scale, mask), dim=-1)
    g32 = g.float()
    dv = p.transpose(-1, -2) @ g32
    dp = g32 @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    dmask = None
    if mask is not None:
        if mask.dim() == 2:
            dmask = ds.sum(dim=(0, 1))
        else:
            dmask = ds.sum(dim=1, keepdim=True)
            if mask.shape[0] == 1:
                dmask = dmask.sum(dim=0, keepdim=True)
        dmask = dmask.to(mask.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dmask


def _operand(t, tensor_cores: bool):
    """t as the kernels read it, through its batch, head and row strides:
    as it is where each row's columns are contiguous (and, on the
    tensor-core route, every row starts on a 16-byte boundary, as its
    16-byte copies need), else a contiguous copy."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    if tensor_cores and (t.data_ptr() % 16
                         or any(s % 8 for s in t.stride()[:3])):
        t = aligned16(t)
    return t


def _launch(q, k, v, scale, mask):
    B, h, T, d = q.shape
    w = kernel_width(d)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = [q, k, v] + ([] if mask is None else [mask])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"fused_attention: all tensors must be on "
                         f"{q.device}")
    if d < w:
        # narrower heads run zero-padded to the kernel's width: the zero
        # columns add nothing to a score and give zero output columns
        q, k, v = (F.pad(t, (0, w - d)) for t in (q, k, v))
    tensor_cores = q.dtype == torch.bfloat16 and w <= 128
    q, k, v = (_operand(t, tensor_cores) for t in (q, k, v))
    m, bstride = None, 0
    if mask is not None:
        m = mask.float()
        if m.dim() == 4:
            # a batch-broadcast [1, 1, T, T] mask is expanded to B: every
            # batch reads the same rows (batch stride 0)
            m = m.expand(B, 1, T, T)
            if m.stride(3) != 1 or m.stride(2) != T:
                m = m.contiguous()
            bstride = m.stride(0)
        else:
            m = m.contiguous()
    # in q's layout: for the [B, h, T, d] view of a [B, T, h d] projection
    # a [B, T, h, d] buffer, whose [B, T, h d] view is the out-projection's
    # input with no copy
    out = torch.empty_like(q)
    if B * h * T:
        lib = _lib()
        bf16 = int(q.dtype == torch.bfloat16)
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, out) for s in t.stride()[:3]))
        with torch.cuda.device(q.device):
            err = lib.vct_attention_fwd(
                bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
                None if m is None else m.data_ptr(), bstride,
                float(scale), out.data_ptr(), B, h, T, w,
                torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(
                f"fused_attention: CUDA kernel launch failed with cudaError "
                f"{err} ({lib.vct_attention_smem(bf16, w)} B of shared "
                "memory per block)")
        fused_attention.launches += 1
    return out[..., :d].contiguous() if d < w else out


def _forward(q, k, v, scale, mask):
    if q.device.type == "cpu":
        return fused_attention_torch(q, k, v, scale, mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    return _launch(q, k, v, scale, mask)


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        return _forward(q, k, v, scale, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        grads = fused_attention_bwd_torch(q, k, v, ctx.scale, mask, g)
        return tuple(gr if need else None for gr, need in
                     zip(grads, ctx.needs_input_grad[:4])) + (None,)


def fused_attention(q, k, v, scale: float,
                    mask: Optional[torch.Tensor] = None):
    """Attention over [B, h, T, d] q, k, v -> [B, h, T, d] (see the
    module docstring for the masks and the precision)."""
    B, h, T, d = q.shape
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"fused_attention: q, k, v must share a shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not supports(mask, T) or (mask is not None and mask.dim() == 4
                                 and mask.shape[0] not in (1, B)):
        raise ValueError(f"fused_attention: unsupported mask shape "
                         f"{tuple(mask.shape)} for q {tuple(q.shape)}")
    tensors = [q, k, v] + ([] if mask is None else [mask])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _AttentionFn.apply(q, k, v, mask, scale)
    return _forward(q, k, v, scale, mask)


fused_attention.launches = 0


def reset_launch_counts() -> None:
    fused_attention.launches = 0


def launch_counts() -> dict:
    return {"fused_attention": fused_attention.launches}
