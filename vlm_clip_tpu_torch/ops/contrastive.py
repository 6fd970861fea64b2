"""Fused contrastive head (K4): l2norm -> scaled BxB logits -> symmetric
CE, with its analytic backward, and plain versions.

Port of ``vlm_clip_tpu/ops/contrastive.py``. The kernels are written by
hand in CUDA C++ for Hopper in ``vlm_clip_tpu_torch/csrc/contrastive.cu``
(forward replaces ``_fwd_kernel``, contrastive.py:52; backward
``_bwd_kernel``, :68):

    Z = exp(s) * tn @ mn^T,  tn, mn the rows over their L2 norms
    loss = (CE_rows(Z, arange B) + CE_cols(Z, arange B)) / 2
    dZ = g ((softmax_rows(Z) - I) + (softmax_cols(Z) - I)) / 2B
    d_txt, d_img through the norm; d_logit_scale = sum(dZ * Z)

All math in fp32 on the inputs widened to fp32. The TPU version holds
the batch in one block and hands batches above 1024 to XLA. Here the
forward and the backward are one launch each of an 8-block thread-block
cluster for every batch whose rows fit its blocks' shared memory
(:func:`bwd_cluster_max`: B <= 128 at D = 512), the logits kept on the
chip, the forward built from the backward's steps (so its row and column
LSEs are the bits the backward recomputes); past that the logits live
in device memory and each pass is its own kernel. So the kernels take
every batch size and nothing switches to the plain version on the card.
:func:`contrastive_loss_fused` launches the kernels for CUDA tensors
(through a ``torch.autograd.Function`` that saves only its inputs when a
gradient is needed) and takes :func:`contrastive_loss_torch` only for
CPU tensors. Launches are counted in ``contrastive_loss_fused.launches``
(forward) and ``contrastive_loss_bwd_cuda.launches`` (backward).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from vlm_clip_tpu_torch.ops.build import aligned16, load_library
from vlm_clip_tpu_torch.ops.fused_adapter import _needs_grad, _on_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("contrastive")
    if not getattr(lib, "_typed", False):
        lib.vct_contrastive_fwd.argtypes = [_I] + [_P] * 5 + [_I, _I, _P]
        lib.vct_contrastive_bwd.argtypes = [_I] + [_P] * 8 + [_I, _I, _P]
        lib.vct_contrastive_cluster_lse.argtypes = \
            [_I, _I] + [_P] * 8 + [_I, _I, _P]
        lib.vct_contrastive_fwd.restype = _I
        lib.vct_contrastive_bwd.restype = _I
        lib.vct_contrastive_cluster_lse.restype = _I
        lib.vct_contrastive_work.argtypes = [_I, _I]
        lib.vct_contrastive_work.restype = ctypes.c_size_t
        lib.vct_contrastive_bwd_cluster_max.argtypes = [_I]
        lib.vct_contrastive_bwd_cluster_max.restype = _I
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _logits(txt, img, logit_scale):
    t, m = txt.float(), img.float()
    tn = t * torch.rsqrt((t * t).sum(-1, keepdim=True))
    mn = m * torch.rsqrt((m * m).sum(-1, keepdim=True))
    return tn, mn, torch.exp(logit_scale.float()) * (tn @ mn.T)


def contrastive_loss_torch(txt, img, logit_scale):
    """The kernel's loss in plain torch (differentiable by autograd)."""
    _, _, z = _logits(txt, img, logit_scale)
    labels = torch.arange(z.shape[0], device=z.device)
    return 0.5 * (F.cross_entropy(z, labels) + F.cross_entropy(z.T, labels))


def contrastive_loss_bwd_torch(txt, img, logit_scale, g):
    """The analytic backward ``_bwd_kernel`` computes: (d_txt, d_img,
    d_logit_scale) for the cotangent g, in the inputs' dtypes."""
    tn, mn, z = _logits(txt, img, logit_scale)
    B = z.shape[0]
    eye = torch.eye(B, device=z.device)
    s = torch.exp(logit_scale.float())
    dz = g.float() * ((torch.softmax(z, 1) - eye)
                      + (torch.softmax(z, 0) - eye)) / (2.0 * B)
    dtn, dmn = s * (dz @ mn), s * (dz.T @ tn)
    t_inv = torch.rsqrt((txt.float() ** 2).sum(-1, keepdim=True))
    m_inv = torch.rsqrt((img.float() ** 2).sum(-1, keepdim=True))
    dt = (dtn - tn * (dtn * tn).sum(-1, keepdim=True)) * t_inv
    dm = (dmn - mn * (dmn * mn).sum(-1, keepdim=True)) * m_inv
    return (dt.to(txt.dtype), dm.to(img.dtype),
            (dz * z).sum().to(logit_scale.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch(name, fn, x, *args):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(int(x.dtype == torch.bfloat16), *args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")


def _work(txt):
    B, D = txt.shape
    return torch.empty(_lib().vct_contrastive_work(B, D),
                       dtype=torch.float32, device=txt.device)


def _fwd_launch(txt, img, logit_scale):
    """K4's forward, one C call: within :func:`bwd_cluster_max` one
    cluster launch and only the loss allocated, past it the four-kernel
    route with its workspace."""
    B, D = txt.shape
    txt, img = aligned16(txt), aligned16(img)  # the cluster's 16-byte loads
    ls = _scalar_f32(logit_scale)
    loss = torch.empty((), dtype=torch.float32, device=txt.device)
    work = None if B <= bwd_cluster_max(D) else _work(txt)
    _launch("contrastive_loss_fused", _lib().vct_contrastive_fwd, txt,
            txt.data_ptr(), img.data_ptr(), ls.data_ptr(),
            None if work is None else work.data_ptr(), loss.data_ptr(), B, D)
    contrastive_loss_fused.launches += 1
    return loss


@functools.lru_cache(maxsize=64)
def bwd_cluster_max(d: int) -> int:
    """The largest batch K4's backward takes in one cluster launch at
    width d (computed by the library from its shared memory, once a
    width; 0 unless d is a multiple of 8); larger batches take the
    multi-kernel route."""
    return _lib().vct_contrastive_bwd_cluster_max(d)


def _scalar_f32(t):
    """A one-float fp32 tensor for the kernel to read: t itself when it
    is one already (a parameter's scalar, autograd's cotangent)."""
    if t.dtype == torch.float32 and t.numel() == 1 and t.is_contiguous():
        return t
    return t.float().reshape(1).contiguous()


def contrastive_loss_bwd_cuda(txt, img, logit_scale, g):
    """Backward kernel of K4: same results as
    :func:`contrastive_loss_bwd_torch`, for CUDA tensors. One C call;
    within :func:`bwd_cluster_max` one cluster launch and only dt, dm and
    dls allocated, past it the multi-kernel route with its workspace."""
    B, D = txt.shape
    txt, img = aligned16(txt), aligned16(img)  # the cluster's 16-byte loads
    ls, gf = _scalar_f32(logit_scale), _scalar_f32(g)
    dt, dm = torch.empty_like(txt), torch.empty_like(img)
    dls = torch.empty((), dtype=torch.float32, device=txt.device)
    work = None if B <= bwd_cluster_max(D) else _work(txt)
    _launch("contrastive_loss_bwd", _lib().vct_contrastive_bwd, txt,
            txt.data_ptr(), img.data_ptr(), ls.data_ptr(), gf.data_ptr(),
            None if work is None else work.data_ptr(), dt.data_ptr(),
            dm.data_ptr(), dls.data_ptr(), B, D)
    contrastive_loss_bwd_cuda.launches += 1
    return dt, dm, dls.to(logit_scale.dtype)


def cluster_lse(txt, img, logit_scale, backward: bool) -> torch.Tensor:
    """Every row's then every column's LSE of Z ([2B], fp32) as K4's
    forward (``backward`` False) or backward cluster kernel computes it,
    for CUDA [B, D] inputs with B within :func:`bwd_cluster_max`: the
    check that the forward's LSEs are the bits the backward recomputes.
    Not a launch of the training path, and not counted as one."""
    B, D = txt.shape
    if not (txt.is_cuda and img.device == txt.device
            and img.shape == txt.shape and img.dtype == txt.dtype
            and txt.dtype in (torch.float32, torch.bfloat16)
            and B <= bwd_cluster_max(D)):
        raise ValueError(f"cluster_lse: fp32 or bf16 [B, D] CUDA inputs "
                         f"alike, within the cluster route (B <= "
                         f"{bwd_cluster_max(D)}); got {txt.dtype} "
                         f"{tuple(txt.shape)} on {txt.device}, {img.dtype} "
                         f"{tuple(img.shape)} on {img.device}")
    txt, img = aligned16(txt), aligned16(img)
    ls = _scalar_f32(logit_scale)
    f32 = dict(dtype=torch.float32, device=txt.device)
    out, lse = torch.empty((), **f32), torch.empty(2 * B, **f32)
    g = torch.ones(1, **f32)
    dt, dm = (torch.empty_like(txt), torch.empty_like(img)) if backward \
        else (None, None)
    _launch("contrastive cluster_lse", _lib().vct_contrastive_cluster_lse,
            txt, int(backward), txt.data_ptr(), img.data_ptr(),
            ls.data_ptr(), g.data_ptr(), out.data_ptr(),
            None if dt is None else dt.data_ptr(),
            None if dm is None else dm.data_ptr(), lse.data_ptr(), B, D)
    return lse


class _ContrastiveFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, txt, img, logit_scale):
        ctx.save_for_backward(txt, img, logit_scale)
        return _fwd_launch(txt, img, logit_scale)

    @staticmethod
    def backward(ctx, g):
        grads = contrastive_loss_bwd_cuda(*ctx.saved_tensors, g)
        return tuple(d if n else None
                     for d, n in zip(grads, ctx.needs_input_grad))


def contrastive_loss_fused(txt: torch.Tensor, img: torch.Tensor,
                           logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE loss of [B, D] text and image features (fp32
    scalar), through the K4 kernels on the card."""
    name = "contrastive_loss_fused"
    if txt.dim() != 2 or txt.shape != img.shape or txt.shape[0] < 1:
        raise ValueError(f"{name}: txt and img must both be [B, D] with "
                         f"B >= 1; got {tuple(txt.shape)} and "
                         f"{tuple(img.shape)}")
    if logit_scale.numel() != 1:
        raise ValueError(f"{name}: logit_scale must be a scalar")
    if not _on_cuda(txt, name):
        return contrastive_loss_torch(txt, img, logit_scale)
    if txt.dtype not in (torch.float32, torch.bfloat16) \
            or img.dtype != txt.dtype:
        raise TypeError(f"{name}: txt and img must share a dtype, float32 "
                        f"or bfloat16; got {txt.dtype}, {img.dtype}")
    if img.device != txt.device or logit_scale.device != txt.device:
        raise ValueError(f"{name}: all tensors must be on {txt.device}")
    if _needs_grad(txt, img, logit_scale):
        return _ContrastiveFn.apply(txt, img, logit_scale)
    return _fwd_launch(txt, img, logit_scale)


contrastive_loss_fused.launches = 0
contrastive_loss_bwd_cuda.launches = 0
KERNELS = (contrastive_loss_fused, contrastive_loss_bwd_cuda)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
