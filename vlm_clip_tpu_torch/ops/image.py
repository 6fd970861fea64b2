"""On-device image resize and preprocessing (port of
``vlm_clip_tpu/ops/image.py``).

Raw decoded uint8 frames ship to the device and are resized, cropped and
normalized there. The resize is separable: two dense resample matrices
``[in, out]`` (H, then W) built on the host with the same kernel and
sampling convention as the reference (``jax.image.resize`` / TF2
``scale_and_translate``: output pixel j samples input coordinate
``(j + 0.5) / scale - 0.5``; antialiased downscale stretches the kernel
by ``1/scale``; columns renormalize to sum 1). The products run in fp32
on ``torch.matmul``: they are plain matrix products outside any kernel,
and fp32 keeps them float-exact where the reference needs its highest
matmul precision.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from vlm_clip_tpu_torch.core.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def _resize_kernel(method: str):
    if method == "bilinear":  # triangle, support 1
        return (lambda x: np.maximum(0.0, 1.0 - np.abs(x))), 1.0
    if method == "bicubic":   # Keys cubic, a = -0.5, support 2
        a = -0.5

        def k(x):
            x = np.abs(x)
            return np.where(
                x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                np.where(x < 2,
                         a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a,
                         0.0))
        return k, 2.0
    raise ValueError(f"unsupported resize method {method!r}")


def _resize_weights(in_size: int, out_size: int, method: str,
                    antialias: bool) -> np.ndarray:
    """Dense separable resample matrix [in, out] (float32)."""
    kernel, _ = _resize_kernel(method)
    scale = out_size / in_size
    kscale = min(scale, 1.0) if antialias else 1.0
    x = (np.arange(out_size) + 0.5) / scale - 0.5        # [out]
    w = kernel((np.arange(in_size)[:, None] - x[None, :]) * kscale)
    return (w / w.sum(axis=0, keepdims=True)).astype(np.float32)


def resize_batch(images: torch.Tensor, out_hw: Union[int, Tuple[int, int]],
                 method: str = "bicubic",
                 antialias: bool = True) -> torch.Tensor:
    """[B, H, W, C] (uint8 or float) -> resized float32 [B, h, w, C], on
    the input's device."""
    if isinstance(out_hw, int):
        out_hw = (out_hw, out_hw)
    H, W = int(images.shape[1]), int(images.shape[2])
    dev = images.device
    wh = torch.from_numpy(_resize_weights(H, out_hw[0], method,
                                          antialias)).to(dev)
    ww = torch.from_numpy(_resize_weights(W, out_hw[1], method,
                                          antialias)).to(dev)
    x = images.float()
    x = torch.tensordot(x, wh, dims=([1], [0]))   # [B, W, C, h]
    x = torch.tensordot(x, ww, dims=([1], [0]))   # [B, C, h, w]
    return x.permute(0, 2, 3, 1)


def resize_center_crop(images: torch.Tensor, image_size: int,
                       method: str = "bicubic") -> torch.Tensor:
    """Shortest-edge resize + center crop on device (CLIPProcessor
    semantics, the device twin of data/preprocess.load_and_resize):
    [B, H, W, C] -> float32 [B, image_size, image_size, C]."""
    h, w = int(images.shape[1]), int(images.shape[2])
    scale = image_size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    x = resize_batch(images, (nh, nw), method=method)
    top = (nh - image_size) // 2
    left = (nw - image_size) // 2
    return x[:, top:top + image_size, left:left + image_size, :]


def resize_normalize(images: torch.Tensor, image_size: int,
                     mean: Sequence[float] = CLIP_IMAGE_MEAN,
                     std: Sequence[float] = CLIP_IMAGE_STD,
                     method: str = "bicubic",
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Raw decoded frames -> model input: shortest-edge resize + center
    crop + 1/255 rescale + normalize + NCHW, in ``dtype``."""
    x = resize_center_crop(images, image_size, method=method)
    x = x.to(dtype) / 255.0
    m = torch.tensor(mean, dtype=dtype, device=x.device)
    s = torch.tensor(std, dtype=dtype, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2)
