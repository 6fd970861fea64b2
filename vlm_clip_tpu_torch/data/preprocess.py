"""Image preprocessing (port of ``vlm_clip_tpu/data/preprocess.py``).

Host side: :func:`load_and_resize` (PIL decode + bicubic shortest-edge
resize + center crop -> uint8 HWC) and :func:`preprocess_host` (the same
plus rescale and normalize, float32 CHW), unchanged from the reference.
Device side: :func:`normalize_batch` (1/255 rescale + CLIP mean/std +
NCHW) on a tensor on any device.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from vlm_clip_tpu_torch.core.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def _to_pil(img) -> "Image.Image":
    if Image is not None and isinstance(img, Image.Image):
        return img.convert("RGB")
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr).convert("RGB")


def load_and_resize(img: Union[str, "Image.Image", np.ndarray],
                    image_size: int = 224) -> np.ndarray:
    """Decode + shortest-edge bicubic resize + center crop -> uint8 [S,S,3]."""
    if isinstance(img, str):
        img = Image.open(img)
    pil = _to_pil(img)
    w, h = pil.size
    short = min(w, h)
    scale = image_size / short
    nw, nh = round(w * scale), round(h * scale)
    pil = pil.resize((nw, nh), Image.BICUBIC)
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    pil = pil.crop((left, top, left + image_size, top + image_size))
    return np.asarray(pil, dtype=np.uint8)


def preprocess_host(img, image_size: int = 224,
                    mean: Sequence[float] = CLIP_IMAGE_MEAN,
                    std: Sequence[float] = CLIP_IMAGE_STD) -> np.ndarray:
    """Full host-side CLIPProcessor equivalent -> float32 [3, S, S]."""
    arr = load_and_resize(img, image_size).astype(np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr.transpose(2, 0, 1)


def normalize_batch(uint8_hwc: torch.Tensor,
                    mean: Sequence[float] = CLIP_IMAGE_MEAN,
                    std: Sequence[float] = CLIP_IMAGE_STD,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B,S,S,3] uint8 -> [B,3,S,S] normalized float, on the input's device."""
    x = uint8_hwc.to(dtype) / 255.0
    m = torch.tensor(mean, dtype=dtype, device=x.device)
    s = torch.tensor(std, dtype=dtype, device=x.device)
    x = (x - m) / s
    return x.permute(0, 3, 1, 2)
