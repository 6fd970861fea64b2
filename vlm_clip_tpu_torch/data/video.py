"""Video frame pipeline (reference process_video.py:6-33) + per-frame
CLIP scoring (BASELINE.json config 4); port of
``vlm_clip_tpu/data/video.py``.

Behavior contracts:
- first ``frame_limit=16`` frames via cv2, BGR->RGB, resize to 224^2;
- normalization uses **ImageNet** stats, not CLIP stats — a reference
  inconsistency (process_video.py:21-26) reproduced by default and
  flag-gated via ``stats="clip"``;
- output layout [C, T, H, W] (tensor stack then permute,
  process_video.py:28-29).

Decode stays on the host (cv2, imported where it is used: the card's
machine has none, and the scorers need none); uint8 frames go to the
CLIP params' device, where normalization (and, for
:func:`score_video_frames_raw`, the shortest-edge resize and center
crop) and the per-frame scoring run. :func:`score_video_frames_sharded`
spreads the frames over a mesh's ``seq`` axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vlm_clip_tpu_torch.core.config import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD,
                                            IMAGENET_MEAN, IMAGENET_STD)


def _stats(stats: str):
    return (IMAGENET_MEAN, IMAGENET_STD) if stats == "imagenet" \
        else (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD)


def extract_frames(video_path: str, frame_limit: int = 16,
                   size: int = 224) -> np.ndarray:
    """First ``frame_limit`` frames -> uint8 [T, size, size, 3] (RGB)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    frames = []
    try:
        while len(frames) < frame_limit:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames.append(cv2.resize(frame, (size, size)))
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return np.stack(frames).astype(np.uint8)


def process_video(video_path: str, frame_limit: int = 16,
                  size: int = 224, stats: str = "imagenet") -> np.ndarray:
    """Reference-shaped output: normalized float32 [C, T, H, W].

    ``stats='imagenet'`` reproduces the reference's (inconsistent) choice
    of ImageNet normalization; ``stats='clip'`` uses CLIP stats.
    """
    frames = extract_frames(video_path, frame_limit, size)
    mean, std = _stats(stats)
    x = frames.astype(np.float32) / 255.0
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return x.transpose(3, 0, 1, 2)  # [C, T, H, W]


def _scores(clip_params, cfg, px: torch.Tensor, emb: torch.Tensor,
            policy) -> torch.Tensor:
    """Softmax over 100 x cosine(image feature, class embedding)."""
    from vlm_clip_tpu_torch.models import clip as C
    from vlm_clip_tpu_torch.models import layers as L

    feats = C.get_image_features(clip_params, px, cfg, policy)
    feats = L.l2_normalize(feats).float()
    return torch.softmax(100.0 * feats @ emb.T, dim=-1)


@torch.no_grad()
def score_video_frames(clip_params, cfg, frames_u8: np.ndarray,
                       class_emb, policy=None, stats: str = "clip"
                       ) -> np.ndarray:
    """Per-frame emotion probabilities [T, C_classes].

    Frames are treated as an image batch through the frozen tower (the
    reference scores frames independently; SURVEY.md §5.7), normalized
    on the params' device.
    """
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch

    dev = clip_params["logit_scale"].device
    mean, std = _stats(stats)
    px = normalize_batch(torch.as_tensor(frames_u8).to(dev), mean, std)
    emb = torch.as_tensor(np.asarray(class_emb), dtype=torch.float32,
                          device=dev)
    return _scores(clip_params, cfg, px, emb, policy or BF16).cpu().numpy()


@functools.lru_cache(maxsize=8)
def _raw_frame_scorer(cfg, policy, stats: str, size: int):
    """The cached config-4 scorer: NATIVE-resolution uint8 frames on the
    device -> per-frame class probabilities, with the shortest-edge
    resize + center crop + normalize (ops/image.resize_normalize), the
    tower and the softmax all on the frames' device. The host's only job
    is demux."""
    from vlm_clip_tpu_torch.ops.image import resize_normalize

    mean, std = _stats(stats)

    @torch.no_grad()
    def run(params, u8: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        px = resize_normalize(u8, size, mean, std,
                              dtype=policy.compute_dtype)
        return _scores(params, cfg, px, emb, policy)

    return run


def score_video_frames_raw(clip_params, cfg, frames_u8: np.ndarray,
                           class_emb, policy=None,
                           stats: str = "imagenet",
                           size: int = 224) -> np.ndarray:
    """Config-4 device-first path: demuxed frames at NATIVE resolution
    (uint8 [T, H, W, 3]) -> per-frame probabilities [T, C_classes].

    The reference resizes + normalizes every frame on the host
    (process_video.py:21-26, cv2 resize + ImageNet stats — the stats
    quirk is reproduced by the ``stats='imagenet'`` default) before a
    per-frame eager forward. Here the raw uint8 frames go to the device
    once and resize/normalize/score run there (:func:`_raw_frame_scorer`);
    measured end to end by cli/bench_video.py.
    """
    from vlm_clip_tpu_torch.core.dtypes import BF16

    dev = clip_params["logit_scale"].device
    run = _raw_frame_scorer(cfg, policy or BF16, stats, size)
    u8 = torch.as_tensor(frames_u8).to(dev)
    emb = torch.as_tensor(np.asarray(class_emb), dtype=torch.float32,
                          device=dev)
    return run(clip_params, u8, emb).cpu().numpy()


def score_video_frames_sharded(clip_params, cfg, frames_u8: np.ndarray,
                               class_emb, mesh, policy=None,
                               stats: str = "clip") -> np.ndarray:
    """Per-frame scores with the frame axis sharded over the mesh's
    ``seq`` axis (``parallel.mesh.MeshConfig(seq=k)``): each ``seq`` rank
    scores its contiguous rows of frames on the params' device, and the
    scores are all-gathered in frame order, so a longer ``frame_limit``
    spreads across ranks instead of one device's batch memory. The frame
    count must divide into the axis's ranks, as the reference's sharded
    placement requires. Every rank of the axis calls it with the same
    frames and gets every score."""
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch
    from vlm_clip_tpu_torch.parallel.distributed import gather_rows
    from vlm_clip_tpu_torch.parallel.mesh import (SEQ_AXIS, axis_coordinate,
                                                  axis_group)

    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a torch DeviceMesh "
                        f"(parallel.mesh.create_mesh), got "
                        f"{type(mesh).__name__}")
    if SEQ_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no '{SEQ_AXIS}' "
                         f"axis: build it with MeshConfig(seq=k)")
    r, n = axis_coordinate(mesh, SEQ_AXIS)
    T = len(frames_u8)
    if T % n:
        raise ValueError(f"{T} frames do not divide over the {n} ranks of "
                         f"the '{SEQ_AXIS}' axis")
    rows = T // n
    dev = clip_params["logit_scale"].device
    mean, std = _stats(stats)
    with torch.no_grad():
        u8 = torch.as_tensor(np.asarray(frames_u8[r * rows:(r + 1) * rows]))
        px = normalize_batch(u8.to(dev), mean, std)
        emb = torch.as_tensor(np.asarray(class_emb), dtype=torch.float32,
                              device=dev)
        mine = _scores(clip_params, cfg, px, emb, policy or BF16)
        if n > 1:
            mine = gather_rows(mine, axis_group(mesh, SEQ_AXIS))
    return mine.cpu().numpy()
