"""Pipeline-V datasets: images with their VLM context features (copied
from ``vlm_clip_tpu/data/enhanced.py``; the class names, the image loader
and the extensions from the port's own modules).

- folder scan, shuffled, then a per-class cap of ``max(1, max_images //
  C)``;
- per item: the CLIP-sized uint8 image, label, path and context features
  from the VLM extractor, with a **zero-vector fallback** when extraction
  or encoding fails, and a black dummy image, label 0 and "Error loading
  image" for a file that does not decode;
- the train variant omits the description text, the eval variant
  carries it.

Contexts are resolved ONCE, when the dataset is built (or ahead of time
by ``cli/build_context_cache``), into an [N, P] feature matrix: the
training loop never waits on the VLM.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from vlm_clip_tpu_torch.core.config import EMOTIONS
from vlm_clip_tpu_torch.data.preprocess import load_and_resize
from vlm_clip_tpu_torch.data.rafdb import IMAGE_EXTS

log = logging.getLogger(__name__)

NO_DESCRIPTION = "No description available"
ERROR_DESCRIPTION = "Error loading image"


class BaseEnhancedFolderDataset:
    def __init__(self, root_dir: str, vlm_context_extractor,
                 mode: str = "test", max_images: Optional[int] = None,
                 emotions: Sequence[str] = EMOTIONS, image_size: int = 224,
                 feature_dim: Optional[int] = None, seed: int = 42,
                 precompute: bool = True):
        self.mode = mode
        self.image_size = image_size
        self.extractor = vlm_context_extractor
        self.feature_dim = feature_dim or getattr(
            vlm_context_extractor, "text_feature_dim", 768)
        self.emotions = list(emotions)

        rng = np.random.default_rng(seed)
        self.image_paths: List[str] = []
        self.labels: List[int] = []
        root = Path(root_dir)
        for idx, emotion in enumerate(self.emotions):
            folder = root / emotion
            if not folder.exists():
                print(f"Warning: {folder} does not exist!")
                continue
            files = sorted(f for f in folder.iterdir()
                           if f.suffix.lower() in IMAGE_EXTS)
            rng.shuffle(files)
            if max_images:
                files = files[:max(1, max_images // len(self.emotions))]
            self.image_paths.extend(str(f) for f in files)
            self.labels.extend([idx] * len(files))
        print(f"Loaded {len(self.image_paths)} images for {mode} mode "
              f"from {root_dir}")

        self._images: List[Optional[np.ndarray]] = [None] * len(self)
        self._contexts: List[Optional[str]] = [None] * len(self)
        self._features = np.zeros((len(self), self.feature_dim), np.float32)
        self._resolved = np.zeros((len(self),), bool)
        if precompute:
            self.precompute_contexts()

    def __len__(self) -> int:
        return len(self.image_paths)

    # -- context resolution ------------------------------------------------
    def _resolve(self, idx: int) -> None:
        if self._resolved[idx]:
            return
        path = self.image_paths[idx]
        try:
            img = load_and_resize(path, self.image_size)
        except Exception as e:
            log.warning("Error opening image %s: %s. Returning dummy data.",
                        path, e)
            self._images[idx] = np.zeros(
                (self.image_size, self.image_size, 3), np.uint8)
            self.labels[idx] = 0  # reference dummy label (enhance.py:57)
            self._contexts[idx] = ERROR_DESCRIPTION
            self._resolved[idx] = True
            return
        self._images[idx] = img
        desc = self.extractor.extract_context_from_image(img) \
            if self.extractor is not None else None
        feats = self.extractor.encode_context_descriptions(desc) \
            if self.extractor is not None else None
        self._contexts[idx] = desc
        if feats is not None:
            f = np.asarray(feats, np.float32).reshape(-1)
            if f.shape[0] == self.feature_dim:
                self._features[idx] = f
        # else: zero-vector fallback (enhance.py:73-78)
        self._resolved[idx] = True

    def precompute_contexts(self) -> None:
        for i in range(len(self)):
            self._resolve(i)

    # -- item access -------------------------------------------------------
    def _common_item(self, idx: int):
        self._resolve(idx)
        return (self._images[idx], self.labels[idx], self.image_paths[idx],
                self._features[idx], self._contexts[idx])


class EnhancedFolderDataset(BaseEnhancedFolderDataset):
    """Train variant: (image, label, path, context_features)."""

    def __getitem__(self, idx: int):
        img, label, path, feats, _ = self._common_item(idx)
        return img, label, path, feats


class EnhancedFolderDatasetWithContext(BaseEnhancedFolderDataset):
    """Eval variant: adds the description text (or the no-context marker)."""

    def __getitem__(self, idx: int):
        img, label, path, feats, desc = self._common_item(idx)
        return img, label, path, feats, desc if desc else NO_DESCRIPTION
