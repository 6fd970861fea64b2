"""RAF-DB folder datasets + fixed-shape batch loader (copied from
``vlm_clip_tpu/data/rafdb.py``: numpy and PIL only, imports pointed at
the port's ``core/config``, ``data/captions``, ``data/preprocess`` and
``data/native_loader``).

Covers the reference's three dataset item schemas (SURVEY.md §1-L2) with
one folder-scan core:

- T-style :class:`FolderDataset` (trung.py:75-124): ``root/{emotion}/*.jpg``
  -> (uint8 image, label_idx, path);
- M-style :class:`RAFDBDataset` (dataset.py:66-170): ``root/{split}/
  {emotion}/*.jpg`` -> dict(input_ids, attention_mask, pixel_values,
  emotion, caption) with a random caption drawn from the 7x5 prompt bank
  (dataset.py:142);
- :func:`create_dataloaders` (dataset.py:173-207): train/val/test dict,
  shuffle train only. The reference's checked-out copy of this import is
  broken (train.py:7 shadowed by the dataset/ package — SURVEY.md §1-L2
  latent defect); here there is exactly one data package.

The loader yields fixed-shape numpy batches (uint8 HWC images —
normalization happens on device), optional drop-last for static train
shapes, pad+valid-mask for eval, and a background prefetch thread.
Corrupt images yield a black dummy (reference fallback contract,
enhance.py:54-61).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from vlm_clip_tpu_torch.core.config import CLIP_MAX_TEXT_LEN, EMOTIONS
from vlm_clip_tpu_torch.data.captions import get_emotion_descriptions
from vlm_clip_tpu_torch.data.preprocess import load_and_resize

log = logging.getLogger(__name__)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_class_folders(root: Path, emotions: Sequence[str] = EMOTIONS,
                       ) -> List[tuple]:
    """[(path, label_idx)] for root/{emotion}/<images> (trung.py:85-101)."""
    samples = []
    for idx, emotion in enumerate(emotions):
        d = root / emotion
        if not d.is_dir():
            continue
        for f in sorted(d.iterdir()):
            if f.suffix.lower() in IMAGE_EXTS:
                samples.append((str(f), idx))
    return samples


def _safe_load(path: str, image_size: int) -> np.ndarray:
    try:
        return load_and_resize(path, image_size)
    except Exception as e:  # corrupt-image dummy fallback (enhance.py:54-61)
        log.warning("failed to load %s (%s); using black dummy", path, e)
        return np.zeros((image_size, image_size, 3), np.uint8)


class _PixelCacheMixin:
    """Opt-in decoded-uint8 cache: ``dataset[i]`` reads mmap row i
    instead of decoding (data/pixel_cache.py). Attach via
    ``PixelCache.for_dataset(ds, cache_dir)``."""

    pixel_cache = None

    def attach_pixel_cache(self, cache) -> None:
        if len(cache) != len(self.samples) \
                or cache.image_size != self.image_size:
            raise ValueError(
                f"pixel cache ({len(cache)} @ {cache.image_size}) does "
                f"not match dataset ({len(self.samples)} @ "
                f"{self.image_size})")
        self.pixel_cache = cache

    def _load_pixels(self, idx: int, path: str) -> np.ndarray:
        if self.pixel_cache is not None:
            return self.pixel_cache.get(idx)
        return _safe_load(path, self.image_size)


class FolderDataset(_PixelCacheMixin):
    """T-style: flat root/{emotion}/ scan -> (image, label, path)."""

    def __init__(self, root_dir: str, image_size: int = 224,
                 emotions: Sequence[str] = EMOTIONS,
                 max_images: Optional[int] = None, seed: int = 42):
        self.image_size = image_size
        self.emotions = list(emotions)
        self.samples = scan_class_folders(Path(root_dir), emotions)
        if not self.samples:
            raise ValueError(f"no images found under {root_dir}")
        if max_images is not None and len(self.samples) > max_images:
            # evenly-split per-class cap with shuffle (enhance.py:25-44)
            rng = np.random.default_rng(seed)
            per_class = max_images // len(self.emotions)
            picked = []
            for c in range(len(self.emotions)):
                cls = [s for s in self.samples if s[1] == c]
                rng.shuffle(cls)
                picked.extend(cls[:per_class])
            self.samples = picked

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        return self._load_pixels(idx, path), label, path

    def get_batch(self, idxs) -> "Batch":
        """Batched mmap read (requires an attached pixel cache): one
        fancy-index slice instead of B python __getitem__ calls."""
        assert self.pixel_cache is not None
        return Batch(
            images=self.pixel_cache.get_batch(idxs),
            labels=np.asarray([self.samples[i][1] for i in idxs],
                              np.int32),
            paths=[self.samples[i][0] for i in idxs])


class RAFDBDataset(_PixelCacheMixin):
    """M-style: root/{split}/{emotion}/ scan with random caption per item.

    ``captions_jsonl``: path to a ``cli/gen_label.py`` output file
    ({path, emotion, caption} records) — images present in it train
    against their LLM-generated caption instead of a random prompt-bank
    draw (BASELINE config 5, "adapter fine-tune with LLM-augmented
    labels"); images without a caption (``caption: null`` fallback
    records, or simply absent) keep the bank draw.
    """

    def __init__(self, root_dir: str, split: str, tokenizer,
                 max_length: int = CLIP_MAX_TEXT_LEN, image_size: int = 224,
                 seed: int = 42, captions_jsonl: Optional[str] = None):
        split_dir = Path(root_dir) / split
        if not split_dir.exists():
            raise ValueError(f"Split directory {split_dir} does not exist")
        self.samples = [(p, EMOTIONS[l]) for p, l in
                        scan_class_folders(split_dir)]
        if not self.samples:
            raise ValueError(f"No images found in {split_dir}")
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_size = image_size
        self.descriptions = get_emotion_descriptions()
        self._rng = np.random.default_rng(seed)
        self.captions: Dict[str, str] = {}
        if captions_jsonl:
            import json

            with open(captions_jsonl) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("caption"):
                        self.captions[str(Path(rec["path"]).resolve())] \
                            = rec["caption"]

    def _caption_for(self, path: str, emotion: str) -> str:
        cap = self.captions.get(str(Path(path).resolve())) \
            if self.captions else None
        if cap is not None:
            return cap
        return self.descriptions[emotion][
            self._rng.integers(len(self.descriptions[emotion]))]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict:
        path, emotion = self.samples[idx]
        caption = self._caption_for(path, emotion)
        ids, mask = self.tokenizer([caption], max_length=self.max_length)
        return {
            "pixel_values": self._load_pixels(idx, path),
            "input_ids": ids[0],
            "attention_mask": mask[0],
            "emotion": emotion,
            "caption": caption,
        }

    def get_batch(self, idxs) -> "Batch":
        """Batched mmap read + one batched tokenizer call (requires an
        attached pixel cache). Per-item __getitem__ costs ~2 ms/img in
        python; this path feeds the chip from the cache at memory
        bandwidth."""
        assert self.pixel_cache is not None
        captions = []
        labels = np.empty((len(idxs),), np.int32)
        for j, i in enumerate(idxs):
            path, emotion = self.samples[i]
            captions.append(self._caption_for(path, emotion))
            labels[j] = EMOTIONS.index(emotion)
        ids, mask = self.tokenizer(captions, max_length=self.max_length)
        return Batch(images=self.pixel_cache.get_batch(idxs),
                     labels=labels, input_ids=ids, attention_mask=mask,
                     captions=captions)


@dataclasses.dataclass
class Batch:
    """Fixed-shape numpy batch; `valid` marks non-padding rows."""
    images: np.ndarray                       # [B, S, S, 3] uint8
    labels: Optional[np.ndarray] = None      # [B] int32
    input_ids: Optional[np.ndarray] = None   # [B, 77] int32
    attention_mask: Optional[np.ndarray] = None
    paths: Optional[List[str]] = None
    captions: Optional[List[str]] = None
    valid: Optional[np.ndarray] = None       # [B] bool
    context_features: Optional[np.ndarray] = None  # [B, P] (pipeline V)
    contexts: Optional[List[str]] = None     # VLM descriptions (pipeline V)
    indices: Optional[np.ndarray] = None     # [B] dataset indices

    @property
    def size(self) -> int:
        return self.images.shape[0]


def _collate(items, batch_size: int, pad: bool) -> Batch:
    n = len(items)
    ids = mask = ctx = None
    captions = contexts = None
    if isinstance(items[0], dict):
        images = np.stack([it["pixel_values"] for it in items])
        ids = np.stack([it["input_ids"] for it in items])
        mask = np.stack([it["attention_mask"] for it in items])
        captions = [it["caption"] for it in items]
        labels = np.asarray([EMOTIONS.index(it["emotion"]) for it in items],
                            np.int32)
        paths = None
    else:
        images = np.stack([it[0] for it in items])
        labels = np.asarray([it[1] for it in items], np.int32)
        paths = [it[2] for it in items]
        if len(items[0]) >= 4:  # V-pipeline: context features
            ctx = np.stack([np.asarray(it[3], np.float32) for it in items])
        if len(items[0]) >= 5:  # V-eval: context description text
            contexts = [it[4] for it in items]
    valid = np.ones((n,), bool)
    if pad and n < batch_size:
        reps = batch_size - n
        images = np.concatenate([images, np.repeat(images[-1:], reps, 0)])
        labels = np.concatenate([labels, np.repeat(labels[-1:], reps)])
        if ids is not None:
            ids = np.concatenate([ids, np.repeat(ids[-1:], reps, 0)])
            mask = np.concatenate([mask, np.repeat(mask[-1:], reps, 0)])
        if ctx is not None:
            ctx = np.concatenate([ctx, np.repeat(ctx[-1:], reps, 0)])
        valid = np.concatenate([valid, np.zeros((reps,), bool)])
    return Batch(images=images, labels=labels, input_ids=ids,
                 attention_mask=mask, paths=paths, captions=captions,
                 valid=valid, context_features=ctx, contexts=contexts)


class BatchLoader:
    """Shuffling, prefetching batch iterator over a map-style dataset.

    ``drop_last=True`` gives static shapes for the jitted train step;
    ``pad_final=True`` pads the last eval batch and marks padding rows in
    ``Batch.valid`` (pad-and-mask, no recompiles).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, pad_final: bool = True,
                 seed: int = 42, prefetch: int = 2,
                 num_workers: int = 0,
                 collate_fn: Optional[Callable] = None,
                 native: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.prefetch = prefetch
        self.collate_fn = collate_fn or _collate
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        # native C++ batch decode path (throughput; bilinear resampling)
        self.native = False
        if native:
            from vlm_clip_tpu_torch.data import native_loader

            if getattr(dataset, "pixel_cache", None) is not None:
                log.info("pixel cache attached; native decode unnecessary")
            elif isinstance(dataset, FolderDataset) \
                    and native_loader.native_available():
                self.native = True
            else:
                log.warning("native loading requested but unavailable for "
                            "%s; using the PIL path",
                            type(dataset).__name__)

    def _cached_batch(self, idxs) -> Batch:
        """Batched mmap path via the dataset's ``get_batch`` (requires
        an attached pixel cache) + final-batch padding."""
        b = self.dataset.get_batch(idxs)
        n = b.size
        b.valid = np.ones((n,), bool)
        if self.pad_final and n < self.batch_size:
            reps = self.batch_size - n

            def pad(x):
                return None if x is None else \
                    np.concatenate([x, np.repeat(x[-1:], reps, 0)])

            b.images = pad(b.images)
            b.labels = pad(b.labels)
            b.input_ids = pad(b.input_ids)
            b.attention_mask = pad(b.attention_mask)
            b.valid = np.concatenate([b.valid, np.zeros((reps,), bool)])
        return b

    def _native_batch(self, idxs) -> Batch:
        from vlm_clip_tpu_torch.data.native_loader import load_batch_native

        paths = [self.dataset.samples[i][0] for i in idxs]
        labels = np.asarray([self.dataset.samples[i][1] for i in idxs],
                            np.int32)
        images, ok = load_batch_native(paths, self.dataset.image_size)
        if not ok.all():
            for i in np.nonzero(~ok)[0]:
                log.warning("native decode failed for %s; black dummy",
                            paths[i])
        n = len(idxs)
        valid = np.ones((n,), bool)
        if self.pad_final and n < self.batch_size:
            reps = self.batch_size - n
            images = np.concatenate(
                [images, np.repeat(images[-1:], reps, 0)])
            labels = np.concatenate([labels, np.repeat(labels[-1:], reps)])
            valid = np.concatenate([valid, np.zeros((reps,), bool)])
        return Batch(images=images, labels=labels, paths=paths,
                     valid=valid)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk.tolist()

    def __iter__(self) -> Iterator[Batch]:
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for idxs in self._index_batches():
                    if getattr(self.dataset, "pixel_cache", None) \
                            is not None \
                            and hasattr(self.dataset, "get_batch") \
                            and self.collate_fn is _collate:
                        b = self._cached_batch(idxs)
                    elif self.native:
                        b = self._native_batch(idxs)
                    else:
                        items = [self.dataset[i] for i in idxs]
                        b = self.collate_fn(items, self.batch_size,
                                            self.pad_final)
                    if hasattr(b, "indices"):
                        padded = idxs + [idxs[-1]] * (
                            self.batch_size - len(idxs)
                            if self.pad_final else 0)
                        b.indices = np.asarray(
                            padded if len(padded) > len(idxs) else idxs,
                            np.int64)
                    q.put(b)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


def create_dataloaders(root_dir: str, tokenizer, batch_size: int = 32,
                       num_workers: int = 4, image_size: int = 224,
                       captions_jsonl: Optional[str] = None,
                       ) -> Dict[str, BatchLoader]:
    """train/val/test loaders, shuffle train only (dataset.py:173-207).
    ``captions_jsonl`` routes LLM-augmented captions (cli/gen_label.py)
    into every split's dataset (config 5); see RAFDBDataset."""
    del num_workers  # prefetch thread model; kept for signature parity
    loaders = {}
    for split in ("train", "val", "test"):
        ds = RAFDBDataset(root_dir, split, tokenizer, image_size=image_size,
                          captions_jsonl=captions_jsonl)
        loaders[split] = BatchLoader(
            ds, batch_size, shuffle=(split == "train"),
            drop_last=(split == "train"))
    return loaders
