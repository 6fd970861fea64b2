"""Decoded-uint8 pixel cache: one-time JPEG decode to an mmap store
(copied from ``vlm_clip_tpu/data/pixel_cache.py``: numpy only, imports
pointed at the port's ``data/native_loader`` and ``data/preprocess``).

The reference re-decodes every JPEG from disk every epoch
(dataset.py:148-159 PIL open + CLIPProcessor per __getitem__), and on a
host with few cores the decode, not the device, sets the epoch's pace.
The fix is the context-cache idea applied to pixels: decode ONCE into a
memory-mappable uint8 array keyed by (dataset order, image size), then
every later epoch reads it back at memory bandwidth with zero decode
work on any core count.

Layout on disk (``cache_dir/``), the same as the reference's, so either
package opens the other's cache:
- ``pixels.npy``  — np.lib.format memmap, uint8 [N, S, S, 3];
- ``manifest.json`` — {"image_size", "paths", "ok", "fingerprints"}
  for validation (``ok[i]`` False means the source was corrupt and row i
  is the black dummy, preserving the reference fallback contract,
  enhance.py:54-61).

Build uses the native C++ threaded decoder (native/loader.cpp) when
available, else the PIL path — numerics note in data/native_loader.py.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_PIXELS = "pixels.npy"
_MANIFEST = "manifest.json"


def _fingerprint(path: str):
    """[mtime_ns, size] of a source file (None if unreadable) — JSON
    round-trips as a list, so compare against lists."""
    try:
        st = os.stat(path)
        return [st.st_mtime_ns, st.st_size]
    except OSError:
        return None


class PixelCache:
    """Read-side handle over a built cache (zero-copy mmap rows)."""

    def __init__(self, pixels: np.ndarray, paths: List[str],
                 ok: np.ndarray, image_size: int):
        self.pixels = pixels          # uint8 memmap [N, S, S, 3]
        self.paths = paths
        self.ok = ok
        self.image_size = image_size
        self._index = None

    def __len__(self) -> int:
        return self.pixels.shape[0]

    def get(self, i: int) -> np.ndarray:
        return np.asarray(self.pixels[i])

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        return np.asarray(self.pixels[np.asarray(indices)])

    def index_of(self, path: str) -> Optional[int]:
        if self._index is None:
            self._index = {p: i for i, p in enumerate(self.paths)}
        return self._index.get(path)

    # -- build / open -------------------------------------------------
    @classmethod
    def build(cls, paths: Sequence[str], image_size: int, cache_dir: str,
              use_native: bool = True, chunk: int = 256,
              overwrite: bool = False) -> "PixelCache":
        """Decode ``paths`` once into ``cache_dir`` and return the
        opened cache. Corrupt images become black dummies with
        ``ok=False`` (enhance.py:54-61 contract)."""
        os.makedirs(cache_dir, exist_ok=True)
        pix_path = os.path.join(cache_dir, _PIXELS)
        man_path = os.path.join(cache_dir, _MANIFEST)
        fps = [_fingerprint(p) for p in paths]
        if not overwrite and os.path.exists(pix_path) \
                and os.path.exists(man_path):
            with open(man_path, encoding="utf-8") as f:
                man = json.load(f)
            # (mtime, size) fingerprints catch in-place edits of source
            # images with unchanged filenames — a stale cache would
            # silently train on old pixels forever otherwise
            if int(man["image_size"]) == image_size \
                    and man["paths"] == list(paths) \
                    and man.get("fingerprints") == fps:
                return cls.open(cache_dir)
            log.warning("pixel cache at %s does not match "
                        "(size/paths/source files); rebuilding", cache_dir)

        n = len(paths)
        out = np.lib.format.open_memmap(
            pix_path, mode="w+", dtype=np.uint8,
            shape=(n, image_size, image_size, 3))
        ok = np.ones((n,), bool)

        native = None
        if use_native:
            from vlm_clip_tpu_torch.data import native_loader

            if native_loader.native_available():
                native = native_loader.load_batch_native
        if native is None:
            from vlm_clip_tpu_torch.data.preprocess import load_and_resize

        for s in range(0, n, chunk):
            batch = list(paths[s:s + chunk])
            if native is not None:
                imgs, good = native(batch, image_size)
                out[s:s + len(batch)] = imgs
                ok[s:s + len(batch)] = good
                for j in np.nonzero(~good)[0]:
                    out[s + j] = 0
            else:
                for j, p in enumerate(batch):
                    try:
                        out[s + j] = load_and_resize(p, image_size)
                    except Exception as e:
                        log.warning("decode failed for %s (%s); black "
                                    "dummy", p, e)
                        out[s + j] = 0
                        ok[s + j] = False
        out.flush()
        with open(man_path, "w", encoding="utf-8") as f:
            json.dump({"image_size": image_size, "paths": list(paths),
                       "ok": ok.tolist(), "fingerprints": fps}, f)
        log.info("pixel cache built at %s: %d images @ %d^2 (%.1f MB)",
                 cache_dir, n, image_size, out.nbytes / 1e6)
        return cls.open(cache_dir)

    @classmethod
    def open(cls, cache_dir: str) -> "PixelCache":
        with open(os.path.join(cache_dir, _MANIFEST),
                  encoding="utf-8") as f:
            man = json.load(f)
        pixels = np.load(os.path.join(cache_dir, _PIXELS), mmap_mode="r")
        return cls(pixels, man["paths"], np.asarray(man["ok"], bool),
                   int(man["image_size"]))

    @classmethod
    def for_dataset(cls, dataset, cache_dir: str,
                    use_native: bool = True,
                    overwrite: bool = False) -> "PixelCache":
        """Build (or reopen) a cache aligned with ``dataset.samples``
        order and attach it, so ``dataset[i]`` reads row i from the
        mmap instead of decoding."""
        paths = [s[0] for s in dataset.samples]
        pc = cls.build(paths, dataset.image_size, cache_dir,
                       use_native=use_native, overwrite=overwrite)
        dataset.attach_pixel_cache(pc)
        return pc
