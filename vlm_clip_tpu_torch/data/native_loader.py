"""ctypes binding for the C++ batch image loader (port of
``vlm_clip_tpu/data/native_loader.py``; the C++ source is the
reference's ``native/loader.cpp``, used unchanged from its place).

GIL-free threaded JPEG decode + shortest-edge resize + center crop into a
caller buffer. At first use the library is built with g++ (the
reference's flags, ``-O3 -shared -fPIC ... -ljpeg -lpthread``) into the
git-ignored ``build/`` at the repository root, as
``build/libvctloader-<hash>.so`` where the hash covers the source and
the flags; nothing is written into ``native/``. Where g++ or libjpeg is
missing, :func:`native_available` is False with a warning and callers
decode with PIL (:func:`unavailable_reason` says why). This is a host
decoder choice, not a device route.

Numerics note: the native path uses bilinear resampling (throughput
path); the PIL path (data/preprocess.py) is bicubic and matches the
reference's CLIPProcessor bit-for-bit — use that for parity evals.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from vlm_clip_tpu_torch.ops.build import BUILD_DIR

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(BUILD_DIR)
SRC = os.path.join(_REPO_ROOT, "native", "loader.cpp")
FLAGS = ["-O3", "-shared", "-fPIC"]
LIBS = ["-ljpeg", "-lpthread"]

_lib = None
_lock = threading.Lock()
_reason: Optional[str] = None  # why the library is unavailable


def library_path() -> str:
    """build/libvctloader-<hash>.so, the hash over the source and flags."""
    h = hashlib.sha1(" ".join(FLAGS + LIBS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvctloader-{h.hexdigest()[:12]}.so")


def _unavailable(reason: str) -> None:
    global _reason
    _reason = reason
    log.warning("native loader unavailable (%s); falling back to PIL",
                reason)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        if not os.path.exists(SRC):
            _unavailable(f"{SRC} is missing")
            return None
        so = library_path()
        if not os.path.exists(so):
            gxx = shutil.which("g++")
            if gxx is None:
                _unavailable("g++ not found on PATH")
                return None
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([gxx, *FLAGS, "-o", tmp, SRC, *LIBS],
                                  capture_output=True, text=True,
                                  timeout=120)
            if proc.returncode != 0:
                err = (proc.stderr or proc.stdout).strip().splitlines()
                first = next((ln for ln in err if "error" in ln),
                             err[0] if err else f"exit {proc.returncode}")
                _unavailable(f"g++ failed: {first.strip()}")
                return None
            os.replace(tmp, so)
            log.info("built native loader at %s", so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _unavailable(str(e))
            return None
        lib.vct_load_batch.restype = ctypes.c_int
        lib.vct_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """None when the library loads, else why it does not."""
    _load()
    return _reason


def load_batch_native(paths: List[str], image_size: int,
                      n_threads: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch -> (uint8 [N,S,S,3], ok mask [N]).

    Raises RuntimeError when the native library is unavailable; callers
    should gate on native_available().
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable ({_reason})")
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.uint8)
    status = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    lib.vct_load_batch(
        arr, n, image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    return out, status.astype(bool)
