"""Build and load the port's CUDA kernels (plain C interface + ctypes).

``load_library(name)`` compiles ``vlm_clip_tpu_torch/csrc/<name>.cu``
with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository root (the
file name carries a hash of the source and of every header under
``csrc/``, so an edited source or header rebuilds),
and returns the ``ctypes.CDLL``; ``load_libraries(names)`` runs one
``nvcc`` per source, all at once. It runs on first use, never at import:
hosts without ``nvcc`` can import every module. A missing ``nvcc`` or a
failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc output (ptxas register use)
build_seconds: Dict[str, float] = {}  # name -> wall time of its nvcc


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels "
            "of vlm_clip_tpu_torch are built from source at first use and "
            "need the CUDA toolkit")
    return nvcc


def _out_path(name: str) -> str:
    """build/lib<name>-<hash>.so, the hash over csrc/<name>.cu, every
    header under csrc/ (any source may include any of them) and the
    target flags."""
    h = hashlib.sha1(" ".join(ARCH_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR)
                     if f.endswith((".cuh", ".h")))
    for path in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC_DIR, path), "rb") as f:
            h.update(path.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def load_libraries(names) -> List[ctypes.CDLL]:
    """Build (once per source version) and load ``csrc/<name>.cu`` for
    each name; the sources not built yet compile in parallel, one
    ``nvcc`` each."""
    with _lock:
        if all(name in _libs for name in names):  # the per-launch path
            return [_libs[name] for name in names]
        builds = []
        for name in dict.fromkeys(names):
            if name in _libs:
                continue
            out = _out_path(name)
            if os.path.isfile(out):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            src = os.path.join(CSRC_DIR, f"{name}.cu")
            cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
            builds.append((name, src, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        t0 = time.time()

        def drain(name, proc):  # reads the pipe to the end, so nvcc never
            build_logs[name] = proc.communicate()[0]  # blocks on a write
            build_seconds[name] = time.time() - t0

        readers = [threading.Thread(target=drain, args=(b[0], b[4]))
                   for b in builds]
        for r in readers:
            r.start()
        for r in readers:
            r.join()
        failed = []
        for name, src, tmp, out, proc in builds:
            if proc.returncode != 0:
                failed.append(f"nvcc failed building {src} (exit "
                              f"{proc.returncode}):\n{build_logs[name]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_out_path(name))
        return [_libs[name] for name in names]


def aligned16(t):
    """t contiguous and starting on a 16-byte boundary, as the tensor-core
    kernels' 16-byte copies need: a view that starts off one is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/<name>.cu``."""
    return load_libraries([name])[0]
