"""Logging and seeding (copied from ``vlm_clip_tpu/utils/logging.py``).

- :func:`setup_logging`: a timestamped ``<log_dir>/<name>_%Y%m%d_%H%M%S.log``
  file handler plus a console handler, on rank 0 only (other ranks get
  no handlers and stay at WARNING, so N ranks do not write N copies of
  every line); ``VLM_CLIP_LOG_DIR`` overrides ``log_dir`` when set, so
  test and smoke drives keep logs out of the checkout;
- :func:`seed_everything`: seeds ``random``, numpy and torch and returns
  a ``torch.Generator`` seeded the same way.
"""

from __future__ import annotations

import logging
import os
import random
from datetime import datetime

import numpy as np
import torch

from vlm_clip_tpu_torch.parallel import distributed


def setup_logging(log_dir: str = "logs", name: str = "training",
                  level: int = logging.INFO) -> str:
    """File + console handlers on the root logger; returns the file ("" on
    a rank other than 0)."""
    log_dir = os.environ.get("VLM_CLIP_LOG_DIR", log_dir)
    root = logging.getLogger()
    if not distributed.is_primary():
        root.setLevel(logging.WARNING)
        return ""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"{name}_{datetime.now():%Y%m%d_%H%M%S}.log")
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    root.setLevel(level)
    fh = logging.FileHandler(path)
    fh.setFormatter(fmt)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    root.addHandler(fh)
    root.addHandler(ch)
    return path


def seed_everything(seed: int = 42) -> torch.Generator:
    """Seed the host RNGs and torch's; return a generator for explicit
    draws."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
