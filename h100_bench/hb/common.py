"""What every cell shares: the comparison's checks, the traffic kinds and
metric readers found by name, the card's description, and the check that
no JAX module was loaded."""

from __future__ import annotations

import importlib.util
import math
import os
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# top-level module names that may not be loaded in a run (compared whole:
# the port's own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vlm_clip_tpu")

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense
PEAK_HBM_BYTES = 3.35e12   # H100 SXM


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (modules or list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


class Checks:
    """The numbers the comparison decides ``correct`` by, each with its
    limit: a run is correct when every number is at or under its limit
    and finite."""

    def __init__(self):
        self.items: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": float(value), "limit": float(limit)}

    def ok(self) -> bool:
        return bool(self.items) and all(
            math.isfinite(v["value"]) and v["value"] <= v["limit"]
            for v in self.items.values())

    def lines(self) -> List[str]:
        return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                for k, v in self.items.items()]


def load_module(path: str, name: str):
    """Import a file by path (metric names carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None where the
    run gave it nothing to read."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    mod = load_module(path, "hb_metric_" + name.replace(".", "_"))
    return mod.read(ctx)


def load_kind(name: str):
    """``kinds/<name>.py``: a traffic kind's loop, with ``run(...)`` and
    ``control(...)``."""
    path = os.path.join(BENCH_DIR, "kinds", f"{name}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"no traffic kind {name!r} ({path})")
    return load_module(path, f"hb_kind_{name}")


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
