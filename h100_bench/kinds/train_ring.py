"""Traffic kind ``train_ring``: pipeline M's adapter training (a
``clip_m`` configuration) under closed-loop steps over a ring of
resident batches.

The window runs the one train state and step that set-up drove through
the first ``check_steps`` steps, round the ring, until ``--seconds``
have passed, and ends in a synchronise. A traced run then profiles
``TRACE_STEPS`` more steps for the per-layer readings.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from hb import clip_m as F
from hb.trace import Recorder, profiled

FAMILY = "clip_m"
TRACE_STEPS = 5


def run(cell: dict, cfg: dict, tr: dict, seed: int, seconds: float,
        trace: bool, dev, t_start: float, limits: dict,
        fault: Optional[str] = None) -> dict:
    state, step, ring, a0, losses, first_grad, after = F.setup(
        cfg, tr, seed, dev, fault)
    n_check = tr["check_steps"]
    B = tr["batch"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    i = n_check
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        state, m = step(state, ring[i % len(ring)])
        i += 1
        n += 1
    final_loss = float(m.loss)  # ends in a synchronise
    window_s = time.perf_counter() - t0
    ctx = {"setup_s": setup_s, "window_s": window_s, "steps": n,
           "pairs": n * B, "batch": B, "config": cfg}
    if trace:
        rec = Recorder()
        with profiled(rec) as h:
            for _ in range(TRACE_STEPS):
                with rec.span("step"):
                    state, m = step(state, ring[i % len(ring)])
                i += 1
            with rec.span("sync"):
                float(m.loss)
        ctx["trace"] = h.summary
        ctx["traced_steps"] = TRACE_STEPS
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, step, m
    ring = ring[:n_check]
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the plain reference follows the first steps from the same numbers
    checks = F.compare(seed, cfg, ring, a0, losses, first_grad, after,
                       limits, dev, "fp32")
    ok = checks.ok() and math.isfinite(final_loss)
    return {"ctx": ctx, "checks": checks, "correct": ok,
            "attempted": n, "failed": 0, "memory_peak_bytes": peak}


def control(cell: dict, cfg: dict, tr: dict, seed: int, dev,
            limits: dict) -> dict:
    """The control (the reference in bf16's place at fp8) and the fault
    of half of each batch left out (a run of the program so broken), at
    the cell's size, each held to the cell's limits: {name: Checks}. A
    step that leaves its state unchanged reads 1 on change_gap by
    construction and needs no run."""
    ring = F.make_batches(seed, cfg, tr, dev)[:tr["check_steps"]]
    a0 = dict(F._leaf_paths(F.make_adapters(seed, cfg, dev)))
    out = {"control_fp8": F.compare(seed, cfg, ring, a0, None, None, None,
                                    limits, dev, "fp8")}
    state, step, ring, a0, losses, first_grad, after = F.setup(
        cfg, tr, seed, dev, "half_batch")
    del state, step
    out["fault_half_batch"] = F.compare(
        seed, cfg, ring[:tr["check_steps"]], a0, losses, first_grad, after,
        limits, dev, "fp32")
    return out

