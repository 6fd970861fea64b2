"""Traffic kind ``static_batches``: offline context generation (a
``qwen_vl`` configuration), ``generate_batch`` on batches of images with
one prompt, as ``cli/build_context_cache`` runs it.

Batches start until ``--seconds`` have passed, so the window is a whole
number of batches. A traced run then times the prefill of a batch alone
(host clock, synchronised) and profiles one prefill and one whole batch.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from hb import qwen_vl as F
from hb.common import Checks
from hb.trace import Recorder, profiled

FAMILY = "qwen_vl"


def _window(gen, cfg, tr, pool, seconds, trace, dev, fault, ctx):
    B, tok = tr["batch"], F.Words(cfg["special_tokens"])
    size = tr["image_size"]

    def batch(b):
        return [pool[(b * B + i) % len(pool)] for i in range(B)]

    def generate(imgs, max_new):
        out = gen.generate_batch(imgs, tr["prompt"], tok,
                                 max_new_tokens=max_new,
                                 fixed_resolution=size)
        if fault == "token":
            out = [F.alter(o, cfg["vocab_size"]) for o in out]
        return out

    generate(batch(0), 4)  # warm-up: prefill at B and decode steps
    F.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ctx["setup_s"] = time.perf_counter() - ctx["t_start"]
    served, walls = [], []
    t0 = time.perf_counter()
    b = 0
    while time.perf_counter() - t0 < seconds:
        tb = time.perf_counter()
        out = generate(batch(b), tr["max_new_tokens"])
        walls.append(time.perf_counter() - tb)
        served += [((b * B + i) % len(pool), o, tr["max_new_tokens"])
                   for i, o in enumerate(out)]
        b += 1
    ctx["window_s"] = time.perf_counter() - t0
    ctx["tokens"] = sum(len(o) for _, o, _ in served)
    ctx["batch_walls"] = walls
    ctx["installs"] = b * B
    ctx["decoded"] = [len(o) for _, o, _ in served]
    if trace:
        _trace(gen, tr, batch(b), tok, dev, ctx)
    return served


def _trace(gen, tr, imgs, tok, dev, ctx):
    """Per-layer readings after the window: the prefill of a batch alone
    (host clock, synchronised), then one prefill and one whole batch
    profiled."""
    from vlm_clip_tpu_torch.vlm.qwen_process import (build_prompt_ids,
                                                     prepare_vision_inputs)

    qv = gen.cfg.vision
    vis = [prepare_vision_inputs(im, qv, fixed_resolution=tr["image_size"],
                                 raw_uint8=True) for im in imgs]
    ids = build_prompt_ids(tok, tr["prompt"], vis[0].num_vision_tokens,
                           gen.cfg)
    ms = []
    for _ in range(3):
        F.sync(dev)
        t0 = time.perf_counter()
        out = gen.prefill_batch(ids, vis)
        F.sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        del out
    ctx["prefill_ms"] = sorted(ms)[1]
    rec = Recorder()
    with profiled(rec) as hp:
        with rec.span("prefill"):
            out = gen.prefill_batch(ids, vis)
            F.sync(dev)
    del out
    with profiled(rec) as hg:
        with rec.span("generate"):
            out = gen.generate_batch(imgs, tr["prompt"], tok,
                                     max_new_tokens=tr["max_new_tokens"],
                                     fixed_resolution=tr["image_size"])
            F.sync(dev)
    ctx["trace"] = hg.summary
    ctx["traced_batches"] = 1
    ctx["prefill_kernels"] = hp.summary.count()
    ctx["traced_lens"] = [len(o) for o in out]


def run(cell: dict, cfg: dict, tr: dict, seed: int, seconds: float,
        trace: bool, dev, t_start: float, limits: dict,
        fault: Optional[str] = None) -> dict:
    pool = F.image_pool(seed, tr)
    gen = F.build_generator(seed, cfg, dev)
    ctx = {"t_start": t_start, "config": cfg, "traffic": tr,
           "prompt_len": len(F.served_prompt(cfg, tr))}
    served = _window(gen, cfg, tr, pool, seconds, trace, dev, fault, ctx)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del gen
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = F.judge(seed, cfg, tr, pool, served, limits, dev)
    return {"ctx": ctx, "checks": checks,
            "correct": checks.ok() and len(served) > 0,
            "attempted": ctx["installs"], "failed": 0,
            "memory_peak_bytes": peak}


def control(cell: dict, cfg: dict, tr: dict, seed: int, dev,
            limits: dict) -> dict:
    """The program's reading on the served tokens of a short run at the
    cell's load (``control_seconds``: one batch), the control's (the
    preset's precision below, in the program's place) and the
    altered-token fault's, each held to the cell's limit:
    {name: Checks}."""
    pool = F.image_pool(seed, tr)
    gen = F.build_generator(seed, cfg, dev)
    ctx = {"t_start": time.perf_counter(), "config": cfg, "traffic": tr}
    served = _window(gen, cfg, tr, pool, tr["control_seconds"], False, dev,
                     None, ctx)
    del gen
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ids = F.served_prompt(cfg, tr)
    V = cfg["vocab_size"]
    gaps = {
        "program": F.served_gap(seed, cfg, tr, pool, ids, served, dev),
        "control": F.served_gap(seed, cfg, tr, pool, ids, served, dev,
                                control=True),
        "fault_token": F.served_gap(
            seed, cfg, tr, pool, ids,
            [(i, F.alter(t, V), b) for i, t, b in served], dev)}
    out = {}
    for name, gap in gaps.items():
        out[name] = Checks()
        out[name].add("token_gap", gap, limits["token_gap"])
    return out
