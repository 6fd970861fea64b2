"""Continuous-batching engine against static batched generation (the card).

Port of ``vlm_clip_tpu/cli/bench_engine.py``. The reference serves with a
fixed ``generate()`` batch (model_v.py:108-118): the batch runs until
its last row finishes, so under mixed generation lengths every early row
idles. The engine (``vlm/engine.py``) refills finished slots at once.
This bench measures that on 3B-shape random weights made on the device
(8h4):

- ``--workload uniform``: every request has the same budget: the
  engine's overhead against ``generate_batch_from_ids`` (per-row masks
  and cache writes, one host read per chunk);
- ``--workload mixed``: budgets drawn uniformly from [lo, hi]: a static
  batch decodes to its largest budget, the engine frees each slot the
  step its request ends;
- ``--arrivals``: open-loop Poisson arrivals instead of everything
  queued at t0. The engine installs each request into the next free
  slot; the static baseline batches whatever has arrived when its last
  batch finished. Reports tok/s, TTFT p50/p95 and completion p50/p95 per
  rate; rates are a comma list or ``auto`` = {0.5, 0.75, 0.95} x the
  engine's drain rate.

    python -m vlm_clip_tpu_torch.cli.bench_engine --slots 32 \\
        --requests 128 [--arrivals auto] [--device cpu]

Each timed run follows an untimed one. ``main`` returns the numbers.
"""

from __future__ import annotations

import argparse
import time


def synth_generator(max_len: int, kv_bits: int, device):
    """A ``QwenVLGenerator`` over 3B-shape random 8h4 weights made on
    ``device`` (int8 layers and vision tower, the folded patch embed, an
    int4 untied head), as ``cli/serve_vlm --allow-synth-weights`` serves."""
    import dataclasses

    from vlm_clip_tpu_torch.cli.bench_decode import \
        synth_quantized_text_params
    from vlm_clip_tpu_torch.cli.bench_vision import synth_vision_params
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator
    from vlm_clip_tpu_torch.vlm.qwen_convert import (
        fold_qwen_patch_normalization, quantize_qwen_params)
    from vlm_clip_tpu_torch.vlm.qwen_model import qwen25vl_3b

    cfg = qwen25vl_3b()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, tie_word_embeddings=False))
    text = synth_quantized_text_params(cfg.text, 8, 4, fused=True,
                                       device=device)
    vision = fold_qwen_patch_normalization(
        synth_vision_params(cfg.vision, device=device), cfg.vision)
    vision = quantize_qwen_params({"vision": vision}, 8)["vision"]
    gen = QwenVLGenerator({"text": text, "vision": vision}, cfg,
                          max_len=max_len, kv_bits=kv_bits)
    gen.u8_patches = True
    return gen


def synth_requests(cfg, n: int, size: int, seed: int = 0):
    """(ids, visions, rng): n random size x size uint8 images and the
    bench prompt (two ids, the image's pads, 24 random ids)."""
    import numpy as np

    from vlm_clip_tpu_torch.vlm.qwen_process import prepare_vision_inputs

    rng = np.random.default_rng(seed)
    vins = [prepare_vision_inputs(
        rng.integers(0, 255, (size, size, 3), np.uint8), cfg.vision,
        fixed_resolution=size, raw_uint8=True) for _ in range(n)]
    n_vis = vins[0].num_vision_tokens
    ids = np.asarray(
        [11, 22, cfg.vision_start_token_id] + [cfg.image_token_id] * n_vis
        + list(rng.integers(1, 10000, 24)), np.int64)
    return ids, vins, rng


def _pctl(xs, q):
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def main(argv=None, gen=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--slots", type=int, default=64)
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--sync-steps", type=int, default=16)
    p.add_argument("--size", type=int, default=448)
    p.add_argument("--max-len", type=int, default=768)
    p.add_argument("--workload", default="mixed",
                   choices=("mixed", "uniform"))
    p.add_argument("--budget-lo", type=int, default=25)
    p.add_argument("--budget-hi", type=int, default=200)
    p.add_argument("--kv-bits", type=int, default=16, choices=(8, 16))
    p.add_argument("--skip-static", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="per-phase engine attribution (install/steps/"
                        "sync; a device sync per phase)")
    p.add_argument("--refill-chunks", default="32,8,1")
    p.add_argument("--no-adaptive", action="store_true",
                   help="fixed sync-steps chunks")
    p.add_argument("--chunk-max", type=int, default=None,
                   help="adaptive chunk-length cap (default 8*sync-steps)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="read each chunk's results before the next chunk "
                        "is launched")
    p.add_argument("--arrivals", default=None,
                   help="streaming mode: comma list of Poisson arrival "
                        "rates (req/s) or 'auto' (see the docstring)")
    p.add_argument("--arrival-seed", type=int, default=1)
    p.add_argument("--spec-k", type=int, default=0,
                   help="n-gram speculative decoding (greedy-exact; "
                        "random weights measure its overhead only)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vlm_clip_tpu_torch.cli.common import resolve_device
    from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine

    dev = resolve_device(args.device)
    if gen is None:
        print("synthesizing 3B-shape params (8h4) ...", flush=True)
        gen = synth_generator(args.max_len, args.kv_bits, dev)
    cfg = gen.cfg

    def sync():
        if gen.device.type == "cuda":
            torch.cuda.synchronize(gen.device)

    n = args.requests
    ids, vins, rng = synth_requests(cfg, n, args.size)
    if args.workload == "mixed":
        budgets = rng.integers(args.budget_lo, args.budget_hi + 1,
                               n).tolist()
    else:
        budgets = [args.budget_hi] * n
    print(f"{n} requests, prompt {len(ids)} tokens, budgets "
          f"{min(budgets)}..{max(budgets)} (sum {sum(budgets)})",
          flush=True)
    chunks = tuple(int(c) for c in args.refill_chunks.split(","))
    out = {"budgets": budgets}

    def new_engine(profile=False):
        return ContinuousBatchingEngine(
            gen, n_slots=args.slots, sync_steps=args.sync_steps,
            refill_chunks=chunks, profile=profile, spec_k=args.spec_k,
            pipeline=not args.no_pipeline, adaptive=not args.no_adaptive,
            chunk_max=args.chunk_max)

    # --- engine, everything queued at t0 -----------------------------------
    def engine_run():
        eng = new_engine(args.profile)
        t_start = time.perf_counter()
        for v, m in zip(vins, budgets):
            eng.submit(ids, v, max_new_tokens=m)
        res, finish = {}, {}
        while eng.pending:
            done = eng.poll()
            now = time.perf_counter() - t_start
            for rid in done:
                finish[rid] = now
            res.update(done)
        sync()
        return res, sorted(finish.values()), eng

    engine_run()  # untimed: the allocator's and cuBLAS's first calls
    t0 = time.perf_counter()
    res, lat, eng = engine_run()
    dt_e = time.perf_counter() - t0
    got = sum(len(v) for v in res.values())
    st = eng.stats
    print(f"engine: {dt_e:.2f} s, {got} tokens -> {got / dt_e:.0f} tok/s, "
          f"{n / dt_e * 3600:.0f} requests/hour, {st['rounds']} rounds in "
          f"{st['chunks']} chunks; request latency p50 "
          f"{_pctl(lat, .5):.2f}s p95 {_pctl(lat, .95):.2f}s "
          f"(queue-at-t0 model)", flush=True)
    if args.profile:
        print(f"  install {st['install_s']:.2f}s ({st['installs']} "
              f"prefills, {st['install_s'] / max(st['installs'], 1) * 1e3:.0f}"
              f" ms/img)  steps {st['steps_s']:.2f}s ({st['steps']} steps, "
              f"{st['steps_s'] / max(st['steps'], 1) * 1e3:.1f} ms/step)  "
              f"sync {st['sync_s']:.2f}s", flush=True)
    out.update(engine_s=dt_e, engine_tokens=got, engine_tok_s=got / dt_e,
               engine_rounds=st["rounds"], engine_chunks=st["chunks"],
               engine_lat_p50=_pctl(lat, .5), engine_lat_p95=_pctl(lat, .95),
               engine_results=res)

    # --- static batches: `slots` requests a batch, each decoded to its
    # batch's largest budget ---------------------------------------------------
    def static_run():
        toks, lats = [], []
        t_start = time.perf_counter()
        for off in range(0, n, args.slots):
            bvins = vins[off:off + args.slots]
            cap = max(budgets[off:off + args.slots])
            rows = gen.generate_batch_from_ids(
                ids, bvins, max_new_tokens=cap,
                prefill_chunk=32 if len(bvins) > 32 else None)
            toks.extend(t[:b] for t, b in
                        zip(rows, budgets[off:off + args.slots]))
            # every request of the batch finishes when the batch does
            lats.extend([time.perf_counter() - t_start] * len(bvins))
        return toks, sorted(lats)

    if not args.skip_static:
        static_run()
        t0 = time.perf_counter()
        toks, slat = static_run()
        dt_s = time.perf_counter() - t0
        s_tokens = sum(len(t) for t in toks)
        print(f"static: {dt_s:.2f} s, {s_tokens} tokens -> "
              f"{s_tokens / dt_s:.0f} tok/s, {n / dt_s * 3600:.0f} "
              f"requests/hour; request latency p50 {_pctl(slat, .5):.2f}s "
              f"p95 {_pctl(slat, .95):.2f}s (queue-at-t0 model)", flush=True)
        print(f"engine speedup: {dt_s / dt_e:.2f}x", flush=True)
        out.update(static_s=dt_s, static_tokens=s_tokens,
                   static_tok_s=s_tokens / dt_s, static_results=toks)

    if not args.arrivals:
        return out

    # --- open-loop Poisson arrivals: one schedule, fixed up front and
    # served by both. Engine TTFT = arrival -> first harvested token
    # (engine.progress(), one chunk's resolution); the static baseline
    # shows a request's tokens only when its batch completes ----------------
    sat = n / dt_e  # the engine's drain rate (req/s)
    rates = ([sat * f for f in (0.5, 0.75, 0.95)]
             if args.arrivals == "auto"
             else [float(r) for r in args.arrivals.split(",")])

    def engine_stream(arrivals):
        eng = new_engine()
        rid2i, ttft, comp = {}, {}, {}
        tokens = nxt = 0
        t0 = time.perf_counter()
        while len(comp) < n:
            now = time.perf_counter() - t0
            while nxt < n and arrivals[nxt] <= now:
                rid = eng.submit(ids, vins[nxt],
                                 max_new_tokens=budgets[nxt])
                rid2i[rid] = nxt
                nxt += 1
            if not eng.pending:
                time.sleep(max(0.0, arrivals[nxt]
                               - (time.perf_counter() - t0)))
                continue
            fin = eng.poll()
            now = time.perf_counter() - t0
            for rid, cnt in eng.progress().items():
                if cnt and rid not in ttft:
                    ttft[rid] = now - arrivals[rid2i[rid]]
            for rid, toks in fin.items():
                comp[rid] = now - arrivals[rid2i[rid]]
                ttft.setdefault(rid, comp[rid])
                tokens += len(toks)
        mk = time.perf_counter() - t0
        return mk, tokens, sorted(ttft.values()), sorted(comp.values())

    def static_stream(arrivals):
        backlog, comp = [], {}
        tokens = nxt = 0
        t0 = time.perf_counter()
        while len(comp) < n:
            now = time.perf_counter() - t0
            while nxt < n and arrivals[nxt] <= now:
                backlog.append(nxt)
                nxt += 1
            if not backlog:
                time.sleep(max(0.0, arrivals[nxt]
                               - (time.perf_counter() - t0)))
                continue
            batch = backlog[:args.slots]
            del backlog[:len(batch)]
            pad = batch + [batch[-1]] * (args.slots - len(batch))
            cap = max(budgets[j] for j in batch)
            rows = gen.generate_batch_from_ids(
                ids, [vins[j] for j in pad], max_new_tokens=cap,
                prefill_chunk=32 if len(pad) > 32 else None)
            now = time.perf_counter() - t0
            for row, j in zip(rows[:len(batch)], batch):
                tokens += len(row[:budgets[j]])
                comp[j] = now - arrivals[j]
        mk = time.perf_counter() - t0
        return mk, tokens, sorted(comp.values())

    arr_rng = np.random.default_rng(args.arrival_seed)
    print(f"\nstreaming arrivals (Poisson, seed {args.arrival_seed}); "
          f"engine drain rate {sat:.1f} req/s", flush=True)
    out["arrivals"] = []
    for rate in rates:
        arrivals = np.cumsum(arr_rng.exponential(1.0 / rate, n))
        mk, tok, tf, cp = engine_stream(arrivals)
        row = {"rate": rate, "engine_tok_s": tok / mk,
               "engine_ttft_p50": _pctl(tf, .5),
               "engine_ttft_p95": _pctl(tf, .95),
               "engine_comp_p50": _pctl(cp, .5),
               "engine_comp_p95": _pctl(cp, .95)}
        print(f"  engine λ={rate:5.1f}/s: makespan {mk:6.1f}s "
              f"{tok / mk:6.0f} tok/s  TTFT p50 {_pctl(tf, .5):6.2f}s "
              f"p95 {_pctl(tf, .95):6.2f}s  completion "
              f"p50 {_pctl(cp, .5):6.2f}s p95 {_pctl(cp, .95):6.2f}s",
              flush=True)
        if not args.skip_static:
            mk, tok, cp = static_stream(arrivals)
            row.update(static_tok_s=tok / mk, static_ttft_p50=_pctl(cp, .5),
                       static_ttft_p95=_pctl(cp, .95))
            print(f"  static λ={rate:5.1f}/s: makespan {mk:6.1f}s "
                  f"{tok / mk:6.0f} tok/s  TTFT == completion "
                  f"p50 {_pctl(cp, .5):6.2f}s p95 {_pctl(cp, .95):6.2f}s",
                  flush=True)
        out["arrivals"].append(row)
    return out


if __name__ == "__main__":
    main()
