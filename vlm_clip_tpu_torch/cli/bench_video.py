"""BASELINE config 4: video emotion pipeline, end to end on the card
(port of ``vlm_clip_tpu/cli/bench_video.py``).

The reference's video path (process_video.py:6-33) is: cv2 demux ->
cv2 resize to 224 on host -> ImageNet-stats normalize on host -> per
-frame eager CLIP forward. Here host cores demux ONLY and native-
resolution uint8 frames go to the device, where resize + center-crop +
normalize + the ViT-B/16 forward + class softmax run
(data/video.py score_video_frames_raw).

Measures, in frames/s:
- demux only (cv2.VideoCapture read + BGR->RGB, native resolution);
- chip only (uint8 upload + on-device resize/normalize/score, demux
  amortized away);
- device-resident (one batch already on the device, scored again and
  again: the card's own rate, upload excluded);
- end-to-end serial (demux then score per chunk);
- end-to-end overlapped (demux producer thread || score consumer — the
  deployment shape);
- the reference-pattern baseline on the same card (host cv2 resize +
  host normalize + fp32 frame upload + tower-only forward), so the table
  isolates what moving preprocessing onto the device buys.

No video file is needed: a synthetic MJPG AVI (moving blocks over a
gradient — realistic decode work, not noise) is written to --tmpdir.
The demux needs cv2; ``--no-demux`` (for a host without it) makes the
frames from a seed with numpy at --width x --height and runs the
chip-only and device-resident lines alone. Device times are read after
``torch.cuda.synchronize()``. Plus ``--device`` (default ``cuda``;
``--device cpu`` for a host without a card).

    python -m vlm_clip_tpu_torch.cli.bench_video --frames 512
    python -m vlm_clip_tpu_torch.cli.bench_video --no-demux --frames 64
"""

from __future__ import annotations

import argparse
import os
import queue
import tempfile
import threading
import time
from typing import List, Optional


def synth_video(path: str, frames: int, w: int, h: int, fps: int) -> None:
    """Moving-blocks clip: cheap to draw, honest MJPEG decode work."""
    import cv2
    import numpy as np

    base = np.linspace(0, 255, w, dtype=np.uint8)[None, :, None]
    base = np.broadcast_to(base, (h, w, 3)).copy()
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                         (w, h))
    if not wr.isOpened():
        raise RuntimeError("cv2.VideoWriter failed to open (MJPG/AVI)")
    rng = np.random.default_rng(0)
    boxes = rng.integers(0, 200, (8, 2))
    vels = rng.integers(-7, 8, (8, 2))
    colors = rng.integers(0, 255, (8, 3))
    try:
        for t in range(frames):
            f = base.copy()
            for i in range(len(boxes)):
                y, x = boxes[i] + vels[i] * t
                y, x = int(y) % (h - 60), int(x) % (w - 60)
                f[y:y + 60, x:x + 60] = colors[i]
            wr.write(f)
    finally:
        wr.release()


def demux(path: str, limit: int):
    """cv2 read + BGR->RGB at native resolution -> uint8 [T, H, W, 3]."""
    import cv2
    import numpy as np

    cap = cv2.VideoCapture(path)
    out = []
    try:
        while len(out) < limit:
            ok, f = cap.read()
            if not ok:
                break
            out.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return np.stack(out)


def seeded_frames(n: int, h: int, w: int):
    """uint8 [n, h, w, 3] frames made from a fixed seed with numpy."""
    import numpy as np

    return np.random.default_rng(0).integers(0, 256, (n, h, w, 3),
                                             dtype=np.uint8)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chip_only(run, params, frames, emb, batch: int, device) -> float:
    """frames/s of upload + score over ``frames`` in chunks of ``batch``
    (one warmup chunk first)."""
    import torch

    def score(chunk):
        return run(params, torch.from_numpy(chunk).to(device), emb)

    score(frames[:batch])
    _sync(device)
    n_chunks = len(frames) // batch
    t0 = time.perf_counter()
    for c in range(n_chunks):
        score(frames[c * batch:(c + 1) * batch])
    _sync(device)
    return n_chunks * batch / (time.perf_counter() - t0)


def device_resident(run, params, frames, emb, batch: int, device,
                    passes: int) -> float:
    """frames/s of scoring one batch already on the device ``passes``
    times (one warmup pass first)."""
    import torch

    chunk = torch.from_numpy(frames[:batch]).to(device)
    run(params, chunk, emb)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(passes):
        run(params, chunk, emb)
    _sync(device)
    return passes * batch / (time.perf_counter() - t0)


def main(argv: Optional[List[str]] = None) -> dict:
    """Print the lines; returns {phase: frames/s}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=512)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--model", default="vit-base-patch16")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--stats", default="imagenet",
                   choices=("imagenet", "clip"),
                   help="imagenet reproduces the reference quirk "
                        "(process_video.py:21-26)")
    p.add_argument("--video", default=None,
                   help="existing video file (else a synthetic MJPG AVI "
                        "is written)")
    p.add_argument("--tmpdir", default=None,
                   help="where the synthetic video goes (default: a "
                        "fresh temporary directory)")
    p.add_argument("--skip-host-path", action="store_true")
    p.add_argument("--no-demux", action="store_true",
                   help="seeded numpy frames, no cv2: the chip-only and "
                        "device-resident lines only")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vlm_clip_tpu_torch.cli.common import resolve_device
    from vlm_clip_tpu_torch.core.config import clip_preset
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.data.video import (_raw_frame_scorer,
                                               extract_frames)
    from vlm_clip_tpu_torch.models.clip import init_clip

    device = resolve_device(args.device)
    out = {}
    path = args.video
    if path is None and not args.no_demux:
        tmpdir = args.tmpdir or tempfile.mkdtemp(prefix="bench_video")
        os.makedirs(tmpdir, exist_ok=True)
        path = os.path.join(tmpdir, "bench_video.avi")
        t0 = time.perf_counter()
        synth_video(path, args.frames, args.width, args.height, args.fps)
        print(f"synth video: {args.frames}f {args.width}x{args.height} "
              f"MJPG -> {path} "
              f"({os.path.getsize(path) / 1e6:.0f} MB, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)

    cfg = clip_preset(args.model)
    params = init_clip(torch.Generator(device=device).manual_seed(0), cfg,
                       device=device)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(7, cfg.projection_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    emb_t = torch.from_numpy(emb).to(device)
    B = args.batch
    tower = f"ViT-{args.model.split('-')[-1]}"

    # --- demux only --------------------------------------------------------
    if args.no_demux:
        frames = seeded_frames(args.frames, args.height, args.width)
        print(f"frames: {len(frames)} seeded {args.width}x{args.height} "
              f"uint8 (no demux)", flush=True)
    else:
        t0 = time.perf_counter()
        frames = demux(path, args.frames)
        dt_demux = time.perf_counter() - t0
        out["demux"] = len(frames) / dt_demux
        print(f"demux only: {len(frames)} frames in {dt_demux:.2f}s -> "
              f"{out['demux']:.0f} f/s (native {frames.shape[1]}x"
              f"{frames.shape[2]})", flush=True)
    T = len(frames)
    n_chunks = T // B
    T_used = n_chunks * B

    # --- chip only (frames already demuxed) --------------------------------
    run = _raw_frame_scorer(cfg, BF16, args.stats, args.size)
    out["chip_only"] = chip_only(run, params, frames, emb_t, B, device)
    print(f"chip only:  {T_used} frames -> {out['chip_only']:.1f} f/s "
          f"(uint8 upload + on-device resize/normalize/{tower}/softmax)",
          flush=True)

    # --- device-resident (compute only, upload amortized away) ------------
    passes = max(1, 512 // B)
    out["device_resident"] = device_resident(run, params, frames, emb_t, B,
                                             device, passes)
    print(f"device-resident: {passes * B} frames -> "
          f"{out['device_resident']:.1f} f/s (device compute incl. "
          f"on-device resize; upload excluded)", flush=True)

    def sanity() -> dict:
        # normalized finite probability rows. (Geometry intentionally
        # differs from the reference-pattern line: the reference squashes
        # to 224x224 — process_video.py:21 — while the device path does
        # shortest-edge + center crop.)
        a = run(params, torch.from_numpy(frames[:B]).to(device),
                emb_t).cpu().numpy()
        if not (np.isfinite(a).all()
                and np.allclose(a.sum(-1), 1.0, atol=1e-3)):
            raise SystemExit("bench_video: probability rows not finite or "
                             "not normalized")
        print("sanity: device-path probability rows finite and "
              "normalized", flush=True)
        return out

    if args.no_demux:
        return sanity()

    # --- end-to-end serial -------------------------------------------------
    t0 = time.perf_counter()
    frames = demux(path, args.frames)
    for c in range(n_chunks):
        run(params, torch.from_numpy(frames[c * B:(c + 1) * B]).to(device),
            emb_t)
    _sync(device)
    dt_serial = time.perf_counter() - t0
    out["e2e_serial"] = T_used / dt_serial
    print(f"e2e serial: {T_used} frames in {dt_serial:.2f}s -> "
          f"{out['e2e_serial']:.0f} f/s", flush=True)

    # --- end-to-end overlapped (demux thread || device) --------------------
    def producer(q):
        import cv2

        cap = cv2.VideoCapture(path)
        buf = []
        try:
            while True:
                ok, f = cap.read()
                if not ok:
                    break
                buf.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
                if len(buf) == B:
                    q.put(np.stack(buf))
                    buf = []
        finally:
            cap.release()
            q.put(None)

    t0 = time.perf_counter()
    q: "queue.Queue" = queue.Queue(maxsize=4)
    threading.Thread(target=producer, args=(q,), daemon=True).start()
    got = 0
    while True:
        chunk = q.get()
        if chunk is None:
            break
        run(params, torch.from_numpy(chunk).to(device), emb_t)
        got += len(chunk)
    _sync(device)
    dt_olap = time.perf_counter() - t0
    out["e2e_overlapped"] = got / dt_olap
    print(f"e2e overlapped: {got} frames in {dt_olap:.2f}s -> "
          f"{out['e2e_overlapped']:.0f} f/s  <- headline (demux || chip)",
          flush=True)

    if not args.skip_host_path:
        # --- reference-pattern baseline on the same card -------------------
        # host cv2 resize to 224 + host normalize (process_video.py:21-26),
        # fp32 [B,3,224,224] upload, tower-only forward.
        from vlm_clip_tpu_torch.data.video import _scores, _stats

        mean, std = (np.asarray(s, np.float32) for s in _stats(args.stats))

        @torch.no_grad()
        def score_px(px):
            return _scores(params, cfg, px, emb_t, BF16)

        def host_px(chunk):
            x = (chunk.astype(np.float32) / 255.0 - mean) / std
            return torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(
                device)

        score_px(host_px(extract_frames(path, B, args.size)))  # warmup
        _sync(device)
        t0 = time.perf_counter()
        f224 = extract_frames(path, args.frames, args.size)  # host resize
        for c in range(n_chunks):
            score_px(host_px(f224[c * B:(c + 1) * B]))
        _sync(device)
        dt_host = time.perf_counter() - t0
        out["reference_pattern"] = T_used / dt_host
        print(f"reference-pattern (host resize+normalize, fp32 upload): "
              f"{T_used} frames in {dt_host:.2f}s -> "
              f"{out['reference_pattern']:.0f} f/s "
              f"({dt_host / dt_olap:.2f}x slower than overlapped)",
              flush=True)

    return sanity()


if __name__ == "__main__":
    main()
