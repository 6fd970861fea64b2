"""Serving endpoint: HTTP image -> emotion probs, and pipeline-M embeddings
(port of ``vlm_clip_tpu/cli/serve.py``).

A ThreadingHTTPServer front-end feeding a micro-batching worker:
``/classify`` requests are coalesced for up to ``--batch-window-ms`` into
one fixed-size padded batch, scored by the zero-shot predict path — or,
with ``--adapter-ckpt``, by pipeline T's CLIP-Adapter (``t-adapter``
mode, the feature adapters loaded strictly from a T checkpoint; kernel
K6 on a GPU), or, with ``--v-adapter-ckpt``, by pipeline V's
context-fused adapter (``v-context`` mode: the three adapters loaded
strictly from a V checkpoint; each image's context features from the
``--context-cache`` directory, keyed by the decoded image's content
hash, zeros for an image the cache has not seen or without a cache, the
reference's own fallback; K6 on a GPU) — and fanned back out. With
``--embed`` or
``--m-adapter-ckpt`` the server also answers ``/embed`` and
``/embed_text`` with unit-norm projected CLIP features;
``--m-adapter-ckpt`` applies pipeline M's adapters, whose fused CUDA
kernels run when ``--device`` is a GPU.

Endpoints:
- ``POST /classify``   raw image bytes (jpeg/png) -> JSON {probs, label}
- ``POST /embed``      image bytes -> unit-norm features
- ``POST /embed_text`` text (raw utf-8 or {"text": ...}) -> features
- ``GET  /healthz``    liveness + model info

Requests run under ``torch.inference_mode()`` on ``--device`` (default
``cuda``).

Drive: ``python -m vlm_clip_tpu_torch.cli.serve --port 8899
--allow-random-weights --allow-hash-tokenizer --m-adapter-ckpt m.pt
[--adapter-ckpt t.pt | --v-adapter-ckpt v.pt --context-cache DIR]``.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

class _Pending:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


class BatchingClassifier:
    """Micro-batching inference worker.

    ``predict_fn(images_u8 [max_batch, S, S, 3]) -> probs [max_batch, 7]``
    (numpy in, numpy out) owns normalization and the device.
    """

    def __init__(self, predict_fn, image_size: int, max_batch: int = 8,
                 window_ms: float = 10.0):
        self.predict_fn = predict_fn
        self.image_size = image_size
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.total_requests = 0
        self.total_batches = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image_bytes: bytes, timeout: float = 30.0):
        p = _Pending(image_bytes)
        self.q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if p.error:
            raise ValueError(p.error)
        return p.result

    def _loop(self) -> None:
        from PIL import Image

        from vlm_clip_tpu_torch.core.config import EMOTIONS
        from vlm_clip_tpu_torch.data.preprocess import load_and_resize

        while True:
            first = self.q.get()
            batch: List[_Pending] = [first]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break

            images = np.zeros((self.max_batch, self.image_size,
                               self.image_size, 3), np.uint8)
            ok = []
            for i, p in enumerate(batch):
                try:
                    img = Image.open(io.BytesIO(p.image))
                    images[i] = load_and_resize(img, self.image_size)
                    ok.append(True)
                except Exception as e:
                    p.error = f"bad image: {e}"
                    ok.append(False)
            try:
                probs = np.asarray(self.predict_fn(images))
            except Exception as e:  # the worker must outlive a bad batch
                for p in batch:
                    p.error = p.error or f"inference failed: {e}"
                    p.event.set()
                continue
            self.total_requests += len(batch)
            self.total_batches += 1
            for i, p in enumerate(batch):
                if ok[i]:
                    row = probs[i]
                    p.result = {
                        "probs": {e: float(row[j])
                                  for j, e in enumerate(EMOTIONS)},
                        "label": EMOTIONS[int(row.argmax())],
                        "confidence": float(row.max()),
                    }
                p.event.set()


class Embedder:
    """Pipeline-M serving surface: projected, L2-normalized CLIP features
    for an image or a text string, with the M sequence/cross-modal
    adapters applied when ``m_adapter_ckpt`` is given. Features from both
    endpoints are unit-norm, so a dot product is the retrieval score."""

    def __init__(self, clip_params, cfg, tokenizer, m_adapter_ckpt=None,
                 policy=None):
        from vlm_clip_tpu_torch.core.dtypes import BF16
        from vlm_clip_tpu_torch.models import clip as C

        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = clip_params["logit_scale"].device
        self._lock = threading.Lock()  # serialized compute
        pol = policy or BF16
        self.model = None
        if m_adapter_ckpt:
            from vlm_clip_tpu_torch.models.model_m import CLIPWithAdapters

            self.model = CLIPWithAdapters(clip_params, cfg, policy=pol)
            self.model.load_adapter_weights(m_adapter_ckpt)
            self._image = self.model.get_image_features
            self._text = self.model.get_text_features
            self.mode = "m-adapter"
        else:
            self._image = lambda px: C.get_image_features(clip_params, px,
                                                          cfg, pol)
            self._text = lambda ids, mask: C.get_text_features(
                clip_params, ids, mask, cfg, pol)
            self.mode = "clip"
        # warm up both paths (and build the kernels) before taking traffic
        self.embed_image_bytes(_png_8x8())
        self.embed_text("warmup")

    @staticmethod
    def _norm(feats: torch.Tensor) -> np.ndarray:
        from vlm_clip_tpu_torch.models.layers import l2_normalize

        return l2_normalize(feats).float().cpu().numpy()

    def pixels(self, data: bytes) -> torch.Tensor:
        """Image bytes -> the [1, 3, S, S] normalized batch /embed runs."""
        from PIL import Image

        from vlm_clip_tpu_torch.data.preprocess import (load_and_resize,
                                                        normalize_batch)

        img = load_and_resize(Image.open(io.BytesIO(data)),
                              self.cfg.vision.image_size)
        return normalize_batch(torch.from_numpy(np.array(img[None])).to(
            self.device))

    def embed_image_bytes(self, data: bytes) -> np.ndarray:
        px = self.pixels(data)
        with self._lock, torch.inference_mode():
            feats = self._image(px)
        return self._norm(feats)[0]

    def embed_text(self, text: str) -> np.ndarray:
        ids, mask = self.tokenizer([text])
        with self._lock, torch.inference_mode():
            feats = self._text(torch.from_numpy(ids).to(self.device),
                               torch.from_numpy(mask).to(self.device))
        return self._norm(feats)[0]


def _png_8x8() -> bytes:
    """Tiny in-memory PNG for the Embedder warmup."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def make_handler(classifier: BatchingClassifier, model_name: str,
                 embedder: Optional[Embedder] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok", "model": model_name,
                    "requests": classifier.total_requests,
                    "batches": classifier.total_batches,
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            known = ("/classify", "/embed", "/embed_text")
            if self.path not in known:
                self._json(404, {"error": "unknown path"})
                return
            if self.path in ("/embed", "/embed_text") and embedder is None:
                self._json(404, {"error": "embedding endpoints disabled "
                                          "(serve --embed to enable)"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > 32 << 20:
                self._json(400, {"error": "missing or oversized body"})
                return
            data = self.rfile.read(length)
            try:
                if self.path == "/classify":
                    self._json(200, classifier.submit(data))
                elif self.path == "/embed":
                    vec = embedder.embed_image_bytes(data)
                    self._json(200, {"features": vec.tolist(),
                                     "dim": len(vec),
                                     "model": embedder.mode})
                else:  # /embed_text: raw utf-8 or {"text": ...}
                    text = data.decode("utf-8", errors="replace")
                    try:
                        obj = json.loads(text)
                        if isinstance(obj, dict) and "text" in obj:
                            text = str(obj["text"])
                    except json.JSONDecodeError:
                        pass
                    vec = embedder.embed_text(text)
                    self._json(200, {"features": vec.tolist(),
                                     "dim": len(vec),
                                     "model": embedder.mode})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except TimeoutError as e:
                self._json(503, {"error": str(e)})
            except Exception as e:  # bad image bytes etc.
                self._json(400, {"error": f"bad request: {e}"})

    return Handler


def build_predict_fn(clip_model_name: str, adapter_ckpt=None,
                     v_adapter_ckpt=None, context_cache=None,
                     max_batch: int = 8, backbone=None, policy=None,
                     device="cuda"):
    """(predict_fn, mode, cfg) for the requested serving mode: zero-shot,
    ``t-adapter`` with ``adapter_ckpt`` (strict T load), or ``v-context``
    with ``v_adapter_ckpt`` (strict V load: all three adapters) and the
    optional ``context_cache`` directory; runs the fixed-shape predict
    path once before returning (warmup).

    ``backbone=(clip_params, cfg, tokenizer)`` injects a preloaded tower
    (its params' device is the serving device); the default loads
    ``clip_model_name`` on ``device`` (the card unless the caller asks
    for the CPU).
    """
    if adapter_ckpt and v_adapter_ckpt:
        raise ValueError("pass --adapter-ckpt OR --v-adapter-ckpt")
    if backbone is not None:
        clip_params, cfg, tokenizer = backbone
    else:
        from vlm_clip_tpu_torch.cli.common import load_backbone, make_tokenizer

        clip_params, cfg = load_backbone(clip_model_name, device=device)
        tokenizer = make_tokenizer(cfg)
    device = clip_params["logit_scale"].device
    model_kw = {} if policy is None else {"policy": policy}
    if v_adapter_ckpt:
        predict = _v_predict_fn(clip_params, cfg, tokenizer, v_adapter_ckpt,
                                context_cache, device, model_kw)
        mode = "v-context" + ("+cache" if context_cache else "")
    else:
        predict, mode = _predict_fn(clip_params, cfg, tokenizer,
                                    adapter_ckpt, device, model_kw)
    t0 = time.time()
    predict(np.zeros((max_batch, cfg.vision.image_size,
                      cfg.vision.image_size, 3), np.uint8))
    print(f"warmup done in {time.time() - t0:.1f}s", flush=True)
    return predict, mode, cfg


def _predict_fn(clip_params, cfg, tokenizer, adapter_ckpt, device,
                model_kw):
    """(predict, mode): zero-shot, or pipeline T's adapters."""
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch
    from vlm_clip_tpu_torch.models.model_t import (CLIPAdapterT,
                                                   ZeroShotEmotionRecognition)

    with torch.inference_mode():
        if adapter_ckpt:
            model = CLIPAdapterT(clip_params, cfg, tokenizer, **model_kw)
            model.load_adapters(adapter_ckpt)  # strict (train/checkpoint.py)
            mode = "t-adapter"
        else:
            model = ZeroShotEmotionRecognition(clip_params, cfg, tokenizer,
                                               **model_kw)
            mode = "zero-shot"

    def predict(images_u8: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            px = normalize_batch(torch.from_numpy(images_u8).to(device))
            return model.predict(px).cpu().numpy()

    return predict, mode


def _v_predict_fn(clip_params, cfg, tokenizer, v_adapter_ckpt,
                  context_cache, device, model_kw):
    """Pipeline V's predict: the three adapters from a V checkpoint
    (strict: a file without one of them is refused), each image's context
    features from the cache by the decoded image's content hash (the key
    ``cli/build_context_cache`` writes beside the path key), zeros where
    the cache has none."""
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch
    from vlm_clip_tpu_torch.models.model_v import EnhancedCLIPAdapterV
    from vlm_clip_tpu_torch.train.checkpoint import load_v_adapters
    from vlm_clip_tpu_torch.vlm.extractor import CachedContextExtractor

    loaded = load_v_adapters(v_adapter_ckpt, device=device)
    missing = [n for n in ("visual", "text", "context") if n not in loaded]
    if missing:
        raise ValueError(f"{v_adapter_ckpt} is not a V checkpoint: "
                         f"missing {missing}")
    with torch.inference_mode():
        model = EnhancedCLIPAdapterV(clip_params, cfg, tokenizer, **model_kw)
        model.adapter_params = loaded
        model.encode_emotion_descriptions()
    cache = CachedContextExtractor(context_cache) if context_cache else None
    P = cfg.projection_dim

    def predict(images_u8: np.ndarray) -> np.ndarray:
        ctx = np.zeros((images_u8.shape[0], P), np.float32)
        if cache is not None:
            for i in range(images_u8.shape[0]):
                feats = cache.encode_context_descriptions(
                    cache.extract_context_from_image(images_u8[i]))
                if feats is not None:
                    ctx[i] = feats[0]
        with torch.inference_mode():
            px = normalize_batch(torch.from_numpy(images_u8).to(device))
            return model.predict_probs(px, ctx).cpu().numpy()

    return predict


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Emotion classification "
                                            "serving endpoint (PyTorch)")
    p.add_argument("--port", type=int, default=8899)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (cuda, cuda:1, "
                        "cpu)")
    p.add_argument("--clip-model-name", default="vit-base-patch32")
    p.add_argument("--adapter-ckpt", default=None,
                   help="T-adapter checkpoint (visual + text feature "
                        "adapters): /classify in t-adapter mode")
    p.add_argument("--v-adapter-ckpt", default=None,
                   help="V 3-adapter checkpoint (context pipeline): "
                        "/classify in v-context mode")
    p.add_argument("--context-cache", default=None,
                   help="context cache dir for the V pipeline "
                        "(cli/build_context_cache.py output)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=10.0)
    p.add_argument("--embed", action="store_true",
                   help="also serve /embed (image) and /embed_text — "
                        "unit-norm projected CLIP features")
    p.add_argument("--m-adapter-ckpt", default=None,
                   help="M adapter checkpoint for the /embed endpoints "
                        "(reference adapter format; implies --embed)")
    p.add_argument("--hf-checkpoint", default=None,
                   help="local HF CLIP checkpoint dir (its vocab.json/"
                        "merges.txt are picked up) or a hub id in the HF "
                        "cache")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="come up with random-init weights when no HF "
                        "checkpoint loads (hermetic drives only)")
    p.add_argument("--allow-hash-tokenizer", action="store_true",
                   help="allow the non-CLIP hash tokenizer fallback "
                        "(hermetic drives only)")
    return p.parse_args(argv)


def build_server(argv=None) -> ThreadingHTTPServer:
    """Load the model, warm it up, and bind the HTTP server (not yet
    serving). The server carries ``embedder`` and ``classifier``."""
    args = parse_args(argv)

    from vlm_clip_tpu_torch.cli.common import load_backbone, make_tokenizer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu to serve on the "
                           "CPU)")
    clip_params, cfg = load_backbone(
        args.clip_model_name, hf_checkpoint=args.hf_checkpoint,
        require_real=not args.allow_random_weights, device=device)
    # auto mode (None): raise exactly when REAL weights would pair with
    # the hash tokenizer; --allow-hash-tokenizer opts out
    tokenizer = make_tokenizer(
        cfg, require_real=False if args.allow_hash_tokenizer else None)
    predict_fn, mode, cfg = build_predict_fn(
        args.clip_model_name, adapter_ckpt=args.adapter_ckpt,
        v_adapter_ckpt=args.v_adapter_ckpt,
        context_cache=args.context_cache, max_batch=args.max_batch,
        backbone=(clip_params, cfg, tokenizer))

    embedder = None
    if args.embed or args.m_adapter_ckpt:
        embedder = Embedder(clip_params, cfg, tokenizer,
                            m_adapter_ckpt=args.m_adapter_ckpt)
        mode += f"+embed[{embedder.mode}]"

    classifier = BatchingClassifier(predict_fn, cfg.vision.image_size,
                                    args.max_batch, args.batch_window_ms)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(classifier, f"{cfg.name} [{mode}]", embedder=embedder))
    server.embedder = embedder
    server.classifier = classifier
    server.mode = mode
    print(f"serving {cfg.name} [{mode}] on {device} at "
          f"http://{args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, "
          f"window={args.batch_window_ms}ms)", flush=True)
    return server


def main(argv=None) -> None:
    build_server(argv).serve_forever()


if __name__ == "__main__":
    main()
