"""VLM generation endpoint on the continuous-batching engine.

Port of ``vlm_clip_tpu/cli/serve_vlm.py``. Front end: a
ThreadingHTTPServer. Back end: one worker thread that owns a
``ContinuousBatchingEngine`` (``vlm/engine.py``): requests stream into
the engine's slots as they arrive and each finished generation goes back
on its own, so a long generation never blocks a short one (the
reference's fixed-batch ``generate()``, model_v.py:108-118, makes every
row wait for the batch's last).

Endpoints:
- ``POST /generate``: raw image bytes -> JSON {tokens, text, ms}. Query
  parameters: ``max_new`` (default ``--max-new``), ``prompt`` (default
  the reference's context prompt, ``extractor.VLM_PROMPT``), ``stream=1``
  for Server-Sent Events: one ``data: {"tokens": [...]}`` event per
  harvested chunk (harvested tokens are final), then
  ``data: {"done": true, tokens, text, ms}``. A client that goes away
  mid-stream has its request cancelled (its slot freed for the next
  refill), seen as a failed write or a FIN on the read side.
- ``GET /healthz``: {status, mode, slots, pending, totals incl.
  cancelled}.

Two deliberate differences from the reference: a request whose wait
times out (streamed or not) is cancelled, where the reference leaves it
decoding; and a cancel that arrives before the worker has handed the
request to the engine is honoured (``_Job.cancelled``), where the
reference's worker drops it and decodes the request anyway.

Weights: ``--weights DIR`` (safetensors + tokenizer.json, the
``QwenVLContextExtractor`` contract). Without weights the server refuses
to start unless given ``--allow-synth-weights`` (3B random weights made
on the card from a seed, token-id-only responses).

    python -m vlm_clip_tpu_torch.cli.serve_vlm --port 8898 \\
        --allow-synth-weights [--device cpu] &
    curl -s --data-binary @face.jpg 'localhost:8898/generate?max_new=32'

Tensor and data parallelism (``--tp``, ``--dp``): one process a device
under a launcher that sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, with world size ``tp x dp``::

    torchrun --nproc-per-node 4 -m vlm_clip_tpu_torch.cli.serve_vlm \\
        --allow-synth-weights --tp 2 --dp 2

Every rank builds the engine over a ``('data', 'model')`` mesh
(``vlm/engine.py``). Rank 0 binds the HTTP server; each worker round it
broadcasts the requests it admitted and the cancels it took to the other
ranks, whose workers replay them, so every rank's engine steps in
lockstep.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

def _group_rank(group) -> int:
    import torch.distributed as dist

    return dist.get_rank(group)


class _Job:
    __slots__ = ("ids", "vision", "max_new", "event", "tokens", "error",
                 "stream_q", "sent", "cancelled")

    def __init__(self, ids, vision, max_new, stream: bool = False):
        self.ids = ids
        self.vision = vision
        self.max_new = max_new
        self.event = threading.Event()
        self.tokens = None
        self.error: Optional[str] = None
        # streaming: the worker puts token-delta lists here as chunks
        # harvest, then None at completion
        self.stream_q: "Optional[queue.Queue]" = \
            queue.Queue() if stream else None
        self.sent = 0  # tokens already put on stream_q
        # set by EngineWorker.cancel from any thread; the worker skips a
        # cancelled job it has not handed to the engine yet
        self.cancelled = False


class EngineWorker:
    """The one thread that owns the engine; HTTP threads hand it _Jobs.

    The engine is not thread-safe, and its device work must run on one
    stream (K8's workspace is shared per device), so every submit, poll
    and cancel happens on this thread, which :meth:`start` starts and
    :meth:`stop` ends.

    ``group``: a process group whose ranks each run an engine over one
    mesh. Its rank 0 is the leader (its HTTP threads hand it jobs); every
    round it broadcasts the submits and cancels it made, and the other
    ranks' workers (:meth:`follow`) make the same before every rank
    polls. The leader's :meth:`stop` stops them too.
    """

    def __init__(self, engine, group=None):
        self.engine = engine
        self.group = group
        self.leader = group is None or _group_rank(group) == 0
        self._ops = {"submit": [], "cancel": []}
        self.q: "queue.Queue[_Job]" = queue.Queue()
        self.cancel_q: "queue.Queue[_Job]" = queue.Queue()
        self._by_rid = {}
        self.total_requests = 0
        self.total_tokens = 0
        self.total_cancelled = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 60.0) -> None:
        """End the worker thread after its current round; jobs it has not
        finished fail with "stopped". The engine is then free to drop."""
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the engine worker did not stop")

    def cancel(self, job: _Job) -> None:
        """Thread-safe cancellation (the client went away or timed out):
        the worker cancels in the engine at its next round, or skips the
        job if it has not reached the engine yet."""
        job.cancelled = True
        self.cancel_q.put(job)

    def _drain_cancels(self):
        while True:
            try:
                job = self.cancel_q.get_nowait()
            except queue.Empty:
                return
            for rid, j in list(self._by_rid.items()):
                if j is job:
                    if self.engine.cancel(rid):
                        self._by_rid.pop(rid, None)
                        self.total_cancelled += 1
                        self._ops["cancel"].append(rid)
                    break

    def submit(self, job: _Job, timeout: float = 300.0):
        self.q.put(job)
        if not job.event.wait(timeout):
            self.cancel(job)
            raise TimeoutError("generation timed out")
        if job.error:
            raise ValueError(job.error)
        return job.tokens

    @staticmethod
    def _fail(job: _Job, error: str) -> None:
        job.error = error
        if job.stream_q is not None:
            job.stream_q.put(None)
        job.event.set()

    def _drain_queue(self):
        while True:
            try:
                job = self.q.get_nowait()
            except queue.Empty:
                return
            if job.cancelled:  # its client left before it was installed
                self.total_cancelled += 1
                self._fail(job, "cancelled")
                continue
            args = (job.ids, job.vision, job.max_new,
                    job.stream_q is not None)
            try:
                rid = self.engine.submit(args[0], args[1],
                                         max_new_tokens=args[2],
                                         stream=args[3])
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._fail(job, str(e))
                continue
            self._ops["submit"].append(args + (rid,))
            self._by_rid[rid] = job
            self.total_requests += 1

    def _share(self, stop: bool = False) -> dict:
        """The leader's ops of this round (made on its engine), broadcast
        to the other ranks; theirs replayed on a follower's engine."""
        ops, self._ops = dict(self._ops, stop=stop), {"submit": [],
                                                      "cancel": []}
        if self.group is None:
            return ops
        import torch.distributed as dist

        box = [ops if self.leader else None]
        dist.broadcast_object_list(box, src=dist.get_global_rank(
            self.group, 0), group=self.group)
        ops = box[0]
        if not self.leader:
            for ids, vision, max_new, stream, rid in ops["submit"]:
                # the leader's engine took this request: a refusal here,
                # or another id, means the ranks' host state diverged
                got = self.engine.submit(ids, vision, max_new_tokens=max_new,
                                         stream=stream)
                if got != rid:
                    raise RuntimeError(
                        f"the leader's request {rid} is request {got} on "
                        f"this rank: the ranks' host state diverged")
            for rid in ops["cancel"]:
                self.engine.cancel(rid)
        return ops

    def follow(self) -> None:
        """A follower rank's loop: replay the leader's rounds until it
        stops."""
        while not self._share()["stop"]:
            if self.engine.pending:
                self.engine.poll()

    def _loop(self):
        while not self._stop.is_set():
            self._round()
        if self.group is not None:
            self._share(stop=True)
        for job in list(self._by_rid.values()):
            self._fail(job, "stopped")
        self._by_rid.clear()
        while True:
            try:
                self._fail(self.q.get_nowait(), "stopped")
            except queue.Empty:
                return

    def _round(self):
        """One round: take new jobs and cancels, then one engine poll and
        its results."""
        self._drain_queue()
        self._drain_cancels()
        self._share()
        if not self.engine.pending:
            try:
                job = self.q.get(timeout=0.05)
            except queue.Empty:
                return
            self.q.put(job)
            return
        fin = self.engine.poll()
        # deltas for live streaming jobs (harvested tokens are final)
        for rid, job in self._by_rid.items():
            if job.stream_q is None or rid in fin:
                continue
            toks = self.engine.partial_tokens(rid)
            if toks is not None and len(toks) > job.sent:
                job.stream_q.put(toks[job.sent:])
                job.sent = len(toks)
        for rid, toks in fin.items():
            job = self._by_rid.pop(rid, None)
            if job is None:
                continue
            job.tokens = toks
            self.total_tokens += len(toks)
            if job.stream_q is not None:
                if len(toks) > job.sent:
                    job.stream_q.put(toks[job.sent:])
                    job.sent = len(toks)
                job.stream_q.put(None)
            job.event.set()


def make_vlm_handler(worker: EngineWorker, prep_fn, tokenizer,
                     default_max_new: int, mode: str,
                     timeout: float = 300.0):
    """``prep_fn(pil_image, prompt_text) -> (ids, vision)`` (host arrays;
    the engine's thread moves them to the device). ``timeout``: seconds a
    request waits for its result (streamed: for its next delta) before
    it is cancelled."""

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
            if urlparse(self.path).path != "/healthz":
                return self._json(404, {"error": "not found"})
            eng = worker.engine
            return self._json(200, {
                "status": "ok", "mode": mode,
                "slots": eng.n_slots, "pending": eng.pending,
                "total_requests": worker.total_requests,
                "total_tokens": worker.total_tokens,
                "total_cancelled": worker.total_cancelled})

        def do_POST(self):
            from PIL import Image

            u = urlparse(self.path)
            if u.path != "/generate":
                return self._json(404, {"error": "not found"})
            qs = parse_qs(u.query)
            try:
                n = int(self.headers.get("Content-Length", 0))
                img = Image.open(io.BytesIO(self.rfile.read(n)))
                img.load()
            except Exception as e:  # noqa: BLE001
                return self._json(400, {"error": f"bad image: {e}"})
            max_new = int(qs.get("max_new", [default_max_new])[0])
            prompt = qs.get("prompt", [None])[0]
            stream = qs.get("stream", ["0"])[0] not in ("0", "", "false")
            t0 = time.perf_counter()
            try:
                ids, vision = prep_fn(img, prompt)
            except Exception as e:  # noqa: BLE001
                return self._json(500, {"error": str(e)})
            if stream:
                return self._stream(ids, vision, max_new, t0)
            try:
                toks = worker.submit(_Job(ids, vision, max_new), timeout)
            except Exception as e:  # noqa: BLE001
                return self._json(500, {"error": str(e)})
            text = (tokenizer.decode(toks).strip()
                    if tokenizer is not None else None)
            return self._json(200, {
                "tokens": toks, "text": text,
                "ms": round((time.perf_counter() - t0) * 1e3, 1)})

        def _stream(self, ids, vision, max_new, t0) -> None:
            """SSE: token deltas per harvested chunk, then a terminal
            done event; ``Connection: close`` framing (the client reads
            to EOF)."""
            job = _Job(ids, vision, max_new, stream=True)
            worker.q.put(job)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def emit(payload: dict) -> None:
                self.wfile.write(
                    b"data: " + json.dumps(payload).encode() + b"\n\n")
                self.wfile.flush()

            def client_gone() -> bool:
                """A closed client sends FIN, and writes into a half-closed
                socket succeed (kernel-buffered), so poll the read side:
                readable with an empty peek is a disconnect (the body is
                already read)."""
                import select
                import socket as _s

                try:
                    r_, _, _ = select.select([self.connection], [], [], 0)
                    if r_:
                        return self.connection.recv(
                            1, _s.MSG_PEEK) == b""
                except OSError:
                    return True
                return False

            try:
                while True:
                    try:
                        delta = job.stream_q.get(timeout=timeout)
                    except queue.Empty:
                        # nobody will wait for the rest: free the slot
                        worker.cancel(job)
                        emit({"done": True,
                              "error": "generation timed out"})
                        return
                    if delta is None:
                        break
                    if client_gone():
                        worker.cancel(job)
                        return
                    emit({"tokens": delta})
                if job.error:
                    emit({"done": True, "error": job.error})
                    return
                text = (tokenizer.decode(job.tokens).strip()
                        if tokenizer is not None else None)
                emit({"done": True, "tokens": job.tokens, "text": text,
                      "ms": round((time.perf_counter() - t0) * 1e3, 1)})
            except (BrokenPipeError, ConnectionResetError):
                # the client went away mid-stream: free the slot instead
                # of decoding tokens nobody will read
                worker.cancel(job)

    return Handler


def build_engine(weights: Optional[str], allow_synth: bool,
                 quant_bits="8h4", kv_bits: int = 16, max_len: int = 768,
                 slots: int = 32, sync_steps: int = 16,
                 resolution: int = 448, sampling=None,
                 refill_chunks=(8, 1), spec_k: int = 0, tp: int = 1,
                 dp: int = 1, device="cuda"):
    """(engine, prep_fn, tokenizer, mode) on ``device`` (the card unless
    the caller asks for the CPU).

    Real weights: the ``QwenVLContextExtractor`` loading contract
    (safetensors directory + tokenizer.json + generation_config.json's
    sampling defaults). Synth: 3B-shape random weights made on the
    device, a fixed pseudo-prompt (no tokenizer), greedy.

    ``tp`` x ``dp`` > 1: under a launcher of that many ranks (the process
    group comes up here, before the weights, so each rank's land on its
    device), the engine runs over a ``(data=dp, model=tp)`` mesh.
    """
    import dataclasses as _dc

    import numpy as np

    from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine
    from vlm_clip_tpu_torch.vlm.extractor import VLM_PROMPT
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator
    from vlm_clip_tpu_torch.vlm.qwen_convert import (
        fold_qwen_patch_normalization, quantize_qwen_params)
    from vlm_clip_tpu_torch.vlm.qwen_model import qwen25vl_3b
    from vlm_clip_tpu_torch.vlm.qwen_process import (build_prompt_ids,
                                                     prepare_vision_inputs)

    mesh = None
    if tp > 1 or dp > 1:
        from vlm_clip_tpu_torch.parallel.distributed import (maybe_initialize,
                                                             world_size)
        from vlm_clip_tpu_torch.parallel.mesh import MeshConfig, create_mesh

        if dp > 1 and slots % dp:
            raise SystemExit(
                f"--slots {slots} is not divisible by --dp {dp}; each "
                f"data replica owns an equal slot shard — adjust --slots "
                f"(e.g. {slots - slots % dp or dp}) or --dp")
        need = tp * dp
        maybe_initialize(device="cuda" if str(device).startswith("cuda")
                         else "cpu")
        if world_size() != need:
            raise SystemExit(
                f"--tp {tp} --dp {dp} needs {need} devices, found "
                f"{world_size()} ranks; start one process a device under "
                f"a launcher (torchrun --nproc-per-node {need} -m "
                f"vlm_clip_tpu_torch.cli.serve_vlm ...)")
        mesh = create_mesh(MeshConfig(data=dp, model=tp),
                           "cuda" if str(device).startswith("cuda")
                           else "cpu")
    cfg = qwen25vl_3b()
    if weights:
        from vlm_clip_tpu_torch.vlm.qwen import (QwenBPETokenizer,
                                                 load_safetensors_dir,
                                                 quantize_preset)
        from vlm_clip_tpu_torch.vlm.qwen_convert import convert_qwen_vl
        from vlm_clip_tpu_torch.vlm.sampling import load_generation_config

        params = convert_qwen_vl(load_safetensors_dir(weights), cfg,
                                 device=device)
        params["vision"] = fold_qwen_patch_normalization(
            params["vision"], cfg.vision)
        params, cfg = quantize_preset(params, cfg, quant_bits)
        tokenizer = QwenBPETokenizer(os.path.join(weights,
                                                  "tokenizer.json"))
        if sampling is None:
            sampling = load_generation_config(weights, cfg.eos_token_id)
        mode = f"qwen2.5-vl ({quant_bits})"
    elif allow_synth:
        from vlm_clip_tpu_torch.cli.bench_decode import \
            synth_quantized_text_params
        from vlm_clip_tpu_torch.cli.bench_vision import synth_vision_params

        cfg = _dc.replace(cfg, text=_dc.replace(
            cfg.text, tie_word_embeddings=False))
        vision = fold_qwen_patch_normalization(
            synth_vision_params(cfg.vision, device=device), cfg.vision)
        params = {"text": synth_quantized_text_params(
                      cfg.text, 8, 4, fused=True, device=device),
                  "vision": quantize_qwen_params({"vision": vision},
                                                 8)["vision"]}
        tokenizer = None
        mode = "SYNTH-WEIGHTS (hermetic drive)"
    else:
        raise SystemExit(
            "refusing to serve without weights: pass --weights DIR "
            "(safetensors + tokenizer.json) or --allow-synth-weights "
            "for a hermetic drive")

    gen = QwenVLGenerator(params, cfg, max_len=max_len, kv_bits=kv_bits)
    gen.u8_patches = True
    engine = ContinuousBatchingEngine(gen, n_slots=slots,
                                      sync_steps=sync_steps,
                                      sampling=sampling,
                                      refill_chunks=refill_chunks,
                                      spec_k=spec_k, mesh=mesh)

    rng = np.random.default_rng(0)
    synth_tail = rng.integers(1, 10000, 24).tolist()

    def prep_fn(img, prompt_text):
        """Host arrays only: the engine's thread moves them to the
        device."""
        vin = prepare_vision_inputs(np.asarray(img.convert("RGB")),
                                    cfg.vision,
                                    fixed_resolution=resolution,
                                    raw_uint8=True)
        if tokenizer is not None:
            ids = build_prompt_ids(tokenizer, prompt_text or VLM_PROMPT,
                                   vin.num_vision_tokens, cfg)
        else:  # synth mode: a fixed pseudo-prompt (one layout)
            ids = np.asarray(
                [11, 22, cfg.vision_start_token_id]
                + [cfg.image_token_id] * vin.num_vision_tokens
                + synth_tail, np.int64)
        return ids, vin

    return engine, prep_fn, tokenizer, mode


def build_server(argv=None) -> ThreadingHTTPServer:
    """Build the engine and bind the HTTP server (not yet serving). The
    server carries ``worker``. Under ``--tp``/``--dp`` only rank 0 binds
    one; another rank gets a :class:`_Follower`, whose ``serve_forever``
    replays rank 0's rounds until rank 0's worker stops."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8898)
    p.add_argument("--weights", default=None,
                   help="Qwen2.5-VL dir (safetensors + tokenizer.json)")
    p.add_argument("--allow-synth-weights", action="store_true",
                   help="hermetic drive: 3B random weights, token-id "
                        "responses (the server refuses otherwise)")
    p.add_argument("--slots", type=int, default=32)
    p.add_argument("--sync-steps", type=int, default=16)
    p.add_argument("--max-len", type=int, default=768)
    p.add_argument("--max-new", type=int, default=200)
    p.add_argument("--kv-bits", type=int, default=16, choices=(8, 16))
    p.add_argument("--bits", default="8h4",
                   choices=("4", "8", "8h4", "mixed"))
    p.add_argument("--size", type=int, default=448)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: shard the VLM weights "
                        "over a 'model' axis of this many ranks (one "
                        "process a device under a launcher)")
    p.add_argument("--dp", type=int, default=1,
                   help="slot-shard degree: shard the engine's slot state "
                        "and KV cache over a 'data' axis; composes with "
                        "--tp on a (data, model) mesh of tp x dp ranks")
    p.add_argument("--spec-k", type=int, default=0,
                   help="n-gram speculative decoding over the prompt + "
                        "history window (lossless: token-identical under "
                        "greedy, distribution-identical when sampling)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from vlm_clip_tpu_torch.cli.common import resolve_device

    bits = args.bits if args.bits in ("mixed", "8h4") else int(args.bits)
    engine, prep_fn, tokenizer, mode = build_engine(
        args.weights, args.allow_synth_weights, quant_bits=bits,
        kv_bits=args.kv_bits, max_len=args.max_len, slots=args.slots,
        sync_steps=args.sync_steps, resolution=args.size,
        spec_k=args.spec_k, tp=args.tp, dp=args.dp,
        device=resolve_device(args.device))
    group = None
    if args.tp * args.dp > 1:
        import torch.distributed as dist

        group = dist.group.WORLD
    worker = EngineWorker(engine, group)
    if not worker.leader:
        return _Follower(worker)
    worker.start()
    srv = ThreadingHTTPServer((args.host, args.port),
                              make_vlm_handler(worker, prep_fn, tokenizer,
                                               args.max_new, mode))
    srv.worker = worker
    print(f"serving VLM generation on {args.host}:{srv.server_address[1]} "
          f"({engine.device}) — mode: {mode}, {args.slots} slots, "
          f"kv{args.kv_bits}"
          + (f", tp={args.tp}" if args.tp > 1 else "")
          + (f", dp={args.dp}" if args.dp > 1 else "")
          + (f", spec_k={args.spec_k}" if args.spec_k else ""), flush=True)
    return srv


class _Follower:
    """What :func:`build_server` returns on a rank other than 0: its
    ``serve_forever`` runs the worker's follower loop."""

    def __init__(self, worker: EngineWorker):
        self.worker = worker

    def serve_forever(self) -> None:
        self.worker.follow()


def main(argv=None) -> None:
    build_server(argv).serve_forever()


if __name__ == "__main__":
    main()
