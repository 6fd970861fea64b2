"""vlm_clip_tpu_torch.cli.serve_vlm over HTTP on a tiny engine (the model
of tests/test_engine.py, the JAX package's random init bridged to the
port, fp32 on the CPU), against JAX generate_from_ids: the reference's
cases (tests/test_serve_vlm.py), and the port's two differences from the
reference: a request whose wait times out is cancelled, and a cancel
that arrives before the request reaches the engine is honoured.
"""

import http.client
import io
import json
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from _torch_port import port_vision
from test_engine import IMG_TOK, VIS_START
from test_torch_engine import Ref
from vlm_clip_tpu.vlm import qwen_process as RP
from vlm_clip_tpu_torch.cli import serve_vlm as S
from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine


def _prep_fn(cfg):
    """The reference test's prep: a 32x32 image (64 patches, 16 vision
    tokens) and a fixed prompt; the reference's VisionInputs, so the JAX
    generation sees exactly the same arrays."""

    def prep(img, prompt_text):
        vin = RP.prepare_vision_inputs(np.asarray(img.convert("RGB")),
                                       cfg.vision, fixed_resolution=32)
        ids = np.asarray([1, 2, VIS_START] + [IMG_TOK] * vin.num_vision_tokens
                         + [3, 4, 5], np.int64)
        return ids, vin

    return prep


def _serve(ref, timeout=300.0, start=True):
    engine = ContinuousBatchingEngine(ref.pgen(), n_slots=2, sync_steps=3,
                                      refill_chunks=(2, 1))
    prep = _prep_fn(ref.cfg)

    def port_prep(img, prompt_text):
        ids, vin = prep(img, prompt_text)
        return ids, port_vision(vin)

    worker = S.EngineWorker(engine)
    if start:
        worker.start()
    srv = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        S.make_vlm_handler(worker, port_prep, None, 5, "tiny-synth",
                           timeout=timeout))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, worker, prep


@pytest.fixture(scope="module")
def ref():
    return Ref()


@pytest.fixture(scope="module")
def server(ref):
    srv, worker, prep = _serve(ref)
    yield srv, worker, prep
    srv.shutdown()
    worker.stop()


def _img(seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)
                    ).save(buf, format="PNG")
    return buf.getvalue()


def _post(srv, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                      timeout=300)
    conn.request("POST", path, body=body)
    r = conn.getresponse()
    out = json.loads(r.read())
    conn.close()
    return r.status, out


def _healthz(srv):
    c = http.client.HTTPConnection("127.0.0.1", srv.server_port, timeout=30)
    c.request("GET", "/healthz")
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    return r.status, out


def _want(ref, prep, body, m):
    from PIL import Image

    ids, vin = prep(Image.open(io.BytesIO(body)), None)
    return ref.want(ids, vin, m)


def _wait_cancelled(srv, n=1):
    deadline = time.time() + 60
    while time.time() < deadline:
        out = _healthz(srv)[1]
        if out["total_cancelled"] >= n:
            return out
        time.sleep(0.05)
    raise AssertionError(f"no cancel seen: {out}")


def test_healthz(server):
    srv, _, _ = server
    status, out = _healthz(srv)
    assert status == 200 and out["status"] == "ok"
    assert out["slots"] == 2 and out["mode"] == "tiny-synth"


def test_generate_matches_oneshot(server, ref):
    srv, _, prep = server
    body = _img(0)
    status, out = _post(srv, "/generate?max_new=5", body)
    assert status == 200, out
    assert out["tokens"] == _want(ref, prep, body, 5)
    assert out["text"] is None  # no tokenizer in synth mode


def test_concurrent_generate(server, ref):
    """8 concurrent clients over 2 slots: each gets its own one-shot
    tokens."""
    srv, _, prep = server
    bodies = [_img(s) for s in range(8)]
    results = [None] * 8

    def hit(i):
        results[i] = _post(srv, "/generate?max_new=4", bodies[i])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (status, out) in enumerate(results):
        assert status == 200, out
        assert out["tokens"] == _want(ref, prep, bodies[i], 4), i


def test_bad_image_400(server):
    srv, _, _ = server
    status, out = _post(srv, "/generate", b"not an image")
    assert status == 400 and "bad image" in out["error"]


def test_build_engine_refusals():
    """No weights without the synth flag; --tp/--dp without a launcher of
    tp x dp ranks, or with slots that --dp does not divide, refuse with
    the reference's texts (tests/test_torch_model_parallel.py serves
    --tp 2 on two ranks)."""
    with pytest.raises(SystemExit, match="refusing"):
        S.build_engine(None, allow_synth=False, device="cpu")
    for kw in ({"tp": 2}, {"dp": 2}):
        with pytest.raises(SystemExit, match="needs 2 devices"):
            S.build_engine(None, allow_synth=True, device="cpu", **kw)
    with pytest.raises(SystemExit, match="not divisible by --dp 2"):
        S.build_engine(None, allow_synth=True, device="cpu", dp=2, slots=3)
    for flag in ("--tp", "--dp"):
        with pytest.raises(SystemExit, match="needs 2 devices"):
            S.build_server(["--allow-synth-weights", "--device", "cpu",
                            flag, "2"])


def _sse(srv, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                      timeout=300)
    conn.request("POST", path, body=body)
    r = conn.getresponse()
    assert r.status == 200
    assert r.getheader("Content-Type") == "text/event-stream"
    raw = r.read().decode()  # Connection: close framing: read to EOF
    conn.close()
    return [json.loads(line[len("data: "):])
            for line in raw.splitlines() if line.startswith("data: ")]


def test_streaming_generate(server, ref):
    """``stream=1``: token deltas per harvested chunk, then a done event;
    the deltas concatenate to the done event's tokens and the one-shot
    generation's; the 7-token budget arrives in at least 2 deltas."""
    srv, _, prep = server
    body = _img(3)
    events = _sse(srv, "/generate?max_new=7&stream=1", body)
    assert events and events[-1].get("done") is True
    deltas = [e["tokens"] for e in events[:-1]]
    assert len(deltas) >= 2, deltas
    got = [t for d in deltas for t in d]
    assert got == events[-1]["tokens"] == _want(ref, prep, body, 7)


def test_stream_client_disconnect_cancels(server, ref):
    """A streaming client that drops mid-generation frees its slot
    (total_cancelled grows) and the engine serves the next request
    exactly."""
    srv, _, prep = server
    before = _healthz(srv)[1]["total_cancelled"]
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                      timeout=300)
    conn.request("POST", "/generate?max_new=60&stream=1", body=_img(9))
    r = conn.getresponse()
    assert r.status == 200
    r.read(16)   # a little, then drop the connection (r.close() closes
    r.close()    # the socket; conn.close() alone keeps the fd open)
    conn.close()
    out = _wait_cancelled(srv, before + 1)
    assert out["pending"] == 0
    body2 = _img(10)
    status, out = _post(srv, "/generate?max_new=4", body2)
    assert status == 200, out
    assert out["tokens"] == _want(ref, prep, body2, 4)


def test_timeout_cancels_the_request(ref):
    """A wait that times out cancels its request (the reference leaves it
    decoding), streamed or not: the client gets the timeout and the
    worker counts the cancel; the engine drains."""
    srv, worker, _ = _serve(ref, timeout=1e-3)
    try:
        events = _sse(srv, "/generate?max_new=40&stream=1", _img(11))
        assert events[-1] == {"done": True, "error": "generation timed out"}
        _wait_cancelled(srv, 1)
        status, out = _post(srv, "/generate?max_new=40", _img(12))
        assert status == 500 and "timed out" in out["error"]
        _wait_cancelled(srv, 2)
        deadline = time.time() + 60
        while worker.engine.pending and time.time() < deadline:
            time.sleep(0.05)
        assert worker.engine.pending == 0
    finally:
        srv.shutdown()
        worker.stop()


def test_cancel_before_install_is_honoured(ref):
    """A job cancelled while it waits for the worker never reaches the
    engine (the reference's worker would decode it anyway)."""
    srv, worker, prep = _serve(ref, start=False)
    try:
        from PIL import Image

        ids, vin = prep(Image.open(io.BytesIO(_img(13))), None)
        job = S._Job(ids, port_vision(vin), 6, stream=True)
        worker.q.put(job)
        worker.cancel(job)
        worker.start()
        assert job.event.wait(30)
        assert job.error == "cancelled" and job.stream_q.get() is None
        assert worker.total_cancelled == 1 and worker.total_requests == 0
        assert worker.engine._next_id == 0  # never submitted
        body = _img(14)
        status, out = _post(srv, "/generate?max_new=4", body)
        assert status == 200 and out["tokens"] == _want(ref, prep, body, 4)
    finally:
        srv.shutdown()
        worker.stop()


def test_worker_stop_ends_the_thread_and_fails_its_jobs(ref):
    """stop() ends the worker's thread after its round, so the engine can
    be dropped; a job it had not finished fails with "stopped" instead of
    waiting out its timeout."""
    srv, worker, prep = _serve(ref, start=False)
    srv.shutdown()
    from PIL import Image

    ids, vin = prep(Image.open(io.BytesIO(_img(15))), None)
    job = S._Job(ids, port_vision(vin), 60)
    worker.q.put(job)
    worker.start()
    worker.stop()
    assert not worker._thread.is_alive()
    assert job.event.is_set() and job.error == "stopped"
