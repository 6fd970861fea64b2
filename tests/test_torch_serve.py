"""The port's serving endpoint against the reference's: /embed,
/embed_text (pipeline-M adapters and plain CLIP) and zero-shot /classify
on the same tiny weights, plus the HTTP surface and the refusals.

Tolerances: features 1e-4 (unit-norm, fp32 towers + adapters, see
test_torch_model_m.py); probabilities 1e-4 (softmax of 100x cosine, so a
1e-6 cosine difference moves a logit by 1e-4).
"""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.cli import serve as RS
from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.data.tokenizer import HashTokenizer as RHash
from vlm_clip_tpu.models.clip import init_clip
from vlm_clip_tpu.models.model_m import CLIPWithAdapters as RCLIPWithAdapters
from vlm_clip_tpu_torch.cli import serve as S
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.data.tokenizer import HashTokenizer
from vlm_clip_tpu_torch.ops import fused_adapter as F

from _torch_port import jpeg_bytes, port_clip_config, to_torch
from helpers import tiny_clip_config

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference embedder, port embedder, ref backbone, port backbone)
    on the same weights and the same M adapter checkpoint."""
    cfg = tiny_clip_config()
    params = init_clip(jax.random.PRNGKey(0), cfg)
    ref_bb = (params, cfg, RHash(cfg.text.vocab_size))
    port_bb = (to_torch(params), port_clip_config(cfg),
               HashTokenizer(cfg.text.vocab_size))
    ckpt = str(tmp_path_factory.mktemp("m") / "m_adapters.pt")
    RCLIPWithAdapters(params, cfg, policy=RFP32, text_adapter_size=8,
                      vision_adapter_size=8, shared_adapter_layers=2,
                      seed=3).save_adapter_weights(ckpt)
    ref = RS.Embedder(*ref_bb, m_adapter_ckpt=ckpt, policy=RFP32)
    port = S.Embedder(*port_bb, m_adapter_ckpt=ckpt, policy=FP32)
    return ref, port, ref_bb, port_bb


TEXTS = ["a happy face", "a person expressing anger with narrowed eyes"]


@pytest.mark.parametrize("seed", [0, 1])
def test_embed_m_adapter_matches_reference(pair, seed):
    ref, port, _, _ = pair
    assert port.mode == ref.mode == "m-adapter"
    body = jpeg_bytes(seed, (40 + 8 * seed, 36))
    got = port.embed_image_bytes(body)
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref.embed_image_bytes(body), atol=ATOL)
    got = port.embed_text(TEXTS[seed])
    np.testing.assert_allclose(got, ref.embed_text(TEXTS[seed]), atol=ATOL)


def test_embed_plain_clip_matches_reference(pair):
    _, _, ref_bb, port_bb = pair
    ref = RS.Embedder(*ref_bb, policy=RFP32)
    port = S.Embedder(*port_bb, policy=FP32)
    assert port.mode == ref.mode == "clip"
    body = jpeg_bytes(4)
    np.testing.assert_allclose(port.embed_image_bytes(body),
                               ref.embed_image_bytes(body), atol=ATOL)
    np.testing.assert_allclose(port.embed_text(TEXTS[0]),
                               ref.embed_text(TEXTS[0]), atol=ATOL)


def test_zero_shot_predict_matches_reference(pair):
    _, _, ref_bb, port_bb = pair
    ref_fn, ref_mode, _ = RS.build_predict_fn("tiny", backbone=ref_bb,
                                              policy=RFP32, max_batch=4)
    got_fn, mode, _ = S.build_predict_fn("tiny", backbone=port_bb,
                                         policy=FP32, max_batch=4)
    assert mode == ref_mode == "zero-shot"
    S_ = ref_bb[1].vision.image_size
    u8 = np.random.default_rng(0).integers(0, 255, (4, S_, S_, 3), np.uint8)
    got = got_fn(u8)
    assert got.shape == (4, 7)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref_fn(u8)), atol=ATOL)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read().decode()))
    conn.close()
    return out


def test_http_routes_match_reference(pair):
    """/embed, /embed_text and /classify served over HTTP by the port
    equal the reference's computation on the same inputs."""
    ref, port_emb, ref_bb, port_bb = pair
    predict_fn, _, cfg = S.build_predict_fn("tiny", backbone=port_bb,
                                            policy=FP32, max_batch=4)
    ref_fn, _, _ = RS.build_predict_fn("tiny", backbone=ref_bb,
                                       policy=RFP32, max_batch=4)
    classifier = S.BatchingClassifier(predict_fn, cfg.vision.image_size,
                                      max_batch=4, window_ms=5.0)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), S.make_handler(
        classifier, "tiny", embedder=port_emb))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        status, health = _request(port, "GET", "/healthz")
        assert status == 200 and health["status"] == "ok"
        body = jpeg_bytes(7)
        status, out = _request(port, "POST", "/embed", body)
        assert status == 200 and out["dim"] == cfg.projection_dim
        np.testing.assert_allclose(out["features"],
                                   ref.embed_image_bytes(body), atol=ATOL)
        status, o1 = _request(port, "POST", "/embed_text", b"a happy face")
        status2, o2 = _request(port, "POST", "/embed_text", json.dumps(
            {"text": "a happy face"}).encode())
        assert status == status2 == 200
        np.testing.assert_allclose(o1["features"], o2["features"], atol=0)
        np.testing.assert_allclose(o1["features"],
                                   ref.embed_text("a happy face"), atol=ATOL)
        status, result = _request(port, "POST", "/classify", body)
        assert status == 200 and set(result) == {"probs", "label",
                                                 "confidence"}
        from PIL import Image
        import io

        from vlm_clip_tpu.data.preprocess import load_and_resize
        u8 = np.zeros((4, cfg.vision.image_size, cfg.vision.image_size, 3),
                      np.uint8)
        u8[0] = load_and_resize(Image.open(io.BytesIO(body)),
                                cfg.vision.image_size)
        want = np.asarray(ref_fn(u8))[0]
        np.testing.assert_allclose(list(result["probs"].values()), want,
                                   atol=ATOL)
        assert _request(port, "POST", "/classify", b"notanimage")[0] == 400
        assert _request(port, "POST", "/embed", b"")[0] == 400
        assert _request(port, "GET", "/nope")[0] == 404
    finally:
        srv.shutdown()


def test_build_server_end_to_end_on_cpu(tmp_path):
    """main()'s path at a real preset on the CPU: flags -> random
    backbone -> M adapters from a reference-format file -> HTTP. On CPU
    tensors the adapters take the plain versions and launch nothing."""
    from vlm_clip_tpu_torch.core.config import AdapterConfig, clip_preset
    from vlm_clip_tpu_torch.models.model_m import init_m_adapters
    from vlm_clip_tpu_torch.train.checkpoint import save_adapter_weights

    ckpt = str(tmp_path / "m.pt")
    save_adapter_weights(ckpt, init_m_adapters(
        torch.Generator().manual_seed(0), clip_preset("vit-base-patch32"),
        AdapterConfig(text_adapter_size=16, vision_adapter_size=16,
                      shared_adapter_layers=1), device="cpu"))
    F.reset_launch_counts()
    srv = S.build_server(["--port", "0", "--device", "cpu", "--max-batch",
                          "2", "--allow-random-weights",
                          "--allow-hash-tokenizer", "--m-adapter-ckpt",
                          ckpt])
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        assert srv.mode == "zero-shot+embed[m-adapter]"
        status, out = _request(port, "POST", "/embed", jpeg_bytes(1))
        assert status == 200 and out["dim"] == 512
        # served under the bf16 policy: unit norm up to bf16 rounding
        np.testing.assert_allclose(np.linalg.norm(out["features"]), 1.0,
                                   atol=2 ** -8)
        status, out = _request(port, "POST", "/embed_text", b"a sad face")
        assert status == 200 and np.isfinite(out["features"]).all()
        status, out = _request(port, "POST", "/classify", jpeg_bytes(2))
        assert status == 200
        np.testing.assert_allclose(sum(out["probs"].values()), 1.0,
                                   atol=1e-5)
    finally:
        srv.shutdown()
        srv.server_close()
    assert set(F.launch_counts().values()) == {0}


def test_serve_refusals(tmp_path, monkeypatch):
    """No random weights without --allow-random-weights, whatever the
    mode (pipeline T's --adapter-ckpt and pipeline V's --v-adapter-ckpt
    are served: see test_torch_pipeline_t.py, test_torch_pipeline_v.py);
    an absent CUDA device is an error, not a CPU run."""
    with pytest.raises(RuntimeError, match="random"):
        S.build_server(["--port", "0", "--device", "cpu",
                        "--hf-checkpoint", str(tmp_path)])
    with pytest.raises(RuntimeError, match="random"):
        S.build_server(["--port", "0", "--device", "cpu",
                        "--v-adapter-ckpt", "x.pt"])
    with pytest.raises(RuntimeError, match="random"):
        S.build_server(["--port", "0", "--device", "cpu",
                        "--adapter-ckpt", "x.pt"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.build_server(["--port", "0", "--allow-random-weights"])
