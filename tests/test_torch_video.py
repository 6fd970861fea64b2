"""The port's video pipeline (data/video.py) against the JAX package's on
a small cv2-written AVI and bridged tiny-config weights (CPU).

- extract_frames and process_video: the same cv2 calls on both sides,
  so exactly equal (process_video's float32 arithmetic is the same
  numpy expression);
- score_video_frames and score_video_frames_raw (FP32): per-frame
  probabilities within 1e-4, the tolerance the reference's own
  tests/test_emotic_video.py holds its raw scorer to its host-resize
  path with (fp32 through the resize, the tower and a softmax of
  100 x cosine);
- the sharded scorer's refusals (its runs across ranks:
  tests/test_torch_model_parallel.py).
"""

import numpy as np
import pytest
import torch

import jax

from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.data import video as RV
from vlm_clip_tpu.models import clip as RC
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.data import video as V

from _torch_port import port_clip_config, to_torch
from helpers import tiny_clip_config

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def avi(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("video") / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    assert w.isOpened()
    rng = np.random.default_rng(4)
    for _ in range(20):
        w.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    w.release()
    return path


@pytest.fixture(scope="module")
def model():
    cfg = tiny_clip_config()
    params = RC.init_clip(jax.random.PRNGKey(2), cfg)
    emb = np.random.default_rng(5).normal(size=(7, cfg.projection_dim))
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return cfg, port_clip_config(cfg), params, to_torch(params), emb


def test_extract_and_process_match_reference(avi):
    got = V.extract_frames(avi, frame_limit=16, size=32)
    assert got.shape == (16, 32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, RV.extract_frames(avi, 16, 32))
    for stats in ("imagenet", "clip"):
        out = V.process_video(avi, frame_limit=8, size=32, stats=stats)
        assert out.shape == (3, 8, 32, 32)  # [C,T,H,W]
        np.testing.assert_array_equal(
            out, RV.process_video(avi, frame_limit=8, size=32, stats=stats))
    assert not np.allclose(V.process_video(avi, 8, 32, "imagenet"),
                           V.process_video(avi, 8, 32, "clip"))
    with pytest.raises(ValueError, match="no frames"):
        V.extract_frames(avi + ".missing")


def test_score_video_frames_matches_reference(avi, model):
    cfg, pcfg, params, pparams, emb = model
    frames = V.extract_frames(avi, 16, cfg.vision.image_size)
    for stats in ("clip", "imagenet"):
        got = V.score_video_frames(pparams, pcfg, frames, emb, policy=FP32,
                                   stats=stats)
        want = RV.score_video_frames(params, cfg, frames, emb, policy=RFP32,
                                     stats=stats)
        assert got.shape == (16, 7)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_score_video_frames_raw_matches_reference(avi, model):
    """Native-resolution frames (48x64, non-square: the shortest-edge
    resize and center crop run on the device) against the reference's
    fused path, and at the target size against score_video_frames (the
    resize is then an identity)."""
    from vlm_clip_tpu_torch.cli.bench_video import demux

    cfg, pcfg, params, pparams, emb = model
    size = cfg.vision.image_size
    native = demux(avi, 6)
    assert native.shape == (6, 48, 64, 3)
    for stats in ("imagenet", "clip"):
        got = V.score_video_frames_raw(pparams, pcfg, native, emb,
                                       policy=FP32, stats=stats, size=size)
        want = RV.score_video_frames_raw(params, cfg, native, emb,
                                         policy=RFP32, stats=stats,
                                         size=size)
        assert got.shape == (6, 7)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    exact = np.random.default_rng(7).integers(0, 255, (6, size, size, 3),
                                              dtype=np.uint8)
    got = V.score_video_frames_raw(pparams, pcfg, exact, emb, policy=FP32,
                                   stats="clip", size=size)
    ref = V.score_video_frames(pparams, pcfg, exact, emb, policy=FP32,
                               stats="clip")
    np.testing.assert_allclose(got, ref, **TOL)
    # one cached scorer per (cfg, policy, stats, size)
    assert V._raw_frame_scorer(pcfg, FP32, "clip", size) is \
        V._raw_frame_scorer(pcfg, FP32, "clip", size)


def test_sharded_scorer_raises(model):
    """What the sharded scorer refuses before any collective (it runs
    across ranks in tests/test_torch_model_parallel.py): a mesh that is
    not a DeviceMesh, one without a 'seq' axis, and frames that do not
    divide over the axis."""
    _, pcfg, _, pparams, emb = model
    frames = np.zeros((3, 32, 32, 3), np.uint8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        V.score_video_frames_sharded(pparams, pcfg, frames, emb,
                                     mesh=object())

    class Mesh:
        def __init__(self, names):
            self.mesh_dim_names = names

        def get_local_rank(self, axis):
            return 0

        def size(self, dim):
            return 2

    with pytest.raises(ValueError, match="no 'seq' axis"):
        V.score_video_frames_sharded(pparams, pcfg, frames, emb,
                                     mesh=Mesh(("data", "model")))
    with pytest.raises(ValueError, match="do not divide"):
        V.score_video_frames_sharded(pparams, pcfg, frames, emb,
                                     mesh=Mesh(("data", "model", "seq")))
    assert torch.is_tensor(pparams["logit_scale"])
