"""The port's uint8 folded-normalization tower (models/clip.py
fold_image_normalization, patchify_hwc, vision_tower_u8,
get_image_features_u8) against the JAX package's on bridged weights,
and against the port's own normalize-then-tower path (tiny config,
CPU).

Tolerances: features atol 2e-4, rtol 1e-4, as the reference's own
tests/test_u8_path.py holds its folded path to its fp path; the folded
kernel 1e-6 relative (one fp32 division), the folded bias 2e-5 absolute
(a sum of P*P*3 = 768 fp32 terms of up to ~15, in another order); the
patch layouts exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.core.dtypes import BF16 as RBF16, FP32 as RFP32
from vlm_clip_tpu.models import clip as RC
from vlm_clip_tpu_torch.core.dtypes import BF16, FP32
from vlm_clip_tpu_torch.data.preprocess import normalize_batch
from vlm_clip_tpu_torch.models import clip as C

from _torch_port import port_clip_config, to_torch
from helpers import tiny_clip_config

TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_clip_config()
    params = RC.init_clip(jax.random.PRNGKey(0), cfg)
    u8 = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3),
                                           dtype=np.uint8)
    return cfg, port_clip_config(cfg), params, to_torch(params), u8


def _folded(params, fold):
    out = dict(params)
    out["vision"] = fold(params["vision"])
    return out


def test_fold_matches_reference(setup):
    _, _, params, pparams, _ = setup
    for stats in ((None, None), ((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))):
        want = RC.fold_image_normalization(params["vision"], *stats)
        got = C.fold_image_normalization(pparams["vision"], *stats)
        for k, atol in (("kernel", 1e-7), ("bias", 2e-5)):
            np.testing.assert_allclose(
                got["patch_embedding"][k].numpy(),
                np.asarray(want["patch_embedding"][k]), rtol=1e-6,
                atol=atol)
        assert got["layers"] is pparams["vision"]["layers"]


def test_u8_features_match_reference(setup):
    """get_image_features_u8 against the JAX one (FP32), and against the
    port's normalize -> tower path."""
    cfg, pcfg, params, pparams, u8 = setup
    want = RC.get_image_features_u8(
        _folded(params, RC.fold_image_normalization), jnp.asarray(u8), cfg,
        RFP32)
    folded = _folded(pparams, C.fold_image_normalization)
    got = C.get_image_features_u8(folded, torch.from_numpy(u8), pcfg, FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = C.get_image_features(pparams, normalize_batch(
        torch.from_numpy(u8)), pcfg, FP32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_u8_tower_bf16_matches_reference(setup):
    """Under BF16 the patch product takes bf16 operands and accumulates
    in fp32 on both sides: the pooled outputs agree to bf16 rounding."""
    cfg, pcfg, params, pparams, u8 = setup
    want = RC.vision_tower_u8(
        RC.fold_image_normalization(params["vision"]), jnp.asarray(u8),
        cfg.vision, RBF16)
    got = C.vision_tower_u8(C.fold_image_normalization(pparams["vision"]),
                            torch.from_numpy(u8), pcfg.vision, BF16)
    assert got.pooled.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.pooled.float().numpy(),
        np.asarray(want.pooled.astype(jnp.float32)), atol=5e-2, rtol=5e-2)


def test_patchify_hwc_matches_patchify(setup):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    a = C.patchify_hwc(torch.from_numpy(img), 16)
    b = C.patchify(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()), 16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = RC.patchify_hwc(jnp.asarray(img), 16)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref))
    u8 = setup[4]
    np.testing.assert_array_equal(
        C.patchify_hwc(torch.from_numpy(u8), 8).numpy(),
        np.asarray(RC.patchify_hwc(jnp.asarray(u8), 8)))


def test_u8_tower_refuses_other_sizes(setup):
    _, pcfg, _, pparams, _ = setup
    folded = C.fold_image_normalization(pparams["vision"])
    with pytest.raises(ValueError, match="image_size"):
        C.vision_tower_u8(folded, torch.zeros(1, 48, 48, 3,
                                              dtype=torch.uint8),
                          dataclasses.replace(pcfg.vision), FP32)
