"""vlm_clip_tpu_torch.ops.nf4 against vlm_clip_tpu.ops.nf4: the quantizer,
the dequantizer, both matmul routes, the bridge, and the NF4 preset of a
tiny Qwen2.5-VL generating token for token with the reference's.

Tolerances, with their reasons:
- ``qweight`` bit for bit: the block absmax is a max (exact), the
  division by it and the 15 midpoint compares are exact IEEE fp32
  operations on both sides;
- ``dq_offset`` is a float32 mean, which XLA and torch sum in different
  orders, so it may differ in its last bits (1e-6 relative). Through
  ``centered = absmax - offset`` that moves each second-level value by a
  few ulps, so ``absmax_q`` entries may differ by 1, and only where the
  reference's ``centered / dq_scale`` lies within 1e-4 of a rounding
  boundary (x.5): the test counts those candidates and allows no other
  entry to differ (none when the two offsets are equal);
- the dequantized weight within 1e-6 of the largest |w|;
- matmuls 1e-5 of the largest |y| (fp32 products in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.ops import nf4 as R
from vlm_clip_tpu.vlm import qwen_convert as RC
from vlm_clip_tpu.vlm import qwen_model as RM
from vlm_clip_tpu.vlm.qwen import QwenVLGenerator as RGen
from vlm_clip_tpu_torch.bridge import tree_to_numpy, tree_to_torch
from vlm_clip_tpu_torch.ops import nf4 as P
from vlm_clip_tpu_torch.ops import quant as PQ
from vlm_clip_tpu_torch.vlm import qwen_convert as PC
from vlm_clip_tpu_torch.vlm import qwen_model as PM
from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator as PGen

from _torch_port import tiny_qwen

# the reference's quantizer, traced once a shape (eagerly each of its ops
# would dispatch on its own)
_r_quantize = jax.jit(R.quantize_nf4, static_argnames="block")


def _weight(seed, shape, zero_block=None):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    w *= 0.05
    if zero_block is not None:
        w[..., :zero_block, :3] = 0.0  # an all-zero block in 3 columns
    return w


def _assert_quantized_equal(got: P.NF4Linear, want, w: np.ndarray):
    """got against the reference's quantization ``want`` of w ([in, out]
    or stacked [L, in, out])."""
    want = jax.tree.map(np.asarray, want)
    np.testing.assert_array_equal(got.qweight.numpy(), want.qweight)
    assert got.qweight.dtype == torch.uint8
    assert got.absmax_q.dtype == torch.int8
    assert (got.in_features, got.out_features, got.block) == \
        (want.in_features, want.out_features, want.block)
    np.testing.assert_allclose(got.dq_offset.numpy(), want.dq_offset,
                               rtol=1e-6)
    np.testing.assert_allclose(got.dq_scale.numpy(), want.dq_scale,
                               rtol=1e-6)
    # absmax_q: an entry may differ, by 1, only where the reference's
    # (absmax - offset) / scale lies within 1e-4 of x.5
    diff = got.absmax_q.numpy().astype(np.int32) - want.absmax_q
    assert np.abs(diff).max(initial=0) <= 1
    K, N = w.shape[-2:]
    pad = (-K) % want.block
    wp = np.pad(w, [(0, 0)] * (w.ndim - 2) + [(0, pad), (0, 0)])
    absmax = np.abs(wp.reshape(*w.shape[:-2], -1, want.block, N)).max(-2)
    flat = absmax.reshape(*w.shape[:-2], -1)
    scale = np.repeat(want.dq_scale, P.NF4_DQ_GROUP,
                      axis=-1)[..., :flat.shape[-1]]
    v = (flat - np.asarray(want.dq_offset)[..., None]) / scale
    near = np.abs(np.abs(v - np.trunc(v)) - 0.5) < 1e-4
    moved = diff.reshape(flat.shape) != 0
    assert not (moved & ~near).any()
    same = (got.dq_offset.numpy() == want.dq_offset).reshape(
        *w.shape[:-2], 1)
    assert not (moved & same).any()


@pytest.mark.parametrize("K,N,block,zero", [(65, 40, 64, 64),
                                            (300, 77, 32, 32),
                                            (2048, 300, 64, None),
                                            (130, 50, 64, 64)])
def test_quantize_nf4_matches_reference(K, N, block, zero):
    """Padding (odd in), blocks of 64 and 32, an all-zero block."""
    w = _weight(K, (K, N), zero)
    got = P.quantize_nf4(torch.from_numpy(w), block=block)
    want = _r_quantize(jnp.asarray(w), block=block)
    _assert_quantized_equal(got, want, w)
    np.testing.assert_allclose(P.dequantize_nf4(got).numpy(),
                               np.asarray(R.dequantize_nf4(want)),
                               atol=1e-6 * np.abs(w).max(), rtol=0)


def test_quantize_nf4_stacked_matches_reference_vmap():
    w = _weight(3, (3, 130, 50), 64)
    bias = np.ones((3, 50), np.float32)
    got = P.quantize_nf4_stacked(torch.from_numpy(w), torch.ones(3, 50))
    want = jax.jit(jax.vmap(R.quantize_nf4))(jnp.asarray(w))
    assert got.dq_offset.shape == (3,) and got.qweight.shape == (3, 96, 50)
    _assert_quantized_equal(got, want, w)
    np.testing.assert_array_equal(got.bias.numpy(), bias)
    one = got.map(lambda t: t[1])
    np.testing.assert_allclose(
        P.dequantize_nf4(one).numpy(),
        np.asarray(R.dequantize_nf4(jax.tree.map(lambda a: a[1], want))),
        atol=1e-6 * np.abs(w).max(), rtol=0)


def test_nf4_refuses_odd_block():
    with pytest.raises(ValueError, match="even"):
        P.quantize_nf4(torch.zeros(8, 4), block=7)


@pytest.mark.parametrize("M", [1, 8, 4097])
@pytest.mark.parametrize("bias", [False, True])
def test_nf4_matmul_matches_reference(M, bias):
    """M <= 4096 takes the row-pair route, 4097 the materialized weight
    (fp32 on the CPU, as in the reference off its accelerator)."""
    K, N = 300, 77
    w = _weight(1, (K, N))
    b = np.random.default_rng(2).normal(size=N).astype(np.float32) \
        if bias else None
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    want_q = _r_quantize(jnp.asarray(w),
                         None if b is None else jnp.asarray(b))
    got_q = P.quantize_nf4(torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b))
    want = np.asarray(R.nf4_matmul(jnp.asarray(x), want_q))
    got = P.nf4_matmul(torch.from_numpy(x), got_q)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)
    # a leading batch shape and another output dtype
    got3 = P.nf4_matmul(torch.from_numpy(x[None, :1]), got_q,
                        out_dtype=torch.bfloat16)
    assert got3.shape == (1, 1, N) and got3.dtype == torch.bfloat16


def test_bridge_carries_nf4_both_ways():
    w = _weight(5, (130, 50), 64)
    want = R.quantize_nf4(jnp.asarray(w), jnp.ones(50))
    got = tree_to_torch({"lin": jax.tree.map(np.asarray, want)})["lin"]
    assert isinstance(got, P.NF4Linear)
    assert (got.in_features, got.out_features, got.block) == (130, 50, 64)
    assert got.qweight.dtype == torch.uint8
    assert got.absmax_q.dtype == torch.int8
    np.testing.assert_array_equal(got.qweight.numpy(),
                                  np.asarray(want.qweight))
    back = tree_to_numpy({"lin": got})["lin"]
    assert isinstance(back, P.NF4Linear)
    for f in ("qweight", "absmax_q", "dq_scale", "dq_offset", "bias"):
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(want, f)), f)


def test_nf4_rms_error_below_int4():
    """The reference's case for the preset: on gaussian weights NF4 loses
    less than the symmetric int4 quantizer at the same bit width."""
    w = torch.from_numpy(_weight(9, (512, 256)))
    nf4 = P.dequantize_nf4(P.quantize_nf4(w))
    int4 = PQ.dequantize_weight(PQ.quantize_weight(w, 4))[:512, :256]
    rms = [float(((a - w) ** 2).mean().sqrt()) for a in (nf4, int4)]
    assert rms[0] < rms[1], rms


@pytest.fixture(scope="module")
def tiny_nf4():
    cfg, pcfg, jp, pp = tiny_qwen(7)
    untie = dict(tie_word_embeddings=False)
    rcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             **untie))
    prcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text,
                                                               **untie))
    rq = jax.jit(lambda p: RC.quantize_qwen_params(
        p, "nf4", head_bits="nf4", fuse_decode=True))(jp)
    pq = PC.quantize_qwen_params(pp, "nf4", head_bits="nf4",
                                 fuse_decode=True)
    return rcfg, prcfg, rq, pq


def test_tiny_qwen_nf4_preset_matches_reference(tiny_nf4):
    """Every linear (the vision tower's and the untied head too) is NF4,
    stacked layers quantized one at a time; first logits within 1e-4,
    greedy tokens equal."""
    rcfg, prcfg, rq, pq = tiny_nf4
    for node in (pq["text"]["layers"]["attn"]["qkv"],
                 pq["text"]["layers"]["mlp"]["gateup"],
                 pq["vision"]["blocks"]["mlp"]["down"],
                 pq["text"]["lm_head"]):
        assert isinstance(node, P.NF4Linear)
    np.testing.assert_array_equal(
        pq["text"]["layers"]["mlp"]["gateup"].qweight.numpy(),
        np.asarray(rq["text"]["layers"]["mlp"]["gateup"].qweight))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 200, (2, 9))
    emb = np.asarray(rq["text"]["embed_tokens"])[ids]
    pos = np.broadcast_to(np.arange(9), (3, 2, 9))
    mask = np.where(np.arange(9)[None] <= np.arange(9)[:, None], 0.0,
                    np.finfo(np.float32).min).astype(np.float32)[None, None]
    want, _ = RM.text_forward(rq["text"], jnp.asarray(emb),
                              jnp.asarray(pos), rcfg.text,
                              jnp.asarray(mask))
    got, _ = PM.text_forward(pq["text"], torch.from_numpy(emb),
                             torch.from_numpy(np.ascontiguousarray(pos)),
                             prcfg.text, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_tiny_qwen_nf4_generation_matches_reference(tiny_nf4):
    from test_torch_qwen import IDS, _patches, _vins

    rcfg, prcfg, rq, pq = tiny_nf4
    rv, pv = _vins(_patches(6))
    want = RGen(rq, rcfg, max_len=64, dtype=jnp.float32).generate_from_ids(
        IDS, rv, max_new_tokens=6)
    got = PGen(pq, prcfg, max_len=64, dtype=torch.float32
               ).generate_from_ids(IDS, pv, max_new_tokens=6)
    assert got == want and len(got) == 6, (got, want)
