"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (marker ``cuda``; they skip without one). This file imports
neither jax nor vlm_clip_tpu, so on a machine without jax it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances (elementwise ``atol + rtol*|want|``): fp32 1e-4 (summation
order only); bf16 2e-2 (both sides round the same operands to bf16, so a
rounding flip from summation order is all that separates them). Gradients
are held to the same numbers relative to their largest element: weight
gradients sum over every row, so an elementwise bound would be set by
cancellation, not by the kernel.
"""

import dataclasses

import pytest
import torch

from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.models import adapters as A
from vlm_clip_tpu_torch.models import layers as L
from vlm_clip_tpu_torch.ops import attention as K5
from vlm_clip_tpu_torch.ops import contrastive as K4
from vlm_clip_tpu_torch.ops import decode_attention as K8
from vlm_clip_tpu_torch.ops import fused_adapter as F
from vlm_clip_tpu_torch.ops import nf4 as N
from vlm_clip_tpu_torch.ops import quant as K7

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


# 77 and 250 rows: a ragged last 32-row tile; widths that are not
# multiples of 128 (K = 64, H = 200 with K = 100: ragged last chunks);
# the train step's B=96 text and vision rows (7392 at 512, 18912 at 768)
# and one served image's (197 at 768)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,k", [(77, 512, 256), (250, 768, 128),
                                   (77, 512, 64), (40, 200, 100),
                                   (7392, 512, 256), (18912, 768, 256),
                                   (197, 768, 256)])
def test_seq_adapter_kernel(dev, dtype, n, h, k):
    p = A.init_seq_adapter(_gen(dev), h, k, device=dev)
    p["down"]["bias"].normal_(generator=_gen(dev, 1))
    x = torch.randn(n, h, generator=_gen(dev, 2), device=dev).to(dtype)
    args = (p["down"]["kernel"], p["down"]["bias"], p["up"]["kernel"],
            p["up"]["bias"], p["ln"]["scale"], p["ln"]["bias"])
    with torch.no_grad():
        _close(F.seq_adapter_fused(x, *args), F.seq_adapter_torch(x, *args),
               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,tk", [(77, 197), (40, 5)])
def test_cross_modal_adapter_kernels(dev, dtype, n, tk):
    """K2 then K3 through the adapter, kernel path vs plain path."""
    p = A.init_cross_modal_adapter(_gen(dev), text_dim=512, image_dim=768,
                                   hidden=512, device=dev)
    text = torch.randn(2, n, 512, generator=_gen(dev, 3),
                       device=dev).to(dtype)
    image = (torch.randn(1, tk, 768, generator=_gen(dev, 4), device=dev)
             * 768 ** -0.5).to(dtype)
    F.reset_launch_counts()
    with torch.no_grad():
        got = A.cross_modal_adapter(p, text, image, 8, impl="kernel")
        want = A.cross_modal_adapter(p, text, image, 8, impl="torch")
    assert F.launch_counts() == {
        "seq_adapter_fused": 0, "cross_attn_block_fused": 1,
        "prenorm_mlp_fused": 1, "seq_adapter_bwd_cuda": 0,
        "cross_attn_block_bwd_cuda": 0, "prenorm_mlp_bwd_cuda": 0,
        "feature_adapter_blend_fused": 0,
        "feature_adapter_blend_bwd_cuda": 0}
    _close(got, want, dtype)


def _cab_args(p, k, v):
    ap = p["attn"]
    return (p["text_proj"]["kernel"], p["text_proj"]["bias"],
            p["norm2"]["scale"], p["norm2"]["bias"], ap["q"]["kernel"],
            ap["q"]["bias"], k, v, ap["out"]["kernel"], ap["out"]["bias"])


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_do(dev):
    """Each wrapper refuses on the card only what its kernels cannot take:
    shapes that do not match x, K2 past 256 shared rows (its gate, where
    impl="auto" routes to the plain version as the reference does),
    tensors on two devices or of two dtypes; never a width the
    reference's kernel takes (bf16 K3 at widths that are not multiples of
    8 and bf16 K2 at heads of other than a multiple of 8 columns run
    their CUDA-core kernels, forward and backward)."""
    p = A.init_seq_adapter(_gen(dev), 512, 256, device=dev)
    args = (p["down"]["kernel"], p["down"]["bias"], p["up"]["kernel"],
            p["up"]["bias"], p["ln"]["scale"], p["ln"]["bias"])
    with pytest.raises(ValueError, match="wrong shapes"):
        F.seq_adapter_fused(torch.randn(8, 500, device=dev), *args)
    m = A.init_mlp_gelu(_gen(dev), 512, device=dev)
    mlp = [t.bfloat16().requires_grad_(True) for t in (
        m["fc1"]["kernel"][:, :1998], m["fc1"]["bias"][:1998],
        m["fc2"]["kernel"][:1998], m["fc2"]["bias"],
        torch.ones(512, device=dev), torch.zeros(512, device=dev))]
    F.reset_launch_counts()
    F.prenorm_mlp_fused(torch.randn(8, 512, device=dev).bfloat16(),
                        *mlp).float().sum().backward()  # K = 1998
    assert F.launch_counts()["prenorm_mlp_fused"] == 1
    assert F.launch_counts()["prenorm_mlp_bwd_cuda"] == 1
    c = A.init_cross_modal_adapter(_gen(dev), text_dim=512, image_dim=64,
                                   hidden=512, device=dev)
    assert not F.cross_attn_block_supported(257)
    k, v = A.shared_kv(c, torch.randn(1, 257, 64, device=dev))
    with pytest.raises(ValueError, match="Tk <= 256"):
        F.cross_attn_block_fused(torch.randn(8, 512, device=dev),
                                 *_cab_args(c, k, v), 8)
    c = A.init_cross_modal_adapter(_gen(dev), text_dim=264, image_dim=64,
                                   hidden=264, device=dev)
    k, v = A.shared_kv(c, torch.randn(1, 5, 64, device=dev).bfloat16())
    cab = [t.bfloat16().requires_grad_(True) for t in _cab_args(c, k, v)]
    F.cross_attn_block_fused(torch.randn(8, 264, device=dev).bfloat16(),
                             *cab, 8).float().sum().backward()  # heads of 33
    assert F.launch_counts()["cross_attn_block_bwd_cuda"] == 1
    with pytest.raises(ValueError, match="must be on"):
        F.seq_adapter_fused(torch.randn(8, 512, device=dev),
                            *(a.cpu() for a in args))
    with pytest.raises(TypeError, match="share a dtype"):
        K4.contrastive_loss_fused(torch.randn(4, 8, device=dev),
                                  torch.randn(4, 8, device=dev).bfloat16(),
                                  torch.tensor(0.0, device=dev))


def _grads_close(got, want, dtype, what, zero=()):
    """Each gradient within tol * max|want| of it (at least tol * 1e-2);
    the gradients at the indices in ``zero`` are zero in exact
    arithmetic, so both sides are rounding noise there, held within tol
    of the largest gradient of all."""
    tol = TOL[dtype]
    top = max(float(w.float().abs().max()) for w in want if w is not None)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, (what, i)
            continue
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        if i in zero:
            assert max(float(g.float().abs().max()),
                       float(w.float().abs().max())) <= tol * top, (what, i)
            continue
        scale = max(float(w.float().abs().max()), 1e-2)
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * scale, (what, i, err, scale)


def _seq_case(dev, n, h, k, dtype):
    p = A.init_seq_adapter(_gen(dev), h, k, device=dev)
    p["down"]["bias"].normal_(generator=_gen(dev, 1))
    x = torch.randn(n, h, generator=_gen(dev, 2), device=dev).to(dtype)
    return x, (p["down"]["kernel"], p["down"]["bias"], p["up"]["kernel"],
               p["up"]["bias"], p["ln"]["scale"], p["ln"]["bias"])


def _k1_grads_close(got, want, dtype, what):
    """K1's function is fp32 in both dtypes: dW1, db1, dW2, db2, dls and
    dlb within the fp32 tolerance (1e-4 of each one's largest element),
    dx (when asked) within its dtype's."""
    if want[0] is None:
        assert got[0] is None, what
    else:
        _grads_close(got[:1], want[:1], dtype, what)
    _grads_close(got[1:], want[1:], torch.float32, what)


# 77 and 250 rows: a ragged last row tile; the vision width; no dx; the
# train step's B=96 shapes, text [7392, 512] with dx and vision [18912,
# 768] without; widths that are not multiples of 128 (and 100, which the
# tensor-core passes take: a multiple of 4)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,k,need_dx", [(77, 512, 256, True),
                                           (250, 768, 256, False),
                                           (77, 512, 64, True),
                                           (40, 200, 100, True),
                                           (7392, 512, 256, True),
                                           (18912, 768, 256, False)])
def test_seq_adapter_bwd_kernel(dev, dtype, n, h, k, need_dx):
    x, args = _seq_case(dev, n, h, k, dtype)
    g = torch.randn(n, h, generator=_gen(dev, 3), device=dev).to(dtype)
    F.reset_launch_counts()
    got = F.seq_adapter_bwd_cuda(x, *args, g, need_dx=need_dx)
    want = F.seq_adapter_bwd_torch(x, *args, g, need_dx=need_dx)
    assert F.launch_counts()["seq_adapter_bwd_cuda"] == 1
    _k1_grads_close(got, want, dtype, "seq_adapter")


# weights w = 0.5 + 0.01 u (scaled by the fan-in): a large common part
# that the LayerNorm's backward cancels magnifies each product's
# rounding, so a single TF32 pass would miss the fp32 tolerance by 100x
# or more (tests/test_torch_fused_adapter shows it by emulation); the
# compensated products hold it. Also a width
# the tensor-core passes do not take (h = 100, not a multiple of 8: a
# bf16 row is not whole 16-byte chunks), which the CUDA-core row pass
# runs.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,k", [(250, 768, 256), (7392, 512, 256),
                                   (77, 100, 64)])
def test_seq_adapter_bwd_kernel_offset_weights(dev, dtype, n, h, k):
    x, args = _seq_case(dev, n, h, k, dtype)
    gen = _gen(dev, 9)
    w1 = (0.5 + 0.01 * torch.randn(h, k, generator=gen, device=dev)) \
        * h ** -0.5
    w2 = (0.5 + 0.01 * torch.randn(k, h, generator=gen, device=dev)) \
        * k ** -0.5
    args = (w1, args[1], w2) + args[3:]
    g = torch.randn(n, h, generator=_gen(dev, 3), device=dev).to(dtype)
    assert F.seq_adapter_tensor_cores(h, k) == (h % 8 == 0)
    got = F.seq_adapter_bwd_cuda(x, *args, g)
    want = F.seq_adapter_bwd_torch(x, *args, g)
    _k1_grads_close(got, want, dtype, "seq_adapter offset")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,need_dx", [(18912, 768, True),
                                         (18912, 768, False),
                                         (7392, 512, True)])
def test_seq_adapter_bwd_repeats_bit_for_bit(dev, dtype, n, h, need_dx):
    """No atomics: two calls on the same inputs give the same bits, at
    the B=96 vision and text shapes (ordered row chunks in both weight
    gradients), with and without dx as the train step asks."""
    x, args = _seq_case(dev, n, h, 256, dtype)
    g = torch.randn(n, h, generator=_gen(dev, 3), device=dev).to(dtype)
    first = F.seq_adapter_bwd_cuda(x, *args, g, need_dx=need_dx)
    second = F.seq_adapter_bwd_cuda(x, *args, g, need_dx=need_dx)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


def _pnmlp_case(dev, n, dtype, h=512):
    p = A.init_mlp_gelu(_gen(dev), h, device=dev)
    p["fc1"]["bias"].normal_(generator=_gen(dev, 7)).mul_(0.1)
    x = torch.randn(n, h, generator=_gen(dev, 3), device=dev).to(dtype)
    ls = 1 + 0.1 * torch.randn(h, generator=_gen(dev, 4), device=dev)
    lb = 0.1 * torch.randn(h, generator=_gen(dev, 5), device=dev)
    args = (p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
            p["fc2"]["bias"], ls, lb)
    g = torch.randn(n, h, generator=_gen(dev, 6), device=dev).to(dtype)
    return x, args, g


# 77 rows (one text row of a batch), 200 (a ragged last 128-row tile of
# the bf16 products and 32-row tile of its LN pass), 7392 (the train
# step's B=96 text rows); without dx as well
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,need_dx", [(77, True), (200, True),
                                       (7392, True), (200, False)])
def test_prenorm_mlp_bwd_kernel(dev, dtype, n, need_dx):
    x, args, g = _pnmlp_case(dev, n, dtype)
    F.reset_launch_counts()
    got = F.prenorm_mlp_bwd_cuda(x, *args, g, need_dx=need_dx)
    assert F.launch_counts()["prenorm_mlp_bwd_cuda"] == 1
    _grads_close(got, F.prenorm_mlp_bwd_torch(x, *args, g, need_dx=need_dx),
                 dtype, "prenorm_mlp")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_prenorm_mlp_bwd_repeats_bit_for_bit(dev, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    x, args, g = _pnmlp_case(dev, 7392, dtype)
    first = F.prenorm_mlp_bwd_cuda(x, *args, g)
    second = F.prenorm_mlp_bwd_cuda(x, *args, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# BASELINE config 5, pipeline M at ViT-L/14-336 and B=32: K1 on the text
# rows [32*77, 768] (dx asked, as the shared layers' input needs) and the
# vision rows [32*577, 1024] (no dx: frozen towers), K3 at H = 768,
# 4H = 3072 on the text rows; forward and backward
C5_TEXT, C5_VISION = 32 * 77, 32 * 577


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,need_dx", [(C5_TEXT, 768, True),
                                         (C5_VISION, 1024, False)])
def test_seq_adapter_kernels_config5(dev, dtype, n, h, need_dx):
    x, args = _seq_case(dev, n, h, 256, dtype)
    g = torch.randn(n, h, generator=_gen(dev, 3), device=dev).to(dtype)
    F.reset_launch_counts()
    with torch.no_grad():
        _close(F.seq_adapter_fused(x, *args), F.seq_adapter_torch(x, *args),
               dtype)
    got = F.seq_adapter_bwd_cuda(x, *args, g, need_dx=need_dx)
    assert F.launch_counts()["seq_adapter_fused"] == 1
    assert F.launch_counts()["seq_adapter_bwd_cuda"] == 1
    _k1_grads_close(got, F.seq_adapter_bwd_torch(x, *args, g,
                                                 need_dx=need_dx),
                    dtype, f"seq_adapter config 5 [{n}, {h}]")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_prenorm_mlp_kernels_config5(dev, dtype):
    x, args, g = _pnmlp_case(dev, C5_TEXT, dtype, h=768)
    assert args[0].shape == (768, 3072)
    F.reset_launch_counts()
    with torch.no_grad():
        _close(F.prenorm_mlp_fused(x, *args), F.prenorm_mlp_torch(x, *args),
               dtype)
    got = F.prenorm_mlp_bwd_cuda(x, *args, g)
    assert F.launch_counts()["prenorm_mlp_fused"] == 1
    assert F.launch_counts()["prenorm_mlp_bwd_cuda"] == 1
    _grads_close(got, F.prenorm_mlp_bwd_torch(x, *args, g), dtype,
                 "prenorm_mlp config 5")


@pytest.mark.cuda
def test_native_loader_builds_into_build_dir(dev, tmp_path):
    """Where libjpeg's header is installed, the C++ batch decoder builds
    with g++ into build/ at first use and decodes close to PIL (the
    reference's bilinear-against-bicubic bound: mean |diff| < 30)."""
    import os

    import numpy as np
    from PIL import Image

    from vlm_clip_tpu_torch.data import native_loader as N
    from vlm_clip_tpu_torch.data.preprocess import load_and_resize
    from vlm_clip_tpu_torch.ops.build import BUILD_DIR

    if not any(os.path.isfile(os.path.join(d, "jpeglib.h")) for d in
               ("/usr/include", "/usr/local/include",
                "/usr/include/x86_64-linux-gnu")):
        pytest.skip("no jpeglib.h: the loader falls back to PIL "
                    f"({N.unavailable_reason()})")
    assert N.native_available(), N.unavailable_reason()
    assert os.path.dirname(N.library_path()) == BUILD_DIR
    assert os.path.isfile(N.library_path())
    rng = np.random.default_rng(0)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)
                    ).resize((448, 448)).save(path, quality=90)
    out, ok = N.load_batch_native([path, str(tmp_path / "missing.jpg")], 336)
    assert list(ok) == [True, False] and out[1].sum() == 0
    diff = np.abs(out[0].astype(int) - load_and_resize(path, 336).astype(int))
    assert diff.mean() < 30, diff.mean()


# the weight-gradient products alone: bf16 x bf16 on the tensor cores,
# whole operands and K2's per-head slices of its keys padded to 8 (Tk =
# 197 -> 200, 5 -> 8), against fp32 matmuls of the same bf16 values
@pytest.mark.cuda
@pytest.mark.parametrize("n,p,q,z,width", [(7392, 512, 2048, 1, None),
                                           (300, 136, 72, 1, None),
                                           (700, 200, 64, 8, 200),
                                           (50, 8, 64, 8, 8)])
def test_wgrad_tensor_cores(dev, n, p, q, z, width):
    gen = _gen(dev, 11)
    sa = width or 0
    a = torch.randn(n, z * p if width else p, generator=gen,
                    device=dev).bfloat16()
    b = torch.randn(n, z * q, generator=gen, device=dev).bfloat16()
    out = torch.zeros(p, z * q, device=dev) if z > 1 else \
        torch.zeros(p, q, device=dev)
    F._wgrad(a, b, out, p, q, sa=sa, sb=q if z > 1 else 0,
             so=q if z > 1 else 0, z=z)
    want = torch.cat([a.float()[:, i * p:(i + 1) * p].T
                      @ b.float()[:, i * q:(i + 1) * q] for i in range(z)],
                     dim=1) if z > 1 else a.float().T @ b.float()
    # fp32 sums of up to 7392 products of bf16 values near 1, in another
    # order than the matmul: about sqrt(n) ulps of sums near sqrt(n)
    torch.testing.assert_close(out, want, atol=5e-3, rtol=1e-4)


@pytest.mark.cuda
def test_wgrad_tensor_cores_refuses_unaligned(dev):
    """The tensor-core weight gradient copies 16 bytes at a time, so it
    refuses a per-head slice 197 wide: F._bf16_tc_route (and vct_wgrad in
    C) sends it to the CUDA cores, which read nothing past its end and
    give the same sums as fp32 matmuls of the bf16 values."""
    gen = _gen(dev, 12)
    a = torch.randn(64, 8 * 197, generator=gen, device=dev).bfloat16()
    b = torch.randn(64, 8 * 64, generator=gen, device=dev).bfloat16()
    out = torch.zeros(197, 8 * 64, device=dev)
    assert not F._bf16_tc_route(a, b, 197, 64, 8 * 197, 197, 8 * 64, 64)
    F._wgrad(a, b, out, 197, 64, sa=197, sb=64, so=64, z=8)
    want = torch.cat([a.float()[:, i * 197:(i + 1) * 197].T
                      @ b.float()[:, i * 64:(i + 1) * 64] for i in range(8)],
                     dim=1)
    torch.testing.assert_close(out, want, atol=5e-3, rtol=1e-4)
    names = _device_kernels(
        lambda: F._wgrad(a, b, out, 197, 64, sa=197, sb=64, so=64, z=8))
    assert names and not any("mma" in nm for nm in names), names


def _cab_bwd_case(dev, n, tk, dtype, din=512):
    p = A.init_cross_modal_adapter(_gen(dev), text_dim=din, image_dim=768,
                                   hidden=512, device=dev)
    image = (torch.randn(1, tk, 768, generator=_gen(dev, 4), device=dev)
             * 768 ** -0.5).to(dtype)
    k, v = A.shared_kv(p, image)
    x = torch.randn(n, din, generator=_gen(dev, 3), device=dev).to(dtype)
    g = torch.randn(n, 512, generator=_gen(dev, 5), device=dev).to(dtype)
    return x, _cab_args(p, k, v), g


# rows: one served text (77), 1, a ragged last 128-row tile (200) and the
# train step's B=96 text rows (7392); shared K/V rows: 1, 5 and 197 (not
# multiples of 16: a ragged last key group, padded per head to 8), 256
# (the most the kernel takes); without dx as well
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 77, 200, 7392])
@pytest.mark.parametrize("tk", [1, 5, 197, 256])
def test_cross_attn_block_bwd_kernel(dev, dtype, n, tk):
    x, args, g = _cab_bwd_case(dev, n, tk, dtype)
    F.reset_launch_counts()
    got = F.cross_attn_block_bwd_cuda(x, *args, g, 8)
    assert F.launch_counts()["cross_attn_block_bwd_cuda"] == 1
    want = F.cross_attn_block_bwd_torch(x, *args, g, 8)
    _grads_close(got, want, dtype, "cross_attn_block")
    if n == 200:
        nodx = F.cross_attn_block_bwd_cuda(x, *args, g, 8, need_dx=False)
        assert nodx[0] is None
        for a, b in zip(nodx[1:], got[1:]):
            assert torch.equal(a, b)


# a text width other than the hidden: 40 (a depth and a dx width that
# end inside one 64-wide tile), 36 (bf16: zero-padded to 40) and 768
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("din", [40, 36, 768])
def test_cross_attn_block_bwd_kernel_text_width(dev, dtype, din):
    x, args, g = _cab_bwd_case(dev, 300, 197, dtype, din)
    _grads_close(F.cross_attn_block_bwd_cuda(x, *args, g, 8),
                 F.cross_attn_block_bwd_torch(x, *args, g, 8), dtype,
                 "cross_attn_block")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attn_block_bwd_repeats_bit_for_bit(dev, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    x, args, g = _cab_bwd_case(dev, 7392, 197, dtype)
    first = F.cross_attn_block_bwd_cuda(x, *args, g, 8)
    second = F.cross_attn_block_bwd_cuda(x, *args, g, 8)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K3 forward: one row (/embed), one served text (77), a ragged last
# 128-row tile (600) and the train step's text rows (7392)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 77, 600, 7392])
def test_prenorm_mlp_fwd_kernel(dev, dtype, n):
    x, args, _ = _pnmlp_case(dev, n, dtype)
    F.reset_launch_counts()
    with torch.no_grad():
        got = F.prenorm_mlp_fused(x, *args)
    assert F.launch_counts()["prenorm_mlp_fused"] == 1
    _close(got, F.prenorm_mlp_torch(x, *args), dtype)


@pytest.mark.cuda
def test_cross_modal_adapter_routes_vit_l_widths(dev):
    """ViT-L/14's cross-modal adapter (H = 768, 8 heads of 96, Tk = 257):
    under impl="auto" K2 takes its plain version (its predicate fails)
    and K3 its kernel, forward and backward; impl="kernel" raises."""
    p = A.init_cross_modal_adapter(_gen(dev), text_dim=768, image_dim=1024,
                                   hidden=768, device=dev)
    text = torch.randn(2, 77, 768, generator=_gen(dev, 3),
                       device=dev).bfloat16()
    image = (torch.randn(1, 257, 1024, generator=_gen(dev, 4), device=dev)
             * 1024 ** -0.5).bfloat16()
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    F.reset_launch_counts()
    y = A.cross_modal_adapter(p, text, image, 8)
    (y.float() ** 2).sum().backward()
    counts = F.launch_counts()
    assert counts["cross_attn_block_fused"] == 0
    assert counts["cross_attn_block_bwd_cuda"] == 0
    assert counts["prenorm_mlp_fused"] == 1
    assert counts["prenorm_mlp_bwd_cuda"] == 1
    assert torch.isfinite(y.float()).all()
    with torch.no_grad():
        want = A.cross_modal_adapter(p, text, image, 8, impl="torch")
        _close(A.cross_modal_adapter(p, text, image, 8), want,
               torch.bfloat16)
        with pytest.raises(ValueError, match="Tk <= 256"):
            A.cross_modal_adapter(p, text, image, 8, impl="kernel")


# K2 at heads other than 64 wide, forward and backward: ViT-L/14's 8
# heads of 96 over H = 768 (bf16: the attention pass zero-padded to 128;
# fp32 forward in 16-row tiles, backward in 8-row tiles), 4 heads of 24
# over 96 and 2 heads of 128 over 256; Tk 197 and 5; and heads the bf16
# tensor-core passes do not take, which bf16 runs on the CUDA-core
# kernels in both directions: 8 heads of 25 over 200, 2 of 192 over 384;
# each of the three again at 616 rows (8 captions of 77)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,heads,tk,n", [(768, 8, 197, 300),
                                          (768, 8, 5, 77),
                                          (96, 4, 197, 200),
                                          (256, 2, 197, 200),
                                          (200, 8, 197, 200),
                                          (384, 2, 197, 77),
                                          (768, 8, 197, 616),
                                          (200, 8, 197, 616),
                                          (384, 2, 197, 616)])
def test_cross_attn_block_kernels_other_head_widths(dev, dtype, h, heads,
                                                    tk, n):
    p = A.init_cross_modal_adapter(_gen(dev), text_dim=h, image_dim=256,
                                   hidden=h, device=dev)
    image = (torch.randn(1, tk, 256, generator=_gen(dev, 4), device=dev)
             * 256 ** -0.5).to(dtype)
    k, v = A.shared_kv(p, image)
    args = _cab_args(p, k, v)
    x = torch.randn(n, h, generator=_gen(dev, 3), device=dev).to(dtype)
    g = torch.randn(n, h, generator=_gen(dev, 5), device=dev).to(dtype)
    F.reset_launch_counts()
    with torch.no_grad():
        y = F.cross_attn_block_fused(x, *args, heads)
    got = F.cross_attn_block_bwd_cuda(x, *args, g, heads)
    assert F.launch_counts()["cross_attn_block_fused"] == 1
    assert F.launch_counts()["cross_attn_block_bwd_cuda"] == 1
    _close(y, F.cross_attn_block_torch(x, *args, heads), dtype)
    _grads_close(got, F.cross_attn_block_bwd_torch(x, *args, g, heads),
                 dtype, "cross_attn_block")


def _device_kernels(fn, expect: int = 1) -> list:
    """The names of the kernels fn launches on the card, one a launch
    (torch.profiler). The profiler has dropped the record of the first
    launch in a trace: one call's only kernel (an empty trace), and K6's
    backward cluster kernel with its colsum kept, three traces in a row.
    So fn runs once first, each trace opens with a launch of the spin
    kernel (``torch.cuda._sleep``), whose record is left out, and a trace
    with fewer than ``expect`` records of fn's (the launches the caller's
    assertion counts on) is taken again, up to three times; the caller's
    assertion then holds the last trace as strictly as ever."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name]
        if len(names) >= expect:
            break
    return names


# K1 forward: 77 and 250 rows (ragged 128-row tiles) at the text and
# vision widths on the TF32 tensor cores, with and without a large common
# offset in the weights (w = 0.5 + 0.01 u, scaled by the fan-in), widths
# that are not multiples of the 128 x 64 tiles (h 200, k 100: on the
# passes' gate), and a width off it (h 100), which the CUDA-core kernel
# takes. fp32 y within 1e-4 of the largest |y| (K1's function is fp32);
# bf16 y at the bf16 tolerance.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,k,offset", [(77, 512, 256, 0.0),
                                          (250, 768, 256, 0.0),
                                          (77, 512, 256, 0.5),
                                          (250, 768, 256, 0.5),
                                          (77, 200, 100, 0.0),
                                          (77, 100, 64, 0.0)])
def test_seq_adapter_fwd_tensor_cores(dev, dtype, n, h, k, offset):
    x, args = _seq_case(dev, n, h, k, dtype)
    if offset:
        gen = _gen(dev, 9)
        w1 = (offset + 0.01 * torch.randn(h, k, generator=gen, device=dev)) \
            * h ** -0.5
        w2 = (offset + 0.01 * torch.randn(k, h, generator=gen, device=dev)) \
            * k ** -0.5
        args = (w1, args[1], w2) + args[3:]
    F.reset_launch_counts()
    with torch.no_grad():
        got = F.seq_adapter_fused(x, *args)
        assert F.launch_counts()["seq_adapter_fused"] == 1
        want = F.seq_adapter_torch(x, *args)
        names = _device_kernels(lambda: F.seq_adapter_fused(x, *args),
                                3 if F.seq_adapter_tensor_cores(h, k)
                                else 1)
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err
    else:
        _close(got, want, dtype)
    tc = F.seq_adapter_tensor_cores(h, k)
    assert tc == (h != 100)
    for frag in ("seqfwd_pre", "seqfwd_z", "seqfwd_ln"):
        assert any(frag in nm for nm in names) == tc, (frag, names)
    assert any("seq_adapter_fwd_kernel" in nm for nm in names) != tc


# K2 forward: the train step's B=96 text rows (7392), one served text
# (77), Tk 5, ViT-L/14's 8 heads of 96 (bf16: zero-padded to 128 in the
# attention pass), and 8 heads of 100 (bf16: the CUDA-core kernel, whose
# width the tensor-core passes do not take), Din 36 (padded to 40)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,din,h,tk", [(7392, 512, 512, 197),
                                        (77, 512, 512, 197),
                                        (200, 512, 512, 5),
                                        (616, 768, 768, 197),
                                        (300, 800, 800, 197),
                                        (600, 36, 512, 197)])
def test_cross_attn_block_fwd_kernel(dev, dtype, n, din, h, tk):
    p = A.init_cross_modal_adapter(_gen(dev), text_dim=din, image_dim=256,
                                   hidden=h, device=dev)
    image = (torch.randn(1, tk, 256, generator=_gen(dev, 4), device=dev)
             * 256 ** -0.5).to(dtype)
    args = _cab_args(p, *A.shared_kv(p, image))
    x = torch.randn(n, din, generator=_gen(dev, 3), device=dev).to(dtype)
    F.reset_launch_counts()
    with torch.no_grad():
        got = F.cross_attn_block_fused(x, *args, 8)
        assert F.launch_counts()["cross_attn_block_fused"] == 1
        _close(got, F.cross_attn_block_torch(x, *args, 8), dtype)
        tc = dtype == torch.bfloat16 and \
            F.cross_attn_block_tensor_cores(h, 8)
        names = _device_kernels(lambda: F.cross_attn_block_fused(x, *args,
                                                                 8),
                                5 if tc else 1)
    assert tc == (dtype == torch.bfloat16 and h != 800)
    passes = ("cab_fwd_t_", "cab_fwd_ln", "cab_fwd_q_", "cab_fwd_attn",
              "cab_fwd_out")
    for frag in passes:
        assert any(frag in nm for nm in names) == tc, (frag, names)
    assert any("cross_attn_block_fwd_kernel" in nm for nm in names) != tc


# K3 at widths that are not multiples of 128 (bf16: multiples of 8 on the
# tensor cores; fp32 any), forward and backward; 300 rows, and 616 (8
# captions of 77) at H 100, K 400
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h,k,n", [(torch.bfloat16, 200, 800, 300),
                                         (torch.bfloat16, 64, 136, 300),
                                         (torch.bfloat16, 100, 390, 300),
                                         (torch.float32, 200, 800, 300),
                                         (torch.float32, 100, 390, 300),
                                         (torch.bfloat16, 100, 400, 616)])
def test_prenorm_mlp_kernels_other_widths(dev, dtype, h, k, n):
    gen = _gen(dev, 8)
    w1 = torch.randn(h, k, generator=gen, device=dev) * h ** -0.5
    w2 = torch.randn(k, h, generator=gen, device=dev) * k ** -0.5
    b1, b2, ls, lb = (0.1 * torch.randn(w, generator=gen, device=dev)
                      for w in (k, h, h, h))
    args = (w1, b1, w2, b2, 1 + ls, lb)
    x = torch.randn(n, h, generator=gen, device=dev).to(dtype)
    g = torch.randn(n, h, generator=gen, device=dev).to(dtype)
    F.reset_launch_counts()
    with torch.no_grad():
        y = F.prenorm_mlp_fused(x, *args)
    got = F.prenorm_mlp_bwd_cuda(x, *args, g)
    assert F.launch_counts()["prenorm_mlp_fused"] == 1
    assert F.launch_counts()["prenorm_mlp_bwd_cuda"] == 1
    _close(y, F.prenorm_mlp_torch(x, *args), dtype)
    _grads_close(got, F.prenorm_mlp_bwd_torch(x, *args, g), dtype,
                 "prenorm_mlp")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_through_the_kernels(dev, dtype):
    """The adapter's gradients with the kernels (autograd Functions) and
    with autograd of the plain versions, to every param and the text."""
    p = A.init_cross_modal_adapter(_gen(dev), text_dim=512, image_dim=768,
                                   hidden=512, device=dev)
    text = torch.randn(2, 77, 512, generator=_gen(dev, 3), device=dev)
    image = torch.randn(1, 197, 768, generator=_gen(dev, 4),
                        device=dev) * 768 ** -0.5
    leaves = tree_leaves(p)
    key_bias = 1 + next(i for i, t in enumerate(leaves)
                        if t is p["attn"]["k"]["bias"])
    grads = {}
    for impl in ("kernel", "torch"):
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        x = text.to(dtype).requires_grad_(True)
        y = A.cross_modal_adapter(p, x, image.to(dtype), 8, impl=impl)
        F.reset_launch_counts()
        (y.float() ** 2).sum().backward()
        if impl == "kernel":
            assert F.launch_counts()["cross_attn_block_bwd_cuda"] == 1
            assert F.launch_counts()["prenorm_mlp_bwd_cuda"] == 1
        grads[impl] = [x.grad] + [t.grad for t in leaves]
    # the softmax is invariant to the key bias: its gradient is zero
    _grads_close(grads["kernel"], grads["torch"], dtype, "adapter",
                 zero=(key_bias,))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [96, 1100])  # 1100: past the TPU's 1024
def test_contrastive_kernels(dev, dtype, b):
    t = torch.randn(b, 512, generator=_gen(dev, 1), device=dev).to(dtype)
    m = torch.randn(b, 512, generator=_gen(dev, 2), device=dev).to(dtype)
    ls = torch.tensor(2.6592, device=dev)
    K4.reset_launch_counts()
    leaves = [a.clone().requires_grad_(True) for a in (t, m, ls)]
    loss = K4.contrastive_loss_fused(*leaves)
    loss.backward()
    assert K4.launch_counts() == {"contrastive_loss_fused": 1,
                                  "contrastive_loss_bwd_cuda": 1}
    want = K4.contrastive_loss_torch(t, m, ls)
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=1e-5)
    _grads_close([a.grad for a in leaves],
                 K4.contrastive_loss_bwd_torch(t, m, ls,
                                               torch.ones((), device=dev)),
                 dtype, "contrastive")


# K4 backward: one cluster launch at B = 1, 7, 96 and the largest batch
# its blocks' shared memory takes at D = 512 (and no other kernel), the
# multi-kernel route at B = 1100; bit for bit on a repeat
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 7, 96, "max", 1100])
def test_contrastive_bwd_cluster_kernel(dev, dtype, b):
    b = K4.bwd_cluster_max(512) if b == "max" else b
    assert K4.bwd_cluster_max(512) == 128
    t = torch.randn(b, 512, generator=_gen(dev, 1), device=dev).to(dtype)
    m = torch.randn(b, 512, generator=_gen(dev, 2), device=dev).to(dtype)
    ls = torch.tensor(2.6592, device=dev)
    one = torch.ones((), device=dev)

    def call():
        return K4.contrastive_loss_bwd_cuda(t, m, ls, one)

    K4.reset_launch_counts()
    got = call()
    assert K4.launch_counts()["contrastive_loss_bwd_cuda"] == 1
    _grads_close(got, K4.contrastive_loss_bwd_torch(t, m, ls, one), dtype,
                 "contrastive bwd")
    again = call()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    names = _device_kernels(call, 1 if b <= 128 else 8)
    if b <= 128:
        assert len(names) == 1 and "contrastive_bwd_cluster_kernel" in \
            names[0], names
    else:
        assert len(names) == 8 and not any("cluster" in nm
                                           for nm in names), names


# K4 forward: one cluster launch at B = 1, 7, 96 and the cluster's largest
# batch at D = 512 (no other kernel), its row and column LSEs the bits
# the backward recomputes; the four-kernel route at B = 1100; at D = 24
# (five blocks own no columns); the loss bit for bit on a repeat and
# within 1e-5 of the plain version's
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,d", [(1, 512), (7, 512), (96, 512),
                                 ("max", 512), (1100, 512), (5, 24)])
def test_contrastive_fwd_cluster_kernel(dev, dtype, b, d):
    b = K4.bwd_cluster_max(d) if b == "max" else b
    t = torch.randn(b, d, generator=_gen(dev, 1), device=dev).to(dtype)
    m = torch.randn(b, d, generator=_gen(dev, 2), device=dev).to(dtype)
    ls = torch.tensor(2.6592, device=dev)

    def call():
        return K4.contrastive_loss_fused(t, m, ls)

    K4.reset_launch_counts()
    got = call()
    assert K4.launch_counts()["contrastive_loss_fused"] == 1
    torch.testing.assert_close(got, K4.contrastive_loss_torch(t, m, ls),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(got, call())
    names = _device_kernels(call, 1 if b <= K4.bwd_cluster_max(d) else 4)
    if b <= K4.bwd_cluster_max(d):
        assert len(names) == 1 and "contrastive_fwd_cluster_kernel" in \
            names[0], names
        fwd, bwd = (K4.cluster_lse(t, m, ls, backward)
                    for backward in (False, True))
        assert torch.isfinite(fwd).all() and torch.equal(fwd, bwd)
    else:
        assert len(names) == 4 and not any("cluster" in nm
                                           for nm in names), names


# K4 backward at D = 24: three blocks of the cluster own 8 columns each and
# five own none (they load nothing and still reach every cluster.sync())
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 5])
def test_contrastive_bwd_cluster_kernel_empty_slices(dev, dtype, b):
    t = torch.randn(b, 24, generator=_gen(dev, 1), device=dev).to(dtype)
    m = torch.randn(b, 24, generator=_gen(dev, 2), device=dev).to(dtype)
    ls = torch.tensor(2.6592, device=dev)
    one = torch.ones((), device=dev)
    K4.reset_launch_counts()
    got = K4.contrastive_loss_bwd_cuda(t, m, ls, one)
    assert K4.launch_counts()["contrastive_loss_bwd_cuda"] == 1
    _grads_close(got, K4.contrastive_loss_bwd_torch(t, m, ls, one), dtype,
                 "contrastive bwd")
    names = _device_kernels(
        lambda: K4.contrastive_loss_bwd_cuda(t, m, ls, one))
    assert len(names) == 1 and "contrastive_bwd_cluster_kernel" in \
        names[0], names


# ---------------------------------------------------------------------------
# K6: feature adapter blend (pipelines T and V)
# ---------------------------------------------------------------------------

def _feat_case(dev, n, d, k, dtype, seed=0):
    p = A.init_feature_adapter(_gen(dev, seed), d, k, device=dev)
    for leaf in (p["fc1"]["bias"], p["fc2"]["bias"]):
        leaf.normal_(generator=_gen(dev, seed + 1)).mul_(0.1)
    x = torch.randn(n, d, generator=_gen(dev, seed + 2), device=dev).to(dtype)
    return x, (p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
               p["fc2"]["bias"])


# the T path's rows (32 image features, 7 class means, 35 descriptions)
# and 600 rows with dropout, across the 256-row tiles the hash keys on
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,dropout", [(32, 0.0), (7, 0.0), (35, 0.0),
                                       (600, 0.1)])
def test_feature_adapter_kernels(dev, dtype, n, dropout):
    x, args = _feat_case(dev, n, 768, 64, dtype)
    g = torch.randn(n, 768, generator=_gen(dev, 9), device=dev).to(dtype)
    F.reset_launch_counts()
    with torch.no_grad():
        got = F.feature_adapter_blend_fused(x, *args, 0.2, dropout, 1234)
        want = F.feature_adapter_blend_torch(x, *args, 0.2, dropout, 1234)
    _close(got, want, dtype)
    gg = F.feature_adapter_blend_bwd_cuda(x, *args, 0.2, g, dropout, 1234)
    gw = F.feature_adapter_blend_bwd_torch(x, *args, 0.2, g, dropout, 1234)
    assert F.launch_counts(F.T_KERNELS) == {
        "feature_adapter_blend_fused": 1,
        "feature_adapter_blend_bwd_cuda": 1}
    _grads_close(gg, gw, dtype, "feature_adapter")


# EMOTIC's head (train/trainer_emotic.py): 32 l2-normed features at
# ViT-B/16's projection (512) and ViT-L/14's (768), bottleneck 192, fp32,
# no dropout; the backward as the trainer runs it (no dx: the frozen
# features need none) and with dx; one launch each way
@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("d", [512, 768])
def test_feature_adapter_kernels_at_emotic_shapes(dev, d, need_dx):
    x, args = _feat_case(dev, 32, d, 192, torch.float32)
    x = x / x.norm(dim=-1, keepdim=True)
    g = torch.randn(32, d, generator=_gen(dev, 9), device=dev)
    F.reset_launch_counts()
    with torch.no_grad():
        got = F.feature_adapter_blend_fused(x, *args, 0.2)
    _close(got, F.feature_adapter_blend_torch(x, *args, 0.2), torch.float32)
    gg = F.feature_adapter_blend_bwd_cuda(x, *args, 0.2, g,
                                          need_dx=need_dx)
    gw = F.feature_adapter_blend_bwd_torch(x, *args, 0.2, g,
                                           need_dx=need_dx)
    assert F.launch_counts(F.T_KERNELS) == {
        "feature_adapter_blend_fused": 1,
        "feature_adapter_blend_bwd_cuda": 1}
    _grads_close(gg, gw, torch.float32, "feature_adapter emotic")


# K6 backward, one cluster launch: the T path's rows (1, 7, 32, 35: one
# group; the weight slices in shared memory) and 600 rows with dropout
# (ten groups across the hash's 256-row tiles, then one colsum launch),
# with and without dx; 77 rows at d 1024, k 192 (two groups; slices too
# large for shared memory beside 64 rows, read in place) and d 100
# (ragged slices); d 4100, k 1100 at 20 and 35 rows (past the widths the
# wrapper once refused: groups of 16 rows, slices in place) and widths
# whose row buffers do not fit shared memory even at 8 rows (k 4000; d
# 30000), kept in the workspace, in one group and (100 rows at k 4001 or
# d 30001) in two, where the groups' partial gradients before the buffers
# hold a count of floats that is not a multiple of 4; bit for bit on a
# repeat; no weight-gradient, column-sum (within one group) or fill
# kernel
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("n,d,k,dropout", [(1, 768, 64, 0.0),
                                           (7, 768, 64, 0.0),
                                           (32, 768, 64, 0.0),
                                           (35, 768, 64, 0.0),
                                           (600, 768, 64, 0.1),
                                           (77, 1024, 192, 0.1),
                                           (20, 100, 24, 0.0),
                                           (20, 4100, 1100, 0.1),
                                           (35, 4100, 1100, 0.1),
                                           (35, 768, 4000, 0.1),
                                           (20, 30000, 64, 0.0),
                                           (100, 768, 4001, 0.1),
                                           (100, 30001, 64, 0.0)])
def test_feature_adapter_bwd_cluster_kernel(dev, dtype, need_dx, n, d, k,
                                            dropout):
    x, args = _feat_case(dev, n, d, k, dtype)
    g = torch.randn(n, d, generator=_gen(dev, 9), device=dev).to(dtype)

    def call():
        return F.feature_adapter_blend_bwd_cuda(x, *args, 0.2, g, dropout,
                                                1234, need_dx=need_dx)

    F.reset_launch_counts()
    got = call()
    assert F.launch_counts()["feature_adapter_blend_bwd_cuda"] == 1
    want = F.feature_adapter_blend_bwd_torch(x, *args, 0.2, g, dropout, 1234,
                                             need_dx=need_dx)
    _grads_close(got, want, dtype, "feature_adapter bwd")
    again = call()
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    # more than one group: past 64 rows, or past 16 where 24 rows' buffers
    # overflow shared memory (d 4100, k 1100)
    groups_of = 16 if (d, k) == (4100, 1100) else 64
    want_names = ["feature_adapter_bwd_cluster_kernel"] + (
        ["colsum_kernel"] if n > groups_of else [])
    names = _device_kernels(call, len(want_names))
    assert len(names) == len(want_names), names
    assert all(any(frag in nm for nm in names) for frag in want_names), names


# K6 forward, one cluster launch: the T path's rows (1, 7, 32, 35: one to
# five groups of 8), 600 rows with dropout (groups of 40 across the
# hash's 256-row tiles), d 100 (ragged slices) and d 1024 with k 192
# (weight slices too large for shared memory beside 8 rows: read in
# place), d 4100 with k 1100 (20 and 35 rows) and the widths whose row
# buffers live in the workspace (k 4000; d 30000; and at 100 rows, 13
# groups, k 4001 or d 30001); bit for bit on a repeat; one launch a call
# and no other kernel
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,k,dropout", [(1, 768, 64, 0.0),
                                           (7, 768, 64, 0.0),
                                           (32, 768, 64, 0.0),
                                           (35, 768, 64, 0.0),
                                           (600, 768, 64, 0.1),
                                           (20, 100, 24, 0.0),
                                           (77, 1024, 192, 0.1),
                                           (20, 4100, 1100, 0.1),
                                           (35, 4100, 1100, 0.1),
                                           (35, 768, 4000, 0.1),
                                           (20, 30000, 64, 0.0),
                                           (100, 768, 4001, 0.1),
                                           (100, 30001, 64, 0.0)])
def test_feature_adapter_fwd_cluster_kernel(dev, dtype, n, d, k, dropout):
    x, args = _feat_case(dev, n, d, k, dtype)

    def call():
        with torch.no_grad():
            return F.feature_adapter_blend_fused(x, *args, 0.2, dropout,
                                                 1234)

    F.reset_launch_counts()
    got = call()
    assert F.launch_counts()["feature_adapter_blend_fused"] == 1
    _close(got, F.feature_adapter_blend_torch(x, *args, 0.2, dropout, 1234),
           dtype)
    assert torch.equal(got, call())
    names = _device_kernels(call)
    assert len(names) == 1 and "feature_adapter_fwd_cluster_kernel" in \
        names[0], names


# K6's forward y does not depend on the rows a cluster takes: the first
# n0 rows of a call whose groups are the backward's at n0 rows (512 rows:
# groups of 32, the backward's at 32 rows; 600 rows: groups of 40, its
# at 35) carry the bits of the call of n0 rows (groups of 8). The
# backward recomputes y through the same device function
# (feat_cluster_forward) at those groups, so its recompute is the
# forward's y bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n0,n", [(32, 512), (35, 600)])
def test_feature_adapter_fwd_bits_at_every_group_size(dev, dtype, n0, n):
    x, args = _feat_case(dev, n, 768, 64, dtype)
    with torch.no_grad():
        small = F.feature_adapter_blend_fused(x[:n0].contiguous(), *args,
                                              0.2)
        big = F.feature_adapter_blend_fused(x, *args, 0.2)
    assert torch.equal(small, big[:n0])


# The same at the widest shapes: d 4100, k 1100 (8-row groups at 35 rows,
# 16 at 600: shared memory) and k 4000 (8 and 40 rows: the workspace),
# with dropout; and the backward's recompute of y agrees with the forward
# through dx at r = 1 (dx = dz + dh W1^T is not y, so the check is the
# forward's bits at both group sizes, as above).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,k", [(4100, 1100), (768, 4000)])
def test_feature_adapter_fwd_bits_wide(dev, dtype, d, k):
    x, args = _feat_case(dev, 600, d, k, dtype)
    with torch.no_grad():
        small = F.feature_adapter_blend_fused(x[:35].contiguous(), *args,
                                              0.2, 0.1, 77)
        big = F.feature_adapter_blend_fused(x, *args, 0.2, 0.1, 77)
    assert torch.equal(small, big[:35])


# 600 rows at k 64 across the hash's 256-row tiles, at d 128 and at the
# T path's d 768
@pytest.mark.cuda
@pytest.mark.parametrize("d,seed", [(128, 99), (768, 1234)])
def test_feature_dropout_mask_bits(dev, d, seed):
    """The kernel keeps exactly the elements the plain hash keeps: with
    W2 = I-like probes, y is zero where the mask dropped h."""
    n, k = 600, 64
    mask = F.feature_dropout_mask(n, k, seed, 0.1, dev)
    cpu = F.feature_dropout_mask(n, k, seed, 0.1)
    assert torch.equal(mask.cpu(), cpu)
    # relu(x W1 + b1) = 1 everywhere, W2 = [I_k | 0]: a = mask (+ b2 = 0),
    # so with r = 1, y = mask / |mask| per row
    x = torch.ones(n, d, device=dev)
    w1 = torch.zeros(d, k, device=dev)
    b1 = torch.ones(k, device=dev)
    w2 = torch.zeros(k, d, device=dev)
    w2[:, :k] = torch.eye(k, device=dev)
    b2 = torch.zeros(d, device=dev)
    y = F.feature_adapter_blend_fused(x, w1, b1, w2, b2, 1.0, 0.1, seed)
    assert torch.equal(y[:, :k] > 0, mask > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_feature_adapter_autograd(dev, dtype):
    """adapt_features' gradients with the kernels (autograd Function)
    and with autograd of K6's plain version (fp32 inside for a bf16 x,
    as the kernels; the plain composition of impl="torch" multiplies in
    x's dtype, so in bf16 it is another function)."""
    p = A.init_feature_adapter(_gen(dev), 768, 64, device=dev)
    x0 = torch.randn(32, 768, generator=_gen(dev, 3), device=dev)
    x0 = (x0 / x0.norm(dim=-1, keepdim=True)).to(dtype)
    leaves = tree_leaves(p)
    grads = {}
    for impl in ("kernel", "plain"):
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        x = x0.clone().requires_grad_(True)
        y = A.adapt_features(p, x, 0.2, impl="kernel") if impl == "kernel" \
            else F.feature_adapter_blend_torch(x, *leaves, 0.2)
        F.reset_launch_counts()
        (y.float() * torch.arange(768.0, device=dev)).sum().backward()
        if impl == "kernel":
            assert F.launch_counts()["feature_adapter_blend_bwd_cuda"] == 1
        grads[impl] = [x.grad] + [t.grad for t in leaves]
    _grads_close(grads["kernel"], grads["plain"], dtype, "adapt_features")


# ---------------------------------------------------------------------------
# K5: short-sequence attention of the towers
# ---------------------------------------------------------------------------

def _attn_mask(kind, b, t, dev):
    neg = torch.finfo(torch.float32).min
    causal = torch.triu(torch.full((t, t), neg, device=dev), diagonal=1)
    pad = torch.zeros(b, t, device=dev)
    pad[-1, t // 2:] = 1.0
    return {"none": None, "causal": causal,
            "padded": causal[None, None] + pad[:, None, None, :] * neg,
            "broadcast": causal[None, None]}[kind]


# ViT-L/14 vision (257) and text (77) at small batches, ViT-B/16 vision
# (197), ViT-L/14-336 (577) and 50 (shorter than one 64-key chunk); the
# batches of pipeline T's encodes (32 images, 35 descriptions) and of the
# B=96 train step's towers
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,t,kind", [
    (3, 16, 257, "none"), (5, 12, 77, "padded"), (5, 12, 77, "broadcast"),
    (2, 8, 77, "causal"), (2, 12, 197, "none"), (1, 16, 577, "none"),
    (3, 4, 50, "none"), (3, 4, 50, "padded"), (32, 16, 257, "none"),
    (35, 12, 77, "padded"), (35, 12, 77, "broadcast"),
    (96, 12, 197, "none"), (96, 8, 77, "padded")])
def test_fused_attention_kernel(dev, dtype, b, h, t, kind):
    q, k, v = (torch.randn(b, h, t, 64, generator=_gen(dev, i),
                           device=dev).to(dtype) for i in range(3))
    mask = _attn_mask(kind, b, t, dev)
    K5.reset_launch_counts()
    got = K5.fused_attention(q, k, v, 0.125, mask)
    assert K5.launch_counts() == {"fused_attention": 1}
    _close(got, K5.fused_attention_torch(q, k, v, 0.125, mask), dtype)


@pytest.mark.cuda
def test_mha_fused_toggle_on_card(dev):
    """A tower layer's attention through K5 equals the plain path, and
    the toggle is restored."""
    p = L.init_mha(_gen(dev), 768, device=dev)
    x = torch.randn(4, 77, 768, generator=_gen(dev, 1), device=dev)
    mask = _attn_mask("padded", 4, 77, dev)
    want = L.mha(p, x, x, 12, mask)
    K5.reset_launch_counts()
    assert not K5.fused_attention_enabled()
    K5.set_fused_attention(True)
    try:
        got = L.mha(p, x, x, 12, mask)
    finally:
        K5.set_fused_attention(False)
    assert K5.launch_counts() == {"fused_attention": 1}
    _close(got, want, torch.float32)


def _projected(b, h, t, d, dtype, dev, seed, offset=0):
    """q, k, v as mha makes them: [b, h, t, d] views of [b, t, h d]
    projections (each starting ``offset`` elements into its buffer)."""
    out = []
    for i in range(3):
        buf = torch.randn(b * t * h * d + offset,
                          generator=_gen(dev, seed + i), device=dev)
        buf = buf.to(dtype)
        out.append(buf[offset:].view(b, t, h, d).transpose(1, 2))
    return out


# the towers' shapes as mha passes them: ViT-L/14-336 vision (577) and
# text (77, padded) at B=32, ViT-B/16's at B=96; then a view off a 16-byte
# boundary, which the tensor-core kernel reads from a contiguous copy
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,t,kind,offset", [
    (32, 16, 577, "none", 0), (32, 12, 77, "padded", 0),
    (96, 12, 197, "none", 0), (96, 8, 77, "padded", 0),
    (4, 12, 77, "padded", 1)])
def test_fused_attention_strided_bit_for_bit(dev, dtype, b, h, t, kind,
                                             offset):
    """K5 on the non-contiguous views and with the output in q's layout
    equals the call on contiguous copies bit for bit, and the output's
    [b, t, h d] reshape is a view (but where the tensor-core kernel
    reads a contiguous copy of a view off a 16-byte boundary: the output
    follows the copy)."""
    q, k, v = _projected(b, h, t, 64, dtype, dev, 0, offset)
    assert not q.is_contiguous()
    mask = _attn_mask(kind, b, t, dev)
    K5.reset_launch_counts()
    got = K5.fused_attention(q, k, v, 0.125, mask)
    want = K5.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              0.125, mask)
    assert K5.launch_counts() == {"fused_attention": 2}
    assert want.is_contiguous() and torch.equal(got, want)
    if offset and dtype == torch.bfloat16:
        return
    flat = got.transpose(1, 2).reshape(b, t, h * 64)
    assert flat.data_ptr() == got.data_ptr() and flat.is_contiguous()


def _tower_case(dev, policy, b):
    """A 2-layer ViT-L/14-336 vision and text tower (published widths),
    b images at 336 and b captions of 8-77 tokens padded to 77."""
    from vlm_clip_tpu_torch.core import dtypes
    from vlm_clip_tpu_torch.core.config import clip_preset
    from vlm_clip_tpu_torch.models import clip as C

    ccfg = clip_preset("vit-large-patch14-336")
    vcfg = dataclasses.replace(ccfg.vision, num_layers=2)
    tcfg = dataclasses.replace(ccfg.text, num_layers=2)
    params = C.init_clip(_gen(dev), dataclasses.replace(
        ccfg, vision=vcfg, text=tcfg), device=dev)
    pol = getattr(dtypes, policy)
    px = torch.randn(b, 3, 336, 336, generator=_gen(dev, 1),
                     device=dev).to(pol.compute_dtype)
    ids = torch.randint(1, tcfg.vocab_size, (b, 77), generator=_gen(dev, 2),
                        device=dev)
    lens = torch.randint(8, 78, (b,), generator=_gen(dev, 3), device=dev)
    am = (torch.arange(77, device=dev)[None] < lens[:, None]).int()
    return {"vision": lambda x=px: C.vision_tower(
                params["vision"], x, vcfg, pol).last_hidden_state,
            "text": lambda: C.text_tower(
                params["text"], ids, am, tcfg, pol).last_hidden_state}, px


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["FAST", "BF16"])
def test_frozen_towers_take_k5_by_themselves(dev, policy, monkeypatch):
    """A bf16 no-grad pass of each tower at ViT-L/14-336's widths (32
    images at 577 tokens; captions under the padded [32, 1, 77, 77] mask)
    launches K5 once a layer and writes no scores (the counter adds 0).
    It matches the same pass on the unfused branch within TOL[bf16] of
    the largest output (a rounding flip in the bf16 chain of two layers
    moves a near-zero element past an elementwise bound, on either
    branch), and is as close to the FP32 pass as that branch is: K5 keeps
    the softmax in fp32 where FAST's unfused branch rounds it to bf16."""
    from vlm_clip_tpu_torch.utils import profiling as P

    towers, px = _tower_case(dev, policy, 32)
    fp32, _ = _tower_case(dev, "FP32", 32)
    for name, run in towers.items():
        with torch.no_grad():
            P.take()
            K5.reset_launch_counts()
            with P.tracing():
                got = run().float()
            assert K5.launch_counts() == {"fused_attention": 2}, name
            assert P.take()["counts"]["layers.attn_score_bytes"] == 0, name
            with monkeypatch.context() as m:
                m.setattr(L, "fused_route", lambda *args: False)
                want = run().float()
            ref = fp32[name](px.float()) if name == "vision" \
                else fp32[name]()
            assert K5.launch_counts() == {"fused_attention": 2}, name
        assert torch.isfinite(got).all()
        top = float(want.abs().max())
        assert float((got - want).abs().max()) <= TOL[torch.bfloat16] * top
        k5_err = float((got - ref).abs().mean())
        unfused_err = float((want - ref).abs().mean())
        assert k5_err <= 1.05 * unfused_err, (name, k5_err, unfused_err)


@pytest.mark.cuda
def test_towers_keep_the_unfused_branch_off_the_route(dev):
    """No K5 launch where the route keeps the unfused branch: a pass that
    needs a gradient (pixels that require one, grad mode on), an fp32
    pass, a batch-1 kv, ``fused=False``; the same attention under
    no_grad in bf16 launches it once."""
    towers, px = _tower_case(dev, "BF16", 4)
    p = L.init_mha(_gen(dev), 1024, device=dev)
    x = torch.randn(4, 577, 1024, generator=_gen(dev, 4),
                    device=dev).bfloat16()
    K5.reset_launch_counts()
    with torch.enable_grad():
        towers["vision"](px.clone().requires_grad_(True)).float().sum() \
            .backward()
    fp32, _ = _tower_case(dev, "FP32", 4)
    with torch.no_grad():
        fp32["vision"]()
        fp32["text"]()
        L.mha(p, x, x[:1], 16, None, torch.bfloat16)
        L.mha(p, x, x, 16, None, torch.bfloat16, fused=False)
    assert K5.launch_counts() == {"fused_attention": 0}
    with torch.no_grad():
        L.mha(p, x, x, 16, None, torch.bfloat16)
    assert K5.launch_counts() == {"fused_attention": 1}


# the benchmark's training cells: a step launches K5 once a tower layer
# (24 + 12 at ViT-L/14-336, 12 + 12 at ViT-B/16) and writes no scores
@pytest.mark.cuda
@pytest.mark.parametrize("preset,b,launches", [
    ("vit-large-patch14-336", 32, 36), ("vit-base-patch16", 96, 24)])
def test_m_train_step_launches_k5_every_tower_layer(dev, preset, b,
                                                    launches):
    from vlm_clip_tpu_torch.core import dtypes
    from vlm_clip_tpu_torch.core.config import AdapterConfig, clip_preset
    from vlm_clip_tpu_torch.train import optim
    from vlm_clip_tpu_torch.train.steps import (init_train_state,
                                                make_m_train_step)
    from vlm_clip_tpu_torch.utils import profiling as P

    ccfg = clip_preset(preset)
    acfg = AdapterConfig(text_adapter_size=256, vision_adapter_size=256,
                         shared_adapter_layers=2)
    tx = optim.adam(3e-4)
    state = init_train_state(_gen(dev), ccfg, acfg, tx, device=dev)
    step = make_m_train_step(ccfg, acfg, tx, dtypes.FAST)
    S = ccfg.vision.image_size
    batch = {"input_ids": torch.randint(1, ccfg.text.vocab_size, (b, 77),
                                        generator=_gen(dev, 1), device=dev),
             "attention_mask": torch.ones(b, 77, dtype=torch.int32,
                                          device=dev),
             "pixel_values": torch.randn(b, 3, S, S, generator=_gen(dev, 2),
                                         device=dev).bfloat16()}
    state, _ = step(state, batch)  # warm-up
    P.take()
    K5.reset_launch_counts()
    with P.tracing():
        state, m = step(state, batch)
    assert K5.launch_counts() == {"fused_attention": launches}
    assert P.take()["counts"]["layers.attn_score_bytes"] == 0
    assert torch.isfinite(m.loss)


# head widths other than 64: the 128-wide kernels (128), narrower heads
# zero-padded to 64 (8, 40) or to 128 (80, 96), the CUDA-core D = 256
# kernel in both dtypes (256; 160 zero-padded to it) and the column-chunk
# kernel past 256 (272, 512); the widths past 128 also unmasked at 4 x 4
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,d,kind", [
    *((2, 3, d, "padded") for d in (8, 40, 80, 96, 128, 160, 256, 272, 512)),
    *((4, 4, d, "none") for d in (160, 256, 272, 512))])
def test_fused_attention_other_head_widths(dev, dtype, b, h, d, kind):
    q, k, v = (torch.randn(b, h, 77, d, generator=_gen(dev, i),
                           device=dev).to(dtype) for i in range(3))
    mask = _attn_mask(kind, b, 77, dev)
    K5.reset_launch_counts()
    got = K5.fused_attention(q, k, v, d ** -0.5, mask)
    assert K5.launch_counts() == {"fused_attention": 1}
    _close(got, K5.fused_attention_torch(q, k, v, d ** -0.5, mask), dtype)


@pytest.mark.cuda
def test_fused_attention_refusals(dev):
    # a head past 256 columns is computed (the column-chunk kernel), not
    # refused; mixed dtypes still are
    q = torch.randn(2, 2, 9, 272, device=dev)
    K5.reset_launch_counts()
    got = K5.fused_attention(q, q, q, 0.1)
    assert K5.launch_counts() == {"fused_attention": 1}
    _close(got, K5.fused_attention_torch(q, q, q, 0.1), torch.float32)
    q = torch.randn(2, 2, 9, 64, device=dev)
    with pytest.raises(TypeError, match="share"):
        K5.fused_attention(q, q.bfloat16(), q, 0.1)


# K7: fp32 out from exact nibbles in both versions; only the summation
# order differs (2048 terms): elementwise 1e-4 + 1e-4 * |want| in both x
# types. N = 4100 (65 column tiles: five ordered depth slices), 22016 (the
# mixed preset's gateup) and 151936 (the 8h4 head); M = 16 takes the
# kernel of two n-tiles of x.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [1, 8, 32, 16])
@pytest.mark.parametrize("N", [4100, 22016, 151936])
def test_int4_gemv_kernel(dev, dtype, M, N):
    q = K7.quantize_weight(torch.randn(2048, N, generator=_gen(dev),
                                       device=dev) * 0.02, 4)
    x = torch.randn(M, 2048, generator=_gen(dev, 1), device=dev).to(dtype)
    K7.reset_launch_counts()
    got = K7.quant_matmul_int4(x, q)
    assert K7.launch_counts() == {"quant_matmul_int4": 1,
                                  "quant_matmul_int8": 0}
    want = K7.quant_matmul_int4_torch(x, q)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # quant_matmul routes a decode GEMV on a wide weight to the kernel
    y = K7.quant_matmul(x, q, out_dtype=torch.float32)
    assert K7.launch_counts() == {"quant_matmul_int4": 2,
                                  "quant_matmul_int8": 0}
    torch.testing.assert_close(y, got, atol=0, rtol=0)


@pytest.mark.cuda
def test_int4_gemv_refusals(dev):
    q = K7.quantize_weight(torch.randn(256, 4096, device=dev), 4)
    with pytest.raises(ValueError, match="rows"):
        K7.quant_matmul_int4(torch.randn(33, 256, device=dev), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K7.quant_matmul_int4(torch.randn(2, 256, device=dev).half(), q)


# The int8 GEMM against its plain twin. Both take the same bf16-valued
# operands (bf16(q * s), exactly; an fp32 x: its three exact bf16 terms
# times the exact int8 values) and sum in fp32, so only the summation
# order separates them: fp32 out within 1e-4 (1 + |want|); bf16 out the
# same sums cast once, a rounding flip at most (TOL's bf16 2e-2). Shapes:
# the 8h4 text linears (qkv with its bias, o, gateup, down), a ragged N
# (3,420: byte loads, a ragged last tile) and a K not a multiple of 16 (a
# padded x, a ragged last stage).
INT8_SHAPES = {"qkv": (2048, 2560, True), "o": (2048, 2048, False),
               "gateup": (2048, 22016, False), "down": (11008, 2048, False),
               "ragged_n": (2048, 3420, True), "ragged_k": (1000, 2048, True)}


def _int8_case(dev, shape, seed=0):
    K, N, bias = INT8_SHAPES[shape]
    gen = _gen(dev, seed)
    w = torch.randn(K, N, generator=gen, device=dev) * 0.02
    b = torch.randn(N, generator=gen, device=dev) if bias else None
    return K7.quantize_weight(w, 8, b)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [1, 5, 8, 16, 32, 48, "max"])
@pytest.mark.parametrize("shape", sorted(INT8_SHAPES))
def test_int8_gemm_kernel(dev, shape, M, dtype, out_dtype):
    M = K7.KERNEL_MAX_M_INT8 if M == "max" else M
    q = _int8_case(dev, shape)
    x = torch.randn(M, q.qweight.shape[0], generator=_gen(dev, 1),
                    device=dev).to(dtype)
    K7.reset_launch_counts()
    got = K7.quant_matmul_int8(x, q, out_dtype)
    assert K7.launch_counts() == {"quant_matmul_int4": 0,
                                  "quant_matmul_int8": 1}
    want = K7.quant_matmul_int8_torch(x, q, out_dtype)
    assert got.dtype == (out_dtype or dtype) and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    tol = TOL[out_dtype or dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # quant_matmul routes these rows on the card to the kernel
    y = K7.quant_matmul(x, q, out_dtype=out_dtype)
    assert K7.launch_counts()["quant_matmul_int8"] == 2
    assert torch.equal(y, got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(INT8_SHAPES))
def test_int8_gemm_operand_bit_for_bit(dev, shape):
    """A one-hot x row k returns bf16(q[k] * s), the reference's operand,
    exactly (fp32 out: one product by 1 and sums of zeros); a second call
    repeats the first bit for bit (the depth slices merge in order)."""
    q = _int8_case(dev, shape)
    K = q.qweight.shape[0]
    plain = dataclasses.replace(q, bias=None)
    rows = [0, K // 2 + 1, K - 1]
    x = torch.zeros(len(rows), K, dtype=torch.bfloat16, device=dev)
    for i, k in enumerate(rows):
        x[i, k] = 1
    got = K7.quant_matmul_int8(x, plain, torch.float32)
    want = K7.dequantize_weight(plain)[rows].to(torch.bfloat16).float()
    assert torch.equal(got, want)
    xr = torch.randn(32, K, generator=_gen(dev, 2), device=dev).bfloat16()
    first = K7.quant_matmul_int8(xr, q)
    assert torch.equal(first, K7.quant_matmul_int8(xr, q))


@pytest.mark.cuda
def test_int8_gemm_refusals(dev):
    q = K7.quantize_weight(torch.randn(256, 512, device=dev), 8)
    with pytest.raises(ValueError, match="rows"):
        K7.quant_matmul_int8(torch.randn(K7.INT8_TILE_M + 1, 256,
                                         device=dev), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K7.quant_matmul_int8(torch.randn(2, 256, device=dev).half(), q)
    with pytest.raises(ValueError, match="int8 weight"):
        K7.quant_matmul_int8(torch.randn(2, 128, device=dev), q)
    # past the route's rows the card takes the materialize route, no launch
    K7.reset_launch_counts()
    K7.quant_matmul(torch.randn(K7.KERNEL_MAX_M_INT8 + 1, 256, device=dev),
                    q)
    assert K7.launch_counts()["quant_matmul_int8"] == 0


# K8 against its plain version, elementwise, within cli/check_decode_attn's
# limits (bf16: 2^-6 of sum_j p_j |v_j|, the two versions round p at
# different points; fp32 2e-5); the 3B heads, S=768 (a ragged last
# 64-column chunk at depth S - T), depths 0 and S - T included.
@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("dtype,quant,B", [(torch.bfloat16, False, 8),
                                           (torch.bfloat16, True, 16),
                                           (torch.float32, False, 2),
                                           (torch.float32, True, 2)])
def test_decode_attention_kernel(dev, T, dtype, quant, B):
    from vlm_clip_tpu_torch.cli.check_decode_attn import compare, rand_case

    case = rand_case(_gen(dev, T), B, T, 16, 2, 128, 768, dtype, quant, dev)
    K8.reset_launch_counts()
    got = K8.decode_attention_kernel(*case)
    assert K8.launch_counts() == {"decode_attention_kernel": 1}
    want = K8.decode_attention_reference(*case)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    err, ratio = compare(got, want, case)
    assert ratio <= 1.0, (err, ratio)


# K8's column splits: at B=8 (bf16) and B=16 (int8), S=768, T=1 and 5,
# rows at depth 0, S - T, and under one split's columns; one launch a
# call, and a second call repeats the first bit for bit (the splits merge
# in order; the merging block resets its ticket)
@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("quant,B", [(False, 8), (True, 16)])
def test_decode_attention_split_kernel(dev, T, quant, B):
    from vlm_clip_tpu_torch.cli.check_decode_attn import compare, rand_case

    case = rand_case(_gen(dev, 7 + T), B, T, 16, 2, 128, 768,
                     torch.bfloat16, quant, dev)
    splits = K8.kernel_splits(B, 2, 128, 768)
    cps = -(-768 // splits)
    assert B * 2 * splits >= 132  # at least one block an SM
    case[5][1:4] = torch.tensor([1, cps - 1, cps + 3], dtype=torch.int32)
    K8.reset_launch_counts()
    got = K8.decode_attention_kernel(*case)
    assert K8.launch_counts() == {"decode_attention_kernel": 1}
    again = K8.decode_attention_kernel(*case)
    assert K8.launch_counts() == {"decode_attention_kernel": 2}
    assert torch.equal(got, again)
    want = K8.decode_attention_reference(*case)
    assert torch.isfinite(got.float()).all()
    err, ratio = compare(got, want, case)
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.cuda
def test_decode_attention_dispatch_on_card(dev):
    """The dispatcher routes a gated shape to the kernel by default; with
    impl="torch", S < 128, T > 16 or d % 128 != 0 it takes the plain
    version; a cache layer read through kv_read_span (a strided view) is
    taken as it is."""
    from vlm_clip_tpu_torch.cli.check_decode_attn import (compare, limits,
                                                          rand_case)

    case = rand_case(_gen(dev), 4, 1, 16, 2, 128, 256, torch.bfloat16,
                     False, dev)
    K8.reset_launch_counts()
    K8.decode_attention(*case, impl="torch")
    for outside in (rand_case(_gen(dev), 2, 1, 16, 2, 128, 96,
                              torch.bfloat16, False, dev),
                    rand_case(_gen(dev), 2, 17, 16, 2, 128, 256,
                              torch.bfloat16, False, dev),
                    rand_case(_gen(dev), 2, 1, 16, 2, 64, 256,
                              torch.bfloat16, False, dev)):
        assert not K8.kernel_route(outside[0], outside[1])
        K8.decode_attention(*outside)
    assert K8.launch_counts() == {"decode_attention_kernel": 0}
    got = K8.decode_attention(*case)
    span = list(case)
    span[1], span[2] = case[1][:, :200], case[2][:, :200]
    span[5] = case[5].clamp(max=199)
    strided = K8.decode_attention(*span)
    assert K8.launch_counts() == {"decode_attention_kernel": 2}
    torch.testing.assert_close(got, K8.decode_attention_kernel(*case),
                               atol=0, rtol=0)
    assert limits(span).shape == strided.shape
    assert compare(strided, K8.decode_attention_reference(*span),
                   span)[1] <= 1.0


# K8 at the serving engine's shapes: 32 slots, T = 1 (a decode step) and
# T = 5 (a speculative verify round), reading the first S columns of a
# max_len-768 cache layer (the engine's kv_read_span bucket, a strided
# view) at per-row depths, finished rows deeper than the span included
@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 384, 768])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_engine_shapes(dev, S, T, quant):
    from vlm_clip_tpu_torch.cli.check_decode_attn import compare, rand_case

    B = 32
    case = list(rand_case(_gen(dev, S + T), B, T, 16, 2, 128, 768,
                          torch.bfloat16, quant, dev))
    for i in (1, 2, 6, 7):  # the span's columns of the cache layer
        if case[i] is not None:
            case[i] = case[i][:, :S]
    depths = torch.randint(0, S + 1 - T, (B,), generator=_gen(dev, 3),
                           device=dev, dtype=torch.int32)
    depths[0], depths[1], depths[2] = 0, S - T, S + 40
    case[5] = depths
    K8.reset_launch_counts()
    got = K8.decode_attention(*case)
    assert K8.launch_counts() == {"decode_attention_kernel": 1}
    want = K8.decode_attention_reference(*case)
    assert torch.isfinite(got.float()).all()
    err, ratio = compare(got, want, case)
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.cuda
def test_engine_places_int8_rows_on_card(dev):
    """The engine's install copies a prefilled group's int8 rows and fp32
    scales into arbitrary slots of the resident cache (index_copy_ on the
    slot axis): on the card as on a CPU copy, bit for bit; the other
    slots keep their rows."""
    from vlm_clip_tpu_torch.vlm.engine import place_rows
    from vlm_clip_tpu_torch.vlm.qwen_model import (QwenTextConfig,
                                                   init_kv_cache)

    cfg = QwenTextConfig(num_layers=3)  # the 3B heads: 2 kv of 128
    g = _gen(dev, 11)
    cache = init_kv_cache(cfg, 8, 256, quantized=True, device=dev)
    sub = init_kv_cache(cfg, 3, 256, quantized=True, device=dev)
    for c in (cache, sub):
        c.k.random_(-127, 128, generator=g)
        c.v.random_(-127, 128, generator=g)
        c.k_scale.uniform_(0.005, 0.02, generator=g)
        c.v_scale.uniform_(0.005, 0.02, generator=g)
    names = ("k", "v", "k_scale", "v_scale")
    cpu, cpu_sub = (type(c)(*(getattr(c, n).cpu() if n != "length" else 0
                              for n in ("k", "v", "length", "k_scale",
                                        "v_scale")))
                    for c in (cache, sub))
    before = {n: getattr(cache, n).clone() for n in names}
    slots = [5, 0, 3]
    place_rows(cache, sub, torch.tensor(slots, device=dev))
    place_rows(cpu, cpu_sub, torch.tensor(slots))
    torch.cuda.synchronize()
    for n in names:
        got = getattr(cache, n)
        assert torch.equal(got.cpu(), getattr(cpu, n)), n
        assert torch.equal(got[:, slots], getattr(sub, n)), n
        keep = [i for i in range(8) if i not in slots]
        assert torch.equal(got[:, keep], before[n][:, keep]), n


@pytest.mark.cuda
def test_decode_attention_kernel_casts_other_cache_types(dev):
    """fp32 q over a bf16 cache (the CPU tests' combination): the wrapper
    reads the cache in q's type, as the plain version does."""
    from vlm_clip_tpu_torch.cli.check_decode_attn import rand_case

    case = list(rand_case(_gen(dev, 9), 2, 1, 16, 2, 128, 256,
                          torch.float32, False, dev))
    case[1], case[2] = case[1].bfloat16(), case[2].bfloat16()
    got = K8.decode_attention_kernel(*case)
    want = K8.decode_attention_reference(*case)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# NF4 (ops/nf4.py; plain PyTorch, no hand kernel), at chip_smoke.py's nf4
# phase's tolerances: the quantizer on the card against the CPU's (qweight
# bit for bit; the float32 mean behind dq_offset sums in another order, so
# the dequantized weights within 1e-6 of the largest |w|), and both matmul
# routes against float64: the row-pair fp32 route within 1e-4 of the
# largest |y|, the bf16 materialize route (prefill) within 2e-2
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_nf4_quantize_on_card_matches_cpu(dev):
    w = torch.randn(2, 2048, 1100, generator=_gen(dev, 7), device=dev) * 0.02
    got = N.quantize_nf4_stacked(w)
    want = N.quantize_nf4_stacked(w.cpu())
    assert torch.equal(got.qweight.cpu(), want.qweight)
    for i in range(2):
        a = N.dequantize_nf4(got.map(lambda t: t[i])).cpu()
        b = N.dequantize_nf4(want.map(lambda t: t[i]))
        assert float((a - b).abs().max()) <= 1e-6 * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,tol", [(1, 1e-4), (8, 1e-4), (4376, 2e-2)])
def test_nf4_matmul_routes_on_card(dev, m, tol):
    w = torch.randn(2048, 5000, generator=_gen(dev, 8), device=dev) * 0.02
    bias = torch.randn(5000, generator=_gen(dev, 9), device=dev)
    q = N.quantize_nf4(w, bias)
    x = torch.randn(m, 2048, generator=_gen(dev, 10), device=dev)
    y = N.nf4_matmul(x, q)
    want = x.double() @ N.dequantize_nf4(q).double() + bias.double()
    assert y.dtype == torch.float32 and y.shape == want.shape
    err = float((y.double() - want).abs().max())
    assert err <= tol * float(want.abs().max()), err
