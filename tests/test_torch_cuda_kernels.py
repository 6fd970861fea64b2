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

import pytest
import torch

from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.models import adapters as A
from vlm_clip_tpu_torch.ops import contrastive as K4
from vlm_clip_tpu_torch.ops import fused_adapter as F

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


# 77 and 250 rows: a ragged last 32-row tile
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,k", [(77, 512, 256), (250, 768, 128)])
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
        "cross_attn_block_bwd_cuda": 0, "prenorm_mlp_bwd_cuda": 0}
    _close(got, want, dtype)


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_do(dev):
    p = A.init_seq_adapter(_gen(dev), 512, 256, device=dev)
    args = (p["down"]["kernel"], p["down"]["bias"], p["up"]["kernel"],
            p["up"]["bias"], p["ln"]["scale"], p["ln"]["bias"])
    with pytest.raises(ValueError, match="wrong shapes"):
        F.seq_adapter_fused(torch.randn(8, 500, device=dev), *args)
    p320 = A.init_seq_adapter(_gen(dev), 320, 256, device=dev)
    with pytest.raises(ValueError, match="multiples of 128"):
        F.seq_adapter_fused(torch.randn(8, 320, device=dev),
                            p320["down"]["kernel"], p320["down"]["bias"],
                            p320["up"]["kernel"], p320["up"]["bias"],
                            p320["ln"]["scale"], p320["ln"]["bias"])
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


# 77 and 250 rows: a ragged last 32-row tile; the vision width; no dx
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,k,need_dx", [(77, 512, 256, True),
                                           (250, 768, 256, False)])
def test_seq_adapter_bwd_kernel(dev, dtype, n, h, k, need_dx):
    x, args = _seq_case(dev, n, h, k, dtype)
    g = torch.randn(n, h, generator=_gen(dev, 3), device=dev).to(dtype)
    F.reset_launch_counts()
    got = F.seq_adapter_bwd_cuda(x, *args, g, need_dx=need_dx)
    want = F.seq_adapter_bwd_torch(x, *args, g, need_dx=need_dx)
    assert F.launch_counts()["seq_adapter_bwd_cuda"] == 1
    _grads_close(got, want, dtype, "seq_adapter")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_prenorm_mlp_bwd_kernel(dev, dtype):
    p = A.init_mlp_gelu(_gen(dev), 512, device=dev)
    x = torch.randn(77, 512, generator=_gen(dev, 3), device=dev).to(dtype)
    ls = 1 + 0.1 * torch.randn(512, generator=_gen(dev, 4), device=dev)
    lb = 0.1 * torch.randn(512, generator=_gen(dev, 5), device=dev)
    args = (p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
            p["fc2"]["bias"], ls, lb)
    g = torch.randn(77, 512, generator=_gen(dev, 6), device=dev).to(dtype)
    _grads_close(F.prenorm_mlp_bwd_cuda(x, *args, g),
                 F.prenorm_mlp_bwd_torch(x, *args, g), dtype, "prenorm_mlp")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,tk", [(77, 197), (40, 5)])
def test_cross_attn_block_bwd_kernel(dev, dtype, n, tk):
    p = A.init_cross_modal_adapter(_gen(dev), text_dim=512, image_dim=768,
                                   hidden=512, device=dev)
    image = (torch.randn(1, tk, 768, generator=_gen(dev, 4), device=dev)
             * 768 ** -0.5).to(dtype)
    k, v = A.shared_kv(p, image)
    ap = p["attn"]
    args = (p["text_proj"]["kernel"], p["text_proj"]["bias"],
            p["norm2"]["scale"], p["norm2"]["bias"], ap["q"]["kernel"],
            ap["q"]["bias"], k, v, ap["out"]["kernel"], ap["out"]["bias"])
    x = torch.randn(n, 512, generator=_gen(dev, 3), device=dev).to(dtype)
    g = torch.randn(n, 512, generator=_gen(dev, 5), device=dev).to(dtype)
    _grads_close(F.cross_attn_block_bwd_cuda(x, *args, g, 8),
                 F.cross_attn_block_bwd_torch(x, *args, g, 8), dtype,
                 "cross_attn_block")


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
