"""K5, the towers' short-sequence attention, in the port against the JAX
package: the plain PyTorch version and its recompute backward against
the Pallas kernel (run through the interpreter on the CPU, as
tests/test_fused_ops.py runs it) and its custom VJP, with each mask
layout; and ``mha``'s dispatch to it under the opt-in toggle.

Also K5's bf16 kernel algorithm, emulated in torch chunk by chunk (two
passes over 64-key chunks, p rounded after it is normalized), against
the Pallas kernel.

Tolerances: fp32 1e-5 absolute for the output and 1e-5 of the largest
gradient for the gradients (the same fp32 math, summed in another order);
bf16 2e-2 (both sides take fp32 scores of the same bf16 operands and
round p and o once each, so a rounding flip separates them).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax
import jax.numpy as jnp

from vlm_clip_tpu.core.dtypes import FP32 as RFP32
from vlm_clip_tpu.models import clip as RC
from vlm_clip_tpu.models import layers as RL
from vlm_clip_tpu.ops import attention as RK5
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.models import clip as C
from vlm_clip_tpu_torch.models import layers as L
from vlm_clip_tpu_torch.ops import attention as K5

from _torch_port import port_clip_config, to_torch
from helpers import rand_batch, tiny_clip_config

B, H, T, D = 3, 2, 17, 8
SCALE = D ** -0.5
MASKS = ["none", "causal", "padded", "broadcast"]


def _mask(kind, rng):
    """none; causal [T, T]; padding + causal [B, 1, T, T]; a
    batch-broadcast [1, 1, T, T] (what the text tower emits without an
    attention mask). Small random biases give the mask a gradient worth
    comparing."""
    causal = np.triu(np.full((T, T), -1e9, np.float32), 1)
    bias = (rng.normal(size=(B, 1, T, T)) * 0.5).astype(np.float32)
    pad = np.zeros((B, 1, 1, T), np.float32)
    pad[-1, ..., T // 2:] = -1e9
    return {"none": None, "causal": causal + bias[0, 0],
            "padded": causal + bias + pad,
            "broadcast": (causal + bias[0, 0])[None, None]}[kind]


def _case(kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, T, D)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, _mask(kind, rng), g


@pytest.mark.parametrize("kind", MASKS)
def test_plain_forward_and_grads_match_pallas(kind):
    q, k, v, m, g = _case(kind)
    args = [jnp.asarray(a) for a in (q, k, v)]
    if m is None:
        want, vjp = jax.vjp(lambda q_, k_, v_: RK5.fused_attention(
            q_, k_, v_, SCALE, None), *args)
    else:
        want, vjp = jax.vjp(lambda q_, k_, v_, m_: RK5.fused_attention(
            q_, k_, v_, SCALE, m_), *args, jnp.asarray(m))
    want_g = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    leaves = [tq, tk, tv]
    tm = None
    if m is not None:
        tm = torch.from_numpy(m).requires_grad_(True)
        leaves.append(tm)
    K5.reset_launch_counts()
    got = K5.fused_attention(tq, tk, tv, SCALE, tm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(
        K5.fused_attention_torch(tq, tk, tv, SCALE, tm).detach().numpy(),
        np.asarray(want), atol=1e-5)
    got.backward(torch.from_numpy(g))
    assert K5.launch_counts() == {"fused_attention": 0}
    top = max(float(np.abs(w).max()) for w in want_g)
    for leaf, w in zip(leaves, want_g):
        assert leaf.grad.shape == w.shape
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-5 * top)


@pytest.mark.parametrize("kind", MASKS)
def test_plain_forward_bf16_matches_pallas(kind):
    q, k, v, m, _ = _case(kind, seed=1)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = RK5.fused_attention(*jb, SCALE, None if m is None
                               else jnp.asarray(m))
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = K5.fused_attention(*tb, SCALE, None if m is None
                             else torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_supports_and_refusals():
    for shape, ok in [((T, T), True), ((B, 1, T, T), True),
                      ((1, 1, T, T), True), ((B, H, T, T), False),
                      ((T,), False), ((T, T + 1), False)]:
        m = np.zeros(shape, np.float32)
        assert K5.supports(torch.from_numpy(m), T) == ok \
            == RK5.supports(jnp.asarray(m), T), shape
    assert K5.supports(None, T)
    q = torch.zeros(B, H, T, D)
    with pytest.raises(ValueError, match="mask"):
        K5.fused_attention(q, q, q, SCALE, torch.zeros(B, H, T, T))
    with pytest.raises(ValueError, match="share a shape"):
        K5.fused_attention(q, q[:, :, :5], q, SCALE)


def test_mha_toggle_takes_k5_and_is_restored():
    """A self-attention layer with the toggle on equals the toggle off in
    fp32, and ``fused=True`` equals the reference's ``mha(fused=True)``;
    cross-attention (another key length) never takes K5."""
    gen = torch.Generator().manual_seed(0)
    p = L.init_mha(gen, 32)
    x = torch.randn(B, T, 32, generator=gen)
    m = torch.from_numpy(_mask("padded", np.random.default_rng(0)))
    want = L.mha(p, x, x, 4, m)
    assert not K5.fused_attention_enabled()
    K5.set_fused_attention(True)
    try:
        assert K5.fused_attention_enabled()
        got = L.mha(p, x, x, 4, m)
        cross = L.mha(p, x, x[:, :5], 4, None)
    finally:
        K5.set_fused_attention(False)
    assert not K5.fused_attention_enabled()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(cross, L.mha(p, x, x[:, :5], 4, None),
                               atol=0, rtol=0)
    rp = {k: {"kernel": jnp.asarray(v["kernel"].numpy()),
              "bias": jnp.asarray(v["bias"].numpy())} for k, v in p.items()}
    ref = RL.mha(rp, jnp.asarray(x.numpy()), jnp.asarray(x.numpy()), 4,
                 jnp.asarray(m.numpy()), fused=True)
    np.testing.assert_allclose(L.mha(p, x, x, 4, m, fused=True).numpy(),
                               np.asarray(ref), atol=1e-5)
    torch.testing.assert_close(L.mha(p, x, x, 4, m, fused=False), want,
                               atol=0, rtol=0)


# mask layouts mha meets: none, [T, T], padded [B, 1, T, T], a
# batch-broadcast [1, 1, T, T], and a per-head [B, h, T, T] K5 does not take
ROUTE_MASKS = {"none": None, "square": (T, T), "padded": (B, 1, T, T),
               "broadcast": (1, 1, T, T), "per_head": (B, H, T, T)}


def _route_want(device, dtype, d, self_attention, mask, grad, fused,
                toggle):
    """The route as specified: never under fused=False, nor for
    cross-attention or a mask layout K5 does not take; else always under
    fused=True or the toggle; else only on the card in bf16, at heads of
    at most 128 columns, with no input needing a gradient."""
    if fused is False or not self_attention or mask == "per_head":
        return False
    if fused or toggle:
        return True
    return device == "cuda" and dtype == torch.bfloat16 and d <= 128 \
        and not grad


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fused_route_decides_every_combination(device):
    """layers.fused_route over every combination of dtype, head width
    (64, 128; 256 and 512 past the tensor-core kernel; 8 and 96 padded to
    it), self- or cross-attention, mask layout, grad mode, ``fused`` and
    the toggle, against the route as specified; no case on the CPU takes
    the kernel by itself."""
    import itertools

    cases = itertools.product(
        (torch.float32, torch.bfloat16), (8, 64, 96, 128, 256, 512),
        (True, False), ROUTE_MASKS, (False, True), (None, True, False),
        (False, True))
    taken = 0
    try:
        for dtype, d, self_attn, mk, grad, fused, toggle in cases:
            K5.set_fused_attention(toggle)
            shape = ROUTE_MASKS[mk]
            mask = None if shape is None else torch.zeros(shape)
            got = L.fused_route(device, dtype, d, self_attn, mask, T, grad,
                                fused)
            want = _route_want(device, dtype, d, self_attn, mk, grad, fused,
                               toggle)
            assert got == want, (device, dtype, d, self_attn, mk, grad,
                                 fused, toggle)
            taken += got and not (fused or toggle)
    finally:
        K5.set_fused_attention(False)
    # by itself: bf16, 4 widths, self-attention, 4 layouts, no grad
    assert taken == (0 if device == "cpu" else 4 * 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_on_the_cpu_takes_the_unfused_branch(dtype, monkeypatch):
    """On the CPU, with no ``fused`` and the toggle off, mha never calls K5
    (in either grad mode, for self- and cross-attention, with every mask
    layout) and computes what ``fused=False`` computes, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    p = L.init_mha(gen, 32)
    x = torch.randn(B, T, 32, generator=gen).to(dtype)
    masks = {mk: None if shape is None else torch.randn(shape, generator=gen)
             for mk, shape in ROUTE_MASKS.items()}

    def calls(fused):
        # FAST's softmax in bf16 for bf16, fp32 for fp32; H heads
        out = {}
        for mk, mask in masks.items():
            for grad in (False, True):
                with torch.set_grad_enabled(grad):
                    out[mk, grad] = (
                        L.mha(p, x, x, H, mask, dtype, fused=fused),
                        L.mha(p, x, x[:1], H, None, dtype, fused=fused))
        return out

    want = calls(False)

    def refuse(*args, **kwargs):
        raise AssertionError("K5 taken on the CPU")

    monkeypatch.setattr(K5, "fused_attention", refuse)
    for key, got in calls(None).items():
        for g, w in zip(got, want[key]):
            torch.testing.assert_close(g, w, atol=0, rtol=0, msg=str(key))


def test_towers_with_the_toggle_match_reference():
    """The text tower (batch-broadcast causal mask plus padding) and the
    vision tower (no mask) with K5 on equal the reference with its own
    toggle on, and the port with the toggle off, in fp32."""
    cfg = tiny_clip_config()
    params = RC.init_clip(jax.random.PRNGKey(0), cfg)
    tp, pcfg = to_torch(params), port_clip_config(cfg)
    px, ids, am = rand_batch()
    off_t = C.get_text_features(tp, torch.from_numpy(ids),
                                torch.from_numpy(am), pcfg, FP32)
    off_i = C.get_image_features(tp, torch.from_numpy(px), pcfg, FP32)
    K5.set_fused_attention(True)
    RK5.set_fused_attention(True)
    try:
        on_t = C.get_text_features(tp, torch.from_numpy(ids),
                                   torch.from_numpy(am), pcfg, FP32)
        on_i = C.get_image_features(tp, torch.from_numpy(px), pcfg, FP32)
        ref_t = RC.get_text_features(params, jnp.asarray(ids),
                                     jnp.asarray(am), cfg, RFP32)
        ref_i = RC.get_image_features(params, jnp.asarray(px), cfg, RFP32)
    finally:
        K5.set_fused_attention(False)
        RK5.set_fused_attention(False)
    np.testing.assert_allclose(on_t.numpy(), np.asarray(ref_t), atol=1e-4)
    np.testing.assert_allclose(on_i.numpy(), np.asarray(ref_i), atol=1e-4)
    torch.testing.assert_close(on_t, off_t, atol=1e-5, rtol=0)
    torch.testing.assert_close(on_i, off_i, atol=1e-5, rtol=0)


KEY_CHUNK = 64  # keys per chunk of the bf16 kernel (csrc/attention.cu)


def _two_pass_bf16(q, k, v, scale, mask):
    """K5's bf16 kernel (attention_mma_kernel) in torch, chunk by chunk as
    it runs: the scores are fp32 sums of products of the bf16 operands,
    times scale, plus the fp32 mask, -inf past the last key (the ragged
    last chunk is masked, not padded in memory); pass 1 keeps each row's
    max and its sum of exp(s - max) over the chunks, rescaling the sum
    when the max grows (a chunk with nothing but -inf so far leaves both);
    pass 2 recomputes each chunk's scores and adds round_bf16(exp(s -
    max) * (1 / sum)) v in fp32; the output is rounded once."""
    T = q.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    m4 = None if mask is None else (mask if mask.dim() == 4
                                    else mask[None, None]).float()

    def scores(c0):
        c1 = min(c0 + KEY_CHUNK, T)
        s = (qf @ kf[:, :, c0:c1].transpose(-1, -2)) * scale
        if m4 is not None:
            s = s + m4[..., c0:c1]
        return TF.pad(s, (0, KEY_CHUNK - (c1 - c0)), value=float("-inf"))

    ninf = torch.tensor(float("-inf"))
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros(q.shape[:3] + (1,))
    for c0 in range(0, T, KEY_CHUNK):
        s = scores(c0)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        e = torch.where(mn == ninf, 0.0,
                        torch.exp(s - mn).sum(-1, keepdim=True))
        l = torch.where(m == ninf, 0.0, l * torch.exp(m - mn)) + e
        m = mn
    inv = 1.0 / l
    o = torch.zeros(q.shape)
    for c0 in range(0, T, KEY_CHUNK):
        n = min(KEY_CHUNK, T - c0)
        p = (torch.exp(scores(c0) - m) * inv).to(v.dtype).float()
        o = o + p[..., :n] @ vf[:, :, c0:c0 + n]
    return o.to(q.dtype)


def _tower_mask(kind, b, t, rng):
    """The text tower's masks with finfo.min entries: causal [t, t], and
    causal plus padding [b, 1, t, t] (some entries add to -inf)."""
    neg = np.finfo(np.float32).min
    causal = np.triu(np.full((t, t), neg, np.float32), 1)
    if kind == "causal":
        return causal
    lens = rng.integers(t // 3, t + 1, size=b)
    pad = np.where(np.arange(t)[None] >= lens[:, None], neg, 0.0)
    return (causal[None, None] + pad[:, None, None, :].astype(np.float32))


# T = 77 (two chunks, the last ragged) with the text tower's masks; T = 50
# (shorter than one chunk) without and with padding
@pytest.mark.parametrize("t,kind", [(77, "padded"), (77, "causal"),
                                    (50, "none"), (50, "padded")])
def test_two_pass_bf16_algorithm_matches_pallas(t, kind):
    rng = np.random.default_rng(t)
    b, h, d = 3, 2, 64
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    m = None if kind == "none" else _tower_mask(kind, b, t, rng)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = RK5.fused_attention(*jb, d ** -0.5,
                               None if m is None else jnp.asarray(m))
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = _two_pass_bf16(*tb, d ** -0.5,
                         None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [8, 40, 80])
def test_narrow_heads_zero_padded_match_pallas(d):
    """A head narrower than a kernel width (64 or 128 columns) runs
    zero-padded to it (ops/attention.py:_launch): the kernel's algorithm,
    emulated on the padded q, k, v with the true width's scale and cut
    back to d columns, against the Pallas kernel at width d. bf16
    tolerance 2e-2, as above; ``supports`` routes by the mask alone,
    whatever the width."""
    rng = np.random.default_rng(d)
    b, h, t = 2, 3, 77
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    m = _tower_mask("padded", b, t, rng)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = RK5.fused_attention(*jb, d ** -0.5, jnp.asarray(m))
    assert K5.kernel_width(d) == (64 if d <= 64 else 128)
    tb = [TF.pad(torch.from_numpy(a).bfloat16(), (0, K5.kernel_width(d) - d))
          for a in (q, k, v)]
    got = _two_pass_bf16(*tb, d ** -0.5, torch.from_numpy(m))[..., :d]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    assert K5.supports(torch.from_numpy(m), t)


@pytest.mark.parametrize("d,width", [(1, 64), (64, 64), (65, 128),
                                     (128, 128), (129, 256), (160, 256),
                                     (256, 256), (257, 320), (272, 320),
                                     (512, 512), (600, 640)])
def test_kernel_width_up_to_256(d, width):
    """The kernel width a head runs at: 64, 128 or 256 columns up to 256
    (heads of 129-256 on the CUDA-core kernel's D = 256 instantiation);
    past 256 the next multiple of 64, on the column-chunk kernel (whole-
    head fp32 tiles at D = 512 would not fit a block's shared memory).
    No width raises."""
    assert K5.HEAD_DIMS == (64, 128, 256)
    assert K5.kernel_width(d) == width
    assert K5.kernel_width(257) == 320


def _two_pass_chunked(q, k, v, scale, mask, wc=256):
    """K5's column-chunk kernel (attention_wide_kernel) in torch: q, k, v
    zero-padded to a multiple of 64 columns and taken in column chunks of
    at most wc; each key chunk's scores are the chunks' q . k summed in
    column order, times scale, plus the fp32 mask; pass 1 keeps each
    row's max and sum of exp(s - max) over 64-key chunks; pass 2 writes
    the output one column chunk at a time, adding round(exp(s - max) /
    sum) v over each key chunk; the output is rounded once."""
    T, d = q.shape[2], q.shape[3]
    w = K5.kernel_width(d)
    qf, kf, vf = (TF.pad(a.float(), (0, w - d)) for a in (q, k, v))
    m4 = None if mask is None else (mask if mask.dim() == 4
                                    else mask[None, None]).float()
    chunks = [(c0, min(c0 + wc, w)) for c0 in range(0, w, wc)]

    def scores(k0):
        k1 = min(k0 + KEY_CHUNK, T)
        s = torch.zeros(q.shape[:3] + (k1 - k0,))
        for c0, c1 in chunks:
            s = s + qf[..., c0:c1] @ kf[:, :, k0:k1, c0:c1].transpose(-1, -2)
        s = s * scale
        if m4 is not None:
            s = s + m4[..., k0:k1]
        return TF.pad(s, (0, KEY_CHUNK - (k1 - k0)), value=float("-inf"))

    ninf = torch.tensor(float("-inf"))
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros(q.shape[:3] + (1,))
    for k0 in range(0, T, KEY_CHUNK):
        s = scores(k0)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        e = torch.where(mn == ninf, 0.0,
                        torch.exp(s - mn).sum(-1, keepdim=True))
        l = torch.where(m == ninf, 0.0, l * torch.exp(m - mn)) + e
        m = mn
    outs = []
    for c0, c1 in chunks:
        o = torch.zeros(q.shape[:3] + (c1 - c0,))
        for k0 in range(0, T, KEY_CHUNK):
            n = min(KEY_CHUNK, T - k0)
            p = (torch.exp(scores(k0) - m) / l).to(v.dtype).float()
            o = o + p[..., :n] @ vf[:, :, k0:k0 + n, c0:c1]
        outs.append(o)
    return torch.cat(outs, -1)[..., :d].to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [272, 512])
def test_wide_heads_column_chunks_match_pallas(d, dtype):
    """Heads wider than 256 columns: the column-chunk kernel's two passes,
    emulated (272: padded to 320, chunks of 256 and 64; 512: two chunks
    of 256), against the Pallas kernel at width d, with the text tower's
    padding mask. fp32 1e-5, bf16 2e-2, as above."""
    rng = np.random.default_rng(d)
    b, h, t = 1, 2, 77
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    m = _tower_mask("padded", b, t, rng)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = RK5.fused_attention(*(jnp.asarray(a).astype(jdt)
                                 for a in (q, k, v)), d ** -0.5,
                               jnp.asarray(m))
    got = _two_pass_chunked(*(torch.from_numpy(a).to(dtype)
                              for a in (q, k, v)), d ** -0.5,
                            torch.from_numpy(m))
    assert got.dtype == dtype and got.shape == (b, h, t, d)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [160, 256])
def test_wide_heads_two_pass_match_pallas(d):
    """Heads of 129-256 columns, zero-padded to 256: the CUDA-core
    kernel's two passes (the row max and sum, then p rounded to bf16
    after it is normalized, times v; the same rounding points as the
    tensor-core kernel's), emulated on the padded q, k, v with the true
    width's scale and cut back to d columns, against the Pallas kernel at
    width d. bf16 tolerance 2e-2, as above."""
    rng = np.random.default_rng(d)
    b, h, t = 1, 2, 77
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    m = _tower_mask("padded", b, t, rng)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = RK5.fused_attention(*jb, d ** -0.5, jnp.asarray(m))
    tb = [TF.pad(torch.from_numpy(a).bfloat16(), (0, K5.kernel_width(d) - d))
          for a in (q, k, v)]
    got = _two_pass_bf16(*tb, d ** -0.5, torch.from_numpy(m))[..., :d]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
