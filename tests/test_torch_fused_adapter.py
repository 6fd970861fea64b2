"""The plain PyTorch versions of the three fused adapter kernels (K1
seq_adapter, K2 cross_attn_block, K3 prenorm_mlp), forward and backward,
against the JAX package's Pallas kernels — run through the Pallas
interpreter on the CPU, as tests/test_fused_ops.py runs them — and
against its jnp composition, plus the wrappers' CPU dispatch.

Tolerances: fp32 forward 1e-5 absolute (same math, summation order
differs); fp32 gradients 1e-5 against autograd of the same plain forward
and 1e-4 of the largest gradient against the Pallas backward (weight
gradients sum over every row, in another order, and the Pallas kernels'
GELU and GELU' come from an erf polynomial good to 1.5e-7); bf16 2e-2
absolute + relative (both sides round the same operands to bf16, so only
a rounding flip from summation order separates them: about two bf16 ulps
of values up to ~4), for gradients 2e-2 of the largest one. K3's bf16
backward on the tensor cores is emulated pass by pass in torch and held
against the Pallas backward at the bf16 tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.models import adapters as RA
from vlm_clip_tpu.models import layers as RL
from vlm_clip_tpu.ops import fused_adapter as RF
from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.models import adapters as A
from vlm_clip_tpu_torch.ops import fused_adapter as F

from _torch_port import to_torch

ATOL = 1e-5
BF16_TOL = 2e-2


def _np(*shapes, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _seq_args(n, d, k, seed):
    x, w1, b1, w2, b2, ls, lb = _np((n, d), (d, k), (k,), (k, d), (d,),
                                    (d,), (d,), seed=seed)
    return [x * 10, w1, b1, w2, b2, ls + 1.0, lb]


@pytest.mark.parametrize("n,d,k", [(8, 64, 16), (260, 64, 32)])
def test_seq_adapter_plain_matches_pallas_and_jnp(n, d, k):
    args = _seq_args(n, d, k, seed=n)
    got = F.seq_adapter_torch(*map(torch.from_numpy, args)).numpy()
    fused = np.asarray(RF.seq_adapter_fused(*map(jnp.asarray, args)))
    p = {"down": {"kernel": args[1], "bias": args[2]},
         "up": {"kernel": args[3], "bias": args[4]},
         "ln": {"scale": args[5], "bias": args[6]}}
    ref = np.asarray(RA.seq_adapter(p, jnp.asarray(args[0]), impl="jnp"))
    np.testing.assert_allclose(got, fused, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _pnmlp_args(n, d, k, seed):
    x, w1, b1, w2, b2, ls, lb = _np((n, d), (d, k), (k,), (k, d), (d,),
                                    (d,), (d,), seed=seed)
    return [x * 10, w1, b1, w2, b2, ls + 1.0, lb]


# (300, 64, 1024): ragged rows, and the TPU kernel's 512-column chunks
@pytest.mark.parametrize("n,d,k", [(8, 64, 32), (300, 64, 1024)])
def test_prenorm_mlp_plain_matches_pallas_and_jnp(n, d, k):
    args = _pnmlp_args(n, d, k, seed=k)
    got = F.prenorm_mlp_torch(*map(torch.from_numpy, args)).numpy()
    fused = np.asarray(RF.prenorm_mlp_fused(*map(jnp.asarray, args)))
    x, w1, b1, w2, b2, ls, lb = map(jnp.asarray, args)
    ref = np.asarray(x + RL.mlp(
        {"fc1": {"kernel": w1, "bias": b1}, "fc2": {"kernel": w2,
                                                     "bias": b2}},
        RL.layer_norm({"scale": ls, "bias": lb}, x), act="gelu"))
    np.testing.assert_allclose(got, fused, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _cab_case(n, din, h, heads, tk, seed):
    """Args of both K2 versions: the port's shared k, v [Tk, H] and the
    reference's block-diagonal packing of the same k, v."""
    rng = np.random.default_rng(seed)
    p = RA.init_cross_modal_adapter(jax.random.PRNGKey(seed), text_dim=din,
                                    image_dim=96, hidden=h,
                                    num_heads=heads)
    image = jnp.asarray(rng.normal(size=(1, tk, 96)).astype(np.float32))
    x = rng.normal(size=(n, din)).astype(np.float32)
    kbd, vbd = RA._pack_shared_kv_blockdiag(p, image, heads, 1e-5,
                                            RF.attn_seg(tk))
    ap = p["attn"]
    ref_args = [x, p["text_proj"]["kernel"], p["text_proj"]["bias"],
                p["norm2"]["scale"], p["norm2"]["bias"], ap["q"]["kernel"],
                ap["q"]["bias"], kbd, vbd, ap["out"]["kernel"],
                ap["out"]["bias"]]
    tp = to_torch(p)
    k, v = A.shared_kv(tp, torch.from_numpy(np.array(image)))
    tap = tp["attn"]
    port_args = [torch.from_numpy(x), tp["text_proj"]["kernel"],
                 tp["text_proj"]["bias"], tp["norm2"]["scale"],
                 tp["norm2"]["bias"], tap["q"]["kernel"], tap["q"]["bias"],
                 k, v, tap["out"]["kernel"], tap["out"]["bias"]]
    return ref_args, port_args


@pytest.mark.parametrize("n,din,h,heads,tk", [(21, 64, 64, 4, 5),
                                              (130, 48, 64, 8, 13)])
def test_cross_attn_block_plain_matches_pallas(n, din, h, heads, tk):
    ref_args, port_args = _cab_case(n, din, h, heads, tk, seed=n)
    fused = np.asarray(RF.cross_attn_block_fused(
        *map(jnp.asarray, ref_args), heads, tk))
    got = F.cross_attn_block_torch(*port_args, heads).numpy()
    np.testing.assert_allclose(got, fused, atol=ATOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_cross_modal_adapter_matches_pallas_and_jnp(layers):
    """The whole adapter (shared k/v in torch, K2, K3) over stacked
    layers, against impl='fused' and impl='jnp' of the reference."""
    rng = np.random.default_rng(layers)
    text = jnp.asarray(rng.normal(size=(3, 7, 64)).astype(np.float32))
    image = jnp.asarray(rng.normal(size=(1, 5, 96)).astype(np.float32))
    got, want_f, want_j = torch.tensor(np.asarray(text)), text, text
    for i in range(layers):
        p = RA.init_cross_modal_adapter(jax.random.PRNGKey(10 + i),
                                        text_dim=64, image_dim=96,
                                        hidden=64, num_heads=4)
        want_f = RA.cross_modal_adapter(p, want_f, image, 4, impl="fused")
        want_j = RA.cross_modal_adapter(p, want_j, image, 4, impl="jnp")
        got = A.cross_modal_adapter(to_torch(p), got,
                                    torch.from_numpy(np.asarray(image)), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_f), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j), atol=1e-4)


def _bf16_close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_bf16_rounding_points_match_pallas():
    """bf16 x, fp32 params: K1 widens to fp32, K2/K3 round every matmul
    operand to bf16 — the plain versions round where the Pallas kernels
    round."""
    args = _seq_args(40, 64, 16, seed=1)
    xb = jnp.asarray(args[0], jnp.bfloat16)
    _bf16_close(F.seq_adapter_torch(
        torch.from_numpy(args[0]).bfloat16(),
        *map(torch.from_numpy, args[1:])),
        RF.seq_adapter_fused(xb, *map(jnp.asarray, args[1:])))

    args = _pnmlp_args(40, 64, 256, seed=2)
    xb = jnp.asarray(args[0], jnp.bfloat16)
    _bf16_close(F.prenorm_mlp_torch(
        torch.from_numpy(args[0]).bfloat16(),
        *map(torch.from_numpy, args[1:])),
        RF.prenorm_mlp_fused(xb, *map(jnp.asarray, args[1:])))

    ref_args, port_args = _cab_case(40, 64, 64, 4, 9, seed=3)
    ref = [jnp.asarray(ref_args[0], jnp.bfloat16)] + [
        jnp.asarray(a) for a in ref_args[1:7]] + [
        jnp.asarray(a, jnp.bfloat16) for a in ref_args[7:9]] + [
        jnp.asarray(a) for a in ref_args[9:]]
    port = [port_args[0].bfloat16()] + port_args[1:7] + [
        port_args[7].bfloat16(), port_args[8].bfloat16()] + port_args[9:]
    _bf16_close(F.cross_attn_block_torch(*port, 4),
                RF.cross_attn_block_fused(*ref, 4, 9))


# bf16 weight gradients take the tensor cores exactly where every row of
# both operands copies in 16-byte chunks: K2's dWo at heads of 192 (H =
# 384) does; a per-head key slice 197 wide, a K3 width of 100 and a start
# off a 16-byte boundary do not; an fp32 operand never does
@pytest.mark.parametrize("p,q,lda,sa,off,want", [
    (384, 384, 384, 0, 0, True), (197, 64, 8 * 197, 197, 0, False),
    (100, 400, 100, 0, 0, False), (512, 512, 512, 0, 1, False)])
def test_bf16_tc_route_follows_alignment(p, q, lda, sa, off, want):
    base = torch.zeros(8 * lda + 8, dtype=torch.bfloat16)
    a = base[off:off + 8 * lda].view(8, lda)
    b = torch.zeros(8, q, dtype=torch.bfloat16)
    assert F._bf16_tc_route(a, b, p, q, lda, sa, q, 0) is want
    assert not F._bf16_tc_route(a.float(), b, p, q, lda, sa, q, 0)


def test_cpu_dispatch_and_impl_choices():
    """On a CPU tensor the wrappers take the plain versions and launch
    nothing; impl='kernel' refuses a CPU tensor."""
    p = A.init_seq_adapter(torch.Generator().manual_seed(0), 64, 16)
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(1))
    F.reset_launch_counts()
    auto = A.seq_adapter(p, x)
    plain = A.seq_adapter(p, x, impl="torch")
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
    assert not any(F.launch_counts().values())
    # a gradient on the CPU comes from autograd of the plain version
    xg = x.clone().requires_grad_(True)
    A.seq_adapter(p, xg).sum().backward()
    assert xg.grad is not None and not any(F.launch_counts().values())
    with pytest.raises(ValueError, match="CUDA"):
        A.seq_adapter(p, x, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        A.seq_adapter(p, x, impl="jnp")


@pytest.mark.parametrize("kernel", ["seq_adapter", "prenorm_mlp",
                                    "cross_attn_block"])
def test_wrappers_refuse_mismatched_param_shapes(kernel):
    """A parameter whose shape does not fit x's width is refused before
    dispatch, on the CPU as on the card (the kernel would read past it)."""
    if kernel == "cross_attn_block":
        _, args = _cab_case(6, 64, 64, 4, 5, seed=0)
        extra = (4,)
    else:
        args = list(map(torch.from_numpy, _seq_args(6, 64, 16, seed=0)))
        extra = ()
    fn = getattr(F, f"{kernel}_fused")
    fn(*args, *extra)  # well-formed: accepted
    short_bias = list(args)
    short_bias[2] = short_bias[2][:-1]
    with pytest.raises(ValueError, match="wrong shapes"):
        fn(*short_bias, *extra)
    with pytest.raises(ValueError, match="rows, features"):
        fn(args[0][None], *args[1:], *extra)


def test_cross_modal_adapter_needs_batch_shared_image():
    p = A.init_cross_modal_adapter(torch.Generator().manual_seed(0),
                                   text_dim=64, image_dim=96, hidden=64)
    with pytest.raises(ValueError, match="batch-shared"):
        A.cross_modal_adapter(p, torch.zeros(2, 3, 64), torch.zeros(2, 5, 96),
                              4)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _grad_close(got, want, rel, what):
    """|got - want| <= rel * max|want|, with max|want| taken as at least
    1e-2: a gradient that is zero in exact arithmetic (the key bias, to
    which the softmax is invariant) comes out as rounding noise."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-2),
                               err_msg=what)


def _check_bwd(plain_fwd, plain_bwd, ref_fused, port_args, ref_args, names,
               extra=(), ref_extra=(), rel=1e-4):
    """The plain backward against autograd of the plain forward and
    against jax.grad of the Pallas kernel, for the cotangent t."""
    y = plain_fwd(*port_args, *extra)
    t = np.random.default_rng(7).normal(size=tuple(y.shape)).astype(
        np.float32)
    g = torch.from_numpy(t).to(y.dtype)
    got = plain_bwd(*port_args, g, *extra)
    leaves = [a.detach().clone().requires_grad_(True) for a in port_args]
    (plain_fwd(*leaves, *extra).float() * torch.from_numpy(t)).sum(
        ).backward()
    want = jax.grad(lambda *a: jnp.sum(ref_fused(*a, *ref_extra) * t),
                    argnums=tuple(range(len(ref_args))))(*ref_args)
    for name, gg, leaf, w in zip(names, got, leaves, want):
        if port_args[0].dtype == torch.float32:
            torch.testing.assert_close(gg, leaf.grad.to(gg.dtype),
                                       atol=1e-5, rtol=1e-5, msg=name)
        _grad_close(gg, w, rel, name)


MLP_NAMES = "x w1 b1 w2 b2 ln_scale ln_bias".split()


@pytest.mark.parametrize("n,d,k", [(8, 64, 16), (70, 64, 32)])
def test_seq_adapter_grads_match_pallas(n, d, k):
    args = _seq_args(n, d, k, seed=n + 1)
    _check_bwd(F.seq_adapter_torch, F.seq_adapter_bwd_torch,
               RF.seq_adapter_fused, list(map(torch.from_numpy, args)),
               list(map(jnp.asarray, args)), MLP_NAMES)


# (40, 64, 1024): the TPU kernel's 512-column hidden chunks
@pytest.mark.parametrize("n,d,k", [(8, 64, 32), (40, 64, 1024)])
def test_prenorm_mlp_grads_match_pallas(n, d, k):
    args = _pnmlp_args(n, d, k, seed=k + 1)
    _check_bwd(F.prenorm_mlp_torch, F.prenorm_mlp_bwd_torch,
               RF.prenorm_mlp_fused, list(map(torch.from_numpy, args)),
               list(map(jnp.asarray, args)), MLP_NAMES)


def _pack(k, v, heads, seg):
    """The reference's block-diagonal packing of k, v [Tk, H], so that
    jax.grad reaches k and v through it."""
    from jax.scipy.linalg import block_diag

    Tk, H = k.shape
    hd = H // heads
    kT = jnp.pad(jnp.transpose(k.reshape(Tk, heads, hd), (1, 2, 0)),
                 ((0, 0), (0, 0), (0, seg - Tk)))
    vp = jnp.pad(jnp.transpose(v.reshape(Tk, heads, hd), (1, 0, 2)),
                 ((0, 0), (0, seg - Tk), (0, 0)))
    return (block_diag(*[kT[h] for h in range(heads)]),
            block_diag(*[vp[h] for h in range(heads)]))


CAB_NAMES = "x wt bt ln_scale ln_bias wq bq k v wo bo".split()


def _cab_grad_case(n, din, h, heads, tk, dtype, seed):
    _, port = _cab_case(n, din, h, heads, tk, seed=seed)
    port = [a.detach() for a in port]
    port[0], port[7], port[8] = (port[i].to(dtype) for i in (0, 7, 8))
    ref = [jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if (dtype == torch.bfloat16 and i in (0, 7, 8))
        else jnp.float32) for i, a in enumerate(port)]

    def ref_fused(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo):
        kbd, vbd = _pack(k, v, heads, RF.attn_seg(tk))
        return RF.cross_attn_block_fused(x, wt, bt, ls, lb, wq, bq, kbd,
                                         vbd, wo, bo, heads, tk)
    return port, ref, ref_fused


@pytest.mark.parametrize("n,din,h,heads,tk", [(21, 64, 64, 4, 5),
                                              (40, 48, 64, 8, 13)])
def test_cross_attn_block_grads_match_pallas(n, din, h, heads, tk):
    port, ref, ref_fused = _cab_grad_case(n, din, h, heads, tk,
                                          torch.float32, seed=n + 2)
    _check_bwd(F.cross_attn_block_torch, F.cross_attn_block_bwd_torch,
               ref_fused, port, ref, CAB_NAMES, extra=(heads,))


def test_bf16_backward_rounding_points_match_pallas():
    """bf16 x, fp32 params: the plain backwards round where the Pallas
    backward kernels round (K1 none, K2/K3 every product operand)."""
    for fwd, bwd, ref, args in (
            (F.seq_adapter_torch, F.seq_adapter_bwd_torch,
             RF.seq_adapter_fused, _seq_args(40, 64, 16, seed=3)),
            (F.prenorm_mlp_torch, F.prenorm_mlp_bwd_torch,
             RF.prenorm_mlp_fused, _pnmlp_args(40, 64, 256, seed=4))):
        port = list(map(torch.from_numpy, args))
        port[0] = port[0].bfloat16()
        refa = [jnp.asarray(args[0], jnp.bfloat16)] + list(
            map(jnp.asarray, args[1:]))
        _check_bwd(fwd, bwd, ref, port, refa, MLP_NAMES, rel=BF16_TOL)
    port, ref, ref_fused = _cab_grad_case(40, 64, 64, 4, 9,
                                          torch.bfloat16, seed=5)
    _check_bwd(F.cross_attn_block_torch, F.cross_attn_block_bwd_torch,
               ref_fused, port, ref, CAB_NAMES, extra=(4,), rel=BF16_TOL)


def test_cross_modal_adapter_grads_match_pallas():
    """Gradients of the whole adapter (shared k/v in torch, K2, K3) with
    respect to every adapter param and the text, over two stacked
    layers, against impl='fused' of the reference: dk and dv reach
    image_proj, norm1, attn.k and attn.v through the shared k/v."""
    rng = np.random.default_rng(11)
    text = rng.normal(size=(3, 7, 64)).astype(np.float32)
    image = jnp.asarray(rng.normal(size=(1, 5, 96)).astype(np.float32))
    t = rng.normal(size=(3, 7, 64)).astype(np.float32)
    ps = [RA.init_cross_modal_adapter(jax.random.PRNGKey(20 + i),
                                      text_dim=64, image_dim=96, hidden=64,
                                      num_heads=4) for i in range(2)]

    def ref_loss(ps, x):
        for p in ps:
            x = RA.cross_modal_adapter(p, x, image, 4, impl="fused")
        return jnp.sum(x * t)

    gp_want, gx_want = jax.grad(ref_loss, argnums=(0, 1))(
        ps, jnp.asarray(text))
    tps = [to_torch(p) for p in ps]
    leaves = [q for p in tps for q in tree_leaves(p)]
    for q in leaves:
        q.requires_grad_(True)
    x = torch.from_numpy(text).requires_grad_(True)
    y = x
    for p in tps:
        y = A.cross_modal_adapter(p, y, torch.from_numpy(np.asarray(image)),
                                  4)
    (y * torch.from_numpy(t)).sum().backward()
    _grad_close(x.grad, gx_want, 1e-4, "text")
    for i, (p, gw) in enumerate(zip(tps, gp_want)):
        want = jax.tree_util.tree_flatten_with_path(gw)[0]
        got = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda q: q.grad, p,
                         is_leaf=lambda q: isinstance(q, torch.Tensor)))[0]
        assert [a for a, _ in want] == [a for a, _ in got]
        for (path, w), (_, g) in zip(want, got):
            _grad_close(g, w, 1e-4, f"layer {i} {jax.tree_util.keystr(path)}")


def _chunked_wgrad(a, b):
    """a^T b as wgrad_mma_kernel sums it: the rows cut into the wrapper's
    ordered chunks (for 128 x 128 output tiles), each chunk's fp32 partial
    product, the partials added in chunk order."""
    n = a.shape[0]
    tiles = -(-a.shape[1] // 128) * -(-b.shape[1] // 128)
    splits = F._tc_splits(n, tiles)
    chunk = -(-n // splits)
    out = torch.zeros(a.shape[1], b.shape[1])
    for s in range(splits):
        rows = slice(s * chunk, (s + 1) * chunk)
        out = out + a[rows].T @ b[rows]
    return out, splits


def _tile_sums(v, rows):
    """Column sums of v per tile of ``rows`` rows, added in tile order
    (colsum_kernel over the row passes' partials)."""
    out = torch.zeros(v.shape[1])
    for r0 in range(0, v.shape[0], rows):
        out = out + v[r0:r0 + rows].sum(0)
    return out


def _k3_bwd_tensor_cores(x, w1, b1, w2, ls, lb, g, eps=1e-5):
    """K3's bf16 backward as its tensor-core passes compute it
    (csrc/fused_adapter.cu, vct_prenorm_mlp_bwd_bf16): um = round(LN(x));
    per 128-row tile pre = um w1 + b1, dh = g w2^T, hm = round(gelu(pre)),
    dpre = dh gelu'(pre), the tile's column sums of the unrounded dpre
    (db1), dpm = round(dpre); du = dpm w1^T in fp32; dx = g + the LN
    backward of du, cast once; per 32-row tile the sums of g, du xhat and
    du; dW1 = um^T dpm and dW2 = hm^T g over ordered row chunks."""
    mm = torch.bfloat16
    xf, gf = x.float(), g.float()
    xhat, inv = F._ln_stats(xf, eps)
    um = F._r(xhat * ls + lb, mm)
    gm, w1m, w2m = F._r(gf, mm), F._r(w1, mm), F._r(w2, mm)
    pre = um @ w1m + b1
    dpre = (gm @ w2m.T) * F.gelu_grad(pre)
    hm, dpm = F._r(torch.nn.functional.gelu(pre), mm), F._r(dpre, mm)
    du = dpm @ w1m.T
    dx = (gf + F._ln_bwd(du * ls, xhat, inv)).to(mm)
    dw1, splits = _chunked_wgrad(um, dpm)
    dw2, _ = _chunked_wgrad(hm, gm)
    return (dx, dw1, _tile_sums(dpre, F.TC_ROWS), dw2,
            _tile_sums(gf, F.LN_ROWS), _tile_sums(du * xhat, F.LN_ROWS),
            _tile_sums(du, F.LN_ROWS)), splits


def test_k3_bwd_tensor_core_passes_match_pallas():
    """600 rows: a ragged last 128-row tile (and 32-row tile), and two
    ordered row chunks in each weight gradient."""
    args = _pnmlp_args(600, 64, 256, seed=9)
    x, w1, b1, w2, b2, ls, lb = map(torch.from_numpy, args)
    xb = x.bfloat16()
    y = F.prenorm_mlp_torch(xb, w1, b1, w2, b2, ls, lb)
    t = np.random.default_rng(8).normal(size=tuple(y.shape)).astype(
        np.float32)
    got, splits = _k3_bwd_tensor_cores(xb, w1, b1, w2, ls, lb,
                                       torch.from_numpy(t).bfloat16())
    assert splits == 2
    refa = [jnp.asarray(args[0], jnp.bfloat16)] + list(
        map(jnp.asarray, args[1:]))
    want = jax.grad(lambda *a: jnp.sum(RF.prenorm_mlp_fused(*a) * t),
                    argnums=tuple(range(7)))(*refa)
    assert got[0].dtype == torch.bfloat16
    for name, gg, w in zip(MLP_NAMES, got, want):
        _grad_close(gg, w, BF16_TOL, name)


def test_k3_fwd_tensor_core_passes_match_pallas():
    """K3's bf16 forward as its three tensor-core passes compute it
    (csrc/fused_adapter.cu, vct_prenorm_mlp_fwd_bf16): um = round(LN(x));
    hm = round(gelu(um w1 + b1)) [n, 4h] in bf16, through device memory;
    y = round((x + b2) + hm w2). 600 rows: a ragged last 128-row tile.
    Against the Pallas forward at the bf16 tolerance (2e-2 absolute and
    relative: only summation order separates them)."""
    args = _pnmlp_args(600, 128, 512, seed=12)
    x, w1, b1, w2, b2, ls, lb = map(torch.from_numpy, args)
    xb = x.bfloat16()
    mm = torch.bfloat16
    xhat, _ = F._ln_stats(xb.float(), 1e-5)
    um = F._r(xhat * ls + lb, mm)
    hm = F._r(torch.nn.functional.gelu(um @ F._r(w1, mm) + b1), mm)
    got = ((xb.float() + b2) + hm @ F._r(w2, mm)).to(mm)
    want = RF.prenorm_mlp_fused(jnp.asarray(args[0], jnp.bfloat16),
                                *map(jnp.asarray, args[1:]))
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 on its bits as cvt.rna.tf32.f32 rounds it: to
    nearest, ties away from zero, 10 mantissa bits (adding half an ulp of
    TF32 to the magnitude's bits, then clearing the 13 low bits)."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b as vct::Tf32Gemm computes it: each fp32 operand split into
    big = tf32(v) and small = tf32(v - big), the products small b + big s
    + big b summed in fp32 (a bf16-valued operand has small = 0: one pass
    fewer; the kernel adds each 8-deep step's passes to its fp32 sum with
    round to nearest, as these fp32 sums round). passes=1: a single TF32
    pass, big b alone."""
    a, b = a.float(), b.float()
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return (_tf32(a - ab) @ bb + ab @ _tf32(b - bb)) + ab @ bb


def _k1_bwd_tensor_cores(x, w1, b1, w2, b2, ls, g, eps=1e-5, passes=3):
    """K1's backward as its TF32 passes compute it (csrc/fused_adapter.cu,
    vct_seq_adapter_bwd_tf32), every product error-compensated: pre = x w1
    + b1 -> h, gelu'(pre); z = (x + h w2) + b2; the LN backward dz and, per
    32-row tile, the sums of dz, g xhat and g; dpre = (dz w2^T) gelu'(pre)
    and its 128-row tile sums; dx = dz + dpre w1^T; dW1 = x^T dpre and
    dW2 = h^T dz over the ordered row chunks of 128 x 64 output tiles."""
    xf, gf = x.float(), g.float()
    n, hdim = xf.shape
    k = w1.shape[1]
    pre = _mm_tf32(xf, w1, passes) + b1
    hh, gp = torch.nn.functional.gelu(pre), F.gelu_grad(pre)
    z = (xf + _mm_tf32(hh, w2, passes)) + b2
    xhat, inv = F._ln_stats(z, eps)
    dz = F._ln_bwd(gf * ls, xhat, inv)
    dpre = _mm_tf32(dz, w2.T, passes) * gp
    dx = (dz + _mm_tf32(dpre, w1.T, passes)).to(x.dtype)

    def wgrad(a, b):
        tiles = -(-a.shape[1] // 128) * -(-b.shape[1] // 64)
        chunk = -(-n // F._tc_splits(n, tiles))
        out = torch.zeros(a.shape[1], b.shape[1])
        for r0 in range(0, n, chunk):
            out = out + _mm_tf32(a[r0:r0 + chunk].T, b[r0:r0 + chunk],
                                 passes)
        return out

    return (dx, wgrad(xf, dpre), _tile_sums(dpre, 128), wgrad(hh, dz),
            _tile_sums(dz, 32), _tile_sums(gf * xhat, 32),
            _tile_sums(gf, 32))


def _k1_case(n, d, k, seed, offset=0.0):
    """K1's inputs; with an offset, weights w = offset + 0.01 u (scaled by
    the fan-in): a large common part that the LayerNorm's backward cancels
    (dz sums to about 0 along a row, so dz w2^T keeps only the 0.01 u
    part), which magnifies each product's rounding error. At offset 0.5
    one TF32 pass misses the fp32 tolerance by 100x or more, the
    compensated products use about a fifth of it (at the train step's
    shapes too, by this emulation); at offset 1 they would use up to
    four fifths: 2^-22 a product is several times fp32's own error."""
    args = _seq_args(n, d, k, seed)
    if offset:
        rng = np.random.default_rng(seed + 1)
        args[1] = (offset + 0.01 * rng.normal(size=(d, k))).astype(
            np.float32) * d ** -0.5
        args[3] = (offset + 0.01 * rng.normal(size=(k, d))).astype(
            np.float32) * k ** -0.5
    return args


def _k1_worst(got, want):
    """Worst |got - want| / (1e-4 * max|want|) over the fp32 gradients
    (dW1, db1, dW2, db2, dls, dlb) and dx."""
    worst = 0.0
    for gg, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        err = np.abs(gg.float().numpy() - w).max()
        worst = max(worst, err / (1e-4 * max(np.abs(w).max(), 1e-2)))
    return worst


def _k1_ref_grads(args, dtype, t):
    refa = [jnp.asarray(args[0], dtype)] + list(map(jnp.asarray, args[1:]))
    return jax.grad(lambda *a: jnp.sum(RF.seq_adapter_fused(*a) * t),
                    argnums=tuple(range(7)))(*refa)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0.0, 0.5])
def test_k1_bwd_compensated_tf32_matches_pallas(dtype, offset):
    """K1's backward on compensated TF32 products, emulated pass by pass,
    against jax.grad of the Pallas kernel at the fp32 tolerance (1e-4 of
    the largest element, every gradient; dx too in fp32, at the bf16
    tolerance in bf16): 300 rows (ragged 128- and 32-row tiles), with and
    without a large common offset in the weights."""
    args = _k1_case(300, 64, 32, seed=31, offset=offset)
    x = torch.from_numpy(args[0]).to(dtype)
    w1, b1, w2, b2, ls, lb = map(torch.from_numpy, args[1:])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    y = F.seq_adapter_torch(x, w1, b1, w2, b2, ls, lb)
    t = np.random.default_rng(3).normal(size=tuple(y.shape)).astype(
        np.float32)
    got = _k1_bwd_tensor_cores(x, w1, b1, w2, b2, ls,
                               torch.from_numpy(t).to(dtype))
    want = _k1_ref_grads(args, jdt, jnp.asarray(t, jdt).astype(jnp.float32))
    assert got[0].dtype == dtype
    if dtype == torch.float32:
        assert _k1_worst(got, want) <= 1.0
    else:
        _grad_close(got[0], want[0], BF16_TOL, "x")
        assert _k1_worst(got[1:], want[1:]) <= 1.0
    # the plain backward the card holds the kernel against agrees too
    plain = F.seq_adapter_bwd_torch(x, w1, b1, w2, b2, ls, lb,
                                    torch.from_numpy(t).to(dtype))
    assert _k1_worst(got[1:], [p.numpy() for p in plain[1:]]) <= 1.0


def test_k1_bwd_single_tf32_pass_fails_on_offset_weights():
    """The negative control: the same emulation with one TF32 pass per
    product misses the fp32 tolerance by a wide margin on weights with a
    large common offset, where the compensated products hold it: the
    tolerance tells the two apart."""
    args = _k1_case(300, 64, 32, seed=31, offset=0.5)
    x, w1, b1, w2, b2, ls, lb = map(torch.from_numpy, args)
    y = F.seq_adapter_torch(x, w1, b1, w2, b2, ls, lb)
    t = np.random.default_rng(3).normal(size=tuple(y.shape)).astype(
        np.float32)
    want = _k1_ref_grads(args, jnp.float32, t)
    g = torch.from_numpy(t)
    three = _k1_worst(_k1_bwd_tensor_cores(x, w1, b1, w2, b2, ls, g), want)
    one = _k1_worst(_k1_bwd_tensor_cores(x, w1, b1, w2, b2, ls, g,
                                         passes=1), want)
    assert three <= 1.0 and one > 10.0, (three, one)


def _k1_fwd_tensor_cores(x, w1, b1, w2, b2, ls, lb, eps=1e-5, passes=3):
    """K1's forward as its TF32 passes compute it (csrc/fused_adapter.cu,
    vct_seq_adapter_fwd): h = gelu(x w1 + b1) and z = (x + h w2) + b2 with
    error-compensated products (x w1 takes two passes for a bf16 x: its
    small part is 0), then y = LN(z) in fp32, rounded once to x's type."""
    xf = x.float()
    hh = torch.nn.functional.gelu(_mm_tf32(xf, w1, passes) + b1)
    z = (xf + _mm_tf32(hh, w2, passes)) + b2
    return F._ln32(z, ls, lb, eps).to(x.dtype)


def _k1_fwd_ratio(got, want):
    """max |got - want| / (1e-4 max |want|): K1's fp32 forward tolerance."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / (1e-4 * np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0.0, 0.5])
def test_k1_fwd_compensated_tf32_matches_pallas(dtype, offset):
    """K1's forward on compensated TF32 products, emulated pass by pass,
    against the Pallas forward: fp32 y within 1e-4 of the largest |y|, bf16
    y at the bf16 tolerance; 300 rows (a ragged 128-row tile), with and
    without a large common offset in the weights."""
    args = _k1_case(300, 64, 32, seed=37, offset=offset)
    x = torch.from_numpy(args[0]).to(dtype)
    w1, b1, w2, b2, ls, lb = map(torch.from_numpy, args[1:])
    got = _k1_fwd_tensor_cores(x, w1, b1, w2, b2, ls, lb)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = RF.seq_adapter_fused(jnp.asarray(args[0], jdt),
                                *map(jnp.asarray, args[1:]))
    assert got.dtype == dtype
    if dtype == torch.float32:
        assert _k1_fwd_ratio(got, want) <= 1.0
    else:
        _bf16_close(got, want)


def test_k1_fwd_single_tf32_pass_fails():
    """The forward's negative control: one TF32 pass per product misses
    the fp32 tolerance where the compensated products hold it, on weights
    without an offset (at offset 0.5, whose weights are scaled by the
    fan-in and so smaller, one pass stays inside the tolerance by this
    emulation: the forward has no LayerNorm backward to magnify it)."""
    args = _k1_case(300, 64, 32, seed=37)
    t = list(map(torch.from_numpy, args))
    want = RF.seq_adapter_fused(*map(jnp.asarray, args))
    three = _k1_fwd_ratio(_k1_fwd_tensor_cores(*t), want)
    one = _k1_fwd_ratio(_k1_fwd_tensor_cores(*t, passes=1), want)
    assert three <= 0.1 and one > 1.0, (three, one)


def _per_head_wgrad(a, b, heads):
    """The per-head weight gradients a_h^T b_h (a [N, heads, P], b [N,
    heads * Q]) as wgrad_mma_kernel sums them for z = heads: ordered row
    chunks for heads x ceil(P/128) x ceil(Q/128) output tiles."""
    n, _, p = a.shape
    q = b.shape[1] // heads
    splits = F._tc_splits(n, heads * -(-p // 128) * -(-q // 128))
    chunk = -(-n // splits)
    out = torch.zeros(p, heads * q)
    for s in range(splits):
        rows = slice(s * chunk, (s + 1) * chunk)
        out = out + torch.cat([a[rows, i].T @ b[rows, i * q:(i + 1) * q]
                               for i in range(heads)], dim=1)
    return out


def _k2_bwd_tensor_cores(x, wt, bt, ls, lb, wq, bq, k, v, wo, g, heads,
                         eps=1e-5):
    """K2's bf16 backward as its tensor-core passes compute it
    (csrc/fused_adapter.cu, vct_cross_attn_block_bwd_bf16): t = x wt + bt
    (fp32); um = round(LN(t)); qm = round(um wq + bq); dom = round(g
    wo^T); per head (one attention block per 128-row tile and head): p in
    fp32, pm = round(p) padded per head to tkp = Tk rounded up to 8 keys,
    om = round(pm v), dp = dom_h v_h^T, dsm = round(p (dp - <dp, p>)
    scale) padded likewise, dqp = dsm k_h, the 128-row tiles' column sums
    of the unrounded dqp (dbq), dqm = round(dqp); du = g + dqm wq^T
    (fp32); dt = the LN backward of du, dtm = round(dt), the 32-row tiles'
    column sums of g, du xhat, du and dt; dx = dtm wt^T; the weight
    gradients over ordered row chunks (dk, dv from the padded pm, dsm,
    their rows past Tk dropped). As the kernel does, x's columns (wt's
    rows) are zero-padded to a multiple of 8 and each head's columns to
    the attention kernel's width (64, or 128 past 64); the zero columns
    change no product."""
    mm = torch.bfloat16
    N, Din = x.shape
    H = wt.shape[1]
    Tk, hd = k.shape[0], H // heads
    tkp = -(-Tk // 8) * 8
    scale = hd ** -0.5
    wide = 64 if hd <= 64 else 128  # cab_bwd_attn_kernel<HD>'s HD
    pad = -Din % 8
    xm, wtm, wqm, wom = (F._r(a, mm) for a in (x, wt, wq, wo))
    xm = torch.nn.functional.pad(xm, (0, pad))
    wtm = torch.nn.functional.pad(wtm, (0, 0, 0, pad))
    km, vm, gf = F._r(k, mm), F._r(v, mm), g.float()
    gm = F._r(gf, mm)
    t = xm @ wtm + bt
    xhat, inv = F._ln_stats(t, eps)
    um = F._r(xhat * ls + lb, mm)
    qm = F._r(um @ wqm + bq, mm)
    dom = F._r(gm @ wom.T, mm)
    om, dqp = torch.zeros(N, H), torch.zeros(N, H)
    pm, dsm = torch.zeros(N, heads, tkp), torch.zeros(N, heads, tkp)
    def head(a, cols):  # a head's columns, zero-padded to the kernel's
        return torch.nn.functional.pad(a[:, cols], (0, wide - hd))

    for i in range(heads):
        cols = slice(i * hd, (i + 1) * hd)
        qh, kh, vh, dh = (head(a, cols) for a in (qm, km, vm, dom))
        p = torch.softmax((qh @ kh.T) * scale, dim=-1)
        pm[:, i, :Tk] = F._r(p, mm)
        om[:, cols] = F._r(pm[:, i, :Tk] @ vh, mm)[:, :hd]
        dp = dh @ vh.T
        dsm[:, i, :Tk] = F._r(
            (p * (dp - (dp * p).sum(-1, keepdim=True))) * scale, mm)
        dqp[:, cols] = (dsm[:, i, :Tk] @ kh)[:, :hd]
    dqm = F._r(dqp, mm)
    du = gf + dqm @ wqm.T
    dt = F._ln_bwd(du * ls, xhat, inv)
    dtm = F._r(dt, mm)
    dx = (dtm @ wtm.T).to(mm)[:, :Din]
    dv = _per_head_wgrad(pm, dom, heads)[:Tk]
    dk = _per_head_wgrad(dsm, qm, heads)[:Tk]
    dwo, splits = _chunked_wgrad(om, gm)
    dwq, _ = _chunked_wgrad(um, dqm)
    dwt, _ = _chunked_wgrad(xm, dtm)
    dwt = dwt[:Din]
    return (dx, dwt, _tile_sums(dt, F.LN_ROWS),
            _tile_sums(du * xhat, F.LN_ROWS), _tile_sums(du, F.LN_ROWS), dwq,
            _tile_sums(dqp, F.TC_ROWS), dk, dv, dwo,
            _tile_sums(gf, F.LN_ROWS)), splits


@pytest.mark.parametrize("tk,din,h", [(5, 128, 128), (197, 128, 128),
                                      (197, 36, 192)])
def test_k2_bwd_tensor_core_passes_match_pallas(tk, din, h):
    """600 rows (a ragged last 128-row tile and 32-row tile; two ordered
    row chunks in each weight gradient), 2 heads of 64 (or of 96, run
    zero-padded to 128, with Din = 36 padded to 40), Tk = 5 and 197 (not
    multiples of 16; padded per head to 8 and 200 keys). Against jax.grad
    of the Pallas forward in interpret mode at the bf16 tolerance: each
    gradient within 2e-2 of its largest element."""
    port, ref, ref_fused = _cab_grad_case(600, din, h, 2, tk,
                                          torch.bfloat16, seed=tk + din)
    y = F.cross_attn_block_torch(*port, 2)
    t = np.random.default_rng(13).normal(size=tuple(y.shape)).astype(
        np.float32)
    args = [a.float() if i not in (0, 7, 8) else a
            for i, a in enumerate(port)]
    got, splits = _k2_bwd_tensor_cores(*args[:10],
                                       torch.from_numpy(t).bfloat16(), 2)
    assert splits == 2
    want = jax.grad(lambda *a: jnp.sum(ref_fused(*a).astype(jnp.float32)
                                       * t),
                    argnums=tuple(range(11)))(*ref)
    assert got[0].dtype == torch.bfloat16
    for name, gg, w in zip(CAB_NAMES, got, want):
        _grad_close(gg, w, BF16_TOL, name)


def _k2_fwd_tensor_cores(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo, heads,
                         eps=1e-5, u_bf16=False):
    """K2's bf16 forward as its tensor-core passes compute it
    (csrc/fused_adapter.cu, vct_cross_attn_block_fwd in bf16): t = x wt +
    bt in fp32 (x's columns, wt's rows zero-padded to a multiple of 8);
    um = round(LN(t)); qm = round(um wq + bq); per head, zero-padded to the
    attention kernel's width (64, or 128 past 64), p = softmax(q k^T
    scale) in fp32 and om = round(round(p) v); y = round(u + (om wo +
    bo)) with the fp32 u (u_bf16: its rounding, which the kernel does not
    add)."""
    mm = torch.bfloat16
    Din, H = wt.shape
    hd = H // heads
    wide = 64 if hd <= 64 else 128
    pad = -Din % 8
    xm = torch.nn.functional.pad(F._r(x, mm), (0, pad))
    wtm = torch.nn.functional.pad(F._r(wt, mm), (0, 0, 0, pad))
    t = xm @ wtm + bt
    xhat, _ = F._ln_stats(t, eps)
    u = xhat * ls + lb
    um = F._r(u, mm)
    qm = F._r(um @ F._r(wq, mm) + bq, mm)
    km, vm = F._r(k, mm), F._r(v, mm)
    om = torch.zeros(x.shape[0], H)
    for i in range(heads):
        cols = slice(i * hd, (i + 1) * hd)
        qh, kh, vh = (torch.nn.functional.pad(a[:, cols], (0, wide - hd))
                      for a in (qm, km, vm))
        p = torch.softmax((qh @ kh.T) * hd ** -0.5, dim=-1)
        om[:, cols] = F._r(F._r(p, mm) @ vh, mm)[:, :hd]
    res = um if u_bf16 else u
    return (res + (om @ F._r(wo, mm) + bo)).to(mm)


def _k2_fwd_case(tk, din, h, seed, offset=0.0):
    """600 rows (a ragged last 128-row tile), 2 heads; with an offset,
    the LN bias of the first 4 columns is raised by it and the output
    bias lowered by it: there u is about `offset` and y is small, so
    rounding u to bf16 before the residual moves y by up to half a bf16
    ulp of the offset."""
    port, ref, ref_fused = _cab_grad_case(600, din, h, 2, tk, torch.bfloat16,
                                          seed=tk + din + 1)
    if offset:
        port[4], port[10] = port[4].clone(), port[10].clone()
        port[4][:4] += offset
        port[10][:4] -= offset
        ref[4], ref[10] = (jnp.asarray(port[i].numpy()) for i in (4, 10))
    return port, ref_fused(*ref)


def _bf16_ratio(got, want):
    """max |got - want| / (BF16_TOL + BF16_TOL |want|)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want)
    return float((err / (BF16_TOL + BF16_TOL * np.abs(want))).max())


@pytest.mark.parametrize("tk,din,h", [(5, 128, 128), (197, 128, 128),
                                      (197, 36, 192)])
def test_k2_fwd_tensor_core_passes_match_pallas(tk, din, h):
    """K2's bf16 forward, emulated pass by pass, against the Pallas
    forward in interpret mode at the bf16 tolerance: 600 rows, 2 heads of
    64 (or of 96, run zero-padded to 128, with Din = 36 padded to 40), Tk
    = 5 and 197."""
    port, want = _k2_fwd_case(tk, din, h, seed=tk + din)
    args = [a.float() if i not in (0, 7, 8) else a
            for i, a in enumerate(port)]
    got = _k2_fwd_tensor_cores(*args, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (600, h)
    _bf16_close(got, want)


def test_k2_fwd_residual_on_a_bf16_u_fails():
    """The negative control: where u is large and y small (LN bias 64 and
    output bias -64 on 4 columns), the emulation with the fp32 u in the
    residual holds the bf16 tolerance against the Pallas forward; the
    same passes with u rounded to bf16 miss it."""
    port, want = _k2_fwd_case(197, 128, 128, seed=0, offset=64.0)
    args = [a.float() if i not in (0, 7, 8) else a
            for i, a in enumerate(port)]
    good = _bf16_ratio(_k2_fwd_tensor_cores(*args, 2), want)
    bad = _bf16_ratio(_k2_fwd_tensor_cores(*args, 2, u_bf16=True), want)
    assert good <= 1.0 and bad > 1.0, (good, bad)


# ---------------------------------------------------------------------------
# shape gates: the kernels' predicates and the route under impl="auto"
# ---------------------------------------------------------------------------

def test_shape_predicates_at_vit_l_widths():
    """K2's gate is the reference's: its fused path takes at most
    ATTN_SEG_MAX shared K/V rows, whatever the widths. ViT-L/14's
    pseudo-image (Tk = 257, or 577 at 336 pixels) fails it and takes the
    plain version, as the reference does; its 96-wide heads at a smaller
    image (Tk = 197) and ViT-B/16's shapes pass. K1 and K3 have no gate:
    their kernels take every width (K = 64 included)."""
    assert F.MAX_SHARED_KV == RF.ATTN_SEG_MAX
    for tk, ok in ((257, False), (577, False), (0, False), (1, True),
                   (197, True), (256, True)):
        assert F.cross_attn_block_supported(tk) is ok, tk
    assert not hasattr(F, "seq_adapter_supported")
    assert not hasattr(F, "prenorm_mlp_supported")


# pipeline M's widths (H 512, K 2048), a K3 of K = 136 (rows of 16
# bytes), and widths whose bf16 rows do not copy in 16-byte chunks
@pytest.mark.parametrize("h,k,tc", [(512, 2048, True), (768, 3072, True),
                                    (64, 136, True), (100, 400, False),
                                    (512, 2044, False), (200, 100, False)])
def test_prenorm_mlp_tensor_core_gate(h, k, tc):
    """K3's route in bf16: the tensor-core passes where H and K are
    multiples of 8, else the CUDA-core kernels (which fp32 takes at every
    width), so no width the reference's kernel takes is refused."""
    assert F.prenorm_mlp_tensor_cores(h, k) is tc


class _OnCuda:
    """Stands in for a CUDA tensor in _pick, which reads only .device."""
    device = torch.device("cuda")


def test_pick_routes_by_the_predicate():
    """impl="auto": a CUDA call whose shapes fail the predicate takes the
    plain version, one whose shapes pass the kernel; a CPU call takes the
    wrapper (which runs its plain version). impl="torch" always the plain
    version; impl="kernel" always the wrapper (which raises on shapes it
    does not take), and refuses a CPU tensor."""
    cuda, cpu = _OnCuda(), torch.zeros(1)
    kern, plain = object(), object()
    assert A._pick("auto", cuda, kern, plain, False) is plain
    assert A._pick("auto", cuda, kern, plain, True) is kern
    assert A._pick("auto", cpu, kern, plain, False) is kern
    for x in (cuda, cpu):
        for ok in (True, False):
            assert A._pick("torch", x, kern, plain, ok) is plain
    assert A._pick("kernel", cuda, kern, plain, False) is kern
    with pytest.raises(ValueError, match="CUDA"):
        A._pick("kernel", cpu, kern, plain, True)
    with pytest.raises(ValueError, match="impl"):
        A._pick("fused", cuda, kern, plain, True)


def test_cross_modal_adapter_past_the_gates_matches_reference():
    """A cross-modal adapter that K2's gate refuses (one 96-wide head,
    Tk = 257, as ViT-L/14's pseudo-image has) computes what the
    reference computes (impl="auto", whose gate takes its plain path
    past 256 shared rows) in fp32."""
    rng = np.random.default_rng(21)
    text = rng.normal(size=(2, 7, 96)).astype(np.float32)
    image = rng.normal(size=(1, 257, 64)).astype(np.float32)
    p = RA.init_cross_modal_adapter(jax.random.PRNGKey(21), text_dim=96,
                                    image_dim=64, hidden=96, num_heads=1)
    assert not F.cross_attn_block_supported(257)
    want = RA.cross_modal_adapter(p, jnp.asarray(text), jnp.asarray(image),
                                  1)
    got = A.cross_modal_adapter(to_torch(p), torch.from_numpy(text),
                                torch.from_numpy(image), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
