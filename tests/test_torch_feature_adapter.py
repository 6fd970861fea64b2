"""K6, the T/V feature adapter blend, in the port against the JAX
package: the plain PyTorch versions (forward, backward, the counter-hash
dropout mask) against the Pallas kernels run through the interpreter on
the CPU, as tests/test_fused_ops.py runs them, and ``adapt_features``
against the reference's composition.

Tolerances: fp32 1e-5 absolute for y (unit-norm rows, the same fp32 math
summed in another order) and 1e-5 of the largest gradient for the
gradients (weight gradients sum over every row, in another order); bf16
2e-2 (both sides widen the same bf16 x and round y once, so one bf16
rounding flip separates them). The dropout mask is compared bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.convert import adapters as RCA
from vlm_clip_tpu.models import adapters as RA
from vlm_clip_tpu.ops import fused_adapter as RF
from vlm_clip_tpu_torch.bridge import tree_leaves
from vlm_clip_tpu_torch.convert import adapters as CA
from vlm_clip_tpu_torch.models import adapters as A
from vlm_clip_tpu_torch.ops import fused_adapter as F

from _torch_port import to_torch

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _case(n, d=64, k=16, seed=0):
    """x (unit-scale rows) and (w1, b1, w2, b2) as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w1 = (rng.normal(size=(d, k)) * d ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(k,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(k, d)) * k ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    return x, (w1, b1, w2, b2), g


def _ref_fwd_bwd(x, params, g, ratio, dtype, dropout=0.0, seed=None):
    """The Pallas kernels' y and (dx, dw1, db1, dw2, db2), as numpy fp32."""
    jx = jnp.asarray(x).astype(JDT[dtype])
    jseed = None if seed is None else jnp.int32(seed)

    def f(x_, *p):
        return RF.feature_adapter_blend_fused(x_, *p, ratio, dropout, jseed)

    y, vjp = jax.vjp(f, jx, *map(jnp.asarray, params))
    grads = vjp(jnp.asarray(g).astype(JDT[dtype]))
    return (np.asarray(y.astype(jnp.float32)),
            [np.asarray(t.astype(jnp.float32)) for t in grads])


def _assert_grads(got, want, tol):
    top = max(float(np.abs(w).max()) for w in want)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy()
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, atol=tol * max(top, 1.0), rtol=0,
                                   err_msg=f"gradient {i}")


# 7 and 37: one ragged TPU tile; 300: two tiles of 256 rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [7, 37, 300])
def test_plain_forward_backward_match_pallas(n, dtype):
    x, params, g = _case(n, seed=n)
    want_y, want_g = _ref_fwd_bwd(x, params, g, 0.2, dtype)
    tx = torch.from_numpy(x).to(dtype)
    tp = [torch.from_numpy(p) for p in params]
    tg = torch.from_numpy(g).to(dtype)
    y = F.feature_adapter_blend_torch(tx, *tp, 0.2)
    assert y.dtype == dtype
    np.testing.assert_allclose(y.float().numpy(), want_y, atol=TOL[dtype])
    grads = F.feature_adapter_blend_bwd_torch(tx, *tp, 0.2, tg)
    assert grads[0].dtype == dtype
    assert all(t.dtype == torch.float32 for t in grads[1:])
    _assert_grads(grads, want_g, TOL[dtype])


def _ranks(parts):
    """The cluster's partials added in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _ranges_matmul(a, w):
    """a @ w in the order of the cluster kernels' products (rows_product):
    the depth cut into S ranges (S = 512 // ncol, at most 8, at least 1,
    from the output columns alone; each range 4-aligned), the ranges'
    partials added in range order."""
    depth, ncol = w.shape
    s = max(1, min(8, 512 // max(ncol, 1)))
    span = (-(-depth // s) + 3) & ~3
    if depth == 0:
        return a @ w
    return _ranks([a[:, t:t + span] @ w[t:t + span]
                   for t in range(0, depth, span)])


def _slices(d):
    """The columns of d each of the cluster's 8 blocks owns: ceil(d / 8),
    the last ones fewer (or none)."""
    ds = -(-d // 8)
    return [slice(q * ds, min(d, (q + 1) * ds)) for q in range(8)]


def _k6_cluster_forward(xg, w1, b1, w2, b2, r, m, cols):
    """K6's forward for one group's rows in the order of the cluster
    kernels' shared device function (csrc/fused_adapter.cu,
    feat_cluster_forward): pre = the blocks' partials x_q W1_q (each over
    its depth ranges, :func:`_ranges_matmul`, as every product here) added
    in rank order, + b1; h = relu(pre) * mask; z_q = r (h W2_q + b2_q) +
    (1 - r) x_q; inv = 1 / |z| from the rows' sums of z_q^2 in rank order.
    Returns (h, [z_q], inv)."""
    pre = _ranks([_ranges_matmul(xg[:, c], w1[c]) for c in cols]) + b1
    h = torch.relu(pre) * m
    z = [r * (_ranges_matmul(h, w2[:, c]) + b2[c]) + (1 - r) * xg[:, c]
         for c in cols]
    inv = torch.rsqrt(_ranks([(zq * zq).sum(1) for zq in z]))[:, None]
    return h, z, inv


def _mask(n, k, dropout, seed):
    return F.feature_dropout_mask(n, k, seed or 0, dropout) if dropout \
        else torch.ones(n, k)


def _k6_fwd_rows(n):
    """Rows a group of K6's cluster forward (feat_fwd_rows in C at widths
    whose shared memory fits): 8 rows a group up to 128 rows, so the
    clusters stay within 16 (one wave of 8-block clusters on the H100),
    more past that, at most 64."""
    tiles = -(-n // 8)
    return min(64, 8 * -(-tiles // 16))


def _k6_fwd_cluster(x, w1, b1, w2, b2, r, dropout, seed, rows):
    """K6's forward in the order of its cluster kernel
    (feature_adapter_fwd_cluster_kernel): groups of ``rows`` rows, each
    the shared forward, then y_q = z_q inv, in x's dtype."""
    xf = x.float()
    n, d = xf.shape
    cols = _slices(d)
    mask = _mask(n, w1.shape[1], dropout, seed)
    y = torch.zeros(n, d)
    for r0 in range(0, n, rows):
        rs = slice(r0, min(n, r0 + rows))
        _, z, inv = _k6_cluster_forward(xf[rs], w1, b1, w2, b2, r, mask[rs],
                                        cols)
        for c, zq in zip(cols, z):
            y[rs, c] = zq * inv
    return y.to(x.dtype)


def _k6_bwd_cluster(x, w1, b1, w2, b2, r, g, dropout, seed, rows):
    """K6's backward in the order its cluster kernel takes
    (csrc/fused_adapter.cu, feature_adapter_bwd_cluster_kernel): groups of
    ``rows`` rows, 8 blocks each owning ds = ceil(d / 8) columns of d
    (the last ones fewer). Per group: the shared forward
    (:func:`_k6_cluster_forward`); the rows' sums of g z added in rank
    order, <g, y> = (g z) inv; dz_q = (g_q - z_q inv <g, y>) inv; dh =
    the partials r (dz_q W2_q^T) in rank order, * mask where h > 0; each
    block's slices of dW1 = x^T dh, dW2 = r (h^T dz), db2 = r (the sum of
    dz) and rank 0's db1 over the group's rows; the groups' partials added
    in group order. Returns (dx, dw1, db1, dw2, db2), dx in x's dtype."""
    xf, gf = x.float(), g.float()
    n, d = xf.shape
    cols = _slices(d)
    mask = _mask(n, w1.shape[1], dropout, seed)
    dx = torch.zeros(n, d)
    grads = None
    for r0 in range(0, n, rows):
        rs = slice(r0, min(n, r0 + rows))
        xg, gg, m = xf[rs], gf[rs], mask[rs]
        h, z, inv = _k6_cluster_forward(xg, w1, b1, w2, b2, r, m, cols)
        gy = _ranks([(gg[:, c] * zq).sum(1) for c, zq in zip(cols, z)]
                    )[:, None] * inv
        dz = [(gg[:, c] - (zq * inv) * gy) * inv for c, zq in zip(cols, z)]
        dh = _ranks([r * _ranges_matmul(dzq, w2[:, c].T)
                     for c, dzq in zip(cols, dz)]) * m
        dh = torch.where(h > 0, dh, 0.0)
        part = (torch.cat([xg[:, c].T @ dh for c in cols]), dh.sum(0),
                torch.cat([r * (h.T @ dzq) for dzq in dz], 1),
                torch.cat([r * dzq.sum(0) for dzq in dz]))
        grads = part if grads is None else [a + b for a, b in
                                            zip(grads, part)]
        for c, dzq in zip(cols, dz):
            dx[rs, c] = (1 - r) * dzq + _ranges_matmul(dh, w1[c].T)
    return (dx.to(x.dtype), *grads)


# n = 1, 7, 35: one group (the T path's rows); 300 with dropout: five
# groups of 64 across the hash's 256-row tiles; d = 100: a ragged last
# slice (13 columns a block, 9 in the last)
@pytest.mark.parametrize("n,d,dropout", [(1, 64, 0.0), (7, 64, 0.0),
                                         (35, 100, 0.0), (300, 64, 0.1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_bwd_cluster_order_matches_pallas(n, d, dropout, dtype):
    """K6's backward in its cluster kernel's order against jax.grad of the
    Pallas K6, at 1e-5 of the largest gradient (fp32) or 2e-2 (bf16, dx
    rounded once)."""
    x, params, g = _case(n, d=d, k=16, seed=n + d)
    seed = 1234 if dropout else None
    _, want = _ref_fwd_bwd(x, params, g, 0.2, dtype, dropout, seed)
    tp = [torch.from_numpy(p) for p in params]
    got = _k6_bwd_cluster(torch.from_numpy(x).to(dtype), *tp, 0.2,
                          torch.from_numpy(g).to(dtype), dropout, seed,
                          rows=min(64, -(-n // 8) * 8))
    assert got[0].dtype == dtype
    _assert_grads(got, want, TOL[dtype])


# n = 1, 7, 35: the T path's rows (one to five groups of 8); 300 with
# dropout: groups of 24 rows (13, the last of 12) across the hash's
# 256-row tiles; d = 100: a ragged last slice (13 columns a block, 9 in
# the last)
@pytest.mark.parametrize("n,d,dropout", [(1, 64, 0.0), (7, 64, 0.0),
                                         (35, 64, 0.0), (300, 64, 0.1),
                                         (35, 100, 0.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_fwd_cluster_order_matches_pallas(n, d, dropout, dtype):
    """K6's forward in its cluster kernel's order against the Pallas
    forward (interpret mode): y within 1e-5 of max|y| in fp32, the bf16
    tolerance in bf16 (y rounded once)."""
    x, params, g = _case(n, d=d, k=16, seed=n + d + 1)
    seed = 4321 if dropout else None
    want, _ = _ref_fwd_bwd(x, params, g, 0.2, dtype, dropout, seed)
    tp = [torch.from_numpy(p) for p in params]
    got = _k6_fwd_cluster(torch.from_numpy(x).to(dtype), *tp, 0.2, dropout,
                          seed, rows=_k6_fwd_rows(n))
    assert got.dtype == dtype
    top = float(np.abs(want).max())
    tol = 1e-5 * top if dtype == torch.float32 else TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


SMEM_FLOATS = 227 * 1024 // 4  # a block's shared memory (SMEM_MAX in C)


def _k6_rows(want, d, k):
    """Rows a group of K6's cluster kernels takes for ``want`` rows
    (feat_rows in C): at most 64, a multiple of 8, cut by 8 while a
    block's row buffers (x, z / dz of its ceil(d / 8) columns, A and h /
    dh of k, per row, beside 4,096 floats of partials) overflow its
    shared memory; where even 8 rows overflow, the buffers go to the
    global workspace and the group keeps its rows."""
    dsp, kp = (-(-d // 8) + 3) & ~3, (k + 3) & ~3

    def floats(rows):
        return rows * (2 * dsp + 2 * kp + 4) + 512 * 8

    rows = min(64, -(-want // 8) * 8)
    if floats(8) > SMEM_FLOATS:
        return rows
    while rows > 8 and floats(rows) > SMEM_FLOATS:
        rows -= 8
    return rows


# D 4100, K 1100: past the widths the kernels once refused (D 4096, K
# 1024). 20 rows with dropout: the forward's groups of 8 rows, the
# backward's of 16 (24 rows' buffers overflow a block's shared memory).
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_k6_cluster_order_at_d4100_k1100_matches_pallas(direction):
    """K6 in its cluster kernels' order at D 4100, K 1100 against the
    Pallas kernel (interpret mode), fp32, dropout 0.1: y within 1e-5 of
    max|y|, the gradients within 1e-5 of the largest one."""
    n, d, k = 20, 4100, 1100
    x, params, g = _case(n, d=d, k=k, seed=11)
    want_y, want_g = _ref_fwd_bwd(x, params, g, 0.2, torch.float32, 0.1,
                                  99)
    tp = [torch.from_numpy(p) for p in params]
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    if direction == "fwd":
        rows = _k6_rows(_k6_fwd_rows(n), d, k)
        assert rows == 8
        got = _k6_fwd_cluster(tx, *tp, 0.2, 0.1, 99, rows)
        np.testing.assert_allclose(got.numpy(), want_y,
                                   atol=1e-5 * float(np.abs(want_y).max()),
                                   rtol=0)
    else:
        rows = _k6_rows(n, d, k)
        assert rows == 16
        got = _k6_bwd_cluster(tx, *tp, 0.2, tg, 0.1, 99, rows)
        _assert_grads(got, want_g, 1e-5)


@pytest.mark.parametrize("seed", [7, 2 ** 31 - 5])
def test_dropout_mask_bit_equal_and_y_agrees(seed):
    """300 rows cross the 256-row tile the hash keys on. The Pallas
    kernel's mask is read out of its forward: with relu(x@W1+b1) = 1,
    W2 = [I | 0], b2 = 0 and r = 1, y's first k columns are the mask over
    its row norm."""
    n, d, k, drop = 300, 64, 16, 0.1
    w1 = np.zeros((d, k), np.float32)
    b1 = np.ones((k,), np.float32)
    w2 = np.zeros((k, d), np.float32)
    w2[:, :k] = np.eye(k, dtype=np.float32)
    b2 = np.zeros((d,), np.float32)
    y = np.asarray(RF.feature_adapter_blend_fused(
        jnp.ones((n, d)), *map(jnp.asarray, (w1, b1, w2, b2)), 1.0, drop,
        jnp.int32(seed)))
    mask = F.feature_dropout_mask(n, k, seed, drop)
    np.testing.assert_array_equal(y[:, :k] > 0, mask.numpy() > 0)
    keep, scale = F.dropout_constants(drop)
    assert keep == int(0.9 * 4294967295.0)
    assert set(np.unique(mask.numpy())) <= {0.0, np.float32(scale)}
    # y and the gradients agree on random weights with this mask
    x, params, g = _case(n, seed=seed % 1000)
    want_y, want_g = _ref_fwd_bwd(x, params, g, 0.3, torch.float32, drop,
                                  seed)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tp = [torch.from_numpy(p) for p in params]
    got = F.feature_adapter_blend_torch(tx, *tp, 0.3, drop, seed)
    np.testing.assert_allclose(got.numpy(), want_y, atol=1e-5)
    _assert_grads(F.feature_adapter_blend_bwd_torch(tx, *tp, 0.3, tg, drop,
                                                    seed), want_g, 1e-5)


def test_fused_wrapper_on_cpu_is_the_plain_version_with_autograd():
    """On CPU tensors the wrapper takes the plain version (no launch) and
    autograd of it equals the written-out backward."""
    x, params, g = _case(19, seed=3)
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = [torch.from_numpy(p).requires_grad_(True) for p in params]
    F.reset_launch_counts()
    y = F.feature_adapter_blend_fused(tx, *tp, 0.25, 0.1, 11)
    (y * torch.from_numpy(g)).sum().backward()
    assert not any(F.launch_counts().values())
    want = F.feature_adapter_blend_bwd_torch(tx.detach(),
                                             *(p.detach() for p in tp), 0.25,
                                             torch.from_numpy(g), 0.1, 11)
    for a, b in zip([tx.grad] + [p.grad for p in tp], want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="dropout"):
        F.feature_adapter_blend_fused(tx, *tp, 0.25, 1.0, 1)
    with pytest.raises(ValueError, match="wrong shapes"):
        F.feature_adapter_blend_fused(tx[:, :8], *tp, 0.25)


@pytest.mark.parametrize("impl", ["torch", "auto"])
@pytest.mark.parametrize("shape", [(7, 32), (2, 5, 32)])
def test_adapt_features_matches_reference(impl, shape):
    """impl="torch" (plain composition) and "auto" (K6 for 2-D x, its
    plain version on the CPU) against the reference's jnp composition."""
    p = RA.init_feature_adapter(jax.random.PRNGKey(1), 32, 8)
    p["fc1"]["bias"] = p["fc1"]["bias"] + 0.1
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = np.asarray(RA.adapt_features(p, jnp.asarray(x), 0.2, impl="jnp"))
    got = A.adapt_features(to_torch(p), torch.from_numpy(x), 0.2, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_adapt_features_dropout_paths():
    """Active dropout: K6 takes a seed drawn from the generator (the hash
    mask, so a given generator state gives one answer); the plain
    composition draws a Bernoulli mask; without a generator both raise,
    as the reference does."""
    p = to_torch(RA.init_feature_adapter(jax.random.PRNGKey(0), 32, 8))
    x = torch.randn(6, 32, generator=torch.Generator().manual_seed(0))
    kw = dict(dropout=0.5, deterministic=False)
    for impl in ("auto", "torch"):
        a = A.adapt_features(p, x, 0.5, generator=torch.Generator()
                             .manual_seed(4), impl=impl, **kw)
        b = A.adapt_features(p, x, 0.5, generator=torch.Generator()
                             .manual_seed(4), impl=impl, **kw)
        torch.testing.assert_close(a, b, atol=0, rtol=0)
        det = A.adapt_features(p, x, 0.5, impl=impl)
        assert not torch.allclose(a, det)
        with pytest.raises(ValueError, match="generator"):
            A.adapt_features(p, x, 0.5, impl=impl, **kw)
    # the kernel path's answer is K6 with the drawn seed
    gen = torch.Generator().manual_seed(4)
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=torch.Generator().manual_seed(4)))
    got = A.adapt_features(p, x, 0.5, generator=gen, impl="auto", **kw)
    want = F.feature_adapter_blend_torch(
        x, p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
        p["fc2"]["bias"], 0.5, 0.5, seed)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_feature_adapter_state_dict_round_trip():
    """fc1/fc2 torch state dicts: the port reads the reference's export
    and writes what the reference reads."""
    p = RA.init_feature_adapter(jax.random.PRNGKey(5), 24, 6)
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in RCA.feature_adapter_to_torch(p).items()}
    tp, want = CA.feature_adapter_from_torch(sd), to_torch(p)
    for layer in ("fc1", "fc2"):
        for key in ("kernel", "bias"):
            torch.testing.assert_close(tp[layer][key], want[layer][key],
                                       atol=0, rtol=0)
    back = RCA.feature_adapter_from_torch(
        {k: v.numpy() for k, v in CA.feature_adapter_to_torch(tp).items()})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
