"""K4's backward in the order of its cluster kernel (csrc/contrastive.cu,
contrastive_bwd_cluster_kernel) against jax.grad of the Pallas K4, run
through the interpreter on the CPU as tests/test_fused_ops.py runs it.

The emulation takes the kernel's order: the cluster's 8 blocks own
slices of ceil(D / 8) columns rounded up to 8 (the last ones fewer, or
none) and ceil(B / 8) rows of Z each; each row's sum of squares is the
slices' partial sums added in rank order; tn, mn = the rows times 1 / |row|;
Z = s (the slices' partial logits added in rank order); the rows' LSE;
each column's LSE merged from the blocks' partials over their rows (the
maximum, the sum of exp(z - maximum)) in rank order; dZ =
g ((softmax_rows - I) + (softmax_cols - I)) / 2B; dls = the blocks' sums
of their rows' sums of dZ Z, in rank order; dtn = s dZ mn, dmn = s dZ^T
tn; each row's <dn, n> from the slices' partials in rank order; the norm
backward.

Tolerance: 1e-5 of the largest gradient (fp32 math through one B x B
product and two softmaxes, summed in another order than XLA's); bf16
inputs widen to fp32 and only dt, dm are rounded once to bf16, so they
are held at 2e-2 of the largest gradient (one bf16 rounding flip).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.ops.contrastive import contrastive_loss_fused as r_k4

CL = 8
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ranks(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _k4_cluster_logits(t, m, log_scale):
    """Steps 1-2 of both cluster kernels, in their order: (tn, mn, t_inv,
    m_inv, s, Z, the rows' LSE, the columns' LSE merged in rank order,
    R: the rows a block owns, the blocks' column slices)."""
    tf, mf = t.float(), m.float()
    b, d = tf.shape
    R = -(-b // CL)
    ds = (-(-d // CL) + 7) // 8 * 8
    cols = [slice(min(d, q * ds), min(d, q * ds + ds)) for q in range(CL)]
    t_inv = torch.rsqrt(_ranks([(tf[:, c] ** 2).sum(1)
                                for c in cols]))[:, None]
    m_inv = torch.rsqrt(_ranks([(mf[:, c] ** 2).sum(1)
                                for c in cols]))[:, None]
    tn, mn = tf * t_inv, mf * m_inv
    s = torch.exp(log_scale.float())
    z = s * _ranks([tn[:, c] @ mn[:, c].T for c in cols])
    lse_r = torch.logsumexp(z, 1)
    pm, ps = [], []
    for q in range(CL):
        rows = z[q * R:min(b, q * R + R)]
        if rows.shape[0]:
            mx = rows.max(0).values
            pm.append(mx)
            ps.append(torch.exp(rows - mx).sum(0))
        else:
            pm.append(torch.full((b,), float("-inf")))
            ps.append(torch.zeros(b))
    top = pm[0]
    for p in pm[1:]:
        top = torch.maximum(top, p)
    lse_c = top + torch.log(_ranks([e * torch.exp(p - top)
                                    for p, e in zip(pm, ps)]))
    return tn, mn, t_inv, m_inv, s, z, lse_r, lse_c, R, cols


def _k4_fwd_cluster(t, m, log_scale):
    """The loss in the forward cluster kernel's order: each block's rows'
    LSE_row(i) - Z_ii and LSE_col(i) - Z_ii summed in row order, the
    blocks' sums added in rank order, (rows / B + columns / B) / 2."""
    _, _, _, _, _, z, lse_r, lse_c, R, _ = _k4_cluster_logits(t, m,
                                                              log_scale)
    b = z.shape[0]
    diag = torch.diagonal(z)
    zero = torch.zeros(())
    st = _ranks([_ranks([zero] + [lse_r[i] - diag[i] for i in
                                  range(q * R, min(b, q * R + R))])
                 for q in range(CL)])
    si = _ranks([_ranks([zero] + [lse_c[i] - diag[i] for i in
                                  range(q * R, min(b, q * R + R))])
                 for q in range(CL)])
    return 0.5 * (st / b + si / b)


def _k4_bwd_cluster(t, m, log_scale, g):
    """(dt, dm, dls) in the cluster kernel's order; dt, dm in t's dtype."""
    tn, mn, t_inv, m_inv, s, z, lse_r, lse_c, R, cols = _k4_cluster_logits(
        t, m, log_scale)
    b = z.shape[0]
    eye = torch.eye(b)
    dz = g * ((torch.exp(z - lse_r[:, None]) - eye)
              + (torch.exp(z - lse_c[None, :]) - eye)) / (2.0 * b)
    rows = (dz * z).sum(1)
    dls = _ranks([_ranks([torch.zeros(())] + [rows[i] for i in
                          range(q * R, min(b, q * R + R))])
                  for q in range(CL)])
    dtn, dmn = s * (dz @ mn), s * (dz.T @ tn)
    sd_t = _ranks([(dtn[:, c] * tn[:, c]).sum(1) for c in cols])[:, None]
    sd_m = _ranks([(dmn[:, c] * mn[:, c]).sum(1) for c in cols])[:, None]
    dt = (dtn - tn * sd_t) * t_inv
    dm = (dmn - mn * sd_m) * m_inv
    return dt.to(t.dtype), dm.to(m.dtype), dls


# 1: one row (dZ = 0); 7: blocks of one row, the last empty; 96: the
# pipeline-M batch (12 rows a block); 200: 25 rows a block (the
# emulation's order at a batch the kernel sends to its multi-kernel route
# at D = 64, past its cluster limit of 160)
# the same batches as below: 1 row; blocks of one row, the last empty;
# the M step's 96; 25 rows a block
@pytest.mark.parametrize("b", [1, 7, 96, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_fwd_cluster_order_matches_pallas(b, dtype):
    """K4's loss in its forward cluster kernel's order against the Pallas
    ``_fwd_kernel`` (interpret mode): within 1e-5 of the loss (fp32 math
    on the same widened inputs, summed in another order)."""
    rng = np.random.default_rng(b + 1)
    txt, img = (rng.normal(size=(b, 64)).astype(np.float32)
                for _ in range(2))
    ls = np.float32(2.6592)
    jt, jm = (jnp.asarray(a).astype(JDT[dtype]) for a in (txt, img))
    want = float(r_k4(jt, jm, jnp.asarray(ls)))
    t, m = (torch.from_numpy(a).to(dtype) for a in (txt, img))
    got = float(_k4_fwd_cluster(t, m, torch.tensor(ls)))
    assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (got, want)


@pytest.mark.parametrize("b", [1, 7, 96, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_bwd_cluster_order_matches_pallas(b, dtype):
    rng = np.random.default_rng(b)
    txt, img = (rng.normal(size=(b, 64)).astype(np.float32)
                for _ in range(2))
    ls = np.float32(2.6592)
    jt, jm = (jnp.asarray(a).astype(JDT[dtype]) for a in (txt, img))
    want = [np.asarray(w.astype(jnp.float32)) for w in jax.grad(
        r_k4, argnums=(0, 1, 2))(jt, jm, jnp.asarray(ls))]
    t, m = (torch.from_numpy(a).to(dtype) for a in (txt, img))
    got = _k4_bwd_cluster(t, m, torch.tensor(ls), torch.tensor(1.0))
    assert got[0].dtype == dtype and got[1].dtype == dtype
    top = max(max(float(np.abs(w).max()) for w in want), 1e-30)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, a, w, tl in zip(("txt", "img", "logit_scale"), got, want,
                              (tol, tol, 1e-5)):
        np.testing.assert_allclose(a.float().numpy(), w, atol=tl * top,
                                   rtol=0, err_msg=name)
