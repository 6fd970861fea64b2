"""vlm_clip_tpu_torch.ops.decode_attention against
vlm_clip_tpu.ops.decode_attention: K8's plain version against the Pallas
kernel (interpret mode on the CPU) at the cases of
tests/test_decode_attention.py, the wrapper and the dispatcher on the CPU,
and the canonical mask through text_forward. Inputs come from numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.ops import decode_attention as RD
from vlm_clip_tpu_torch.ops import decode_attention as PD


def _case(seed, B, T, h, kv, d, S, quant=False, depths=None):
    """Numpy inputs: q, k_old, v_old, k_cur, v_cur, depths, scales."""
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return rng.normal(size=shape).astype(np.float32)

    q, k_cur, v_cur = rn(B, T, h, d), rn(B, T, kv, d), rn(B, T, kv, d)
    if quant:
        k_old = rng.integers(-127, 128, (B, S, kv, d)).astype(np.int8)
        v_old = rng.integers(-127, 128, (B, S, kv, d)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (B, S, kv)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (B, S, kv)).astype(np.float32)
    else:
        k_old, v_old, ks, vs = rn(B, S, kv, d), rn(B, S, kv, d), None, None
    if depths is None:
        depths = rng.integers(0, S + 1 - T, (B,))
    depths = np.asarray(depths, np.int32)
    return q, k_old, v_old, k_cur, v_cur, depths, ks, vs


def _both(case, dtype=torch.float32):
    jx = [None if a is None else jnp.asarray(a) for a in case]
    tx = [None if a is None else torch.from_numpy(a) for a in case]
    if dtype != torch.float32:
        jx = [a.astype(jnp.bfloat16) if a is not None and a.dtype ==
              jnp.float32 and i < 5 else a for i, a in enumerate(jx)]
        tx = [a.to(dtype) if a is not None and a.dtype == torch.float32
              and i < 5 else a for i, a in enumerate(tx)]
    return jx, tx


@pytest.mark.parametrize("T,quant", [(1, False), (3, False), (2, True)])
def test_plain_matches_reference(T, quant):
    """The plain version == the JAX package's
    decode_attention_reference."""
    jx, tx = _both(_case(T, B=4, T=T, h=4, kv=2, d=16, S=40, quant=quant))
    want = RD.decode_attention_reference(*jx)
    got = PD.decode_attention_reference(*tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("T,quant", [(1, False), (1, True), (5, False),
                                     (5, True)])
def test_plain_matches_pallas_kernel(T, quant):
    """The plain version == the Pallas kernel (interpreter) with an
    empty-cache row and a full-depth row, fp32 within 2e-5."""
    case = _case(10 + T, B=3, T=T, h=8, kv=2, d=32, S=96, quant=quant)
    case[5][0], case[5][1] = 0, 96 - T
    jx, tx = _both(case)
    want = RD.decode_attention_pallas(*jx, chunk=32, interpret=True)
    got = PD.decode_attention_kernel(*tx)  # a CPU tensor: the plain one
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("T,quant,dtype,tol", [
    (1, False, torch.bfloat16, 3e-2),   # ragged chunk, the decode dtype
    (5, True, torch.float32, 2e-5),     # ragged chunk, int8 scales
])
def test_plain_matches_pallas_ragged_chunk(T, quant, dtype, tol):
    """S = 80 over 64-column chunks: the padded tail must stay masked
    (the reference's regression was NaN from 0 * garbage)."""
    case = _case(6, B=2, T=T, h=8, kv=2, d=32, S=80, quant=quant,
                 depths=[80 - T, 37])
    jx, tx = _both(case, dtype)
    want = RD.decode_attention_pallas(*jx, chunk=64, interpret=True)
    got = PD.decode_attention_reference(*tx)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_plain_matches_pallas_head_dim_128():
    """The 3B head width, the only one the dispatcher routes."""
    jx, tx = _both(_case(4, B=2, T=2, h=16, kv=2, d=128, S=64, quant=True))
    want = RD.decode_attention_pallas(*jx, chunk=64, interpret=True)
    got = PD.decode_attention_reference(*tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_dispatcher_on_cpu_takes_the_plain_version(impl):
    """On the CPU the dispatcher takes the plain version at a shape its
    gate admits on the card, and launches nothing."""
    _, tx = _both(_case(5, B=2, T=1, h=16, kv=2, d=128, S=128))
    PD.reset_launch_counts()
    assert not PD.kernel_route(tx[0], tx[1])
    got = PD.decode_attention(*tx, impl=impl)
    np.testing.assert_array_equal(got.numpy(),
                                  PD.decode_attention_reference(*tx).numpy())
    assert PD.launch_counts() == {"decode_attention_kernel": 0}


def test_limits_hold_the_rounding_and_catch_a_dropped_chunk():
    """cli/check_decode_attn's limits (shared with chip_smoke.py) admit
    the kernel's rounding point, emulated here: p v in fp32, the output
    rounded to bf16 once; they refuse the output of one 64-column chunk
    fewer."""
    from vlm_clip_tpu_torch.cli import check_decode_attn as C

    gen = torch.Generator().manual_seed(0)
    for T, dtype, quant in C.CASES:
        case = C.rand_case(gen, 2, T, 16, 2, 128, 256, dtype, quant, "cpu")
        want = PD.decode_attention_reference(*case)
        wide = [t.float() if t is not None and t.dtype == torch.bfloat16
                else t for t in case]
        rounded = PD.decode_attention_reference(*wide).to(dtype)
        assert C.compare(rounded, want, case)[1] <= 1.0
        short = list(case)
        short[5] = (case[5] - 64).clamp(min=0)
        assert C.compare(PD.decode_attention_reference(*short), want,
                         case)[1] > 1.0


MNEG = -1e30  # the kernel's masked score


def _k8_split(case, cps, ch=64, rescale=True):
    """K8 as its split kernel computes it (csrc/decode_attention.cu): each
    (row, kv head)'s cache columns in splits of cps columns; within a
    split, chunks of ch columns with an online softmax (scores in fp32
    from q's type, k scales folded in, p = exp(s - running max) summed
    unrounded into l, then times the v scales and rounded to q's type
    before p v); a split wholly at or past the depth is empty. The merge
    takes, in split order, M = the largest running max of the non-empty
    splits, acc = sum acc_s w_s and l = sum l_s w_s with w_s = exp(m_s -
    M) (rescale=False: w_s = 1, the fault the negative test shows), then
    the T fresh columns in fp32 (causal), out = (acc alpha + sum p_t v_t)
    / l in q's type."""
    q, k_old, v_old, k_cur, v_cur, depths, ks, vs = case
    B, T, h, d = q.shape
    S, kv = k_old.shape[1], k_old.shape[2]
    rep, R, mm = h // kv, T * (h // kv), q.dtype
    scale = d ** -0.5
    rows_t = torch.arange(R) // rep
    out = torch.empty(B, T, h, d, dtype=mm)
    for b in range(B):
        depth = min(max(int(depths[b]), 0), S)
        for g in range(kv):
            qg = q[b, :, g * rep:(g + 1) * rep].reshape(R, d).float()
            parts = []
            for cs in range(0, S, cps):
                ce = min(cs + cps, depth)
                if cs >= ce:
                    parts.append(None)
                    continue
                m = torch.full((R,), MNEG)
                l, acc = torch.zeros(R), torch.zeros(R, d)
                for c0 in range(cs, ce, ch):
                    cols = slice(c0, min(c0 + ch, ce))
                    s = qg @ k_old[b, cols, g].to(mm).float().T
                    if ks is not None:
                        s = s * ks[b, cols, g]
                    s = s * scale
                    mn = torch.maximum(m, s.max(1).values)
                    p = torch.exp(s - mn[:, None])
                    alpha = torch.exp(m - mn)
                    l = l * alpha + p.sum(1)
                    if vs is not None:
                        p = p * vs[b, cols, g]
                    acc = acc * alpha[:, None] + p.to(mm).float() @ \
                        v_old[b, cols, g].to(mm).float()
                    m = mn
                parts.append((acc, m, l))
            live = [pt for pt in parts if pt is not None]
            M = torch.stack([pt[1] for pt in live]).max(0).values if live \
                else torch.full((R,), MNEG)
            acc, l = torch.zeros(R, d), torch.zeros(R)
            for pt in live:
                w = torch.exp(pt[1] - M) if rescale else torch.ones(R)
                acc = acc + pt[0] * w[:, None]
                l = l + pt[2] * w
            kf = k_cur[b, :, g].to(mm).float()
            vf = v_cur[b, :, g].to(mm).float()
            causal = torch.arange(T)[None, :] <= rows_t[:, None]
            sf = torch.where(causal, (qg @ kf.T) * scale,
                             torch.tensor(MNEG))
            mn = torch.maximum(M, sf.max(1).values)
            pf = torch.where(causal, torch.exp(sf - mn[:, None]),
                             torch.tensor(0.0))
            alpha = torch.exp(M - mn)
            l = l * alpha + pf.sum(1)
            o = (acc * alpha[:, None] + pf @ vf) / l[:, None]
            out[b, :, g * rep:(g + 1) * rep] = o.reshape(T, rep, d).to(mm)
    return out.reshape(B, T, h * d)


def _k8_case(T, quant, dtype, S=256):
    """The 3B heads (16 q, 2 kv, d 128), S = 256 (four 64-column chunks),
    depths 0, 37 (inside the first split), S - T and 150 (the splits past
    it empty), from numpy."""
    case = _case(40 + T, B=4, T=T, h=16, kv=2, d=128, S=S, quant=quant,
                 depths=[0, 37, S - T, 150])
    return _both(case, dtype)


def _k8_ratio(got, jx, tx):
    """max |got - want| / limit, want the JAX package's reference."""
    from vlm_clip_tpu_torch.cli import check_decode_attn as C

    want = torch.from_numpy(np.array(
        RD.decode_attention_reference(*jx), np.float32))
    return C.compare(got, want, tx)[1]


@pytest.mark.parametrize("cps", [64, 128])
@pytest.mark.parametrize("T,quant,dtype", [
    (1, False, torch.bfloat16), (1, True, torch.bfloat16),
    (16, False, torch.bfloat16), (5, True, torch.bfloat16),
    (1, False, torch.float32), (5, True, torch.float32)])
def test_k8_split_merge_matches_reference(T, quant, dtype, cps):
    """K8's split kernel, emulated (splits of one and of two 64-column
    chunks), against the JAX package's decode_attention_reference within
    cli/check_decode_attn's limits, at depth 0, inside the first split,
    S - T and with splits wholly past the depth; the Pallas kernel
    (interpret mode) agrees on the same inputs."""
    jx, tx = _k8_case(T, quant, dtype)
    got = _k8_split(tx, cps)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert _k8_ratio(got, jx, tx) <= 1.0
    if T == 1 and cps == 64:
        pal = torch.from_numpy(np.array(RD.decode_attention_pallas(
            *jx, chunk=128, interpret=True), np.float32))
        from vlm_clip_tpu_torch.cli import check_decode_attn as C
        assert C.compare(pal, got, tx)[1] <= 1.0


def test_k8_merge_without_rescaling_fails():
    """The negative control: merging the splits' partials without
    rescaling each by exp(m_s - M) exceeds the limit, where the rescaled
    merge holds it."""
    jx, tx = _k8_case(1, False, torch.bfloat16)
    good = _k8_ratio(_k8_split(tx, 64), jx, tx)
    bad = _k8_ratio(_k8_split(tx, 64, rescale=False), jx, tx)
    assert good <= 1.0 and bad > 1.0, (good, bad)


def test_text_forward_mask_none_matches_reference():
    """End to end through a 2-layer stack with per-row depths: the port's
    text_forward(mask=None) (the dispatcher's route) == the JAX
    package's, logits and written cache rows."""
    from vlm_clip_tpu.vlm import qwen_model as QM
    from vlm_clip_tpu_torch.bridge import tree_to_torch
    from vlm_clip_tpu_torch.vlm import qwen_model as PM

    kw = dict(hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=97,
              rope_theta=10_000.0, mrope_section=(4, 2, 2))
    rcfg, pcfg = QM.QwenTextConfig(**kw), PM.QwenTextConfig(**kw)
    params = QM.init_text(jax.random.PRNGKey(0), rcfg)
    pparams = tree_to_torch(jax.tree.map(np.asarray, params))
    B, S = 3, 48
    rng = np.random.default_rng(1)
    k0 = rng.normal(size=(2, B, S, 2, 16)).astype(np.float32)
    emb = rng.normal(size=(B, 1, 64)).astype(np.float32)
    depths = np.asarray([0, 7, 31], np.int32)
    pos3 = np.broadcast_to(depths[None, :, None], (3, B, 1)).copy()
    rc = QM.init_kv_cache(rcfg, B, S)._replace(k=jnp.asarray(k0),
                                               v=jnp.asarray(k0 * 0.5))
    pc = PM.init_kv_cache(pcfg, B, S, dtype=torch.float32, device="cpu")
    pc.k.copy_(torch.from_numpy(k0))
    pc.v.copy_(torch.from_numpy(k0 * 0.5))
    want, rcache = QM.text_forward(params, jnp.asarray(emb),
                                   jnp.asarray(pos3), rcfg, None, rc,
                                   jnp.asarray(depths))
    got, pcache = PM.text_forward(pparams, torch.from_numpy(emb),
                                  torch.from_numpy(pos3), pcfg, None, pc,
                                  torch.from_numpy(depths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(pcache.k.numpy(), np.asarray(rcache.k),
                               atol=1e-5, rtol=1e-5)
