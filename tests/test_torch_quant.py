"""vlm_clip_tpu_torch.ops.quant against vlm_clip_tpu.ops.quant: the
quantizer bit for bit, K7's plain version against the Pallas kernel (in
interpret mode on the CPU), the row-pair GEMV, the int8 kernel's plain
twin and its arithmetic, the CPU route and the routing tables. Inputs
come from numpy; fp32 unless a case says bf16."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vlm_clip_tpu.ops import quant as RQ
from vlm_clip_tpu_torch.bridge import tree_leaves, tree_to_torch
from vlm_clip_tpu_torch.ops import quant as PQ


def _pair(shape, bits, seed=0, bias=False):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    w[..., :, 3] = 0.0  # an all-zero column: scale 1
    b = rng.normal(size=shape[-1:]).astype(np.float32) if bias else None
    ref = RQ.quantize_weight(jnp.asarray(w), bits,
                             None if b is None else jnp.asarray(b))
    got = PQ.quantize_weight(torch.from_numpy(w), bits,
                             None if b is None else torch.from_numpy(b))
    return w, ref, got


@pytest.mark.parametrize("bits,shape", [(8, (64, 40)), (4, (64, 40)),
                                        (4, (300, 1100)), (8, (6, 10))])
def test_quantize_weight_bit_for_bit(bits, shape):
    _, ref, got = _pair(shape, bits)
    np.testing.assert_array_equal(got.qweight.numpy(),
                                  np.asarray(ref.qweight))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert (got.bits, got.logical_in, got.logical_out) == (
        ref.bits, ref.logical_in, ref.logical_out)
    np.testing.assert_array_equal(PQ.dequantize_weight(got).numpy(),
                                  np.asarray(RQ.dequantize_weight(ref)))


def test_quantize_stacked_matches_per_layer():
    """A stacked [L, in, out] kernel quantizes as each layer alone (the
    reference vmaps the quantizer)."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 32, 2100)).astype(np.float32)
    q = PQ.quantize_weight(torch.from_numpy(w), 4)
    for i in range(3):
        ref = RQ.quantize_weight(jnp.asarray(w[i]), 4)
        np.testing.assert_array_equal(q.qweight[i].numpy(),
                                      np.asarray(ref.qweight))
        np.testing.assert_array_equal(q.scale[i].numpy(),
                                      np.asarray(ref.scale))


@pytest.mark.parametrize("M", [1, 5, 32])
@pytest.mark.parametrize("K,N", [(300, 1100), (2048, 4100)])
def test_int4_plain_matches_pallas_kernel(M, K, N):
    """K7's plain version == quant_matmul_pallas_int4 (interpret mode on
    the CPU) at ragged K and N; fp32 out, atol 1e-4."""
    _, ref, got = _pair((K, N), 4, seed=M)
    x = np.random.default_rng(M + 7).normal(size=(M, K)).astype(np.float32)
    want = RQ.quant_matmul_pallas_int4(jnp.asarray(x), ref.qweight,
                                       ref.scale, out_features=N,
                                       in_features=K)
    out = PQ.quant_matmul_int4_torch(torch.from_numpy(x), got)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    # the wrapper takes the plain version on a CPU tensor, no launch
    PQ.reset_launch_counts()
    np.testing.assert_array_equal(
        PQ.quant_matmul_int4(torch.from_numpy(x), got).numpy(), out.numpy())
    assert PQ.launch_counts() == {"quant_matmul_int4": 0,
                                  "quant_matmul_int8": 0}


@pytest.mark.parametrize("M", [1, 40])
def test_rowpair_gemv_matches_reference(M):
    _, ref, got = _pair((300, 1100), 4, seed=3)
    x = np.random.default_rng(4).normal(size=(M, 300)).astype(np.float32)
    want = RQ._int4_gemv_xla(jnp.asarray(x), ref)
    out = PQ._int4_gemv_rowpair(torch.from_numpy(x), got)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_quant_matmul_cpu_route_matches_reference(bits, out_dtype):
    """Off the card both packages dequantize and take one product, bias
    added in fp32; a 3-D x keeps its leading axes."""
    _, ref, got = _pair((64, 40), bits, seed=5, bias=True)
    x = np.random.default_rng(6).normal(size=(2, 3, 64)).astype(np.float32)
    want = RQ.quant_matmul(jnp.asarray(x).reshape(6, 64), ref,
                           out_dtype=None if out_dtype is None
                           else jnp.float32).reshape(2, 3, 40)
    out = PQ.quant_matmul(torch.from_numpy(x), got, out_dtype=out_dtype)
    assert out.shape == (2, 3, 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_int4_route_is_the_references():
    """The reference's shape routing, "on TPU" read as "on CUDA"."""
    wide = PQ.QuantizedLinear(torch.zeros(1024, 4096, dtype=torch.uint8),
                              torch.ones(4096), 4, in_features=2048,
                              out_features=4096)
    narrow = dataclasses.replace(wide, qweight=torch.zeros(
        1024, 3072, dtype=torch.uint8), out_features=3000)
    assert PQ.int4_route(8, wide, "cuda") == "kernel"
    assert PQ.int4_route(32, wide, "cuda") == "kernel"
    assert PQ.int4_route(33, wide, "cuda") == "rowpair"
    assert PQ.int4_route(8, narrow, "cuda") == "rowpair"
    assert PQ.int4_route(1024, wide, "cuda") == "rowpair"
    assert PQ.int4_route(1025, wide, "cuda") == "bf16"
    assert PQ.int4_route(8, wide, "cpu") == "dequant"


def test_k_splits_fill_the_card():
    """Ordered depth slices only where the 64-column tiles cannot cover
    the card twice: the 8h4 head (2,374 tiles) and the gateup (344) in
    one, a 4096-column weight (64 tiles) in 5; never so many that a warp
    gets under 4 of the 16-deep steps."""
    assert PQ.k_splits(151936, 1024) == 1
    assert PQ.k_splits(22016, 1024) == 1
    assert PQ.k_splits(4096, 1024) == 5
    assert PQ.k_splits(4100, 1024) == 5
    assert PQ.k_splits(4096, 32) == 1


# ---------------------------------------------------------------------------
# K7's tensor-core arithmetic (csrc/quant.cu), emulated in numpy/torch
# ---------------------------------------------------------------------------

def _bf16_bits(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> their fp32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _int4_pairs(w: np.ndarray, w4: np.ndarray, q: int):
    """vct::int4_pairs on uint32 words: byte q of packed rows r (w) and
    r + 4 (w4) -> (lo pair, hi pair) of bf16 weights as fp32 values
    [..., 2], the lower element first. prmt puts the two bytes at byte 0
    and 2; OR-ing a nibble into 0x4300 gives 128 + v; subtracting 136
    (exact in bf16, as the hardware's bf16 subtraction rounds an exact
    result to itself) leaves v - 8."""
    b = ((w >> (8 * q)) & 0xFF) | (((w4 >> (8 * q)) & 0xFF) << 16)
    out = []
    for word in ((b & 0x000F000F) | 0x43004300,
                 ((b >> 4) & 0x000F000F) | 0x43004300):
        halves = np.stack([word & 0xFFFF, word >> 16], -1)
        out.append(_bf16_bits(halves) - np.float32(136.0))
    return out


def test_k7_nibble_to_bf16_all_values():
    """Every packed byte (both nibbles, all 16 values each) in both
    positions of the pair converts to exactly nib - 8, and each pair's
    low half comes from packed row r, its high half from r + 4."""
    v = np.arange(256, dtype=np.uint32)
    other = v[::-1].copy()
    for q in range(4):
        lo, hi = _int4_pairs(v << (8 * q), other << (8 * q), q)
        np.testing.assert_array_equal(lo[:, 0], (v & 0xF).astype(np.float32)
                                      - 8)
        np.testing.assert_array_equal(hi[:, 0], (v >> 4).astype(np.float32)
                                      - 8)
        np.testing.assert_array_equal(lo[:, 1], (other & 0xF).astype(
            np.float32) - 8)
        np.testing.assert_array_equal(hi[:, 1], (other >> 4).astype(
            np.float32) - 8)
    # every value the conversion produces is an integer in -8..7, exact
    # in bf16 (its bits survive a round trip)
    vals = np.arange(-8, 8, dtype=np.float32)
    np.testing.assert_array_equal(
        torch.from_numpy(vals).bfloat16().float().numpy(), vals)


def _split3(x: torch.Tensor):
    """The kernel's three bf16 terms of an fp32 x: h = bf16(x),
    m = bf16(x - h), l = bf16(x - h - m)."""
    h = x.bfloat16()
    r = x - h.float()
    m = r.bfloat16()
    return h, m, (r - m.float()).bfloat16()


def test_k7_three_bf16_terms_reproduce_fp32_x():
    """h + m + l == x exactly for fp32 x over many binades (normal
    values, below bf16's largest finite 3.39e38, past which h rounds to
    inf), the edge cases of bf16 rounding included."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=200000) * np.exp2(rng.integers(-60, 60, 200000))
         ).astype(np.float32)
    edge = np.array([1.0, -1.0, 1 + 2 ** -8, 1 + 2 ** -9 + 2 ** -23,
                     1 - 2 ** -24, 3.3e38, -1.1754944e-38 * 4, 0.0],
                    dtype=np.float32)
    x = torch.from_numpy(np.concatenate([x, edge]))
    h, m, l = _split3(x)
    total = h.double() + m.double() + l.double()
    assert torch.equal(total, x.double())


def _k7_tensor_cores(x: torch.Tensor, q) -> np.ndarray:
    """K7 as csrc/quant.cu computes it, fragment by fragment: per 16-deep
    step s, lane (g, t) of the warp on a 64-column tile reads bytes
    8g .. 8g + 7 of packed rows 8s + t and 8s + t + 4; int4_pairs turns
    byte q into tile q's A registers (row g from word 0, row g + 8 from
    word 1: columns 8g + q and 8g + 4 + q), with logical k (2t, 2t + 1)
    = physical (2t, 2t + 8) and (2t + 8, 2t + 9) = (2t + 1, 2t + 9);
    B takes x (each bf16 term) in that order. fp32 sums per quarter of
    the depth (the block's 4 warps), added in warp order, then * scale."""
    M, K = x.shape
    N = q.logical_out
    packed = q.qweight.numpy().astype(np.uint32)
    K2p, ldw = packed.shape
    steps = -(-K // 16)
    terms = [x] if x.dtype == torch.bfloat16 else list(_split3(x.float()))
    xs = [np.pad(t.float().numpy(), ((0, 0), (0, 16 * steps - K)))
          for t in terms]
    g = np.arange(8)[:, None]
    t = np.arange(4)[None, :]
    # logical -> physical k inside a step, for (t, slot 0..3 of 2t, 2t + 1,
    # 2t + 8, 2t + 9)
    phys = np.stack([2 * t, 2 * t + 8, 2 * t + 1, 2 * t + 9], -1)[0]  # [4,4]
    logical = np.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], -1)[0]
    per = -(-steps // 4)
    out = np.zeros((M, ldw), np.float32)
    for c0 in range(0, ldw, 64):
        quarter_sums = []
        for w in range(4):
            acc = np.zeros((64, M), np.float32)
            for s in range(w * per, min(steps, (w + 1) * per)):
                A = np.zeros((64, 16), np.float32)  # [column, logical k]
                for h in range(2):  # word 0: rows g, word 1: rows g + 8
                    for qq in range(4):
                        cols = c0 + 8 * g + 4 * h + qq            # [8, 1]
                        rows = 8 * s + t                          # [1, 4]
                        w0 = np.zeros((8, 4), np.uint32)
                        w1 = np.zeros((8, 4), np.uint32)
                        ok0 = rows < K2p
                        ok1 = rows + 4 < K2p
                        w0[:, ok0[0]] = packed[np.clip(rows, 0, K2p - 1),
                                               cols][:, ok0[0]] << (8 * qq)
                        w1[:, ok1[0]] = packed[np.clip(rows + 4, 0, K2p - 1),
                                               cols][:, ok1[0]] << (8 * qq)
                        lo, hi = _int4_pairs(w0, w1, qq)          # [8,4,2]
                        a_col = (8 * g + 4 * h + qq)[:, 0]
                        for tt in range(4):
                            A[a_col, logical[tt, 0]] = lo[:, tt, 0]
                            A[a_col, logical[tt, 1]] = lo[:, tt, 1]
                            A[a_col, logical[tt, 2]] = hi[:, tt, 0]
                            A[a_col, logical[tt, 3]] = hi[:, tt, 1]
                for xt in xs:
                    B = np.zeros((16, M), np.float32)  # [logical k, row]
                    for tt in range(4):
                        for j in range(4):
                            B[logical[tt, j]] = xt[:, 16 * s + phys[tt, j]]
                    acc = acc + A @ B  # exact products, fp32 sums
            quarter_sums.append(acc)
        tot = ((quarter_sums[0] + quarter_sums[1]) + quarter_sums[2]) \
            + quarter_sums[3]
        out[:, c0:c0 + 64] = tot.T
    return out[:, :N] * q.scale.numpy()[None, :N]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 5])
def test_k7_tensor_core_emulation_matches_pallas(dtype, M):
    """The swapped bf16 product, emulated fragment by fragment, against
    quant_matmul_pallas_int4 (interpret mode) at 1e-4: K = 300 (a ragged
    last 16-deep step), N = 130 (a ragged last 64-column tile of the
    padded weight)."""
    K, N = 300, 130
    _, ref, got = _pair((K, N), 4, seed=20 + M)
    x = torch.from_numpy(np.random.default_rng(M).normal(
        size=(M, K)).astype(np.float32)).to(dtype)
    want = RQ.quant_matmul_pallas_int4(jnp.asarray(x.float().numpy()),
                                       ref.qweight, ref.scale,
                                       out_features=N, in_features=K)
    out = _k7_tensor_cores(x, got)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The int8 GEMM (csrc/quant.cu qmm8_mma_kernel): its twin, arithmetic, route
# ---------------------------------------------------------------------------

def _int8_bf16_case(M, K, N, bias, seed):
    """(reference QuantizedLinear, port QuantizedLinear, bf16 x [M, K])."""
    _, ref, got = _pair((K, N), 8, seed=seed, bias=bias)
    x = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(M, K)).astype(np.float32)).bfloat16()
    return ref, got, x


def _reference_fp32(ref, x: torch.Tensor) -> np.ndarray:
    """The reference's quant_matmul on a bf16 x, fp32 out: its operand
    bf16(q * s), fp32 accumulation, the bias added in fp32."""
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return np.asarray(RQ.quant_matmul(xj, ref, out_dtype=jnp.float32))


def _fp32_gap(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got - want| over 1e-5 (1 + |want|): at most 1 when the two
    differ only in the order of their fp32 sums (the bf16-valued operands
    are exact, products too), as the twin and the kernel do."""
    g = got.float().numpy()
    return float((np.abs(g - want) / (1e-5 * (1 + np.abs(want)))).max())


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M,K,N", [(1, 64, 40), (5, 300, 130),
                                   (32, 2048, 96)])
def test_int8_twin_matches_reference_bf16(bias, M, K, N):
    """The int8 kernel's twin on a bf16 x against the reference's
    quant_matmul: fp32 out within fp32's summation order; bf16 out, one
    cast of those sums, within half a bf16 ulp of the fp32 result."""
    ref, got, x = _int8_bf16_case(M, K, N, bias, seed=30 + M)
    want = _reference_fp32(ref, x)
    y32 = PQ.quant_matmul_int8_torch(x, got, torch.float32)
    assert y32.dtype == torch.float32 and y32.shape == (M, N)
    assert _fp32_gap(y32, want) <= 1.0
    y = PQ.quant_matmul_int8_torch(x, got)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(),
                                  y32.bfloat16().float().numpy())
    # quant_matmul takes the twin on the CPU, a 3-D x keeping its axes
    y3 = PQ.quant_matmul(x.reshape(1, M, K), got, out_dtype=torch.float32)
    assert y3.shape == (1, M, N) and torch.equal(y3[0], y32)


@pytest.mark.parametrize("bias", [False, True])
def test_int8_parent_arithmetic_fails_the_check(bias):
    """Negative control for the check above: the materialize route's
    arithmetic (a bf16 product, rounded to bf16 before the bias is added)
    is out by about a bf16 ulp, far past fp32's summation order."""
    ref, got, x = _int8_bf16_case(32, 2048, 96, bias, seed=41)
    want = _reference_fp32(ref, x)
    y = torch.matmul(x, PQ.dequantize_weight(got).to(torch.bfloat16))
    if got.bias is not None:
        y = y.float() + got.bias.float()
    assert _fp32_gap(y.float(), want) > 10.0


def test_int8_byte_conversion_all_values():
    """The kernel's operand, emulated on uint32 words: every int8 value,
    stored as b + 128 (xor 0x80) under the exponent bits of 2^23 (prmt
    with 0x4B000000), less 2^23 + 128, is b exactly; times an fp32 scale
    and rounded to bf16 it is dequantize_weight's value in bf16, bit for
    bit, over scales of many binades."""
    b = np.arange(-128, 128, dtype=np.int8)
    u = b.view(np.uint8).astype(np.uint32) ^ 0x80
    f = (u | np.uint32(0x4B000000)).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f, b.astype(np.float32))
    rng = np.random.default_rng(5)
    scale = (rng.uniform(0.5, 1.0, 64) * np.exp2(rng.integers(-30, 10, 64))
             ).astype(np.float32)
    q = PQ.QuantizedLinear(torch.from_numpy(np.tile(b[:, None], (1, 64))),
                           torch.from_numpy(scale), 8)
    want = PQ.dequantize_weight(q).to(torch.bfloat16)
    got = torch.from_numpy(f[:, None] * scale[None, :]).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_int8_route_by_rows():
    """The int8 route reads the rows alone: the kernel on CUDA for 1..
    KERNEL_MAX_M_INT8 (decode steps, the engine's chunks, speculative
    verify when it fits), the materialized weight past it (the text
    prefill's 9,504 rows, the vision tower's 32,768), the twin off the
    card."""
    top = PQ.KERNEL_MAX_M_INT8
    assert 32 <= top <= PQ.INT8_TILE_M
    for M in (1, 32, top):
        assert PQ.int8_route(M, "cuda") == "kernel"
    for M in (0, top + 1, 9504, 32768):
        assert PQ.int8_route(M, "cuda") == "dequant"
    assert PQ.int8_route(32, "cpu") == "plain"


def test_int8_splits_fill_the_card():
    """Ordered depth slices (a cluster's blocks) where the 128-column tiles
    leave the SMs idle, about 96 blocks, at most 6: the 8h4 gateup (172
    tiles) in one, o and down (16 tiles) in 6, qkv (20) in 5, a tensor-
    parallel half of o (8) in 6; never a slice under two 64-deep stages."""
    assert PQ.int8_splits(22016, 2048) == 1
    assert PQ.int8_splits(2048, 2048) == 6
    assert PQ.int8_splits(2048, 11008) == 6
    assert PQ.int8_splits(2560, 2048) == 5
    assert PQ.int8_splits(1024, 2048) == 6
    assert PQ.int8_splits(2048, 128) == 1


@pytest.mark.parametrize("M", [1, 32, "top", "past"])
def test_int8_quant_matmul_routes_by_rows(monkeypatch, M):
    """quant_matmul on a device read as CUDA: the kernel's wrapper at
    1..KERNEL_MAX_M_INT8 rows (impl="torch": the twin there), the
    materialize route past them."""
    top = PQ.KERNEL_MAX_M_INT8
    M = {"top": top, "past": top + 1}.get(M, M)
    route = PQ.int8_route
    monkeypatch.setattr(PQ, "int8_route", lambda m, _: route(m, "cuda"))
    calls = []

    def spy(x, q, out_dtype=None):
        calls.append((tuple(x.shape), out_dtype))
        return PQ.quant_matmul_int8_torch(x, q, out_dtype)

    monkeypatch.setattr(PQ, "quant_matmul_int8", spy)
    _, _, got = _pair((64, 40), 8, seed=7, bias=True)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(M, 64)).astype(np.float32)).bfloat16()
    y = PQ.quant_matmul(x.reshape(1, M, 64), got)
    assert y.shape == (1, M, 40) and y.dtype == torch.bfloat16
    if M <= top:
        assert calls == [((M, 64), None)]
        assert torch.equal(y[0], PQ.quant_matmul_int8_torch(x, got))
        PQ.quant_matmul(x, got, impl="torch")
        assert len(calls) == 1
    else:
        assert calls == []
        w = PQ.dequantize_weight(got).to(torch.bfloat16)
        want = (torch.matmul(x, w).float() + got.bias).bfloat16()
        assert torch.equal(y[0], want)


def test_bridge_carries_quantized_linears():
    """A reference tree with QuantizedLinear leaves crosses to the port's
    QuantizedLinear, integer weights keeping their types."""
    import jax

    _, ref8, _ = _pair((64, 40), 8, bias=True)
    _, ref4, _ = _pair((300, 1100), 4)
    tree = jax.tree.map(np.asarray, {"a": {"q": ref8}, "h": ref4})
    port = tree_to_torch(tree)
    q8, q4 = port["a"]["q"], port["h"]
    assert isinstance(q8, PQ.QuantizedLinear) and q8.bits == 8
    assert q8.qweight.dtype == torch.int8 and q4.qweight.dtype == torch.uint8
    assert (q4.in_features, q4.out_features) == (300, 1100)
    np.testing.assert_array_equal(q4.qweight.numpy(),
                                  np.asarray(ref4.qweight))
    assert len(tree_leaves(port)) == 5  # q8: qweight, scale, bias; q4: 2
    moved = q8.to("cpu")
    assert moved.qweight.dtype == torch.int8 and moved.bias is not None
    np.testing.assert_array_equal(moved.scale.numpy(), q8.scale.numpy())
