"""Weight-only quantization (int8 / row-pair packed int4) and its matmul,
with the int4 GEMV kernel (K7) and its plain version.

Port of ``vlm_clip_tpu/ops/quant.py``: symmetric per-output-channel
scales, weights stored int8 (``bits=8``) or as two 4-bit nibbles per byte
(``bits=4``; row-pair packing: the low nibble holds input row 2k, the high
nibble row 2k+1, each offset by +8), int4 weights pre-padded at
quantization time to a 1024 x 2048 (packed 1024 x 1024) tile grid.

int8 has no kernel in the reference (its matmul is XLA's fused
dequantize-then-dot, no fp weight in memory). Here it routes by the rows
M of x alone (:func:`int8_route`): on CUDA, 1 <= M <=
``KERNEL_MAX_M_INT8`` (the decode steps) launches
:func:`quant_matmul_int8`, the int8-weight GEMM of ``csrc/quant.cu``,
which forms the reference's operand bf16(q * s) in registers, sums in
fp32, adds the bias in fp32 and casts once; a larger M (prefill, the
vision tower: compute-bound) dequantizes to x's dtype and calls
``torch.matmul``; a CPU tensor takes the kernel's plain twin
:func:`quant_matmul_int8_torch`. ``quant_matmul_int8.launches`` counts
the kernel's launches. int4 routes as the reference does on its chip
(:func:`int4_route`): a GEMV of at most 32 rows on a wide weight launches
:func:`quant_matmul_int4`, the kernel written by hand for Hopper in
``vlm_clip_tpu_torch/csrc/quant.cu`` (replaces ``_qmm4_kernel``
quant.py:233); 32 < M <= 1024 takes the row-pair product
(:func:`_int4_gemv_rowpair`); larger M a bf16 dequantized matmul. On a CPU
tensor every int4 matmul dequantizes, as the reference does off its chip.
``quant_matmul_int4.launches`` counts the kernel's launches.

K7's arithmetic: the nibbles (-8..7) are exact in bf16, so the kernel
runs on the bf16 tensor cores (mma.sync, fp32 accumulation) with the
weight as the A operand, converted nibble pair by nibble pair in
registers, and x^T as the B operand. A bf16 x is an exact operand as it
is. An fp32 x is split into three bf16 terms h = bf16(x), m = bf16(x - h),
l = bf16(x - h - m) that sum to x exactly (above the subnormals, below
bf16's largest finite value, 3.39e38), each multiplied by the same
nibbles: every product is exact, and the result differs from the
reference's fp32 unpack-and-multiply only in summation order (there is
no CUDA-core path).

The reference's ``pallas_ok`` / ``set_int4_pallas_enabled`` exist for
GSPMD tensor parallelism and are not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from vlm_clip_tpu_torch.ops.build import aligned16, load_library

# int4 tile grid of the reference kernel; quantize-time padding targets
# multiples of these (packed rows _I4_TK // 2, columns _I4_TN)
_I4_TN, _I4_TK = 1024, 2048
# the kernel's limits: rows of x (the reference's GEMV route) and columns
# per block (a 64-column tile, 4 warps over the depth)
KERNEL_MAX_M = 32
_COLS_PER_BLOCK = 64
_SMS = 132  # H100 SXM
# the int8 GEMM: the rows its tiles take, its columns per block, its most
# depth slices (blocks of a cluster), and the rows up to which
# quant_matmul routes a CUDA int8 matmul to it: the kernel beat the
# materialize route at all four 8h4 text shapes at every M timed up to
# its tiles' 64 (chip_smoke.py --int8, H100; PERF.md)
INT8_TILE_M = 64
_INT8_COLS_PER_BLOCK = 128
_INT8_MAX_SPLITS = 6
_INT8_BLOCKS = 96  # the blocks the depth slices aim for (H100 sweeps)
KERNEL_MAX_M_INT8 = 64


@dataclasses.dataclass
class QuantizedLinear:
    """Per-output-channel symmetric weight-only quantization.

    ``qweight``: int8 [in, out] (bits=8) or packed uint8 [in/2 -> padded,
    out -> padded] (bits=4); ``scale``: fp32 [out (padded)]; an optional
    fp32 ``bias`` [out]. Stacked layers carry a leading [L] axis on every
    tensor. ``in_features`` / ``out_features`` keep the logical shape of
    an int4 weight (padded rows and columns hold zero nibbles).
    """
    qweight: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    bias: Optional[torch.Tensor] = None
    in_features: Optional[int] = None
    out_features: Optional[int] = None

    @property
    def logical_in(self) -> int:
        if self.in_features is not None:
            return self.in_features
        return self.qweight.shape[-2] * (2 if self.bits == 4 else 1)

    @property
    def logical_out(self) -> int:
        return (self.out_features if self.out_features is not None
                else self.qweight.shape[-1])

    def map(self, fn) -> "QuantizedLinear":
        """A copy with ``fn`` applied to every tensor (a layer slice)."""
        return dataclasses.replace(
            self, qweight=fn(self.qweight), scale=fn(self.scale),
            bias=None if self.bias is None else fn(self.bias))

    def to(self, device) -> "QuantizedLinear":
        """A copy on ``device``; every tensor keeps its type."""
        return self.map(lambda t: t.to(device))


def quantize_weight(w: torch.Tensor, bits: int = 8,
                    bias: Optional[torch.Tensor] = None) -> QuantizedLinear:
    """fp weight [in, out] (or stacked [L, in, out]) -> QuantizedLinear,
    bit for bit the reference's ``quantize_weight``."""
    w = w.float()
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    amax = w.abs().amax(dim=-2)
    qmax = 127.0 if bits == 8 else 7.0
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -qmax, qmax
                    ).to(torch.int8).contiguous()
    if bits == 8:
        return QuantizedLinear(q, scale, 8, bias)
    K, N = w.shape[-2:]
    if K % 2:
        raise ValueError("int4 packing requires even in dim")
    lo = (q[..., 0::2, :] + 8).to(torch.uint8)
    hi = (q[..., 1::2, :] + 8).to(torch.uint8)
    packed = lo | (hi << 4)
    pk2 = (-packed.shape[-2]) % (_I4_TK // 2)
    pn = (-N) % _I4_TN
    if pk2 or pn:  # pay the pad copy once here, never per matmul
        packed = torch.nn.functional.pad(packed, (0, pn, 0, pk2),
                                         value=0x88)  # (0, 0) nibbles
        scale = torch.nn.functional.pad(scale, (0, pn), value=1.0)
    return QuantizedLinear(packed, scale, 4, bias, in_features=K,
                           out_features=N)


def shard_quantized(q: QuantizedLinear, dim: int, start: int,
                    stop: int) -> QuantizedLinear:
    """The logical input rows (``dim`` -2) or output columns (``dim`` -1)
    [start, stop) of ``q`` (stacked or not), for a tensor-parallel rank.
    A column cut is bit for bit ``quantize_weight`` of the cut weight
    (per-output-channel scales; an int4 cut re-padded to the tile grid,
    which also gives K7 its multiple of 16 columns). A row cut keeps the
    whole columns' scales (int4: ``start`` and ``stop`` even, the packed
    rows re-padded), so it dequantizes to those rows of the whole
    weight."""
    bias = q.bias
    if dim == -1:
        bias = None if bias is None else bias[..., start:stop].clone()
        qw, scale = q.qweight[..., start:stop], q.scale[..., start:stop]
        if q.bits == 8:
            return QuantizedLinear(qw.clone(), scale.clone(), 8, bias)
        n = stop - start
        pn = (-n) % _I4_TN
        qw = torch.nn.functional.pad(qw, (0, pn), value=0x88)
        scale = torch.nn.functional.pad(scale, (0, pn), value=1.0)
        return QuantizedLinear(qw.contiguous(), scale.contiguous(), 4, bias,
                               in_features=q.logical_in, out_features=n)
    if q.bits == 8:
        return QuantizedLinear(q.qweight[..., start:stop, :].clone(),
                               q.scale, 8, bias)
    if start % 2 or stop % 2:
        raise ValueError(f"an int4 row cut must hold whole row pairs, got "
                         f"[{start}, {stop})")
    qw = q.qweight[..., start // 2:stop // 2, :]
    pk2 = (-qw.shape[-2]) % (_I4_TK // 2)
    qw = torch.nn.functional.pad(qw, (0, 0, 0, pk2), value=0x88)
    return QuantizedLinear(qw.contiguous(), q.scale, 4, bias,
                           in_features=stop - start,
                           out_features=q.logical_out)


def _unpack(qw: torch.Tensor):
    """Packed uint8 -> (lo, hi) int32 nibbles minus 8 (even, odd rows)."""
    q = qw.to(torch.int32)
    return (q & 0xF) - 8, (q >> 4) - 8


def dequantize_weight(q: QuantizedLinear) -> torch.Tensor:
    """fp32 [in, out] of the logical shape."""
    if q.bits == 8:
        return q.qweight * q.scale.unsqueeze(-2)  # int8 x fp32 -> fp32
    K, N = q.logical_in, q.logical_out  # the tile padding is never read
    lo, hi = _unpack(q.qweight[..., :K // 2, :N])
    out = torch.stack([lo, hi], dim=-2).reshape(*q.qweight.shape[:-2], K, N)
    return out.float() * q.scale[..., None, :N]


def _int4_gemv_rowpair(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """The reference's ``_int4_gemv_xla``: x [M, K] -> [M, N] fp32 as
    ``x_even @ lo*s + x_odd @ hi*s`` over the logical rows and columns
    (the tile-pad columns are sliced off before the products)."""
    K, N = q.logical_in, q.logical_out
    xe = x[:, 0:K:2].float()
    xo = x[:, 1:K:2].float()
    lo, hi = _unpack(q.qweight[:K // 2, :N])
    sf = q.scale[None, :N]
    return xe @ (lo.float() * sf) + xo @ (hi.float() * sf)


def quant_matmul_int4_torch(x: torch.Tensor,
                            q: QuantizedLinear) -> torch.Tensor:
    """K7's plain version (what ``_qmm4_kernel`` computes): fp32 unpack,
    ``(x_even @ (lo-8) + x_odd @ (hi-8)) * scale`` in fp32, fp32 out
    [M, N] over the logical columns."""
    K, N = q.logical_in, q.logical_out
    lo, hi = _unpack(q.qweight[:K // 2, :N])
    acc = x[:, 0:K:2].float() @ lo.float() + x[:, 1:K:2].float() @ hi.float()
    return acc * q.scale[None, :N]


def _lib() -> ctypes.CDLL:
    lib = load_library("quant")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vct_qmm4.argtypes = [I, I, P, P, P, P, P, P] + [I] * 6 + [P]
        lib.vct_qmm4.restype = I
        lib.vct_qmm8.argtypes = [I, P, I, P, P, P, P, I, I, I, I, I, I, P]
        lib.vct_qmm8.restype = I
        lib._typed = True
    return lib


def k_splits(n_cols: int, k_rows: int) -> int:
    """How many ordered depth slices the kernel cuts the packed rows into:
    only where the 64-column tiles cannot cover the 132 SMs twice, and
    never so many that a warp of a tile's four gets under 4 of the
    16-deep steps (8 packed rows each)."""
    blocks = -(-n_cols // _COLS_PER_BLOCK)
    steps = -(-k_rows // 8)
    return max(1, min(-(-2 * _SMS // blocks), steps // 16))


def _launch(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    M, K = x.shape
    N = q.logical_out
    if M > KERNEL_MAX_M or M < 1:
        raise ValueError(f"quant_matmul_int4: the kernel takes 1..."
                         f"{KERNEL_MAX_M} rows, got {M}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul_int4: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if q.bits != 4 or q.qweight.dim() != 2 \
            or q.qweight.dtype != torch.uint8 or K != q.logical_in \
            or q.qweight.shape[0] < K // 2 or q.qweight.shape[1] < N \
            or q.qweight.shape[1] % 16 or q.scale.shape[-1] < N:
        raise ValueError(f"quant_matmul_int4: need a packed int4 weight for "
                         f"x {tuple(x.shape)} (columns padded to a multiple "
                         f"of 16, as quantize_weight pads them), got qweight "
                         f"{tuple(q.qweight.shape)} {q.qweight.dtype} "
                         f"(in {q.logical_in}, out {N})")
    if any(t.device != x.device for t in (q.qweight, q.scale)):
        raise ValueError(f"quant_matmul_int4: all tensors must be on "
                         f"{x.device}")
    if q.scale.dtype != torch.float32:
        raise ValueError("quant_matmul_int4: scale must be float32")
    x = x.contiguous()
    qweight = aligned16(q.qweight)
    scale = q.scale.contiguous()
    bf16 = x.dtype == torch.bfloat16
    # a bf16 x whose rows copy in 16-byte chunks is read in place; an fp32
    # x (three bf16 terms) or another bf16 x goes through the split pass
    direct = bf16 and K % 8 == 0 and x.data_ptr() % 16 == 0
    lib = _lib()
    # the bf16 terms of x, [terms, M, K rounded up to 8]
    xs = None if direct else torch.empty(
        (1 if bf16 else 3) * M * (-(-K // 8) * 8), dtype=torch.bfloat16,
        device=x.device)
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    splits = k_splits(N, K // 2)
    partial = (torch.empty(splits, M, N, dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = lib.vct_qmm4(
            int(bf16), int(direct), x.data_ptr(),
            None if xs is None else xs.data_ptr(),
            qweight.data_ptr(), scale.data_ptr(),
            None if partial is None else partial.data_ptr(), out.data_ptr(),
            M, K, qweight.shape[0], N, qweight.shape[1], splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quant_matmul_int4: CUDA kernel launch failed "
                           f"with cudaError {err}")
    quant_matmul_int4.launches += 1
    return out


def quant_matmul_int4(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """K7: x [M <= 32, K] @ unpack_int4(q) * scale -> fp32 [M, N] (the
    logical columns). A CUDA tensor launches the kernel on the bf16
    tensor cores (an fp32 x as three exact bf16 terms, not on the CUDA
    cores: see the module docstring); a CPU tensor takes
    :func:`quant_matmul_int4_torch`."""
    if x.device.type == "cpu":
        return quant_matmul_int4_torch(x, q)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_int4: no kernel for device "
                         f"{x.device}")
    return _launch(x, q)


quant_matmul_int4.launches = 0


# ---------------------------------------------------------------------------
# int8: the decode linears' GEMM
# ---------------------------------------------------------------------------

def quant_matmul_int8_torch(x: torch.Tensor, q: QuantizedLinear,
                            out_dtype=None) -> torch.Tensor:
    """The int8 kernel's plain twin, the reference's int8 ``quant_matmul``:
    x [.., K] times the operand ``dequantize_weight(q)`` in x's dtype
    (bf16(q * s) for a bf16 x), the product of those values in fp32, the
    fp32 bias added, one cast to ``out_dtype`` (default x's)."""
    w = dequantize_weight(q).to(x.dtype)
    y = torch.matmul(x.float(), w.float())
    if q.bias is not None:
        y = y + q.bias.float()
    return y.to(out_dtype or x.dtype)


def int8_splits(n_cols: int, k_rows: int) -> int:
    """How many ordered depth slices (blocks of one thread-block cluster)
    the int8 kernel cuts a column tile's depth into: about _INT8_BLOCKS
    blocks over the 128-column tiles, at most 6 (past that the cluster's
    merge and scheduling cost more than the blocks bring, H100), and never
    so many that a slice gets under two of the 64-deep stages."""
    tiles = -(-n_cols // _INT8_COLS_PER_BLOCK)
    return max(1, min((_INT8_BLOCKS + tiles // 2) // tiles,
                      _INT8_MAX_SPLITS, k_rows // 128))


def _launch_int8(x: torch.Tensor, q: QuantizedLinear,
                 out_dtype) -> torch.Tensor:
    M, K = x.shape
    out_dtype = out_dtype or x.dtype
    if not 1 <= M <= INT8_TILE_M:
        raise ValueError(f"quant_matmul_int8: the kernel takes 1..."
                         f"{INT8_TILE_M} rows, got {M}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul_int8: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul_int8: out_dtype must be float32 or "
                        f"bfloat16, got {out_dtype}")
    if q.bits != 8 or q.qweight.dim() != 2 \
            or q.qweight.dtype != torch.int8 or q.qweight.shape[0] != K:
        raise ValueError(f"quant_matmul_int8: need an int8 weight [{K}, N] "
                         f"for x {tuple(x.shape)}, got qweight "
                         f"{tuple(q.qweight.shape)} {q.qweight.dtype} "
                         f"(bits {q.bits})")
    N = q.qweight.shape[1]
    bias = q.bias
    if q.scale.dtype != torch.float32 or q.scale.shape != (N,) or (
            bias is not None and bias.shape != (N,)):
        raise ValueError(f"quant_matmul_int8: need a float32 scale [{N}] "
                         f"and a bias [{N}] or none, got scale "
                         f"{tuple(q.scale.shape)} {q.scale.dtype}")
    if any(t.device != x.device for t in (q.qweight, q.scale)) or (
            bias is not None and bias.device != x.device):
        raise ValueError(f"quant_matmul_int8: all tensors must be on "
                         f"{x.device}")
    x = x.contiguous()
    f32 = x.dtype == torch.float32
    # rows of x that copy in 16-byte chunks are read in place; another x
    # is copied once into zero-padded rows
    per = 4 if f32 else 8
    ldx = -(-K // per) * per
    if ldx != K or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, ldx - K))
    qweight = q.qweight.contiguous()
    scale = q.scale.contiguous()
    bias = None if bias is None else bias.float().contiguous()
    vec = N % 16 == 0 and qweight.data_ptr() % 16 == 0
    splits = int8_splits(N, K)
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.vct_qmm8(
            int(f32), x.data_ptr(), ldx, qweight.data_ptr(),
            scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.float32), M, K, N,
            int(vec), splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quant_matmul_int8: CUDA kernel launch failed "
                           f"with cudaError {err}")
    quant_matmul_int8.launches += 1
    return out


def quant_matmul_int8(x: torch.Tensor, q: QuantizedLinear,
                      out_dtype=None) -> torch.Tensor:
    """x [M <= 64, K] @ bf16(q * s) (+bias) -> [M, N] in ``out_dtype``
    (default x's). A CUDA tensor launches the int8 kernel (an fp32 x as
    three exact bf16 terms times the exact int8 values, its scale applied
    to the fp32 sum: see ``csrc/quant.cu``) or raises; a CPU tensor takes
    :func:`quant_matmul_int8_torch`."""
    if x.device.type == "cpu":
        return quant_matmul_int8_torch(x, q, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_int8: no kernel for device "
                         f"{x.device}")
    return _launch_int8(x, q, out_dtype)


quant_matmul_int8.launches = 0


def int4_route(M: int, q: QuantizedLinear, device_type: str) -> str:
    """The reference's int4 routing (quant.py:204-223), "on TPU" read as
    "on CUDA": ``kernel`` (GEMV on a wide weight), ``rowpair``
    (M <= 1024), ``bf16`` (larger M) or ``dequant`` (off the card)."""
    if device_type != "cuda":
        return "dequant"
    if M <= KERNEL_MAX_M and q.qweight.shape[-1] >= 4 * _I4_TN:
        return "kernel"
    return "rowpair" if M <= 1024 else "bf16"


def int8_route(M: int, device_type: str) -> str:
    """An int8 matmul's route by its rows alone: ``kernel`` (CUDA, 1 <= M
    <= ``KERNEL_MAX_M_INT8``), ``dequant`` (CUDA, larger M: the
    materialized weight) or ``plain`` (off the card: the twin)."""
    if device_type != "cuda":
        return "plain"
    return "kernel" if 1 <= M <= KERNEL_MAX_M_INT8 else "dequant"


def quant_matmul(x: torch.Tensor, q: QuantizedLinear, out_dtype=None,
                 impl: str = "auto") -> torch.Tensor:
    """x [.., in] @ dequant(q) [in, out] (+bias), fp32 accumulation, cast
    to ``out_dtype`` (default x's). ``impl="torch"`` takes K7's or the
    int8 kernel's plain version where the kernel would launch (the plain
    route of a check)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if q.bits == 8:
        route = int8_route(x2.shape[0], x.device.type)
        if route != "dequant":
            y = (quant_matmul_int8(x2, q, out_dtype)
                 if route == "kernel" and impl != "torch"
                 else quant_matmul_int8_torch(x2, q, out_dtype))
            return y.reshape(*shape[:-1], -1)
    route = int4_route(x2.shape[0], q, x.device.type) if q.bits == 4 \
        else "dequant"
    if route == "kernel":
        y = (quant_matmul_int4_torch(x2, q) if impl == "torch"
             else quant_matmul_int4(x2, q))
    elif route == "rowpair":
        y = _int4_gemv_rowpair(x2, q)
    elif route == "bf16":
        w = dequantize_weight(q).to(torch.bfloat16)
        y = torch.matmul(x2.to(torch.bfloat16), w).float()
    else:
        w = dequantize_weight(q).to(x.dtype)
        y = torch.matmul(x2, w)
    if q.bias is not None:
        y = y.float() + q.bias.float()
    return y.to(out_dtype or x.dtype).reshape(*shape[:-1], -1)


def reset_launch_counts() -> None:
    quant_matmul_int4.launches = 0
    quant_matmul_int8.launches = 0


def launch_counts() -> dict:
    return {"quant_matmul_int4": quant_matmul_int4.launches,
            "quant_matmul_int8": quant_matmul_int8.launches}
