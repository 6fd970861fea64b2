"""NF4 (NormalFloat-4) blockwise quantization with double quantization.

Port of ``vlm_clip_tpu/ops/nf4.py``, the faithful bitsandbytes-semantics
preset (``load_in_4bit, bnb_4bit_quant_type="nf4",
bnb_4bit_use_double_quant=True``): 16 levels at the quantiles of N(0, 1)
instead of int4's 15 uniform ones, so a gaussian weight loses less to
rounding (a lower RMS error than ``ops/quant.py``'s int4 at the same bit
width; ``tests/test_torch_nf4.py`` holds both quantizers to the
reference's).

- blockwise absmax scaling: blocks of ``block`` (default 64) consecutive
  input elements per output column of the [in, out] kernel; each block is
  divided by its absmax and every element rounded to the nearest of the
  16 :data:`NF4_CODE` values (ties to the higher code);
- double quantization of the absmax tensor: subtract its mean
  (``dq_offset``; summed in float64, so the card and the CPU agree where
  the reference's float32 sum may differ from either in its last bits),
  then blockwise-256 symmetric int8 with fp32 second-level scales;
- storage: two code indices per byte, row-pair packed like int4 (even
  input rows in the low nibble).

The matmul keeps the reference's two routes and its cutoff
:data:`_NF4_FUSED_MAX_M`. The reference's route up to 4096 rows is an XLA
select tree fused into two fp32 dots, not a Pallas kernel; here it is
plain PyTorch computing the same function: each nibble plane is
dequantized to fp32 (a 256-entry lookup on the packed byte, scaled by the
block absmax) and ``x_even @ lo + x_odd @ hi`` is taken in fp32. Past
4096 rows the weight is materialized and multiplied in bf16 on the card,
in fp32 on the CPU. The quantizer and the dequantizer run on the
weight's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# The 16 NF4 values: quantiles of N(0,1) normalized to [-1, 1], exactly
# bitsandbytes' NF4 data type. Index 7 is exactly 0.0.
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367,
    -0.39491748809814453, -0.28444138169288635, -0.18477343022823334,
    -0.09105003625154495, 0.0, 0.07958029955625534, 0.16093020141124725,
    0.24611230194568634, 0.33791524171829224, 0.44070982933044434,
    0.5626170039176941, 0.7229568362236023, 1.0], dtype=np.float32)

# decision boundaries for nearest-code rounding (15 midpoints, float32)
_NF4_MID = (NF4_CODE[1:] + NF4_CODE[:-1]) / 2.0

NF4_BLOCK = 64        # first-level block (bitsandbytes default)
NF4_DQ_GROUP = 256    # second-level (double-quant) group size

# the code values of a packed byte's low and high nibble, by byte value
_LO_OF_BYTE = NF4_CODE[np.arange(256) & 0xF]
_HI_OF_BYTE = NF4_CODE[np.arange(256) >> 4]


@dataclasses.dataclass
class NF4Linear:
    """Blockwise NF4 weight + double-quantized absmax.

    ``qweight``: packed uint8 [in_p/2, out], two code indices per byte
    (even logical input rows in the low nibble). ``absmax_q``: int8
    [in_p/block, out]. ``dq_scale``: fp32 [ceil(nblk*out/256)]
    second-level scales. ``dq_offset``: fp32 scalar (the mean of the
    absmax tensor). ``in_features``/``out_features`` keep the logical
    shape (the input dim is zero-padded to a multiple of ``block``).
    Stacked layers carry a leading [L] axis on every tensor (``dq_offset``
    is then [L]).

    A tensor-parallel shard (:func:`shard_nf4`) keeps the whole
    ``dq_scale`` and ``dq_offset``, whose groups run over the unsharded
    absmax flattened row-major: ``dq_cols`` is that absmax's width (0 for
    a whole weight, set on every shard, rank 0's too), and ``dq_row0`` /
    ``dq_col0`` place this ``absmax_q`` in it.
    """
    qweight: torch.Tensor
    absmax_q: torch.Tensor
    dq_scale: torch.Tensor
    dq_offset: torch.Tensor
    bias: Optional[torch.Tensor] = None
    in_features: int = 0
    out_features: int = 0
    block: int = NF4_BLOCK
    dq_cols: int = 0
    dq_row0: int = 0
    dq_col0: int = 0

    @property
    def logical_in(self) -> int:
        return self.in_features

    @property
    def logical_out(self) -> int:
        return self.out_features

    def map(self, fn) -> "NF4Linear":
        """A copy with ``fn`` applied to every tensor (a layer slice)."""
        return dataclasses.replace(
            self, qweight=fn(self.qweight), absmax_q=fn(self.absmax_q),
            dq_scale=fn(self.dq_scale), dq_offset=fn(self.dq_offset),
            bias=None if self.bias is None else fn(self.bias))

    def to(self, device) -> "NF4Linear":
        """A copy on ``device``; every tensor keeps its type."""
        return self.map(lambda t: t.to(device))


def _nearest_code(scaled: torch.Tensor) -> torch.Tensor:
    """[-1, 1] values -> nearest NF4_CODE index (ties to the higher
    code). 15 broadcast compares instead of a [.., 16] distance tensor,
    which would take about 20 GB for the 3B model."""
    idx = torch.zeros(scaled.shape, dtype=torch.uint8, device=scaled.device)
    for m in _NF4_MID:
        idx += scaled >= torch.tensor(m, dtype=torch.float32,
                                      device=scaled.device)
    return idx


def quantize_nf4(w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 block: int = NF4_BLOCK) -> NF4Linear:
    """fp weight [in, out] -> NF4Linear (blockwise NF4 + double quant),
    on the weight's device."""
    if block % 2:
        raise ValueError(f"block must be even (row-pair packing), "
                         f"got {block}")
    w = w.float()
    K, N = w.shape
    pad = (-K) % block
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
    Kp = K + pad
    nblk = Kp // block

    wb = w.reshape(nblk, block, N)
    absmax = wb.abs().amax(dim=1)                           # [nblk, N]
    safe = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    idx = _nearest_code(wb / safe[:, None, :]).reshape(Kp, N)
    packed = idx[0::2] | (idx[1::2] << 4)                   # [Kp/2, N]
    del idx

    # double quantization of absmax: mean offset + blockwise-256 int8.
    # The mean is summed in float64 and the scale divided by a tensor
    # (a CUDA division by a Python scalar multiplies by its reciprocal),
    # so that the card and the CPU give the same bits.
    flat = absmax.reshape(-1)
    offset = flat.mean(dtype=torch.float64).float()
    centered = flat - offset
    gpad = (-centered.shape[0]) % NF4_DQ_GROUP
    cg = F.pad(centered, (0, gpad)).reshape(-1, NF4_DQ_GROUP)
    amax2 = cg.abs().amax(dim=1)
    scale2 = torch.where(amax2 > 0,
                         amax2 / torch.tensor(127.0, device=amax2.device),
                         torch.ones_like(amax2))            # [ngroups]
    aq = torch.clamp(torch.round(cg / scale2[:, None]), -127, 127)
    absmax_q = aq.reshape(-1)[:flat.shape[0]].reshape(nblk, N).to(
        torch.int8)
    return NF4Linear(packed.contiguous(), absmax_q, scale2, offset, bias,
                     K, N, block)


def quantize_nf4_stacked(w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> NF4Linear:
    """Stacked [L, in, out] kernels, quantized one layer at a time (the
    reference's ``vmap``; a layer's temporaries bound the memory) and
    stacked; ``bias`` stays as given."""
    layers = [quantize_nf4(w[i]) for i in range(w.shape[0])]
    first = layers[0]
    return NF4Linear(
        *(torch.stack([getattr(q, f) for q in layers])
          for f in ("qweight", "absmax_q", "dq_scale", "dq_offset")),
        bias=bias, in_features=first.in_features,
        out_features=first.out_features, block=first.block)


def shard_nf4(q: NF4Linear, dim: int, start: int, stop: int) -> NF4Linear:
    """The logical input rows (``dim`` -2; ``start`` and ``stop`` on block
    boundaries) or output columns (``dim`` -1) [start, stop) of ``q``
    (stacked or not): the codes and absmax blocks of those rows or
    columns, the second-level scales whole. A column cut holds the codes
    of quantizing the cut weight bit for bit (blocks run down a column);
    either cut dequantizes to the same rows or columns of the whole
    weight exactly."""
    cols = q.dq_cols or q.absmax_q.shape[-1]
    if dim == -1:
        return dataclasses.replace(
            q, qweight=q.qweight[..., start:stop].clone(),
            absmax_q=q.absmax_q[..., start:stop].clone(),
            bias=None if q.bias is None else q.bias[..., start:stop].clone(),
            out_features=stop - start, dq_cols=cols,
            dq_col0=q.dq_col0 + start)
    if start % q.block or (stop - start) % q.block:
        raise ValueError(f"an NF4 row cut must fall on {q.block}-row block "
                         f"boundaries, got [{start}, {stop})")
    b0, b1 = start // q.block, stop // q.block
    return dataclasses.replace(
        q, qweight=q.qweight[..., start // 2:stop // 2, :].clone(),
        absmax_q=q.absmax_q[..., b0:b1, :].clone(),
        in_features=stop - start, dq_cols=cols, dq_row0=q.dq_row0 + b0)


def _dequant_absmax(q: NF4Linear) -> torch.Tensor:
    """[nblk, out] fp32 block absmax from the double-quantized form."""
    nblk, N = q.absmax_q.shape
    if q.dq_cols:
        # a shard: its elements' places in the unsharded absmax pick
        # their second-level scales
        dev = q.absmax_q.device
        idx = ((torch.arange(nblk, device=dev)[:, None] + q.dq_row0)
               * q.dq_cols + q.dq_col0 + torch.arange(N, device=dev)[None])
        scale = q.dq_scale[idx // NF4_DQ_GROUP]
        return q.absmax_q.float() * scale + q.dq_offset
    flat = q.absmax_q.reshape(-1).float()
    gpad = (-flat.shape[0]) % NF4_DQ_GROUP
    fg = F.pad(flat, (0, gpad)).reshape(-1, NF4_DQ_GROUP)
    dec = fg * q.dq_scale[:, None]
    return dec.reshape(-1)[:nblk * N].reshape(nblk, N) + q.dq_offset


@functools.lru_cache(maxsize=None)
def _byte_tables(device: torch.device):
    """The [256, 1] code values of a packed byte's low and high nibble on
    ``device``, made once a device: a copy from pageable host memory
    would wait for the device's queue at every call."""
    return tuple(torch.from_numpy(t[:, None]).to(device)
                 for t in (_LO_OF_BYTE, _HI_OF_BYTE))


def _planes(q: NF4Linear):
    """(lo, hi): the even and odd input rows' dequantized weights, fp32
    [in_p/2, out] each."""
    byte = q.qweight.int()
    lo_of, hi_of = _byte_tables(q.qweight.device)
    lo = F.embedding(byte, lo_of)
    hi = F.embedding(byte, hi_of)
    am = _dequant_absmax(q)                                 # [nblk, N]
    nblk, N = am.shape
    half = q.block // 2                           # packed rows per block
    out = []
    for plane in (lo, hi):
        plane = plane.view(nblk, half, N)
        plane.mul_(am[:, None, :])
        out.append(plane.view(nblk * half, N))
    return out


def dequantize_nf4(q: NF4Linear, dtype=torch.float32) -> torch.Tensor:
    """NF4Linear -> dense [in_features, out_features] weight."""
    lo, hi = _planes(q)
    Kp2, N = lo.shape
    w = torch.stack([lo, hi], dim=1).reshape(2 * Kp2, N)
    return w[:q.in_features, :q.out_features].to(dtype)


def _nf4_matmul_rowpair(x2: torch.Tensor, q: NF4Linear) -> torch.Tensor:
    """x2 [M, in] -> [M, out] fp32: ``x_even @ lo + x_odd @ hi``, the
    reference's fused route (its select tree computes the same lo, hi)."""
    K = q.in_features
    K2p = q.qweight.shape[0]
    xe = x2[:, 0:K:2].float()
    xo = x2[:, 1:K:2].float()
    # block-padded rows (and the odd-K high nibble): zero x contribution
    xe = F.pad(xe, (0, K2p - xe.shape[1]))
    xo = F.pad(xo, (0, K2p - xo.shape[1]))
    lo, hi = _planes(q)
    return torch.addmm(xe @ lo, xo, hi)


# Cutoff of the row-pair route: the edge of the reference's measurement
# (its fused route won at every measured M up to 4096); bulk prefill
# materializes the weight once instead.
_NF4_FUSED_MAX_M = 4096


def nf4_matmul(x: torch.Tensor, q: NF4Linear, out_dtype=None
               ) -> torch.Tensor:
    """x [.., in] @ dequant(q) [in, out] (+bias), fp32 accumulation.

    M <= 4096 rows: the row-pair route in fp32. More rows: the weight is
    materialized in bf16 on the card (the reference's accelerator
    choice) and fp32 on the CPU, then multiplied. The bias is added in
    fp32; the output is in ``out_dtype`` (default x's).
    """
    lead = x.shape[:-1]
    M = int(np.prod(lead)) if lead else 1
    if M <= _NF4_FUSED_MAX_M:
        y = _nf4_matmul_rowpair(x.reshape(M, x.shape[-1]), q)
        y = y.reshape(*lead, q.out_features)
    else:
        mat_dtype = torch.bfloat16 if x.is_cuda else torch.float32
        w = dequantize_nf4(q, mat_dtype)
        y = torch.matmul(x.to(mat_dtype), w).float()
    if q.bias is not None:
        y = y + q.bias.float()
    return y.to(out_dtype or x.dtype)
