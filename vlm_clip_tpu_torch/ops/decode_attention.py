"""GQA decode attention over a KV cache (K8), with its plain version and
the dispatcher of the cached decode path.

Port of ``vlm_clip_tpu/ops/decode_attention.py``. The canonical decode
contract: q [B, T, h, d] attends cache columns ``col < depth_b`` (per-row
depths [B]) plus a causal triangle over the T fresh columns (fresh
position i attends fresh columns <= i). With an int8 cache the per-row
scales fold in algebraically: k scales into the scores, v scales into the
probs before the p v product.

:func:`decode_attention_reference` is the plain version (the reference's
of the same name). :func:`decode_attention_kernel` launches the kernel
written by hand for Hopper in ``vlm_clip_tpu_torch/csrc/decode_attention.cu``
(replaces ``_make_kernel`` decode_attention.py:130) on CUDA tensors and
takes the plain version on CPU tensors; ``.launches`` counts its launches.
The kernel splits each row's cache columns across blocks
(:func:`kernel_splits`), each block rounding p against its own running
max, and merges the splits in order inside the same launch.
:func:`decode_attention` dispatches with the reference's shape gate: the
kernel when the tensors are on the card, ``d % 128 == 0``, ``S >= 128``
and ``T <= 16``; the plain version otherwise, or with ``impl="torch"``.
The reference keeps its TPU kernel behind an opt-in flag
(``VLM_CLIP_DECODE_ATTN_PALLAS``) because it measured a loss there; on
the H100 the kernel is faster than the plain version at every decode
shape measured, so the port routes to it by default and has no flag.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from vlm_clip_tpu_torch.ops.build import aligned16, load_library

_NEG = float(torch.finfo(torch.float32).min)  # additive-mask -inf
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def decode_attention_reference(q, k_old, v_old, k_cur, v_cur, depths,
                               k_scale=None, v_scale=None):
    """The plain version: q [B,T,h,d], k_old/v_old [B,S,kv,d] (q's type,
    or int8 with k_scale/v_scale [B,S,kv]), k_cur/v_cur [B,T,kv,d],
    depths [B] -> [B, T, h*d] in q's type."""
    B, T, h, d = q.shape
    S, kv = k_old.shape[1], k_old.shape[2]
    rep = h // kv
    dev = q.device
    qg = q.reshape(B, T, kv, rep, d)
    cols = torch.arange(S, device=dev)
    neg = torch.full((), _NEG, device=dev)  # a fill: a graph capture takes it
    zero = torch.zeros((), device=dev)
    mask_past = torch.where(
        cols[None, None, None] >= depths.to(dev)[:, None, None, None],
        neg, zero)                                              # [B,1,1,S]
    tri = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
    mask_self = torch.where(tri, zero, neg)[None, None]         # [1,1,T,T]
    s_past = torch.einsum("btkrd,bskd->bkrts", qg.float(),
                          k_old.to(q.dtype).float()) * (d ** -0.5)
    if k_scale is not None:
        s_past = s_past * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    s_past = s_past + mask_past[:, :, None]
    s_self = torch.einsum("btkrd,bskd->bkrts", qg.float(),
                          k_cur.to(q.dtype).float()) * (d ** -0.5)
    s_self = s_self + mask_self[:, :, None]
    probs = torch.softmax(torch.cat([s_past, s_self], dim=-1), dim=-1)
    p_past = probs[..., :S]
    if v_scale is not None:
        p_past = p_past * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    p_past = p_past.to(q.dtype).float()
    p_self = probs[..., S:].to(q.dtype).float()
    out = torch.einsum("bkrts,bskd->btkrd", p_past,
                       v_old.to(q.dtype).float())
    out = out + torch.einsum("bkrts,bskd->btkrd", p_self,
                             v_cur.to(q.dtype).float())
    return out.to(q.dtype).reshape(B, T, h * d)


def _lib() -> ctypes.CDLL:
    lib = load_library("decode_attention")
    if not getattr(lib, "_typed", False):
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
        lib.vct_decode_attention.argtypes = [
            I, I, P, P, P, P, P, P, P, P, P, P, ctypes.c_longlong,
            ctypes.c_longlong, I, I, I, I, I, I, ctypes.c_float, P]
        lib.vct_decode_attention.restype = I
        lib.vct_decode_attention_ws.argtypes = [I] * 6
        lib.vct_decode_attention_ws.restype = U
        lib.vct_decode_attention_splits.argtypes = [I] * 4
        lib.vct_decode_attention_splits.restype = I
        lib.vct_decode_attention_smem.argtypes = [I] * 8
        lib.vct_decode_attention_smem.restype = U
        lib._typed = True
    return lib


# The kernel's workspace, one per device, kept across calls and grown when
# a call needs more: the merge tickets, zeroed once here (the kernel's
# merging blocks leave them zero), then the per-split partials. Calls on
# one device share it, so they run on one stream at a time, as the
# decode loop does.
_WORKSPACE: dict = {}
_WS_BYTES: dict = {}  # (device, (B, T, h, kv, d, S)) -> workspace bytes
_WS_LOCK = threading.Lock()


def _workspace(device: torch.device, shape) -> torch.Tensor:
    """The device's workspace, at least as large as these shapes need
    (the split count behind the size is the card's: call this with the
    device current)."""
    with _WS_LOCK:
        nbytes = _WS_BYTES.get((device, shape))
        if nbytes is None:
            nbytes = _lib().vct_decode_attention_ws(*shape)
            _WS_BYTES[(device, shape)] = nbytes
        ws = _WORKSPACE.get(device)
        if ws is None or ws.numel() < nbytes:
            ws = torch.zeros(nbytes, dtype=torch.uint8, device=device)
            _WORKSPACE[device] = ws
        return ws


def reserve_workspace(device: torch.device, B: int, T: int, h: int,
                      kv: int, d: int, S: int) -> torch.Tensor:
    """The workspace the kernel takes at these shapes, grown now: call it
    before a CUDA graph captures the kernel (a workspace grown during the
    capture would come from the graph's private pool) and hold the
    tensor as long as the graph, whose launches keep its address when a
    later call grows the shared one."""
    with torch.cuda.device(device):
        return _workspace(device, (B, T, h, kv, d, S))


def kernel_splits(B: int, kv: int, d: int, S: int) -> int:
    """The column splits a (batch row, kv head) takes on the current
    card: about two blocks an SM over B x kv x splits blocks."""
    return _lib().vct_decode_attention_splits(B, kv, d, S)


def _rows_ok(t: torch.Tensor) -> bool:
    """[B, S, ...] with everything after the batch axis contiguous (a
    layer of the stacked cache, or its first S columns)."""
    expect = 1
    for size, stride in reversed(list(zip(t.shape[1:], t.stride()[1:]))):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _launch(q, k_old, v_old, k_cur, v_cur, depths, k_scale, v_scale):
    B, T, h, d = q.shape
    S, kv = k_old.shape[1], k_old.shape[2]
    quant = k_scale is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_old.dtype != v_old.dtype or k_old.dtype not in _TYPES \
            or (k_old.dtype == torch.int8) != quant:
        raise TypeError(f"decode_attention: the cache must be float32 or "
                        f"bfloat16, or int8 with scales; got {k_old.dtype}, "
                        f"{v_old.dtype}, scales {quant}")
    if tuple(k_old.shape) != (B, S, kv, d) or v_old.shape != k_old.shape \
            or tuple(k_cur.shape) != (B, T, kv, d) \
            or v_cur.shape != k_cur.shape or h % kv:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k_old.shape)}, fresh "
                         f"{tuple(k_cur.shape)} do not fit")
    tensors = [q, k_old, v_old, k_cur, v_cur, depths] + (
        [k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"decode_attention: all tensors must be on "
                         f"{q.device}")
    if not (_rows_ok(k_old) and _rows_ok(v_old)
            and k_old.stride(0) == v_old.stride(0)):
        raise ValueError("decode_attention: the cache rows must be "
                         "contiguous after the batch axis")
    if quant and not (_rows_ok(k_scale) and _rows_ok(v_scale)
                      and k_scale.stride(0) == v_scale.stride(0)
                      and k_scale.dtype == torch.float32
                      and v_scale.dtype == torch.float32
                      and tuple(k_scale.shape) == (B, S, kv)):
        raise ValueError("decode_attention: scales must be float32 "
                         "[B, S, kv] with rows contiguous")
    if not quant and k_old.dtype != q.dtype:
        # the kernel reads a float cache in q's type (the plain version
        # rounds it to q's type too); no decode path gives another
        k_old, v_old = k_old.to(q.dtype), v_old.to(q.dtype)
    if k_old.data_ptr() % 16 or v_old.data_ptr() % 16:
        raise ValueError("decode_attention: the cache must start on a "
                         "16-byte boundary (the kernel copies 16-byte rows)")
    q, k_cur, v_cur = (aligned16(t.to(q.dtype)) for t in (q, k_cur, v_cur))
    depths = depths.to(torch.int32).expand(B).contiguous()
    out = torch.empty(B, T, h, d, dtype=q.dtype, device=q.device)
    lib = _lib()
    types = (_TYPES[q.dtype], _TYPES[k_old.dtype])
    with torch.cuda.device(q.device):
        ws = _workspace(q.device, (B, T, h, kv, d, S))
        err = lib.vct_decode_attention(
            *types, q.data_ptr(), k_old.data_ptr(), v_old.data_ptr(),
            k_cur.data_ptr(), v_cur.data_ptr(), depths.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, out.data_ptr(),
            ws.data_ptr(), k_old.stride(0),
            k_scale.stride(0) if quant else 0, B, T, h, kv, d, S,
            float(d) ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            smem = lib.vct_decode_attention_smem(*types, B, T, h, kv, d, S)
            raise RuntimeError(
                f"decode_attention: CUDA kernel launch failed with "
                f"cudaError {err} (B={B}, T={T}, h={h}, kv={kv}, d={d}, "
                f"S={S}: {smem} B of shared memory per block)")
    decode_attention_kernel.launches += 1
    return out.reshape(B, T, h * d)


def decode_attention_kernel(q, k_old, v_old, k_cur, v_cur, depths,
                            k_scale=None, v_scale=None):
    """K8, same contract as :func:`decode_attention_reference`. A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_old, v_old, k_cur, v_cur,
                                          depths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    return _launch(q, k_old, v_old, k_cur, v_cur, depths, k_scale, v_scale)


decode_attention_kernel.launches = 0


def kernel_route(q: torch.Tensor, k_old: torch.Tensor) -> bool:
    """The reference's shape gate, "on TPU" read as "on CUDA"."""
    return (q.device.type == "cuda" and q.shape[-1] % 128 == 0
            and k_old.shape[1] >= 128 and q.shape[1] <= 16)


def decode_attention(q, k_old, v_old, k_cur, v_cur, depths,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     impl: str = "auto"):
    """Dispatcher (see the module docstring); ``impl="torch"`` always
    takes the plain version."""
    if impl != "torch" and kernel_route(q, k_old):
        return decode_attention_kernel(q, k_old, v_old, k_cur, v_cur,
                                       depths, k_scale, v_scale)
    return decode_attention_reference(q, k_old, v_old, k_cur, v_cur,
                                      depths, k_scale, v_scale)


def reset_launch_counts() -> None:
    decode_attention_kernel.launches = 0


def launch_counts() -> dict:
    return {"decode_attention_kernel": decode_attention_kernel.launches}
