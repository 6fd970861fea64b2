"""Qwen2.5-VL in PyTorch: text decoder and windowed vision tower.

Port of ``vlm_clip_tpu/vlm/qwen_model.py`` (the reference's
``VLMContextExtractor`` model, model_v.py:43-142). Params keep the JAX
package's keys and layouts: layers stacked on a leading [L] axis, linear
kernels [in, out], weights fp, :class:`~vlm_clip_tpu_torch.ops.quant.
QuantizedLinear` or :class:`~vlm_clip_tpu_torch.ops.nf4.NF4Linear`
leaves. ``lax.scan`` over the stacked layers becomes a
Python loop over [L] slices (views, no copy).

- text: pre-RMSNorm decoder, GQA attention (grouped: K/V are never
  repeated to the query head count), biased q/k/v and biasless o, SwiGLU
  MLP (``gateup`` fused decode layout too), M-RoPE, tied or untied head;
- vision: patch embed (raw uint8 patches with a normalization-folded
  embed), RMSNorm blocks, 2D rotary, window attention with full-attention
  blocks at ``fullatt_block_indexes`` (the uniform-window path computes
  each window as a batch), 2x2 merger to the text width. Accepts one
  image [S, D] or a batch [B, S, D].

The KV cache is preallocated and each layer writes its fresh rows into it
in place (the reference writes them once after its scan on a donated
buffer). The vision tower's and the prefill's attention are plain
matmuls with an fp32 softmax, as in the reference; the cached decode
attention goes through ``ops/decode_attention.py`` (K8) and the int4
GEMVs through ``ops/quant.py`` (K7); NF4 linears through
``ops/nf4.nf4_matmul`` (plain PyTorch, as the reference's is XLA).
``impl="torch"`` takes both kernels' plain versions.

A tensor-parallel rank's tree (``parallel/sharding.shard_params``) runs
through the same functions: ``linear`` hands a sharded leaf to
``parallel/tensor_parallel.apply`` (row-parallel ``o``, ``down`` and
vision ``proj`` all-reduce, column-parallel q/k/v and ``gate``/``up``
stay local, the untied head all-gathers its vocabulary), and
:func:`local_heads` gives the q and kv heads this rank attends with
(picking, from replicated k/v, the kv heads of its q heads).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from vlm_clip_tpu_torch.ops.decode_attention import decode_attention
from vlm_clip_tpu_torch.ops.nf4 import NF4Linear, nf4_matmul
from vlm_clip_tpu_torch.ops.quant import QuantizedLinear, quant_matmul
from vlm_clip_tpu_torch.parallel import tensor_parallel as TP

Params = Dict[str, Any]
_NEG = float(torch.finfo(torch.float32).min)  # additive-mask -inf


@dataclasses.dataclass(frozen=True)
class QwenTextConfig:
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_layers: int = 36
    num_heads: int = 16
    num_kv_heads: int = 2
    head_dim: int = 128
    vocab_size: int = 151936
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = True


@dataclasses.dataclass(frozen=True)
class QwenVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 3420
    out_hidden_size: int = 2048
    depth: int = 32
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


@dataclasses.dataclass(frozen=True)
class QwenVLConfig:
    text: QwenTextConfig = dataclasses.field(default_factory=QwenTextConfig)
    vision: QwenVisionConfig = dataclasses.field(
        default_factory=QwenVisionConfig)
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    eos_token_id: int = 151645  # <|im_end|>


def qwen25vl_3b() -> QwenVLConfig:
    """Qwen2.5-VL-3B-Instruct dims (the reference's checkpoint)."""
    return QwenVLConfig()


def qwen25vl_7b() -> QwenVLConfig:
    """Qwen2.5-VL-7B-Instruct dims (HF config)."""
    return QwenVLConfig(
        text=QwenTextConfig(
            hidden_size=3584, intermediate_size=18944, num_layers=28,
            num_heads=28, num_kv_heads=4, head_dim=128,
            tie_word_embeddings=False),
        vision=QwenVisionConfig(out_hidden_size=3584))


def qwen25vl_72b() -> QwenVLConfig:
    """Qwen2.5-VL-72B-Instruct dims (HF config)."""
    return QwenVLConfig(
        text=QwenTextConfig(
            hidden_size=8192, intermediate_size=29568, num_layers=80,
            num_heads=64, num_kv_heads=8, head_dim=128,
            tie_word_embeddings=False),
        vision=QwenVisionConfig(out_hidden_size=8192))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views; quantized leaves too)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (QuantizedLinear, NF4Linear, TP.TPLinear)):
        return tree.map(lambda t: t[i])
    return tree[i]


def linear(p, x: torch.Tensor, out_dtype=None,
           impl: str = "auto") -> torch.Tensor:
    """fp {'kernel'[,'bias']}, QuantizedLinear or NF4Linear; fp32
    accumulation, the output in ``out_dtype`` (default x's; the LM head
    passes float32); a tensor-parallel shard across its ranks."""
    if isinstance(p, TP.TPLinear):
        return TP.apply(p, x, lambda q, v: linear(q, v, torch.float32,
                                                 impl), out_dtype)
    if isinstance(p, QuantizedLinear):
        return quant_matmul(x, p, out_dtype=out_dtype, impl=impl)
    if isinstance(p, NF4Linear):
        return nf4_matmul(x, p, out_dtype=out_dtype)
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if p.get("bias") is not None:
        y = y.float() + p["bias"].float()
    return y.to(out_dtype or x.dtype)


def rms_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def swiglu_mlp(p, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    if "gateup" in p:  # decode-fused layout: one wide GEMV
        g, u = linear(p["gateup"], x, impl=impl).chunk(2, dim=-1)
        return linear(p["down"], torch.nn.functional.silu(g) * u, impl=impl)
    return linear(p["down"],
                  torch.nn.functional.silu(linear(p["gate"], x, impl=impl))
                  * linear(p["up"], x, impl=impl), impl=impl)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                  mrope_section: Tuple[int, int, int]):
    """position_ids [3, B, T] -> (cos, sin) [B, T, head_dim] with the
    temporal/height/width channel sections interleaved (HF
    apply_multimodal_rotary_pos_emb semantics)."""
    half = head_dim // 2
    if sum(mrope_section) != half:
        raise ValueError(f"mrope_section {mrope_section} must sum to "
                         f"head_dim/2 = {half}")
    dev = position_ids.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=dev) / half))
    freqs = position_ids.float()[..., None] * inv_freq  # [3, B, T, half]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos(), emb.sin()
    sections = list(mrope_section) * 2
    starts = [sum(sections[:i]) for i in range(len(sections))]
    cos_parts = [cos[i % 3, ..., s:s + n]
                 for i, (s, n) in enumerate(zip(starts, sections))]
    sin_parts = [sin[i % 3, ..., s:s + n]
                 for i, (s, n) in enumerate(zip(starts, sections))]
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(q, k, cos, sin):
    """q [B,T,h,d], cos/sin [B,T,d] -> rotated (fp32 inside)."""
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    q32, k32 = q.float(), k.float()
    qe = q32 * c + _rotate_half(q32) * s
    ke = k32 * c + _rotate_half(k32) * s
    return qe.to(q.dtype), ke.to(k.dtype)


# ---------------------------------------------------------------------------
# text decoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Preallocated cache, written in place. k, v: [L, B, max_len, kv,
    head_dim]; ``length``: rows filled (all rows at one depth); an int8
    cache carries per-(layer, row, position, kv head) scales."""
    k: torch.Tensor
    v: torch.Tensor
    length: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def local_heads(attn, cfg: QwenTextConfig):
    """(q heads, kv heads, kv pick) a layer's attention computes on this
    rank: the config's counts and no pick for an unsharded (or fused, or
    gathered) q; a q shard's heads, and its k/v shard's or, from
    replicated k/v, the kv heads its q heads read: a slice when each kv
    head serves an equal run of them (grouped attention at the local
    counts), else one index per q head."""
    q = attn.get("q")
    if not isinstance(q, TP.TPLinear) or q.kind != TP.COLUMN:
        return cfg.num_heads, cfg.num_kv_heads, None
    hd = cfg.head_dim
    if (q.stop - q.start) % hd:
        raise ValueError(
            f"a q shard of {q.stop - q.start} columns is not whole heads "
            f"of {hd}: cut the tree with shard_params(..., head_dim=...)")
    h0, h = q.start // hd, (q.stop - q.start) // hd
    k = attn["k"]
    if isinstance(k, TP.TPLinear) and k.kind == TP.COLUMN:
        return h, (k.stop - k.start) // hd, None
    rep = cfg.num_heads // cfg.num_kv_heads
    kvs = [(h0 + i) // rep for i in range(h)]
    n = kvs[-1] - kvs[0] + 1
    if h % n == 0 and kvs == [kvs[0] + i // (h // n) for i in range(h)]:
        return h, n, slice(kvs[0], kvs[-1] + 1)
    return h, h, torch.tensor(kvs)


def cache_kv_heads(text_params, cfg: QwenTextConfig) -> int:
    """The kv heads of a rank's KV cache for this (sharded) text tree."""
    return local_heads(text_params["layers"]["attn"], cfg)[1]


def init_kv_cache(cfg: QwenTextConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, quantized: bool = False,
                  device="cuda", kv_heads: Optional[int] = None) -> KVCache:
    """``kv_heads``: a tensor-parallel rank's (default the config's)."""
    shape = (cfg.num_layers, batch, max_len, kv_heads or cfg.num_kv_heads,
             cfg.head_dim)
    if quantized:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       0, torch.ones(shape[:-1], device=device),
                       torch.ones(shape[:-1], device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def quantize_kv_rows(rows: torch.Tensor):
    """[..., d] -> (int8 rows, fp32 scales [...]): symmetric per-row
    absmax / 127."""
    r32 = rows.float()
    amax = r32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(r32 / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(rows_i8: torch.Tensor, scale: torch.Tensor, dtype):
    return (rows_i8.float() * scale[..., None]).to(dtype)


def _gqa_attention(q, k, v, mask, num_heads, num_kv_heads,
                   k_scale=None, v_scale=None):
    """q [B,T,h,d]; k,v [B,S,kv,d]; mask additive [B|1,1,T,S]. Grouped:
    no repeat of K/V; an int8 cache's scales fold outside the products."""
    B, T, h, d = q.shape
    rep = h // num_kv_heads
    qg = q.reshape(B, T, num_kv_heads, rep, d).float()
    scores = torch.einsum("btkrd,bskd->bkrts", qg,
                          k.to(q.dtype).float()) * (d ** -0.5)
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if mask is not None:
        scores = scores + mask.float()[:, :, None]
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkrts,bskd->btkrd", probs.to(q.dtype).float(),
                       v.to(q.dtype).float()).to(q.dtype)
    return out.reshape(B, T, h * d)


# Below this per-layer cache size (bytes of ONE of k/v), decode writes the
# fresh rows and attends over the cache (dense route); above it, it
# attends the old columns and the fresh ones apart (split route, K8's).
_DENSE_CACHE_ROUTE_MAX_BYTES = 2 * 1024 * 1024


def _gqa_attention_cached(q, k_old, v_old, k_cur, v_cur, mask,
                          cache_index, num_heads, num_kv_heads,
                          k_scale=None, v_scale=None, impl: str = "auto"):
    """Cached attention over the S old columns (rows >= cache_index
    masked) plus the T fresh ones; ``mask=None`` is the canonical decode
    mask and goes to ``ops/decode_attention.decode_attention``."""
    B, T, h, d = q.shape
    vector = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
    if mask is None:
        depths = (cache_index if vector else torch.full(
            (B,), int(cache_index), dtype=torch.int32, device=q.device))
        return decode_attention(q, k_old, v_old, k_cur, v_cur, depths,
                                k_scale, v_scale, impl=impl)
    S = k_old.shape[1]
    rep = h // num_kv_heads
    qg = q.reshape(B, T, num_kv_heads, rep, d).float()
    dev = q.device
    cols = torch.arange(S, device=dev)
    neg = torch.tensor(_NEG, device=dev)
    if vector:
        cut = cache_index[:, None, None, None]
        mask_past = torch.where(cols[None, None, None] >= cut, neg,
                                mask.float())
        tri = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
        mask_self = torch.where(tri, torch.zeros((), device=dev), neg)
        mask_self = mask_self[None, None].expand(B, 1, T, T)
    else:
        ci = int(cache_index)
        mask_past = torch.where(cols[None, None, None] >= ci, neg,
                                mask.float())
        mask_self = mask.float()[..., ci:ci + T]
    s_past = torch.einsum("btkrd,bskd->bkrts", qg,
                          k_old.to(q.dtype).float()) * (d ** -0.5)
    if k_scale is not None:
        s_past = s_past * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    s_past = s_past + mask_past[:, :, None]
    s_self = torch.einsum("btkrd,bskd->bkrts", qg,
                          k_cur.float()) * (d ** -0.5)
    s_self = s_self + mask_self[:, :, None]
    probs = torch.softmax(torch.cat([s_past, s_self], dim=-1), dim=-1)
    p_past = probs[..., :S]
    if v_scale is not None:
        p_past = p_past * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    p_past = p_past.to(q.dtype).float()
    p_self = probs[..., S:].to(q.dtype).float()
    out = torch.einsum("bkrts,bskd->btkrd", p_past,
                       v_old.to(q.dtype).float())
    out = out + torch.einsum("bkrts,bskd->btkrd", p_self, v_cur.float())
    return out.to(q.dtype).reshape(B, T, h * d)


def split_route(ck: torch.Tensor) -> bool:
    """Whether a decode over this cache layer ([B, S, kv, d] k) with one
    int depth takes the split route (the one a per-row depth always
    takes): its bytes are past ``_DENSE_CACHE_ROUTE_MAX_BYTES``."""
    return ck.numel() * ck.element_size() > _DENSE_CACHE_ROUTE_MAX_BYTES


def row_positions(cache_index: torch.Tensor, T: int, S: int):
    """The (batch [B, 1], position [B, T]) index pair of T fresh rows at
    per-row depths ``cache_index`` [B] in a cache of S rows. Positions
    past the cache (the engine's finished rows and drafts past a row's
    budget, which the reference's scatter drops) land on the last row,
    which no later position reads."""
    dev = cache_index.device
    bidx = torch.arange(cache_index.shape[0], device=dev)[:, None]
    idx = cache_index.long()[:, None] + torch.arange(T, device=dev)[None]
    return bidx, idx.clamp(max=S - 1)


def _write_rows(dst: torch.Tensor, rows: torch.Tensor, cache_index):
    """Write [B, T, ...] rows into a [B, S, ...] cache layer in place, at
    one depth (int), per-row depths ([B] tensor) or their
    :func:`row_positions` pair."""
    if isinstance(cache_index, tuple):
        dst[cache_index] = rows
    elif isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        dst[row_positions(cache_index.to(dst.device), rows.shape[1],
                          dst.shape[1])] = rows
    else:
        ci = int(cache_index)
        dst[:, ci:ci + rows.shape[1]] = rows


def text_decoder_layer(p, x, cos, sin, mask, cfg: QwenTextConfig,
                       cache_kv: Optional[Tuple] = None,
                       cache_index=None, kv_read_span: Optional[int] = None,
                       impl: str = "auto", write_at=None):
    """Returns (x, (k_rows, v_rows, k_scale, v_scale)). With a cache
    (``cache_kv`` = this layer's [B, S, kv, d] k, v and scales or None),
    the current tokens' rows (cast to the cache type, or int8 with their
    scales) are written into it in place at ``cache_index`` (or at
    ``write_at``, its :func:`row_positions` pair, when the caller made it
    once for every layer)."""
    B, T, _ = x.shape
    h = rms_norm(p["ln1"], x, cfg.rms_norm_eps)
    nh, nkv, pick = local_heads(p["attn"], cfg)
    if "qkv" in p["attn"]:  # decode-fused, replicated: every head
        n_q = cfg.num_heads * cfg.head_dim
        n_kv = cfg.num_kv_heads * cfg.head_dim
        q, k, v = linear(p["attn"]["qkv"], h, impl=impl).split(
            (n_q, n_kv, n_kv), dim=-1)
    else:
        q = linear(p["attn"]["q"], h, impl=impl)
        k = linear(p["attn"]["k"], h, impl=impl)
        v = linear(p["attn"]["v"], h, impl=impl)
    q = q.reshape(B, T, nh, cfg.head_dim)
    k = k.reshape(B, T, -1, cfg.head_dim)
    v = v.reshape(B, T, -1, cfg.head_dim)
    if pick is not None:  # replicated k/v: the kv heads of this rank's q
        k, v = k[:, :, pick], v[:, :, pick]
    q, k = apply_rope(q, k, cos, sin)
    if cache_kv is None:
        attn = _gqa_attention(q, k, v, mask, nh, nkv)
        rows = (k, v, None, None)
    else:
        ck, cv, cks, cvs = cache_kv
        quant = cks is not None
        if quant:
            k_rows, k_sc = quantize_kv_rows(k)
            v_rows, v_sc = quantize_kv_rows(v)
            # attention sees the round-tripped rows, as the cache will
            k_cur = dequantize_kv(k_rows, k_sc, q.dtype)
            v_cur = dequantize_kv(v_rows, v_sc, q.dtype)
        else:
            k_rows, v_rows = k.to(ck.dtype), v.to(cv.dtype)
            k_sc = v_sc = None
            k_cur, v_cur = k_rows.to(q.dtype), v_rows.to(q.dtype)
        rows = (k_rows, v_rows, k_sc, v_sc)
        targets = [(ck, k_rows), (cv, v_rows)] + (
            [(cks, k_sc), (cvs, v_sc)] if quant else [])
        at = cache_index if write_at is None else write_at
        vector = isinstance(cache_index, torch.Tensor) \
            and cache_index.dim() == 1
        def read(t):  # the columns attention reads
            if t is None or kv_read_span is None:
                return t
            return t[:, :kv_read_span]

        if not vector and not split_route(ck):
            # small cache: write the fresh rows, then attend over it
            for dst, src in targets:
                _write_rows(dst, src, at)
            if mask is None:
                cols = torch.arange(ck.shape[1], device=x.device)
                ci = int(cache_index)
                allowed = cols[None, :] <= ci + torch.arange(
                    T, device=x.device)[:, None]
                dmask = torch.where(allowed, 0.0, _NEG)[None, None]
            else:
                dmask = mask
            attn = _gqa_attention(q, ck, cv, dmask, nh, nkv, k_scale=cks,
                                  v_scale=cvs)
        else:
            attn = _gqa_attention_cached(
                q, read(ck), read(cv), k_cur, v_cur, mask, cache_index,
                nh, nkv, k_scale=read(cks),
                v_scale=read(cvs), impl=impl)
            for dst, src in targets:
                _write_rows(dst, src, at)
    x = x + linear(p["attn"]["o"], attn, impl=impl)
    x = x + swiglu_mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.rms_norm_eps),
                       impl=impl)
    return x, rows


def text_forward(params: Params, embeds: torch.Tensor,
                 position_ids: torch.Tensor, cfg: QwenTextConfig,
                 mask: Optional[torch.Tensor] = None,
                 cache: Optional[KVCache] = None,
                 cache_index: Union[int, torch.Tensor, None] = None,
                 last_only: bool = False,
                 last_index: Optional[int] = None,
                 kv_read_span: Optional[int] = None,
                 impl: str = "auto") -> Tuple[torch.Tensor, Optional[KVCache]]:
    """embeds [B, T, H] -> (fp32 logits [B, T|1, V], the cache).

    ``position_ids`` [3, B|1, T]. With a cache, ``mask`` covers the full
    cache [B|1, 1, T, max_len], or is ``None`` for the canonical decode
    mask (cache columns < depth, causal fresh triangle).
    ``cache_index``: the row the fresh K/V land at, an int (every row at
    one depth; the returned cache's length grows by T) or a per-row [B]
    tensor. ``last_only`` / ``last_index``: head logits at the last (or
    the given) position only. ``kv_read_span`` (per-row ``cache_index``
    only): attention reads only the first ``kv_read_span`` columns;
    writes still target the full cache. The cache is written in place
    and returned with its new length.
    """
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_section)
    x = embeds
    vector = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
    if kv_read_span is not None and (
            cache is None or not vector or kv_read_span > cache.k.shape[2]):
        raise ValueError("kv_read_span requires a per-row vector "
                         "cache_index and span <= max_len")
    if cache is not None and not vector:
        cache_index = int(cache_index)
    rmask = mask if kv_read_span is None or mask is None \
        else mask[..., :kv_read_span]
    quant = cache is not None and cache.k_scale is not None
    # per-row depths: the rows every layer writes, indexed once
    write_at = row_positions(cache_index.to(cache.k.device), x.shape[1],
                             cache.k.shape[2]) \
        if vector and cache is not None else None
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        kv = None if cache is None else (
            cache.k[i], cache.v[i], cache.k_scale[i] if quant else None,
            cache.v_scale[i] if quant else None)
        x, _ = text_decoder_layer(lp, x, cos, sin, rmask, cfg, kv,
                                  cache_index, kv_read_span, impl, write_at)
    new_cache = cache
    if cache is not None and not vector:
        new_cache = dataclasses.replace(cache,
                                        length=cache.length + x.shape[1])
    if last_index is not None:
        x = x[:, last_index:last_index + 1]
    elif last_only:
        x = x[:, -1:]
    x = rms_norm(params["final_norm"], x, cfg.rms_norm_eps)
    if cfg.tie_word_embeddings:
        logits = torch.matmul(x, params["embed_tokens"].to(x.dtype).T)
    else:
        # fp32 out: logits never round through bf16 on the way to
        # sampling
        logits = linear(params["lm_head"], x, out_dtype=torch.float32,
                        impl=impl)
    return logits.float(), new_cache


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------

def _vision_attention(q, k, v, mask, scale):
    """Dense attention over q/k/v [..., S, h, d]; ``mask`` additive [S, S]
    or None (full attention)."""
    scores = torch.einsum("...thd,...shd->...hts", q.float(),
                          k.float()) * scale
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("...hts,...shd->...thd", probs.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def _vision_attention_windowed(q, k, v, window: int, scale):
    """Block-diagonal attention over contiguous uniform windows, each
    window a batch (q/k/v [..., S, h, d], S % window == 0)."""
    *lead, S, h, d = q.shape
    nw = S // window
    out = _vision_attention(*(t.reshape(*lead, nw, window, h, d)
                              for t in (q, k, v)), None, scale)
    return out.reshape(*lead, S, h, d)


def vision_block(p, x, cos, sin, mask, cfg: QwenVisionConfig,
                 window: Optional[int] = None, impl: str = "auto"):
    """x [B, S, H]; ``window``: the uniform window length (batched
    block-diagonal attention) instead of ``mask``."""
    h = rms_norm(p["ln1"], x, cfg.rms_norm_eps)
    B, S = x.shape[:2]
    qkv = linear(p["attn"]["qkv"], h, impl=impl).reshape(
        B, S, 3, cfg.num_heads, cfg.head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q, k = apply_rope(q, k, cos[None], sin[None])
    scale = cfg.head_dim ** -0.5
    if window is not None:
        attn = _vision_attention_windowed(q, k, v, window, scale)
    else:
        attn = _vision_attention(q, k, v, mask, scale)
    x = x + linear(p["attn"]["proj"], attn.reshape(B, S, -1), impl=impl)
    x = x + swiglu_mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.rms_norm_eps),
                       impl=impl)
    return x


def vision_forward(params: Params, patches: torch.Tensor,
                   rot_pos_emb: torch.Tensor,
                   window_mask: Optional[torch.Tensor],
                   full_mask: Optional[torch.Tensor],
                   cfg: QwenVisionConfig,
                   uniform_window: Optional[int] = None,
                   impl: str = "auto") -> torch.Tensor:
    """patches [S, C*t*P*P] or [B, S, C*t*P*P], already window-permuted
    (uint8 with a normalization-folded embed); rot_pos_emb [S, hd/2];
    masks additive [S, S] (unread with ``uniform_window``). Returns the
    merged embeds [(B,) S/4, out_hidden] in window order."""
    single = patches.dim() == 2
    if single:
        patches = patches[None]
    if not patches.is_floating_point():
        patches = patches.float()  # raw uint8 patch path
    pe = params["patch_embed"]
    x = torch.matmul(patches.float(), pe["kernel"].float())
    if "bias" in pe:  # normalization-folded uint8 patch path
        x = x + pe["bias"].float()
    x = x.to(patches.dtype)
    emb = torch.cat([rot_pos_emb, rot_pos_emb], dim=-1)
    cos, sin = emb.cos(), emb.sin()
    full = set(cfg.fullatt_block_indexes)
    for i in range(cfg.depth):
        lp = layer(params["blocks"], i)
        if uniform_window is not None:
            x = vision_block(lp, x, cos, sin, None, cfg,
                             None if i in full else uniform_window, impl)
        else:
            x = vision_block(lp, x, cos, sin,
                             full_mask if i in full else window_mask, cfg,
                             impl=impl)
    x = rms_norm(params["merger"]["ln_q"], x, cfg.rms_norm_eps)
    x = x.reshape(x.shape[0], -1, cfg.merge_unit * cfg.hidden_size)
    h = torch.nn.functional.gelu(linear(params["merger"]["fc1"], x,
                                        impl=impl))
    out = linear(params["merger"]["fc2"], h, impl=impl)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# init (seeded random, for hermetic runs)
# ---------------------------------------------------------------------------

def _init_linear(gen, lead, din, dout, bias, dtype, device):
    p = {"kernel": (torch.randn(*lead, din, dout, generator=gen,
                                device=device) * din ** -0.5).to(dtype)}
    if bias:
        p["bias"] = torch.zeros(*lead, dout, dtype=dtype, device=device)
    return p


def init_text(gen: torch.Generator, cfg: QwenTextConfig,
              dtype=torch.float32, device="cuda") -> Params:
    """Random text params with the reference's tree (stacked layers)."""
    L, H, hd = (cfg.num_layers,), cfg.hidden_size, cfg.head_dim

    def lin(din, dout, bias=False):
        return _init_linear(gen, L, din, dout, bias, dtype, device)

    params = {
        "embed_tokens": (torch.randn(cfg.vocab_size, H, generator=gen,
                                     device=device) * 0.02).to(dtype),
        "layers": {
            "attn": {"q": lin(H, cfg.num_heads * hd, True),
                     "k": lin(H, cfg.num_kv_heads * hd, True),
                     "v": lin(H, cfg.num_kv_heads * hd, True),
                     "o": lin(cfg.num_heads * hd, H)},
            "mlp": {"gate": lin(H, cfg.intermediate_size),
                    "up": lin(H, cfg.intermediate_size),
                    "down": lin(cfg.intermediate_size, H)},
            "ln1": {"scale": torch.ones(*L, H, dtype=dtype, device=device)},
            "ln2": {"scale": torch.ones(*L, H, dtype=dtype, device=device)},
        },
        "final_norm": {"scale": torch.ones(H, dtype=dtype, device=device)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _init_linear(gen, (), H, cfg.vocab_size, False,
                                         dtype, device)
    return params


def init_vision(gen: torch.Generator, cfg: QwenVisionConfig,
                dtype=torch.float32, device="cuda") -> Params:
    L, H = (cfg.depth,), cfg.hidden_size
    in_dim = 3 * cfg.temporal_patch_size * cfg.patch_size ** 2
    merged = cfg.merge_unit * H

    def lin(din, dout, lead=L):
        return _init_linear(gen, lead, din, dout, True, dtype, device)

    return {
        "patch_embed": {"kernel": (torch.randn(in_dim, H, generator=gen,
                                               device=device)
                                   * in_dim ** -0.5).to(dtype)},
        "blocks": {
            "attn": {"qkv": lin(H, 3 * H), "proj": lin(H, H)},
            "mlp": {"gate": lin(H, cfg.intermediate_size),
                    "up": lin(H, cfg.intermediate_size),
                    "down": lin(cfg.intermediate_size, H)},
            "ln1": {"scale": torch.ones(*L, H, dtype=dtype, device=device)},
            "ln2": {"scale": torch.ones(*L, H, dtype=dtype, device=device)},
        },
        "merger": {
            "ln_q": {"scale": torch.ones(H, dtype=dtype, device=device)},
            "fc1": lin(merged, merged, ()),
            "fc2": lin(merged, cfg.out_hidden_size, ()),
        },
    }
