"""Plain PyTorch reference of Qwen2.5-VL: the windowed vision tower with
its 2D rotary and 2x2 merger, the M-RoPE text decoder with grouped-query
attention, one image and a chat prompt, teacher-forced over served
tokens. Written from the published model (HF ``Qwen2_5_VL*`` modules and
``Qwen2VLImageProcessor``), in float32 with TF32 off, one sequence at a
time, no cache. It imports nothing of the program.

Weights: the benchmark's fp32 numbers in its tree layout (linear kernels
[in, out], stacked layers). The configuration's weight-only quantization
is worked out again here from those numbers: symmetric, one scale an
output channel (``amax / qmax``), qmax 127 for int8 and 7 for int4; the
head is ``embed_tokens`` transposed, quantized to int4. ``layer_bits=4``
puts int4 where the configuration has int8: the control.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """[.., in, out] fp32 -> its dequantized weight-only quantization."""
    w = w.float()
    qmax = 127.0 if bits == 8 else 7.0
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def quantized_weights(raw: Dict, layer_bits: int, head_bits: int) -> Dict:
    """Every linear kernel quantized (``layer_bits``), the head from
    ``embed_tokens.T`` (``head_bits``); embeddings, norms and the patch
    embed as they are."""
    def walk(node, top):
        if isinstance(node, dict):
            if "kernel" in node and top not in ("patch_embed",):
                out = dict(node)
                out["kernel"] = quantize(node["kernel"], layer_bits)
                return out
            return {k: walk(v, top or k) for k, v in node.items()}
        return node.float()
    text = {k: walk(v, k) for k, v in raw["text"].items()}
    text["lm_head"] = quantize(raw["text"]["embed_tokens"].float().T,
                               head_bits)
    return {"text": text,
            "vision": {k: walk(v, k) for k, v in raw["vision"].items()}}


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _lin(p, x):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def _rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------

def image_patches(image_u8: np.ndarray, v: dict):
    """HWC uint8 [S, S, 3] -> (normalized patches [N, C*T*P*P] in the
    processor's order, 2x2 merge units contiguous; the grid (t, h, w))."""
    x = torch.from_numpy(np.ascontiguousarray(image_u8)).float() / 255.0
    x = (x - torch.tensor(CLIP_MEAN)) / torch.tensor(CLIP_STD)
    x = x.permute(2, 0, 1)  # C, H, W
    T, P, M = v["temporal_patch_size"], v["patch_size"], \
        v["spatial_merge_size"]
    C, H, W = x.shape
    gh, gw = H // P, W // P
    frames = x[None].expand(T, C, H, W)
    p = frames.reshape(1, T, C, gh // M, M, P, gw // M, M, P)
    p = p.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return p.reshape(gh * gw, C * T * P * P), (1, gh, gw)


def _rot_pos_emb(grid, v):
    t, h, w = grid
    M = v["spatial_merge_size"]
    hpos = torch.arange(h)[:, None].expand(h, w)
    wpos = torch.arange(w)[None, :].expand(h, w)

    def order(x):
        return x.reshape(h // M, M, w // M, M).permute(0, 2, 1, 3).flatten()

    ids = torch.stack([order(hpos), order(wpos)], -1).repeat(t, 1)
    dim = v["hidden_size"] // v["num_heads"] // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32)
                             / dim))
    full = torch.outer(torch.arange(max(h, w), dtype=torch.float32), inv)
    return full[ids].flatten(1)  # [N, dim]


def _window_index(grid, v):
    """(merge-unit permutation into windows, window sizes in patches)."""
    t, h, w = grid
    M = v["spatial_merge_size"]
    ws = v["window_size"] // M // v["patch_size"]
    lh, lw = h // M, w // M
    idx = torch.arange(t * lh * lw).reshape(t, lh, lw)
    ph, pw = ws - lh % ws, ws - lw % ws
    nh, nw = (lh + ph) // ws, (lw + pw) // ws
    padded = F.pad(idx, (0, pw, 0, ph), value=-100)
    padded = padded.reshape(t, nh, ws, nw, ws).permute(0, 1, 3, 2, 4)
    padded = padded.reshape(t, nh * nw, ws, ws)
    sizes = (padded != -100).sum([2, 3]).reshape(-1) * M * M
    flat = padded.reshape(-1)
    return flat[flat != -100], [int(s) for s in sizes if s > 0]


def vision(p, image_u8: np.ndarray, v: dict, dev) -> torch.Tensor:
    """One image -> its merged embeddings [N / 4, out] in raster order."""
    patches, grid = image_patches(image_u8, v)
    patches = patches.to(dev)
    M2 = v["spatial_merge_size"] ** 2
    N = patches.shape[0]
    x = patches @ p["patch_embed"]["kernel"]
    rot = _rot_pos_emb(grid, v).to(dev)
    win, sizes = _window_index(grid, v)
    win = win.to(dev)
    x = x.reshape(N // M2, M2, -1)[win].reshape(N, -1)
    rot = rot.reshape(N // M2, M2, -1)[win].reshape(N, -1)
    emb = torch.cat([rot, rot], -1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    heads = v["num_heads"]
    hd = v["hidden_size"] // heads
    bounds = np.cumsum([0] + sizes)
    full = set(v["fullatt_block_indexes"])
    eps = 1e-6
    for i in range(v["depth"]):
        b = _layer(p["blocks"], i)
        h = _rms(x, b["ln1"]["scale"], eps)
        qkv = _lin(b["attn"]["qkv"], h).reshape(N, 3, heads, hd)
        q, k, val = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        segs = [(0, N)] if i in full else list(zip(bounds[:-1], bounds[1:]))
        out = torch.empty_like(q)
        for a, e in segs:
            s = torch.einsum("qhd,khd->hqk", q[a:e], k[a:e]) / math.sqrt(hd)
            out[a:e] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                    val[a:e])
        x = x + _lin(b["attn"]["proj"], out.reshape(N, -1))
        h = _rms(x, b["ln2"]["scale"], eps)
        m = b["mlp"]
        x = x + _lin(m["down"], F.silu(_lin(m["gate"], h)) * _lin(m["up"], h))
    x = _rms(x, p["merger"]["ln_q"]["scale"], eps).reshape(N // M2, -1)
    x = _lin(p["merger"]["fc2"], F.gelu(_lin(p["merger"]["fc1"], x)))
    return x[torch.argsort(win)]


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def rope_index(ids: List[int], grid, cfg: dict) -> torch.Tensor:
    """[3, T] M-RoPE positions of one sequence with one image (HF
    ``get_rope_index``): text positions count on, the image's tokens take
    (t, h, w) of its merged grid offset by the text before it."""
    v = cfg["vision_config"]
    M = v["spatial_merge_size"]
    st = ids.index(cfg["vision_start_token_id"]) + 1
    t, h, w = grid[0], grid[1] // M, grid[2] // M
    n = t * h * w
    if ids[st:st + n] != [cfg["image_token_id"]] * n:
        raise ValueError("the image's tokens must follow vision_start")
    pos = [torch.arange(st).expand(3, st)]
    tt = torch.arange(t).repeat_interleave(h * w)
    hh = torch.arange(h).repeat_interleave(w).repeat(t)
    ww = torch.arange(w).repeat(t * h)
    pos.append(torch.stack([tt, hh, ww]) + st)
    rest = len(ids) - st - n
    nxt = int(pos[-1].max()) + 1
    pos.append(torch.arange(rest).expand(3, rest) + nxt)
    return torch.cat(pos, dim=1)


def text_logits(p, embeds: torch.Tensor, pos: torch.Tensor, cfg: dict,
                first: int) -> torch.Tensor:
    """Causal forward of one sequence [T, H]; fp32 logits [T - first, V]
    of the positions from ``first`` on."""
    T, H = embeds.shape
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = H // nq
    eps = cfg["rms_norm_eps"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=embeds.device) / hd))
    freqs = pos.float()[..., None] * inv  # [3, T, hd/2]
    emb = torch.cat([freqs, freqs], -1)
    sec = list(cfg["rope_scaling"]["mrope_section"]) * 2
    cos = torch.cat([c[i % 3] for i, c in enumerate(emb.cos().split(sec, -1))],
                    -1)[:, None]
    sin = torch.cat([c[i % 3] for i, c in enumerate(emb.sin().split(sec, -1))],
                    -1)[:, None]
    mask = torch.full((T, T), float("-inf"), device=embeds.device).triu(1)
    x = embeds
    for i in range(cfg["num_hidden_layers"]):
        b = _layer(p["layers"], i)
        h = _rms(x, b["ln1"]["scale"], eps)
        a = b["attn"]
        q = _lin(a["q"], h).reshape(T, nq, hd)
        k = _lin(a["k"], h).reshape(T, nkv, hd)
        val = _lin(a["v"], h).reshape(T, nkv, hd)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        k = k.repeat_interleave(nq // nkv, dim=1)
        val = val.repeat_interleave(nq // nkv, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd) + mask
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), val)
        x = x + _lin(a["o"], o.reshape(T, -1))
        h = _rms(x, b["ln2"]["scale"], eps)
        m = b["mlp"]
        x = x + _lin(m["down"], F.silu(_lin(m["gate"], h)) * _lin(m["up"], h))
    x = _rms(x[first:], p["final_norm"]["scale"], eps)
    return x @ p["lm_head"]


@torch.no_grad()
def served_logits(weights: Dict, cfg: dict, prompt: List[int],
                  image_u8: np.ndarray, served: List[int], dev
                  ) -> torch.Tensor:
    """Logits [len(served), V] at each served token's position: the
    prompt with its image, then the served tokens, teacher-forced."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    v = cfg["vision_config"]
    vis = vision(weights["vision"], image_u8, v, dev)
    ids = list(prompt) + list(served[:-1])
    S = image_u8.shape[0] // v["patch_size"]
    pos = rope_index(ids, (1, S, S), cfg).to(dev)
    emb = weights["text"]["embed_tokens"][torch.tensor(ids, device=dev)]
    slots = [i for i, t in enumerate(ids) if t == cfg["image_token_id"]]
    emb = emb.clone()
    emb[torch.tensor(slots, device=dev)] = vis
    return text_logits(weights["text"], emb, pos, cfg, len(prompt) - 1)


def widest_gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest gap by which a chosen token's reference logit lies
    below the reference's best, over positions."""
    best = ref.max(dim=-1).values
    got = ref.gather(-1, chosen[:, None])[:, 0]
    return float((best - got).max())
