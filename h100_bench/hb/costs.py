"""Operations and bytes of the logical work, from shapes (whatever
implements it): each input read once, each output written once, a
multiply-add counted as 2 operations. The bound of a call is the larger
of operations over the bf16 peak and bytes over the HBM bandwidth
(``common.PEAK_*``, NVIDIA's H100 SXM data sheet)."""

from __future__ import annotations

from typing import Iterable

from hb.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ---------------------------------------------------------------------------
# CLIP towers and pipeline M's adapters (K1-K3)
# ---------------------------------------------------------------------------

def encoder_layer_flops(S: int, H: int, inter: int) -> float:
    """One pre-norm transformer layer on S tokens: q, k, v, out, the two
    MLP products, and attention's two products."""
    return 2.0 * S * (4 * H * H + 2 * H * inter) + 4.0 * S * S * H


def clip_tower_flops(cfg: dict) -> dict:
    """Forward operations of one image and one caption."""
    v, t = cfg["vision_config"], cfg["text_config"]
    n_patch = (v["image_size"] // v["patch_size"]) ** 2
    patch_in = 3 * v["patch_size"] ** 2
    vision = 2.0 * n_patch * patch_in * v["hidden_size"] + \
        v["num_hidden_layers"] * encoder_layer_flops(
            n_patch + 1, v["hidden_size"], v["intermediate_size"])
    text = t["num_hidden_layers"] * encoder_layer_flops(
        t["max_position_embeddings"], t["hidden_size"],
        t["intermediate_size"])
    return {"vision": vision, "text": text}


def adapter_calls(cfg: dict, batch: int) -> list:
    """(kind, direction, flops, bytes) of every K1-K3 call of one M
    training step at ``batch`` pairs. Activations bf16, params fp32.
    Backward: the weight gradients and, where an upstream adapter needs
    it, the input gradient (the towers are frozen: no dx for the
    sequence adapters)."""
    v, t, a = cfg["vision_config"], cfg["text_config"], cfg["adapters"]
    es, ps = 2, 4
    Tt = t["max_position_embeddings"]
    Tv = (v["image_size"] // v["patch_size"]) ** 2 + 1
    Ht, Hv = t["hidden_size"], v["hidden_size"]
    calls = []
    for N, H, K in ((batch * Tt, Ht, a["text_adapter_size"]),
                    (batch * Tv, Hv, a["vision_adapter_size"])):
        w = (2 * H * K + K + 3 * H) * ps
        mm = 2.0 * N * H * K
        calls.append(("K1", "fwd", 2 * mm, 2 * N * H * es + w))
        # dpre = dz @ w2^T, dw2 = h^T dz, dw1 = x^T dpre
        calls.append(("K1", "bwd", 3 * mm, 2 * N * H * es + 2 * w))
    N, H, Tk = batch * Tt, Ht, Tv
    for _ in range(a["shared_adapter_layers"]):
        w2 = (3 * H * H + 5 * H) * ps
        kv = 2 * Tk * H * es
        f2 = 6.0 * N * H * H + 4.0 * N * Tk * H
        calls.append(("K2", "fwd", f2, 2 * N * H * es + kv + w2))
        calls.append(("K2", "bwd", 2 * f2, 3 * N * H * es + 2 * kv
                      + 2 * w2))
        w3 = (8 * H * H + 7 * H) * ps
        f3 = 16.0 * N * H * H
        calls.append(("K3", "fwd", f3, 2 * N * H * es + w3))
        calls.append(("K3", "bwd", 2 * f3, 3 * N * H * es + 2 * w3))
    return calls


def adapter_step_bound_s(cfg: dict, batch: int) -> float:
    return sum(bound_s(f, b) for _, _, f, b in adapter_calls(cfg, batch))


def m_step_flops(cfg: dict, batch: int) -> float:
    """Model operations of one M step: both towers forward, the adapters
    forward and backward (backward = twice the forward's products), the
    image side of the cross-modal layers once a step, the projections
    and the loss; no recompute."""
    tw = clip_tower_flops(cfg)
    adapters = sum(f for _, d, f, _ in adapter_calls(cfg, batch)
                   if d == "fwd")
    v, t, a = cfg["vision_config"], cfg["text_config"], cfg["adapters"]
    Tv = (v["image_size"] // v["patch_size"]) ** 2 + 1
    H = t["hidden_size"]
    # image_proj and k, v of the batch-shared image sequence, per layer
    image_side = a["shared_adapter_layers"] * 2.0 * Tv * (
        v["hidden_size"] * H + 2 * H * H)
    P = cfg["projection_dim"]
    proj = 2.0 * batch * (v["hidden_size"] + H) * P
    loss = 2.0 * batch * batch * P
    return batch * (tw["vision"] + tw["text"]) + \
        3 * (adapters + image_side + proj + loss)


# ---------------------------------------------------------------------------
# Qwen2.5-VL (generation)
# ---------------------------------------------------------------------------

def qwen_dims(cfg: dict) -> dict:
    H = cfg["hidden_size"]
    hd = H // cfg["num_attention_heads"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    layer_params = H * (nq + 2 * nkv) * hd + nq * hd * H \
        + 3 * H * cfg["intermediate_size"]
    return {"H": H, "hd": hd, "nq": nq, "nkv": nkv,
            "L": cfg["num_hidden_layers"], "V": cfg["vocab_size"],
            "layer_params": layer_params}


def qwen_vision_flops(cfg: dict, image_size: int) -> float:
    """One image through the vision tower and the merger."""
    v = cfg["vision_config"]
    P, M = v["patch_size"], v["spatial_merge_size"]
    S = (image_size // P) ** 2
    Hv, inter = v["hidden_size"], v["intermediate_size"]
    win = (v["window_size"] // P) ** 2  # patches a window
    full = len(v["fullatt_block_indexes"])
    lin = 2.0 * S * (4 * Hv * Hv + 3 * Hv * inter)
    attn_full = 4.0 * S * S * Hv
    attn_win = 4.0 * S * min(win, S) * Hv
    merged = M * M * Hv
    merger = 2.0 * (S // (M * M)) * (merged * merged
                                      + merged * v["out_hidden_size"])
    patch = 2.0 * S * 3 * v["temporal_patch_size"] * P * P * Hv
    return patch + v["depth"] * lin + full * attn_full \
        + (v["depth"] - full) * attn_win + merger


def qwen_prefill_flops(cfg: dict, T: int) -> float:
    """One row's prefill of T tokens (causal attention) and the head at
    its last position."""
    d = qwen_dims(cfg)
    return d["L"] * (2.0 * T * d["layer_params"]
                     + 2.0 * T * T * d["nq"] * d["hd"]) \
        + 2.0 * d["H"] * d["V"]


def qwen_decode_token_flops(cfg: dict, depth: int) -> float:
    """One decoded token attending ``depth`` columns, with the head."""
    d = qwen_dims(cfg)
    return d["L"] * (2.0 * d["layer_params"]
                     + 4.0 * depth * d["nq"] * d["hd"]) \
        + 2.0 * d["H"] * d["V"]


def k7_bytes(cfg: dict, rows: int) -> float:
    """The int4 head's GEMV (K7): packed weight, scales, bf16 x, fp32 out."""
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    return H * V / 2 + 4 * V + 2 * rows * H + 4 * rows * V


def k7_flops(cfg: dict, rows: int) -> float:
    return 2.0 * rows * cfg["hidden_size"] * cfg["vocab_size"]


def k8_bytes(cfg: dict, depths: Iterable[int]) -> float:
    """One layer's decode attention (K8) over rows at the given depths
    (old cache columns): bf16 q and out, bf16 k and v read once, one
    fresh column each."""
    d = qwen_dims(cfg)
    depths = list(depths)
    kv_col = 2 * 2 * d["nkv"] * d["hd"]  # k and v, bf16
    return len(depths) * (2 * 2 * d["nq"] * d["hd"] + kv_col) \
        + kv_col * sum(depths)


def k8_flops(cfg: dict, depths: Iterable[int]) -> float:
    d = qwen_dims(cfg)
    return sum(4.0 * (x + 1) * d["nq"] * d["hd"] for x in depths)
