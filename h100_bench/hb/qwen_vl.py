"""The ``qwen_vl`` family: what a traffic kind of Qwen2.5-VL context
generation through the program's ``vlm/qwen.QwenVLGenerator`` builds on.

Set-up makes the fp32 weights on the device from the seed in the
program's tree layout and hands them to the program's own load path (the
patch-normalization fold, then ``quantize_preset``), as a checkpoint
would be (:func:`build_generator`). After the window the program is
freed and the plain reference is run teacher-forced over a seeded sample
of finished requests (the longest among them): the widest gap by which a
served (greedy) token's logit lies below the reference's best
(:func:`judge`). The reference works the configuration's preset out
again from the same fp32 numbers with ``reference/quant_<preset>.py``.
"""

from __future__ import annotations

import os
import re
import zlib
from typing import Dict, List

import torch

from hb import traffic as TR
from hb.common import BENCH_DIR, Checks, load_module

CHAT_PREFIX = ("<|im_start|>system\nYou are a helpful assistant."
               "<|im_end|>\n<|im_start|>user\n<|vision_start|>")
CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"


class Words:
    """A word-level stand-in tokenizer (no tokenizer.json here): the chat
    template's special tokens at their published ids, every other
    whitespace-separated word at crc32(word) mod 150000."""

    def __init__(self, special: Dict[str, int]):
        self.special = special
        self._pat = re.compile("(" + "|".join(map(re.escape, special)) + ")")

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for part in self._pat.split(text):
            if part in self.special:
                ids.append(self.special[part])
            else:
                ids += [zlib.crc32(w.encode()) % 150000 for w in part.split()]
        return ids


def prompt_ids(tok: Words, prompt: str, n_vis: int, cfg: dict) -> List[int]:
    """The single-image chat prompt: the image's pads after
    <|vision_start|>, then <|vision_end|>, the prompt and the
    assistant's turn."""
    return (tok.encode(CHAT_PREFIX) + [cfg["image_token_id"]] * n_vis
            + tok.encode("<|vision_end|>" + prompt + CHAT_SUFFIX))


# ---------------------------------------------------------------------------
# weights from the seed, in the program's tree layout (fp32)
# ---------------------------------------------------------------------------

def make_weights(seed: int, cfg: dict, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    L, H = cfg["num_hidden_layers"], cfg["hidden_size"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, inter, V = H // nq, cfg["intermediate_size"], cfg["vocab_size"]

    def lin(lead, din, dout, bias):
        p = {"kernel": torch.randn(*lead, din, dout, generator=g,
                                   device=dev) * din ** -0.5}
        if bias:
            p["bias"] = torch.randn(*lead, dout, generator=g,
                                    device=dev) * 0.02
        return p

    def ones(*shape):
        return {"scale": torch.ones(*shape, device=dev)}

    text = {
        "embed_tokens": torch.randn(V, H, generator=g, device=dev) * 0.02,
        "layers": {
            "attn": {"q": lin((L,), H, nq * hd, True),
                     "k": lin((L,), H, nkv * hd, True),
                     "v": lin((L,), H, nkv * hd, True),
                     "o": lin((L,), nq * hd, H, False)},
            "mlp": {"gate": lin((L,), H, inter, False),
                    "up": lin((L,), H, inter, False),
                    "down": lin((L,), inter, H, False)},
            "ln1": ones(L, H), "ln2": ones(L, H)},
        "final_norm": ones(H),
    }
    v = cfg["vision_config"]
    D, Hv, vi = v["depth"], v["hidden_size"], v["intermediate_size"]
    pin = 3 * v["temporal_patch_size"] * v["patch_size"] ** 2
    merged = v["spatial_merge_size"] ** 2 * Hv
    vision = {
        "patch_embed": {"kernel": torch.randn(pin, Hv, generator=g,
                                              device=dev) * pin ** -0.5},
        "blocks": {
            "attn": {"qkv": lin((D,), Hv, 3 * Hv, True),
                     "proj": lin((D,), Hv, Hv, True)},
            "mlp": {"gate": lin((D,), Hv, vi, True),
                    "up": lin((D,), Hv, vi, True),
                    "down": lin((D,), vi, Hv, True)},
            "ln1": ones(D, Hv), "ln2": ones(D, Hv)},
        "merger": {"ln_q": ones(Hv),
                   "fc1": lin((), merged, merged, True),
                   "fc2": lin((), merged, v["out_hidden_size"], True)},
    }
    return {"text": text, "vision": vision}


def program_config(cfg: dict):
    from vlm_clip_tpu_torch.vlm.qwen_model import (QwenTextConfig,
                                                   QwenVisionConfig,
                                                   QwenVLConfig)

    v = cfg["vision_config"]
    H, nq = cfg["hidden_size"], cfg["num_attention_heads"]
    return QwenVLConfig(
        text=QwenTextConfig(
            hidden_size=H, intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"], num_heads=nq,
            num_kv_heads=cfg["num_key_value_heads"], head_dim=H // nq,
            vocab_size=cfg["vocab_size"], rms_norm_eps=cfg["rms_norm_eps"],
            rope_theta=cfg["rope_theta"],
            mrope_section=tuple(cfg["rope_scaling"]["mrope_section"]),
            tie_word_embeddings=cfg["tie_word_embeddings"]),
        vision=QwenVisionConfig(
            hidden_size=v["hidden_size"],
            intermediate_size=v["intermediate_size"],
            out_hidden_size=v["out_hidden_size"], depth=v["depth"],
            num_heads=v["num_heads"], patch_size=v["patch_size"],
            temporal_patch_size=v["temporal_patch_size"],
            spatial_merge_size=v["spatial_merge_size"],
            window_size=v["window_size"],
            fullatt_block_indexes=tuple(v["fullatt_block_indexes"])),
        image_token_id=cfg["image_token_id"],
        vision_start_token_id=cfg["vision_start_token_id"],
        eos_token_id=cfg["eos_token_id"])


def build_generator(seed: int, cfg: dict, dev):
    """The program's generator over the seed's weights, loaded as a
    checkpoint is: the normalization folded into the patch embed, then
    the configuration's preset."""
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator, quantize_preset
    from vlm_clip_tpu_torch.vlm.qwen_convert import \
        fold_qwen_patch_normalization

    qcfg = program_config(cfg)
    params = make_weights(seed, cfg, dev)
    params["vision"] = fold_qwen_patch_normalization(params["vision"],
                                                     qcfg.vision)
    params, qcfg = quantize_preset(params, qcfg, cfg["preset"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    kv_bits = {"bf16": 16, "int8": 8}[cfg["kv_cache"]]
    gen = QwenVLGenerator(params, qcfg, max_len=cfg["max_len"],
                          kv_bits=kv_bits)
    gen.u8_patches = True
    return gen


# ---------------------------------------------------------------------------
# what the traffic kinds share
# ---------------------------------------------------------------------------

def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def alter(tokens: List[int], V: int) -> List[int]:
    """The fault "token": a served token altered where it is produced."""
    if not tokens:
        return tokens
    i = len(tokens) // 2
    return tokens[:i] + [(tokens[i] + 1) % V] + tokens[i + 1:]


def image_pool(seed: int, tr: dict):
    """The traffic's images, from the seed: [pool, size, size, 3] uint8."""
    return TR.images(tr.get("image_pool", 64), tr["image_size"],
                     TR.rng(seed, 4))


def served_prompt(cfg: dict, tr: dict) -> List[int]:
    return prompt_ids(Words(cfg["special_tokens"]), tr["prompt"],
                      _n_vis(cfg, tr["image_size"]), cfg)


def judge(seed: int, cfg: dict, tr: dict, pool, served, limits: dict,
          dev) -> Checks:
    """The comparison of a run's served tokens, held to the limits. Call
    it once the program is freed."""
    checks = Checks()
    gap = served_gap(seed, cfg, tr, pool, served_prompt(cfg, tr), served,
                     dev)
    checks.add("token_gap", gap, limits["token_gap"])
    return checks


def _n_vis(cfg: dict, size: int) -> int:
    v = cfg["vision_config"]
    return (size // v["patch_size"] // v["spatial_merge_size"]) ** 2


def sample(served, n: int, seed: int) -> list:
    """A seeded sample of n finished requests, the longest among them."""
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: len(served[i][1]))
    rest = [i for i in range(len(served)) if i != longest]
    pick = TR.rng(seed, 5).permutation(len(rest))[:max(0, n - 1)]
    return [served[longest]] + [served[rest[i]] for i in sorted(pick)]


def _with_stop(cfg, budget, toks):
    """The served tokens, with the stop token that ended a row early."""
    return list(toks) + ([cfg["eos_token_id"]] if len(toks) < budget
                         else [])


def preset(name: str):
    """``reference/quant_<name>.py``: the preset's weight-only quantization
    worked out again (``weights(raw)``) and its control, the precision
    below (``control(raw)``)."""
    path = os.path.join(BENCH_DIR, "reference", f"quant_{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no reference for preset {name!r} ({path})")
    return load_module(path, f"hb_quant_{name}")


def served_gap(seed, cfg, tr, pool, ids, served, dev, control=False):
    """The widest gap, over a sample of finished requests, by which a
    served token's reference logit lies below the reference's best.
    ``control``: instead, the gap of the token that the preset's control
    (the precision below) puts first, on the same tokens."""
    from reference import qwen_vl as R

    q = preset(cfg["preset"])
    raw = make_weights(seed, cfg, dev)
    ref = q.weights(raw)
    alt = q.control(raw) if control else None
    del raw
    worst = 0.0
    for img_i, toks, budget in sample(served, tr["check_rows"], seed):
        toks = _with_stop(cfg, budget, toks)
        logits = R.served_logits(ref, cfg, ids, pool[img_i], toks, dev)
        if alt is None:
            chosen = torch.tensor(toks, device=dev)
        else:
            chosen = R.served_logits(alt, cfg, ids, pool[img_i], toks,
                                     dev).argmax(-1)
        worst = max(worst, R.widest_gap(logits, chosen))
    return worst
