"""BASELINE config 5 (CLIP ViT-L/14@336 under pipeline M's adapters) as
the benchmark runs it: ``h100_bench/configs/clip-l14-336-m.json`` holds
the published widths; at a small size whose vision position table has
more rows than K2 takes (so the shared adapters take K2's plain route),
the port's M step follows the benchmark's fp32 reference; the towers'
attention counts the bytes of the scores it writes; and the benchmark's
reader ``attn_scores_gb.train`` divides that counter by ``m.steps``."""

from __future__ import annotations

import copy
import json
import os
import time

import pytest
import torch

from vlm_clip_tpu_torch.core import dtypes
from vlm_clip_tpu_torch.core.config import clip_preset
from vlm_clip_tpu_torch.models import clip as C
from vlm_clip_tpu_torch.models import layers as L
from vlm_clip_tpu_torch.ops import fused_adapter as FA
from vlm_clip_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "h100_bench")
CPU = torch.device("cpu")

# openai/clip-vit-large-patch14-336's config.json, with the CLIP
# tokenizer's BOS and EOS ids
PUBLISHED = {
    "vision_config": {"hidden_size": 1024, "intermediate_size": 4096,
                      "num_hidden_layers": 24, "num_attention_heads": 16,
                      "image_size": 336, "patch_size": 14,
                      "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5},
    "text_config": {"hidden_size": 768, "intermediate_size": 3072,
                    "num_hidden_layers": 12, "num_attention_heads": 12,
                    "vocab_size": 49408, "max_position_embeddings": 77,
                    "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5,
                    "bos_token_id": 49406, "eos_token_id": 49407},
    "projection_dim": 768,
    "logit_scale_init_value": 2.6592,
}


def _file(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def _limits():
    with open(os.path.join(BENCH, "limits", "m_train_l336_b32.json")) as f:
        return json.load(f)


@pytest.fixture
def bench(monkeypatch):
    """The benchmark's folder on the path, and the program's record
    empty."""
    monkeypatch.syspath_prepend(BENCH)
    P.take()
    yield
    P.take()


def _tiny(policy="FAST"):
    """clip-l14-336-m's file at small widths: 34 px in patches of 2, so
    the vision position table (the shared adapters' keys) has 290 rows;
    ring traffic of the cell's 32 pairs with captions of 4-16 tokens.
    At these widths and this batch FAST's gaps from the fp32 reference
    lie as far under the cell's limits as the cell's own (over 16 seeds:
    grad_gap at most 0.065, change_gap 0.033); at text width 32 and
    8 pairs, single bias leaves' bf16 round-off reads up to 0.15."""
    cfg = copy.deepcopy(_file("clip-l14-336-m"))
    cfg["vision_config"].update(hidden_size=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4,
                                image_size=34, patch_size=2)
    cfg["text_config"].update(hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4,
                              max_position_embeddings=16)
    cfg["projection_dim"] = 16
    cfg["adapters"].update(text_adapter_size=32, vision_adapter_size=32,
                           shared_num_heads=4)
    cfg["policy"] = policy
    tr = {"kind": "train_ring", "batch": 32, "ring": 4,
          "caption_len": [4, 16], "pad_to": 16, "check_steps": 3}
    return cfg, tr


def _score_bytes(cfg, batch, itemsize=2):
    """The attention scores both towers write a step: layers x batch x
    heads x T^2 x itemsize, T the tower's tokens."""
    v, t = cfg["vision_config"], cfg["text_config"]
    tv = (v["image_size"] // v["patch_size"]) ** 2 + 1
    tt = t["max_position_embeddings"]
    return itemsize * batch * (
        v["num_hidden_layers"] * v["num_attention_heads"] * tv * tv
        + t["num_hidden_layers"] * t["num_attention_heads"] * tt * tt)


def test_config_file_holds_the_published_widths():
    cfg = _file("clip-l14-336-m")
    for key, value in PUBLISHED.items():
        assert cfg[key] == value, key
    assert cfg["adapters"] == {"text_adapter_size": 256,
                               "vision_adapter_size": 256,
                               "shared_adapter_layers": 2,
                               "shared_num_heads": 8}
    assert (cfg["policy"], cfg["freeze_towers"]) == ("FAST", True)
    assert cfg["optimizer"]["name"] == "adam"
    p = clip_preset("vit-large-patch14-336")
    v, t = cfg["vision_config"], cfg["text_config"]
    assert (p.vision.hidden_size, p.vision.intermediate_size,
            p.vision.num_layers, p.vision.num_heads, p.vision.image_size,
            p.vision.patch_size) == (
        v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"],
        v["num_attention_heads"], v["image_size"], v["patch_size"])
    assert (p.text.hidden_size, p.text.intermediate_size, p.text.num_layers,
            p.text.num_heads, p.text.vocab_size, p.text.max_positions,
            p.text.eos_token_id) == (
        t["hidden_size"], t["intermediate_size"], t["num_hidden_layers"],
        t["num_attention_heads"], t["vocab_size"],
        t["max_position_embeddings"], t["eos_token_id"])
    assert p.projection_dim == cfg["projection_dim"]
    assert p.vision.hidden_act == v["hidden_act"] == t["hidden_act"]
    # 577 shared K/V rows: past K2's, so K2 takes its plain version
    tk = (v["image_size"] // v["patch_size"]) ** 2 + 1
    assert tk == 577 and not FA.cross_attn_block_supported(tk)


def test_score_bytes_at_the_cells_sizes():
    """The reader's values at the cells' shapes, worked out from the
    configuration files: 8.2367 GB a step of 32 pairs at config 5,
    1.1823 GB a step of 96 at ViT-B/16."""
    assert _score_bytes(_file("clip-l14-336-m"), 32) == \
        24 * 32 * 16 * 577 ** 2 * 2 + 12 * 32 * 12 * 77 ** 2 * 2
    assert round(_score_bytes(_file("clip-l14-336-m"), 32) / 1e9, 4) == \
        8.2367
    assert round(_score_bytes(_file("clip-b16-m"), 96) / 1e9, 4) == 1.1823


@pytest.mark.parametrize("policy", ["FP32", "FAST"])
def test_m_step_follows_the_reference_past_k2s_rows(bench, policy):
    """Three steps of the port's M step from the seed's numbers against
    the benchmark's fp32 reference, held to the cell's three gaps."""
    from hb import clip_m

    cfg, tr = _tiny(policy)
    v = cfg["vision_config"]
    tk = (v["image_size"] // v["patch_size"]) ** 2 + 1
    assert tk == 290 and not FA.cross_attn_block_supported(tk)
    seed = 2 ** 31 + 101
    _, _, ring, a0, losses, first_grad, after = clip_m.setup(cfg, tr, seed,
                                                             CPU)
    r = clip_m.reference_readings(seed, cfg, ring[:tr["check_steps"]], a0,
                                  losses, first_grad, after, CPU, "fp32")
    for name, limit in _limits().items():
        assert r[name] <= limit, (name, r)


@pytest.mark.parametrize("policy", ["FP32", "FAST"])
def test_attn_score_bytes_counts_each_towers_scores(bench, policy):
    from hb import clip_m

    cfg, tr = _tiny(policy)
    ccfg = clip_m._program(cfg)[0]
    pol = getattr(dtypes, policy)
    clip = clip_m.make_clip(3, cfg, CPU)
    batch = clip_m.make_batches(3, cfg, tr, CPU)[0]
    item = torch.empty((), dtype=pol.stable_dtype).element_size()
    B = tr["batch"]
    v, t = ccfg.vision, ccfg.text
    tv = (v.image_size // v.patch_size) ** 2 + 1
    tt = tr["pad_to"]
    runs = {
        "vision": (lambda: C.vision_tower(clip["vision"],
                                          batch["pixel_values"], v, pol),
                   v.num_layers * B * v.num_heads * tv * tv * item),
        "text": (lambda: C.text_tower(clip["text"], batch["input_ids"],
                                      batch["attention_mask"], t, pol),
                 t.num_layers * B * t.num_heads * tt * tt * item)}
    for name, (tower, expect) in runs.items():
        with torch.no_grad():
            tower()
            assert "layers.attn_score_bytes" not in P.take()["counts"]
            with P.tracing():
                tower()
        assert P.take()["counts"]["layers.attn_score_bytes"] == expect, name


def test_fused_attention_counts_no_score_bytes(bench):
    """K5 keeps its scores on chip: a fused call adds 0 (the counter is
    there, so the reader reads 0 and not None)."""
    g = torch.Generator().manual_seed(0)
    p = L.init_mha(g, 32)
    x = torch.randn(2, 5, 32, generator=g)
    with P.tracing():
        L.mha(p, x, x, 4, fused=True)
    assert P.take()["counts"]["layers.attn_score_bytes"] == 0


def test_attn_scores_reader(bench, monkeypatch):
    from hb.common import read_metric

    with P.tracing():
        P.count("layers.attn_score_bytes", 3_000_000_000)
        P.count("m.steps")
        P.count("m.steps")
    ctx = {}
    assert read_metric("attn_scores_gb.train", ctx) == pytest.approx(1.5)
    # one take a run: a second reader reads the same
    assert read_metric("attn_scores_gb.train", ctx) == pytest.approx(1.5)
    with P.tracing():
        P.count("m.steps")
    assert read_metric("attn_scores_gb.train", {}) is None  # no counter
    with P.tracing():
        P.count("layers.attn_score_bytes", 8)
    assert read_metric("attn_scores_gb.train", {}) is None  # no m.steps
    assert read_metric("attn_scores_gb.train", {}) is None  # nothing
    with monkeypatch.context() as m:
        m.delattr(P, "take")  # a program without the tracer
        assert read_metric("attn_scores_gb.train", {}) is None


def test_traced_tiny_run_reads_the_score_bytes(bench):
    """A traced run of the cell's kind at the small size: the reader
    reads both towers' scores a step, the text tower's at the padded
    caption length."""
    from hb.common import load_kind, read_metric

    cfg, tr = _tiny()
    lim = {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}
    out = load_kind("train_ring").run({}, cfg, tr, 5, 0.2, True, CPU,
                                      time.perf_counter(), lim)
    want = _score_bytes(dict(cfg, text_config=dict(
        cfg["text_config"], max_position_embeddings=tr["pad_to"])),
        tr["batch"]) / 1e9
    assert read_metric("attn_scores_gb.train", out["ctx"]) == \
        pytest.approx(want)
