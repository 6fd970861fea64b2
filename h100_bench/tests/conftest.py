"""Shared set-up of the benchmark's own tests (run them with
``python -m pytest h100_bench/tests -p no:cacheprovider``): the harness's
folder on the path, tiny configurations and traffic for CPU runs, and
the ``card`` marker of tests that need a CUDA card (they decide inside
the test, and skip without one)."""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

PROMPT = "Describe the emotion of the person in this image."


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def kind(name):
    from hb.common import load_kind

    return load_kind(name)


def limits(workload):
    with open(os.path.join(BENCH, "limits", f"{workload}.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_clip():
    """clip-b16-m's file at tiny widths, and ring traffic of 8 pairs."""
    cfg = copy.deepcopy(_cfg("clip-b16-m"))
    cfg["vision_config"].update(hidden_size=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4,
                                image_size=32, patch_size=8)
    cfg["text_config"].update(hidden_size=32, intermediate_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              max_position_embeddings=16)
    cfg["projection_dim"] = 16
    cfg["adapters"].update(text_adapter_size=8, vision_adapter_size=8,
                           shared_num_heads=4)
    tr = {"kind": "train_ring", "batch": 8, "ring": 4, "caption_len": [4, 16],
          "pad_to": 16, "check_steps": 3}
    return cfg, tr


@pytest.fixture
def tiny_qwen():
    """qwen25vl-3b-8h4's file at tiny widths (the published vocabulary,
    so the special ids hold) and static batches at a tiny load."""
    cfg = copy.deepcopy(_cfg("qwen25vl-3b-8h4"))
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_len=160)
    cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [2, 3, 3]}
    cfg["vision_config"].update(depth=4, hidden_size=32, intermediate_size=64,
                                num_heads=2, out_hidden_size=64,
                                fullatt_block_indexes=[1, 3])
    tr = {"kind": "static_batches", "batch": 2, "max_new_tokens": 6,
          "image_size": 224, "prompt": PROMPT, "image_pool": 4,
          "check_rows": 3, "control_seconds": 0.5}
    return cfg, tr
