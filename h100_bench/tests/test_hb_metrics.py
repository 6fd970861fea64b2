"""The metric arithmetic against hand computations: rates, the union of
intervals, idle shares and gaps, bounds, operation counts and the
readers."""

import json
import os

import pytest

from hb import costs
from hb.common import (PEAK_BF16_FLOPS, PEAK_HBM_BYTES, Checks,
                       forbidden_loaded, read_metric)
from hb.trace import Trace, merged, union_seconds

from conftest import BENCH


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_rates():
    assert read_metric("train_pairs_per_s",
                       {"pairs": 960, "window_s": 0.5}) == 1920
    assert read_metric("gen_tokens_per_s",
                       {"tokens": 6400, "window_s": 10.0}) == 640


def test_union_gaps_and_idle():
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    t = Trace([("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("Memcpy HtoD", 6.0,
                                                       7.0)],
              [("poll", 0.0, 5.0), ("wait", 5.0, 8.0)])
    assert t.window() == (0.0, 8.0)
    assert t.busy_seconds() == 3.0
    assert t.count() == 2
    assert t.device_seconds(("k",)) == 2.5
    assert t.idle_gaps(2) == [["poll", 3.0], ["poll", 1.0]]
    # busy 3 s over one traced batch, against unprofiled batches of 4 s
    assert read_metric("device_idle_pct.gen",
                       {"trace": t, "traced_batches": 1,
                        "batch_walls": [3.5, 4.5]}) == pytest.approx(25.0)
    # busy 1.5 s a traced step, against 10 unprofiled steps in 20 s
    ctx = {"trace": t, "traced_steps": 2, "steps": 10, "window_s": 20.0}
    assert read_metric("step_device_ms.train", ctx) == pytest.approx(1500)
    assert read_metric("device_idle_pct.train", ctx) == pytest.approx(25.0)
    empty = dict(ctx, trace=Trace([], [("step", 0.0, 1.0)]))
    assert read_metric("step_device_ms.train", empty) is None
    assert read_metric("device_idle_pct.train", empty) is None


def test_bounds_by_hand():
    assert costs.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert costs.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    # one encoder layer: 4 H^2 + 2 H I products a token, attention 4 S^2 H
    assert costs.encoder_layer_flops(2, 3, 5) == 2 * 2 * (36 + 30) + 4 * 4 * 3
    cfg = _cfg("clip-b16-m")
    calls = costs.adapter_calls(cfg, 96)
    assert [c[:2] for c in calls][:4] == [("K1", "fwd"), ("K1", "bwd"),
                                          ("K1", "fwd"), ("K1", "bwd")]
    # K1 text forward: two products of 7392 x 512 x 256
    assert calls[0][2] == 2 * 2.0 * 96 * 77 * 512 * 256
    # its bytes: bf16 rows in and out, fp32 weights and LayerNorm
    assert calls[0][3] == 2 * 96 * 77 * 512 * 2 + (2 * 512 * 256 + 256
                                                   + 3 * 512) * 4
    assert len(calls) == 4 + 4 * cfg["adapters"]["shared_adapter_layers"]


def test_qwen_counts_by_hand():
    cfg = _cfg("qwen25vl-3b-8h4")
    d = costs.qwen_dims(cfg)
    assert d["layer_params"] == 2048 * (16 + 4) * 128 + 2048 * 2048 \
        + 3 * 2048 * 11008
    tok = costs.qwen_decode_token_flops(cfg, 300)
    assert tok == 36 * (2 * d["layer_params"] + 4 * 300 * 2048) \
        + 2 * 2048 * 151936
    # K7 reads the packed int4 head once: K * N / 2 bytes and fp32 scales
    assert costs.k7_bytes(cfg, 0) == 2048 * 151936 / 2 + 4 * 151936
    # K8 at one row of depth 10: q and out, 10 + 1 columns of k and v
    assert costs.k8_bytes(cfg, [10]) == 2 * 2 * 16 * 128 + 11 * 2 * 2 * 2 \
        * 128


def test_readers_on_a_synthetic_trace():
    cfg = _cfg("clip-b16-m")
    bound = costs.adapter_step_bound_s(cfg, 96)
    t = Trace([("seqfwd_pre_kernel", 0.0, 2 * bound),
               ("gemm_other", 0.0, 1.0)], [])
    ctx = {"trace": t, "traced_steps": 1, "config": cfg, "batch": 96,
           "steps": 10, "window_s": 1.0}
    assert read_metric("adapter_roofline_pct.train", ctx) == \
        pytest.approx(50.0)
    assert read_metric("mfu_pct.train", ctx) == pytest.approx(
        100 * 10 * costs.m_step_flops(cfg, 96) / PEAK_BF16_FLOPS)
    assert read_metric("adapter_roofline_pct.train",
                       dict(ctx, trace=Trace([], []))) is None
    assert PEAK_HBM_BYTES == 3.35e12


def test_checks_and_forbidden_modules():
    c = Checks()
    c.add("gap", 0.1, 0.5)
    assert c.ok()
    c.add("other", float("nan"), 1.0)
    assert not c.ok()
    assert forbidden_loaded(["vlm_clip_tpu_torch.ops", "torch"]) == []
    assert forbidden_loaded(["vlm_clip_tpu.ops.quant", "jax.numpy",
                             "flax"]) == ["flax", "jax", "vlm_clip_tpu"]
