"""The comparison fails what it must: a run of the harness (all but the
look for a card) with the timed path broken underneath, and the controls
(the reference one precision below the configuration's, in the
program's place), at tiny sizes on the CPU. The cells' own readings at
their sizes on the card are in PERF.md."""

import time

import pytest
import torch

from hb import clip_m, qwen_vl

from conftest import kind, limits

CPU = torch.device("cpu")
# At these tiny widths the logits spread about a sixth of the cell's
# (0.02 * sqrt(64) against 0.02 * sqrt(2048)), so the served runs here
# hold the same comparison to a limit of their own, between the tiny
# program's readings (0 to 0.002) and the tiny int4 control's (0.08 to
# 0.19); the cells' limit sits likewise between the card's readings.
TINY_SERVED = {"token_gap": 0.04}


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_training_faults_fail(tiny_clip, fault):
    cfg, tr = tiny_clip
    out = kind("train_ring").run({}, cfg, tr, 2 ** 31 + 21, 0.2, False, CPU,
                                 time.perf_counter(), limits("m_train_b96"),
                                 fault=fault)
    assert not out["correct"], out["checks"].items


def test_training_runs_correct_unbroken(tiny_clip):
    """Unbroken (in fp32: at tiny widths bf16's gaps are not the cell's),
    the same run is correct and traced."""
    cfg, tr = tiny_clip
    out = kind("train_ring").run({}, dict(cfg, policy="FP32"), tr,
                                 2 ** 31 + 21, 0.2, True, CPU,
                                 time.perf_counter(), limits("m_train_b96"))
    assert out["correct"], out["checks"].items
    assert out["ctx"]["steps"] >= 1 and "trace" in out["ctx"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_training_control_fails(tiny_clip, seed):
    cfg, tr = tiny_clip
    ring = clip_m.make_batches(seed, cfg, tr, CPU)[:tr["check_steps"]]
    a0 = dict(clip_m._leaf_paths(clip_m.make_adapters(seed, cfg, CPU)))
    r = clip_m.reference_readings(seed, cfg, ring, a0, None, None, None,
                                  CPU, "fp8")
    lim = limits("m_train_b96")
    assert any(r[k] > lim[k] for k in lim), r


def test_training_control_run_comes_out_not_correct(tiny_clip):
    """control.py's path: the control and the half-batch fault, held to
    the cell's limits, come out not correct."""
    cfg, tr = tiny_clip
    out = kind("train_ring").control({}, cfg, tr, 2 ** 31 + 23, CPU,
                                     limits("m_train_b96"))
    assert set(out) == {"control_fp8", "fault_half_batch"}
    assert not any(c.ok() for c in out.values()), \
        {k: c.items for k, c in out.items()}


def test_served_token_fault_fails(tiny_qwen):
    cfg, tr = tiny_qwen
    k = kind("static_batches")
    good = k.run({}, cfg, tr, 2 ** 31 + 31, 1.0, True, CPU,
                 time.perf_counter(), TINY_SERVED)
    assert good["correct"], good["checks"].items
    bad = k.run({}, cfg, tr, 2 ** 31 + 31, 1.0, False, CPU,
                time.perf_counter(), TINY_SERVED, fault="token")
    assert not bad["correct"], bad["checks"].items


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_served_control_reads_far_above_the_program(tiny_qwen, seed):
    """control.py's path: the program comes out correct, the int4 control
    and the altered token not."""
    cfg, tr = tiny_qwen
    out = kind("static_batches").control({}, cfg, tr, seed, CPU, TINY_SERVED)
    assert out["program"].ok(), out["program"].items
    assert not out["control"].ok() and not out["fault_token"].ok(), \
        {k: c.items for k, c in out.items()}


def test_served_gap_of_the_control_is_its_own(tiny_qwen):
    """The control is the preset's reference one precision below, found
    by the preset's name."""
    cfg, _ = tiny_qwen
    q = qwen_vl.preset(cfg["preset"])
    w = torch.tensor([[1.0, -0.5], [-2.0, 0.3]])
    raw = {"text": {"embed_tokens": w, "x": {"kernel": w}},
           "vision": {"y": {"kernel": w}}}
    assert not torch.equal(q.weights(raw)["text"]["x"]["kernel"],
                           q.control(raw)["text"]["x"]["kernel"])
    with pytest.raises(ValueError, match="no reference for preset"):
        qwen_vl.preset("nf3")
