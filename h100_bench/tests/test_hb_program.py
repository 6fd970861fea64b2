"""The reader of the program's own spans (``hb/program.py``) against a
hand computation on a synthetic trace and record; the existing readers
read the same with the program's spans merged into the trace; the idle
gaps take the innermost program span's name, and keep the benchmark's
labels in a cell none of whose metrics reads the program; a program
without the tracer gives nothing; and tiny runs of both kinds on the CPU
record the program's spans."""

import time

import pytest
import torch

import run
from hb import program as HP
from hb.common import read_metric
from hb.trace import Trace

from conftest import kind

NEW = ("prefill_device_ms.gen",)
S = 1_000_000_000  # ns a second


@pytest.fixture
def record(monkeypatch):
    """Make the program's take() hand over the given record."""
    from vlm_clip_tpu_torch.utils import profiling

    def use(spans, counts):
        monkeypatch.setattr(profiling, "take",
                            lambda: {"spans": spans, "counts": counts})
    return use


def _gen_trace():
    """One traced batch, 10-20 s: prepare 10-11, prefill 11-13, a stop
    check 13-14, two decode steps (14-15.5, 16-17.5) each followed by a
    check (15.5-16, 17.5-19), readback 19-19.5. Device: the prefill's
    kernels 11.5-13.5 and a 0.25 s copy at 12, the decode kernels."""
    ops = [("vision", 11.5, 12.5), ("Memcpy HtoD", 12.0, 12.25),
           ("prefill", 12.5, 13.5), ("dec0", 14.5, 15.75),
           ("dec1", 16.5, 18.5)]
    return Trace(ops, [("generate", 10.0, 20.0)])


GEN_SPANS = [(1, None, "qwen.generate_batch", 10 * S, 19.75 * S),
             (2, 1, "qwen.prepare", 10 * S, 11 * S),
             (3, 1, "qwen.prefill", 11 * S, 13 * S),
             (4, 1, "qwen.stop_check", 13 * S, 14 * S),
             (5, 1, "qwen.decode_step", 14 * S, 15.5 * S),
             (6, 1, "qwen.stop_check", 15.5 * S, 16 * S),
             (7, 1, "qwen.decode_step", 16 * S, 17.5 * S),
             (8, 1, "qwen.stop_check", 17.5 * S, 19 * S),
             (9, 1, "qwen.readback", 19 * S, 19.5 * S),
             # an earlier pass's prefill, outside the trace: left out
             (10, None, "qwen.prefill", 2 * S, 4 * S)]
GEN_COUNTS = {"qwen.decode_forwards": 2, "qwen.prefill_rows": 64}


def _gen_ctx():
    return {"trace": _gen_trace(), "traced_batches": 1,
            "batch_walls": [10.0, 12.0], "prefill_ms": 2000.0,
            "prefill_kernels": 2, "traced_lens": [3, 2],
            "decoded": [3, 2, 3, 1],
            "traffic": {"batch": 2, "max_new_tokens": 3, "image_size": 448}}


def test_generation_readers_by_hand(record):
    record(GEN_SPANS, GEN_COUNTS)
    ctx = _gen_ctx()
    # ops starting in 11-14: 11.5-13.5 (the copy inside it) = 2 s
    assert read_metric("prefill_device_ms.gen", ctx) == pytest.approx(2000)
    assert [s[0] for s in ctx["program_spans"]].count("qwen.prefill") == 1


def test_breakdown_without_a_program_reader_keeps_the_harness_labels(
        record, tiny_clip):
    """m_train_b96 has no metric that reads the program: its breakdown
    is built as ``run.py`` builds it and keeps the benchmark's spans."""
    bench, c, cfg, _ = run.load_cell("m_train_b96")
    record([(1, None, "m.step", 1 * S, 3 * S),
            (2, 1, "m.text", 1 * S, 2 * S)], {"m.steps": 1})
    ctx = {"trace": Trace([("seqfwd_pre_kernel", 1.5, 2.0),
                           ("gemm", 2.5, 3.0)],
                          [("step", 0.5, 3.5), ("sync", 3.5, 4.0)]),
           "traced_steps": 1, "steps": 4, "window_s": 8.0,
           "pairs": 384, "batch": 96, "config": cfg}
    names = [m["name"] for m in run.metric_names(bench, c, True)]
    assert names and not set(names) & set(NEW)
    for m in names:
        read_metric(m, ctx)
    assert "program_spans" not in ctx
    assert ctx["trace"].idle_gaps(3) == [["step", pytest.approx(1.0)],
                                        ["sync", pytest.approx(1.0)],
                                        ["step", pytest.approx(0.5)]]


@pytest.mark.parametrize("cell", ["m_train_b96", "ctx_gen_b32"])
def test_existing_readers_unchanged_by_the_merge(record, cell, tiny_clip,
                                                 tiny_qwen):
    bench, c, cfg, _ = run.load_cell(cell)
    if cell == "ctx_gen_b32":
        record(GEN_SPANS, GEN_COUNTS)
        ctx = dict(_gen_ctx(), config=cfg, prompt_len=40, installs=4,
                   window_s=22.0, tokens=9)
    else:
        record([(1, None, "m.step", 1 * S, 3 * S)], {"m.steps": 1})
        ctx = {"trace": Trace([("seqfwd_pre_kernel", 1.5, 2.0),
                               ("gemm", 2.0, 2.5)],
                              [("step", 0.5, 3.5), ("sync", 3.5, 4.0)]),
               "traced_steps": 1, "steps": 4, "window_s": 8.0,
               "pairs": 384, "batch": 96, "config": cfg}
    old = [m["name"] for m in run.metric_names(bench, c, True)
           if m["name"] not in NEW]
    before = {m: read_metric(m, ctx) for m in old}
    w = ctx["trace"].window()
    assert HP.program(ctx) is not None
    assert ctx["trace"].window() == w
    assert {m: read_metric(m, ctx) for m in old} == before
    assert all(read_metric(m["name"], ctx) is not None
               for m in run.metric_names(bench, c, True)
               if m["name"] in NEW)


def test_gaps_take_the_innermost_program_span(record):
    record(GEN_SPANS, GEN_COUNTS)
    ctx = _gen_ctx()
    t = ctx["trace"]
    assert {g[0] for g in t.idle_gaps(10)} == {"generate"}
    HP.program(ctx)
    gaps = t.idle_gaps(3)
    # 10-11.5, 18.5-20 (its midpoint in the readback), 13.5-14.5
    assert gaps == [["qwen.prepare", pytest.approx(1.5)],
                    ["qwen.readback", pytest.approx(1.5)],
                    ["qwen.stop_check", pytest.approx(1.0)]]


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    from vlm_clip_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "take")
    ctx = _gen_ctx()
    spans = list(ctx["trace"].spans)
    for m in NEW:
        assert read_metric(m, ctx) is None
    assert ctx["trace"].spans == spans


@pytest.mark.parametrize("family", ["clip_m", "qwen_vl"])
def test_tiny_runs_read_the_program_spans(family, tiny_clip, tiny_qwen):
    cell = "m_train_b96" if family == "clip_m" else "ctx_gen_b32"
    c = run.load_cell(cell)[1]
    cfg, tr = tiny_clip if family == "clip_m" else tiny_qwen
    lim = {"loss_gap": 1, "grad_gap": 1, "change_gap": 1, "token_gap": 1}
    out = kind(tr["kind"]).run(c, cfg, tr, 3, 0.2, True,
                               torch.device("cpu"), time.perf_counter(), lim)
    ctx = out["ctx"]
    spans = HP.program(ctx)
    top = "m.step" if family == "clip_m" else "qwen.generate_batch"
    assert any(s[0] == top for s in spans)
    assert any(s[0] == top for s in ctx["trace"].spans)
