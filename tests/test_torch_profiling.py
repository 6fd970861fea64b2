"""The port's tracing and debug utilities (utils/profiling.py), on the
CPU: the program's spans nest by thread and survive an exception, cost
one shared no-op with tracing off, and are recorded while a profiler
collects, on the profiler's clock; counters and take() (with the op
modules' launch counts); the trace file holds the annotated regions and
the program's spans; the M train step and batched Qwen generation record
their spans and counters; debug_mode makes a NaN raise, as
jax_debug_nans does, and restores the previous mode on exit."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import port_clip_config, tiny_qwen
from helpers import tiny_clip_config
from vlm_clip_tpu.utils import profiling as RP
from vlm_clip_tpu_torch.core.config import AdapterConfig
from vlm_clip_tpu_torch.core.dtypes import FP32
from vlm_clip_tpu_torch.ops import quant as PQ
from vlm_clip_tpu_torch.train import optim as O
from vlm_clip_tpu_torch.train import steps as S
from vlm_clip_tpu_torch.utils import profiling as P
from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator


@pytest.fixture
def clean():
    """Nothing recorded before and after the test."""
    P.take()
    yield
    P.take()


def _by_name(spans):
    return {name: (sid, parent) for sid, parent, name, _, _ in spans}


def test_spans_nest_by_parent_across_an_exception(clean):
    with P.tracing():
        with P.annotate("outer"):
            with P.annotate("a"):
                pass
            with pytest.raises(ValueError):
                with P.annotate("b"):
                    with P.annotate("b.inner"):
                        raise ValueError("boom")
            with P.annotate("c"):
                pass
        with P.annotate("after"):
            pass
    spans = P.take()["spans"]
    got = _by_name(spans)
    assert set(got) == {"outer", "a", "b", "b.inner", "c", "after"}
    outer = got["outer"][0]
    assert got["outer"][1] is None and got["after"][1] is None
    assert got["a"][1] == got["b"][1] == got["c"][1] == outer
    assert got["b.inner"][1] == got["b"][0]
    assert len({sid for sid, *_ in spans}) == len(spans)
    for _, _, _, t0, t1 in spans:
        assert t0 <= t1
    assert P.take()["spans"] == []


def test_tracing_off_records_nothing_and_shares_one_noop(clean):
    a, b = P.annotate("x"), P.annotate("y")
    assert a is b
    with a:
        P.count("n", 3)
    assert P.take()["spans"] == []
    with P.tracing():
        assert P.annotate("x") is not a
    assert P.annotate("x") is a
    assert "n" not in P.take()["counts"]


def test_spans_recorded_while_a_profiler_collects_on_its_clock(clean):
    """Off by the switch, a span still records inside a torch.profiler
    session, and the profiler's record of a region inside the span lies
    inside it: one clock (CPU records here; the card's kernels in
    h100_bench/tests/test_hb_clock.py)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.annotate("span"):
            with torch.profiler.record_function("inside"):
                x = torch.ones(128, 128)
                (x @ x).sum()
        P.count("k")
    with P.annotate("later"):
        pass
    rec = P.take()
    assert [s[2] for s in rec["spans"]] == ["span"] and rec["counts"]["k"] == 1
    _, _, _, t0, t1 = rec["spans"][0]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "inside"]
    assert len(ev) == 1
    a, b = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    # the profiler's CPU clock is approximate (a cycle counter scaled)
    assert t0 - 1_000_000 <= a <= b <= t1 + 1_000_000


def test_count_and_take_snapshot_launch_counts(clean, monkeypatch):
    base = PQ.quant_matmul_int4.launches
    monkeypatch.setattr(PQ.quant_matmul_int4, "launches", base + 7)
    with P.tracing():
        P.count("steps")
        P.count("rows", 32)
        P.count("rows", 32)
    rec = P.take()
    assert rec["counts"]["steps"] == 1 and rec["counts"]["rows"] == 64
    # launches since the last take (the fixture's)
    assert rec["counts"]["launches.quant_matmul_int4"] == 7
    for key in ("decode_attention_kernel", "fused_attention",
                "contrastive_loss_fused", "seq_adapter_fused"):
        assert rec["counts"][f"launches.{key}"] == 0
    again = P.take()["counts"]
    assert "steps" not in again and again["launches.quant_matmul_int4"] == 0
    PQ.quant_matmul_int4.launches = base + 9
    assert P.take()["counts"]["launches.quant_matmul_int4"] == 2
    PQ.reset_launch_counts()  # a reset since the last take: all new
    PQ.quant_matmul_int4.launches = 3
    assert P.take()["counts"]["launches.quant_matmul_int4"] == 3


def test_trace_writes_an_annotated_trace(tmp_path):
    with P.trace(str(tmp_path / "prof")):
        with P.annotate("vct_region"):
            x = torch.ones(64, 64)
            (x @ x).sum()
    path = tmp_path / "prof" / "trace.json"
    assert os.path.isfile(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "vct_region" for e in events)


def test_trace_writes_program_spans_and_counters(tmp_path, clean):
    with P.trace(str(tmp_path / "prof")):
        with P.annotate("vct_outer"):
            with P.annotate("vct_inner"):
                P.count("vct_rows", 5)
                torch.ones(8).sum()
    assert P.annotate("x") is P.annotate("y")  # off again after the scope
    with open(tmp_path / "prof" / "trace.json") as f:
        doc = json.load(f)
    ours = {e["name"]: e for e in doc["traceEvents"]
            if e.get("cat") == "program"}
    outer, inner = ours["vct_outer"], ours["vct_inner"]
    assert inner["args"]["parent"] == outer["args"]["id"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert ours["program"]["ph"] == "C"
    assert ours["program"]["args"] == {"vct_rows": 5}
    # on the profiler's timeline: near its own events, not at an offset
    ts = [e["ts"] for e in doc["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") != "program"]
    assert min(ts) - 1e6 < outer["ts"] < max(ts) + 1e6


def test_m_train_step_records_its_spans(clean):
    cfg = port_clip_config(tiny_clip_config())
    acfg = AdapterConfig(text_adapter_size=16, vision_adapter_size=16,
                         shared_adapter_layers=1, shared_num_heads=4)
    gen = torch.Generator().manual_seed(0)
    tx = O.adam(1e-3)
    state = S.init_train_state(gen, cfg, acfg, tx, device="cpu")
    step = S.make_m_train_step(cfg, acfg, tx, FP32)
    ids = torch.randint(3, 90, (3, 9), generator=gen)
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids),
             "pixel_values": torch.randn(3, 3, 32, 32, generator=gen)}
    state, _ = step(state, batch)  # tracing off: nothing recorded
    assert P.take()["spans"] == []
    with P.tracing():
        state, m = step(state, batch)
    rec = P.take()
    spans = rec["spans"]
    top = [s for s in spans if s[2] == "m.step"]
    assert len(top) == 1 and top[0][1] is None
    children = [s[2] for s in spans if s[1] == top[0][0]]
    assert children == ["m.text", "m.image", "m.loss", "m.backward",
                        "m.optimizer"]
    text = [s for s in spans if s[2] == "m.text"][0]
    assert [s[2] for s in spans if s[1] == text[0]] == ["m.cross_modal"]
    assert len(spans) == 7
    assert rec["counts"]["m.steps"] == 1 and rec["counts"]["m.pairs"] == 3
    assert np.isfinite(float(m.loss))


class _Words:
    """A stand-in tokenizer: one small id a word."""

    def encode(self, text):
        return [3 + len(w) % 50 for w in text.split()]


def test_generate_batch_counts_the_forwards_it_runs(clean, monkeypatch):
    _, pcfg, _, pp = tiny_qwen(7)
    gen = QwenVLGenerator(pp, pcfg, max_len=96, dtype=torch.float32)
    forwards = []
    real = gen._decode_step

    def counted(*a, **k):
        forwards.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gen, "_decode_step", counted)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (32, 32, 3), np.uint8) for _ in range(2)]
    with P.tracing():
        out = gen.generate_batch(images, "describe the face", _Words(),
                                 max_new_tokens=5, fixed_resolution=32)
    rec = P.take()
    names = [s[2] for s in rec["spans"]]
    assert len(out) == 2 and forwards
    assert rec["counts"]["qwen.decode_forwards"] == len(forwards)
    assert names.count("qwen.decode_step") == len(forwards)
    assert names.count("qwen.stop_check") == len(forwards) + (
        0 if len(forwards) == 4 else 1)
    assert rec["counts"]["qwen.prefill_rows"] == 2
    top = [s for s in rec["spans"] if s[2] == "qwen.generate_batch"]
    assert len(top) == 1
    children = {s[2] for s in rec["spans"] if s[1] == top[0][0]}
    assert children == {"qwen.prepare", "qwen.prefill", "qwen.stop_check",
                        "qwen.decode_step", "qwen.readback"}


def test_debug_mode_raises_on_nans_like_the_reference():
    before = torch.is_anomaly_enabled()
    with RP.debug_mode():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.sqrt(x))(jnp.float32(-1.0))
    with P.debug_mode() as check:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        y = torch.sqrt(x)
        with pytest.raises(FloatingPointError, match="NaN in step"):
            check({"out": [y]}, "step")
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()
        check({"ok": torch.sqrt(torch.tensor([4.0]))}, "step")
    assert torch.is_anomaly_enabled() == before
    with P.debug_mode(nans=False):
        assert not torch.is_anomaly_enabled()
    P.check_nans([np.float32(1.0), torch.arange(3)])  # ints and non-tensors
