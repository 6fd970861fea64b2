"""The port's tracing and debug utilities (utils/profiling.py) against the
JAX package's (CPU): StepTimer gives the reference's summary for the
same tick times; the trace file holds an annotated region; debug_mode
makes a NaN raise, as jax_debug_nans does, and restores the previous
mode on exit."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlm_clip_tpu.utils import profiling as RP
from vlm_clip_tpu_torch.utils import profiling as P


def test_step_timer_matches_reference(monkeypatch):
    ticks = [0.0, 0.5, 0.75, 1.0, 1.5, 1.625, 2.0]
    summaries = []
    for mod in (P, RP):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        timer = mod.StepTimer(warmup=2)
        assert timer.summary() == {}
        for _ in ticks:
            timer.tick()
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 4


def test_step_timer_sync_ticks():
    timer = P.StepTimer(warmup=0)
    for _ in range(3):
        timer.tick(sync=True)
    assert timer.summary()["steps"] == 2


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
