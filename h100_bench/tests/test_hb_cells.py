"""Every cell of BENCHMARK.json names files that exist (its traffic
kind's loop and its preset's reference found by name), and a run of its
kind at tiny size on the CPU gives every one of its metrics that does
not come from the device (those come from the card's trace)."""

import json
import os
import time

import pytest
import torch

import run
from hb import traffic
from hb.common import read_metric

from conftest import BENCH, kind

ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCHMARK = json.load(f)
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files(workload):
    bench, cell, cfg, limits = run.load_cell(workload)
    k = kind(traffic.load(cell["traffic"])["kind"])
    assert cfg["family"] == k.FAMILY
    assert callable(k.run) and callable(k.control)
    if "preset" in cfg:
        assert os.path.isfile(os.path.join(BENCH, "reference",
                                           f"quant_{cfg['preset']}.py"))
    assert limits
    for trace in (False, True):
        for m in run.metric_names(bench, cell, trace):
            assert os.path.isfile(os.path.join(BENCH, "metrics",
                                               f"{m['name']}.py"))


def test_unknown_kind_refused():
    with pytest.raises(SystemExit, match="no traffic kind"):
        kind("no_such_kind")


@pytest.mark.parametrize("workload", CELLS)
def test_host_metrics_read(workload, tiny_clip, tiny_qwen):
    bench, cell, cfg, _ = run.load_cell(workload)
    tcfg, tr = tiny_clip if cfg["family"] == "clip_m" else tiny_qwen
    lim = {"loss_gap": 1, "grad_gap": 1, "change_gap": 1, "token_gap": 1}
    for trace in (False, True):
        out = kind(tr["kind"]).run(cell, tcfg, tr, 3, 0.2, trace,
                                   torch.device("cpu"), time.perf_counter(),
                                   lim)
        for m in run.metric_names(bench, cell, trace):
            if m["source"] in ("host_clock", "program_counter"):
                value = read_metric(m["name"], out["ctx"])
                assert value is not None and value > 0, m["name"]
