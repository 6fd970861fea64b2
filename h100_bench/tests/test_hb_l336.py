"""m_train_l336_b32 (BASELINE config 5): without a card a run fails and
prints no result; on the card a short traced run prints a correct result
line whose attention-score reading is the towers' scores a step at the
cell's shapes (8.2367 GB)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH

CELL = "m_train_l336_b32"


def _run(seconds, trace, env=None, timeout=900):
    return subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", CELL,
         "--seed", "2147483791", "--seconds", str(seconds), "--trace",
         str(trace)], cwd=os.path.dirname(BENCH), env=env,
        capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    p = _run(1, 0, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
             timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


@pytest.mark.card
def test_traced_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _run(2, 1)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    m = res["metrics"]
    for name in ("step_device_ms.train", "mfu_pct.train",
                 "device_idle_pct.train"):
        assert name in m, name
    # 24 x 32*16*577^2*2 B (vision) + 12 x 32*12*77^2*2 B (text)
    assert m["attn_scores_gb.train"]["value"] == pytest.approx(
        (24 * 32 * 16 * 577 ** 2 + 12 * 32 * 12 * 77 ** 2) * 2 / 1e9)
