"""On the card: one short run of each cell prints a well-formed, correct
result line. Skips without a card; run there with
``python -m pytest h100_bench/tests -m card -p no:cacheprovider``."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH


@pytest.mark.card
@pytest.mark.parametrize("workload,seconds", [
    ("m_train_b96", 2), ("ctx_gen_b32", 2)])
def test_cell_runs_on_the_card(workload, seconds):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         workload, "--seed", "2147483777", "--seconds", str(seconds),
         "--trace", "0"], cwd=os.path.dirname(BENCH), capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks" and "setup_s" in res["metrics"]
    assert res["build_s"] >= 0
