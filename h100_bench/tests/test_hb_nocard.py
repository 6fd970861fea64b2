"""A run without a card fails and prints no result; it never falls back
to the CPU."""

import os
import subprocess
import sys

import pytest

from conftest import BENCH


@pytest.mark.parametrize("workload", ["m_train_b96", "ctx_gen_b32"])
def test_no_card_no_result(workload):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         workload, "--seed", "2147483999", "--seconds", "1", "--trace",
         "0"], cwd=os.path.dirname(BENCH), env=env, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr
