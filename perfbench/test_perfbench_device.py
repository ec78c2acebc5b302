"""Without a card the benchmark reports nothing: run.py exits non-zero
with no result line, and the result refuses to give device metrics."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness

REPO = Path(__file__).resolve().parent.parent


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, str(REPO / "perfbench" / "run.py"), "--workload",
         "starcoder2-7b-edge2.code-unshared", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_result_refuses_device_metrics_on_the_cpu():
    cell = harness.load_cell("starcoder2-7b-edge2.code-unshared")
    opts = harness.Options(seed=1, seconds=1.0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        harness.result(cell, opts, {"requests": []},
                       {}, 0)
