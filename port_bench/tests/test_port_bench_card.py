"""One short run of a cell on the card, through the benchmark's command.

Needs an NVIDIA GPU (marker `cuda`); skips on the CPU. Run it on the chip
with `python -m pytest port_bench/tests -q -m cuda`.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_cornell_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "cornell.final",
         "--seed", str(2 ** 32 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"msamples_per_s", "setup_s"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
