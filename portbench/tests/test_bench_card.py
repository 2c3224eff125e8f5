"""The benchmark's command on the card, one short run of every cell."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the card only")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["ensemble-window", "drive-diagram"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(cell, trace):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
