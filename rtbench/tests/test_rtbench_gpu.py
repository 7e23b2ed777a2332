"""On the card: a short run of every cell is correct and reports its
metrics (``python -m pytest rtbench/tests -q -m gpu``)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from rtbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell, trace):
    r = subprocess.run([sys.executable, "-m", "rtbench", "--workload", cell, "--seed",
                        "2147483901", "--seconds", "2", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["metrics"]
