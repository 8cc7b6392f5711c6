"""On the card: every cell's traced run is correct and no share of a
roofline or a peak reads above 100 %. Run on a machine with a CUDA card
from the root of a checkout:
``python -m pytest h100bench/tests -q -m card``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from harness import registry

ROOT = Path(__file__).resolve().parent.parent.parent
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "5", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
