"""Tests of the benchmark, run on the CPU at small sizes:
``python -m pytest h100bench/tests -q``. Tests marked ``card`` need a
CUDA card and skip without one."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
