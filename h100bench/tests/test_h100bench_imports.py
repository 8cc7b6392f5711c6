"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the reference imports nothing of the
measured program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pyqed_tpu"}


def imported(path):
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*dirs):
    return [p for d in dirs for p in (HERE / d).rglob("*.py")]


def test_no_source_imports_jax_or_the_jax_package():
    files = [HERE / "run.py", HERE / "calibrate.py"] + sources(
        "harness", "reference", "drivers", "systems", "metrics", "counts")
    for path in files:
        assert not imported(path) & FORBIDDEN, path


def test_the_whole_name_is_compared(monkeypatch):
    from types import ModuleType

    from harness.cell import forbidden_modules
    for name in ("pyqed_tpu_torch.open", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, ModuleType(name))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "pyqed_tpu", ModuleType("pyqed_tpu"))
    assert forbidden_modules() == ["jax", "pyqed_tpu"]


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "numpy", "torch", "reference"}
    for path in sources("reference"):
        assert imported(path) <= allowed, path


SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import small
for cell in ("fmo_77k.pop", "chain8_f2des.b256"):
    assert small.run(cell)["correct"]
from harness.cell import forbidden_modules
print(json.dumps(forbidden_modules()))
"""


def test_a_cpu_rehearsal_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(HERE), str(ROOT)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(HERE / "tests")))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
