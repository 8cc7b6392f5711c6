"""A cell added as new files runs through the loader with no file of the
benchmark edited: a copy of the benchmark gains a traffic mix, a limits
file, a metric reader and an entry in its BENCHMARK.json, and a small
run of the new cell finds them all by name."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from harness import registry
from harness.cell import run_cell
spec = registry.benchmark()
cfg = registry.config(spec, "fmo_77k")
cfg.update(lmax=1, nexp=1)
traffic = registry.data("traffic", "pop_short")
r = run_cell(spec, "fmo_77k.pop_short", 5, 0.1, trace=False,
             device="cpu", cfg=cfg, traffic=traffic)
print(json.dumps(r))
"""


def test_dummy_cell_added_as_files(tmp_path):
    bench = tmp_path / "h100bench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    os.symlink(ROOT / "pyqed_tpu_torch", tmp_path / "pyqed_tpu_torch")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    traffic = json.loads((bench / "traffic" / "pop.json").read_text())
    traffic.update(nt=20, nout=10, what="short population runs")
    (bench / "traffic" / "pop_short.json").write_text(json.dumps(traffic))
    (bench / "limits" / "fmo_77k.pop_short.json").write_text(
        json.dumps({"obs_gap": {"limit": 1e-9}}))
    (bench / "metrics" / "jobs_done.py").write_text(
        "def read(ctx):\n    return len(ctx.jobs)\n")
    spec["workloads"].append({"name": "fmo_77k.pop_short",
                              "config": "fmo_77k", "traffic": "pop_short",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "steps_per_s":
            m["workloads"].append("fmo_77k.pop_short")
    spec["end_to_end"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["fmo_77k.pop_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(bench),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"jobs_done", "steps_per_s", "setup_s"}
    assert result["metrics"]["jobs_done"]["value"] >= 1
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == []
