"""Everything that belongs to one configuration, traffic mix, driver,
system, per-layer metric or count function is a file of its own, found
here by the name that ``BENCHMARK.json`` or another file gives it:

- ``configs/<config>.json`` (the ``file`` of the configuration),
- ``traffic/<traffic>.json``, naming its ``driver``,
- ``drivers/<driver>.py``, ``systems/<system>.py`` (a configuration's
  ``system``), ``metrics/<metric>.py``, ``counts/<count>.py``,
- ``limits/<workload>.json``, the limits of the numbers that decide
  ``correct`` in that cell.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # the benchmark's folder
ROOT = HERE.parent                                 # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_modules = {}


def _path(kind, name, suffix):
    if not NAME.match(name):
        raise ValueError(f"{kind}: {name!r} is not a valid name")
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{kind}: no file {path.relative_to(ROOT)}")
    return path


def benchmark(path=None):
    """The parsed ``BENCHMARK.json`` of the checkout."""
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def data(kind, name):
    """``<kind>/<name>.json``, parsed."""
    return json.loads(_path(kind, name, ".json").read_text())


def config(spec, name):
    """The configuration ``name`` of a parsed ``BENCHMARK.json``, from its
    ``file``."""
    entry = next((c for c in spec["configs"] if c["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no configuration {name!r}")
    return json.loads((ROOT / entry["file"]).read_text())


def module(kind, name):
    """``<kind>/<name>.py`` as a module, loaded once (a name may hold
    dots, so it is loaded by path)."""
    key = (kind, name)
    if key not in _modules:
        path = _path(kind, name, ".py")
        mod_name = f"h100bench_{kind}_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def workload(spec, name):
    """The cell ``name`` of a parsed ``BENCHMARK.json``."""
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    return cell


def metrics_of(spec, cell, trace):
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones. A metric with a ``workloads`` key is the
    listed cells'; a per-layer metric without one is every cell's that
    reports its ``moves``."""
    def listed(m):
        return cell["name"] in m.get("workloads", [cell["name"]])
    e2e = [m for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if listed(m) and ("workloads" in m or m["moves"] in names)]
