"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import math
import re

import pytest

from harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = registry.benchmark()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "h100bench/run.py"]
    assert SPEC["paths"] == ["h100bench"]
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = registry.config(SPEC, entry["name"])
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    registry.module("systems", cfg["system"])
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    traffic = registry.data("traffic", cell["traffic"])
    registry.module("drivers", traffic["driver"])
    limits = registry.data("limits", cell["name"])
    assert limits and all(v["limit"] > 0 for v in limits.values())
    e2e = registry.metrics_of(SPEC, cell, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert registry.metrics_of(SPEC, cell, trace=True)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(registry.module("metrics", metric["name"]).read)
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"]: m for m in SPEC["end_to_end"]}
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(
            moved.get("workloads", cells))
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_names_are_unique_and_valid():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        registry.data("traffic", "no_such_traffic")
    with pytest.raises(ValueError):
        registry.module("metrics", "../run")
    with pytest.raises(KeyError):
        registry.workload(SPEC, "no.such.cell")


def test_bounds_are_finite():
    for m in SPEC["end_to_end"]:
        assert math.isfinite(m["bound"])
