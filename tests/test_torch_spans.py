"""The port's spans (pyqed_tpu_torch/core/diagnostics.py) on the HEOM and
field-2DES paths, on the CPU: what a run records with spans off and on,
how the spans nest, that they change no number, and that they land on
the clock of ``torch.profiler``. A 2-site hierarchy (two site-projector
modes, lmax 2: 6 ADOs) through the ``cuda`` right-hand side, which on CPU
tensors runs the coupling kernel's plain version."""
import json
import time

import numpy as np
import pytest
import torch

from pyqed_tpu_torch.core import diagnostics as diag
from pyqed_tpu_torch.open.heom import HEOMSolver
from pyqed_tpu_torch.ops import kernels as kn
from pyqed_tpu_torch.signal.field2des import field_2des_rephasing

H = np.array([[0.0, 0.1], [0.1, 0.3]])
RHO0 = np.diag([1.0, 0.0])
MU = np.array([[0.0, 1.0], [1.0, 0.0]])
E_OPS = [np.diag([1.0, 0.0]), np.diag([0.0, 1.0])]
BUILD_CHILDREN = ["heom.build.hierarchy", "heom.build.operands",
                  "heom.build.plan"]


@pytest.fixture(autouse=True)
def _spans_off():
    yield
    diag.stop_spans()


def solver():
    bath = [(np.diag([1.0, 0.0]), 0.02 - 0.01j, 0.5),
            (np.diag([0.0, 1.0]), 0.02 - 0.01j, 0.5)]
    return HEOMSolver(H, bath=bath, lmax=2, kernel="cuda", device="cpu")


def run(sol, driven=False):
    kw = dict(edip=MU, pulse=lambda t: 0.01 * np.cos(t)) if driven else {}
    return sol.run(RHO0, dt=0.05, nt=8, nout=4, e_ops=E_OPS, **kw)


def recorded(fn):
    """(fn's result, the spans it recorded)."""
    diag.start_spans()
    out = fn()
    return out, diag.stop_spans()


def names(spans, parent=None):
    return [s.name for s in spans
            if parent is None or (s.parent >= 0
                                  and spans[s.parent].name == parent)]


def check_nesting(spans):
    for s in spans:
        assert s.start_ns <= s.end_ns, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)


def test_spans_off_record_nothing():
    diag.start_spans()
    diag.stop_spans()
    sol = solver()
    run(sol, driven=True)
    with diag.span("heom.run", nt=1) as attrs:
        attrs["nado"] = 6
    with diag.span("heom.run") as attrs:
        assert attrs == {}
    assert not diag.spans_enabled()
    assert diag.stop_spans() == []


@pytest.mark.parametrize("driven", [False, True], ids=["pop", "driven"])
def test_heom_run_spans_nest(driven):
    sol = solver()
    _, spans = recorded(lambda: run(sol, driven))
    check_nesting(spans)
    (root,) = [s for s in spans if s.name == "heom.run"]
    assert root.parent == -1
    assert root.attrs == dict(nt=8, nout=4, nado=6, driven=int(driven))
    assert names(spans, "heom.run") == ["heom.build", "heom.window",
                                        "heom.window"]
    assert names(spans, "heom.build") == BUILD_CHILDREN
    assert names(spans).count("heom.rhs") == 32
    assert names(spans).count("heom.observe") == 2
    in_window = names(spans, "heom.window")
    assert in_window.count("heom.rhs") == 32
    assert in_window.count("heom.observe") == 2
    assert in_window.count("heom.field") == (32 if driven else 0)
    assert len(spans) == 1 + 4 + 2 + 32 + 2 + (32 if driven else 0)


def test_init_span_holds_the_bath():
    sol, spans = recorded(solver)
    assert sol._modes and [s.name for s in spans] == ["heom.init"]


def test_field2des_map_spans():
    sol = HEOMSolver(H, bath=[(np.diag([1.0, 0.0]), 0.02, 0.5)], lmax=1,
                     kernel="cuda", device="cpu")
    _, spans = recorded(lambda: field_2des_rephasing(
        sol, RHO0, MU, [0.0, 0.1], t2=0.1, nt3=3, dt=0.05, pulse_width=0.05,
        e_amps=(0.05, 0.05, 0.05), omega_c=1.0, pad=0.1, n_phase=(2, 2),
        kernel="cuda"))
    check_nesting(spans)
    (root,) = [s for s in spans if s.name == "f2des.map"]
    assert root.parent == -1 and root.attrs["B"] == 8
    nt_total = root.attrs["nt_total"]
    assert nt_total == round((0.1 + 0.1 + 0.1 + 0.1) / 0.05) + 3
    assert names(spans, "f2des.map") == ["heom.build", "f2des.fields",
                                         "f2des.loop", "f2des.phase_cycle"]
    assert names(spans, "f2des.loop") == ["heom.rhs"] * (4 * nt_total)


def test_spans_change_no_number():
    off = run(solver(), driven=True).observables
    on, spans = recorded(lambda: run(solver(), driven=True).observables)
    assert spans and torch.equal(on, off)


def test_spans_on_the_profilers_clock():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        diag.start_spans()
        with diag.span("outer"):
            time.sleep(0.002)
            with torch.autograd.profiler.record_function("marker"):
                time.sleep(0.005)
            time.sleep(0.002)
        (s,) = diag.stop_spans()
    (m,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "marker"]
    assert s.start_ns <= m.start_ns()
    assert m.start_ns() + m.duration_ns() <= s.end_ns


def test_plan_builds_count_one_per_run():
    sol = solver()
    before = kn.heom_coupling_plan.builds
    for k in range(1, 3):
        run(sol)
        assert kn.heom_coupling_plan.builds == before + k


def test_a_span_open_at_stop_ends_there():
    diag.start_spans()
    with diag.span("outer", k=1) as attrs:
        attrs["m"] = 2
        (s,) = diag.stop_spans()
        diag.start_spans()
    assert s.name == "outer" and s.attrs == dict(k=1, m=2)
    assert s.start_ns <= s.end_ns <= time.time_ns()
    assert diag.stop_spans() == []


def test_trace_keeps_a_callers_log(tmp_path):
    """``diagnostics.trace`` inside a caller's spans: the caller's log
    keeps every record and stays on; the trace holds the block's spans
    alone, with parents counted from the block."""
    sol = solver()
    diag.start_spans()
    with diag.span("outer"):
        with diag.trace(str(tmp_path)):
            run(sol)
    assert diag.spans_enabled()
    spans = diag.stop_spans()
    check_nesting(spans)
    assert names(spans, "outer") == ["heom.run"]
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "span"]
    assert [e["name"] for e in events] == names(spans)[1:]
    assert events[0]["args"]["parent"] == -1
    assert [e["args"]["parent"] for e in events[1:]] == [
        s.parent - 1 for s in spans[2:]]
