"""The idle attribution of ``harness/spans.py`` on synthetic device events
and spans, and on a small copy of each cell's program run on the CPU
with spans on."""
import numpy as np
import pytest
import torch

from harness import registry
from harness import spans as sp
from harness import traffic as tf
from pyqed_tpu_torch.core.diagnostics import (Span, span, start_spans,
                                              stop_spans)
from small import cell as small_cell


def S(name, a, b, parent=-1, **attrs):
    return Span(name, a, b, parent, attrs)


# a window 0..100: a job 5..95 holding a build 10..20 and a loop 20..90
# with three steps; device busy 12..15, 22..30, 32..60, 62..88
LOG = [S("bench.window", 0, 100), S("bench.job", 5, 95, 0),
       S("heom.run", 6, 94, 1, nt=3), S("heom.build", 10, 20, 2),
       S("heom.window", 20, 90, 2), S("heom.rhs", 21, 31, 4),
       S("heom.field", 31, 33, 4), S("heom.rhs", 33, 61, 4),
       S("heom.rhs", 61, 89, 4)]
EVENTS = [("k", 12, 15), ("k", 22, 30), ("k", 32, 45), ("k", 40, 60),
          ("k", 62, 88)]


def test_idle_put_down_to_the_innermost_span():
    idle = sp.idle_by_span(EVENTS, LOG, 0, 100)
    # idle 0-12, 15-22, 30-32, 60-62, 88-100
    assert idle == {0: 5 + 5, 1: 1 + 1, 2: 4 + 4, 3: 2 + 5, 4: 1 + 1,
                    5: 1 + 1, 6: 1, 7: 1, 8: 1 + 1}
    red = sp.reduce(LOG, EVENTS)
    assert sp.idle_under(red, "heom.window") == 2 + 2 + 1 + 1 + 2
    assert sp.idle_in_loop(type("C", (), {"spans": red}), "heom.window") \
        == 8.0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_idle_sums_to_the_window_less_busy(seed):
    """Random nested spans and overlapping events: the attributed idle
    and "outside" add up to the window less the union of the events."""
    rng = np.random.default_rng(seed)
    log = [S("bench.window", 0, 10_000)]

    def grow(parent, a, b, depth):
        t = a
        while depth < 4 and t < b - 20:
            s = int(rng.integers(t, b - 10))
            e = int(rng.integers(s + 1, min(b, s + 2_000) + 1))
            log.append(S(f"s{depth}", s, e, parent))
            grow(len(log) - 1, s, e, depth + 1)
            t = e + int(rng.integers(0, 50))
    grow(0, 0, 10_000, 0)
    starts = rng.integers(-500, 10_500, 300)
    events = [("k", int(s), int(s + rng.integers(1, 60))) for s in starts]
    red = sp.reduce(log, events)
    busy = sum(e - s for s, e in sp._union([(s, e) for _, s, e in events],
                                           0, 10_000))
    assert sum(red["idle"].values()) == 10_000 - busy
    tab = sp.table(red)
    assert abs(sum(r["idle_s"] for r in tab.values())
               - (10_000 - busy) * 1e-9) < 1e-15


def test_table_and_readers():
    red = sp.reduce(LOG, EVENTS)
    tab = sp.table(red)
    assert tab["heom.rhs"]["count"] == 3
    assert tab["heom.window"]["self_s"] == pytest.approx((70 - 68) * 1e-9)
    assert tab["outside"]["idle_s"] == 0.0
    ctx = type("C", (), {"spans": red})
    assert sp.build_ms_per_job(ctx, "heom.run") == pytest.approx(10e-6)
    assert sp.field_us_per_step(ctx) == pytest.approx(2e-3 / 3)
    assert sp.build_ms_per_job(ctx, "f2des.map") is None
    assert sp.idle_in_loop(ctx, "f2des.loop") is None
    none = type("C", (), {})
    assert sp.build_ms_per_job(none, "heom.run") is None
    assert sp.reduce([], EVENTS) is None


@pytest.mark.parametrize("cell", ["fmo_77k.driven", "chain8_f2des.b256"])
def test_a_small_cell_with_spans_on(cell):
    """A job of a small copy of the cell, spans on around it: every new
    metric reads, and with no device events the whole window is idle."""
    spec, cfg, traffic = small_cell(cell)
    traffic.update(nt=8, nout=4)
    driver = registry.module("drivers", traffic["driver"]).Driver(
        cfg, traffic, "cpu", torch.complex128)
    job = next(tf.jobs(traffic, cfg, 2 ** 31 + 5))
    start_spans()
    with span("bench.window"):
        with span("bench.job"):
            driver.run(job)
    red = sp.reduce(stop_spans(), [])
    ctx = type("C", (), {"spans": red})
    root, loop = (("heom.run", "heom.window") if cfg["system"] == "fmo"
                  else ("f2des.map", "f2des.loop"))
    assert sp.build_ms_per_job(ctx, root) > 0
    assert 0 < sp.idle_in_loop(ctx, loop) < 100
    assert sum(red["idle"].values()) == red["window_ns"]
    if cell == "fmo_77k.driven":
        assert sp.field_us_per_step(ctx) > 0
