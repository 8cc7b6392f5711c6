"""The program's spans over a traced window, for the span metrics.

``pyqed_tpu_torch.core.diagnostics`` records named host intervals at the
HEOM and field-2DES layer boundaries (``heom.run``, ``heom.build``,
``heom.window``, ``f2des.map``, ...) and returns them on the clock of
``torch.profiler``'s host events; its device events sit off that clock by
an offset constant over a session (up to 0.59 ms on an H100, torch 2.11),
which moves idle across span edges. A window run with spans on (between
``start_spans`` and ``stop_spans``, the window itself a span
``bench.window``, each job a ``bench.job``) gives here:

- :func:`idle_by_span`: every idle interval of the window (the window
  minus the union of device operations) put down to the innermost span
  open on the host at that instant, or to none ("outside");
- :func:`reduce`: that, with the log, as the context's ``spans`` that the
  readers below take, and :func:`table`, the count, total, self and idle
  seconds of each span name.

The readers return None where the run recorded no spans (a program
without them, or a window run with them off)."""
from __future__ import annotations

from collections import defaultdict

OUTSIDE = "outside"
WINDOW = "bench.window"


def _union(intervals, lo, hi):
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def innermost(spans, lo, hi):
    """[(start, end, index)] covering [lo, hi]: the log index of the
    innermost span open at each instant, -1 where none is. The spans of
    one thread nest, so a stack of the open ones finds it."""
    out = []

    def emit(a, b, i):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b, i))

    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    stack, t = [], lo
    for i in order:
        s = spans[i]
        while stack and spans[stack[-1]].end_ns <= s.start_ns:
            j = stack.pop()
            emit(t, spans[j].end_ns, j)
            t = max(t, spans[j].end_ns)
        emit(t, s.start_ns, stack[-1] if stack else -1)
        t = max(t, s.start_ns)
        stack.append(i)
    while stack:
        j = stack.pop()
        emit(t, spans[j].end_ns, j)
        t = max(t, spans[j].end_ns)
    emit(t, hi, -1)
    return out


def idle_by_span(events, spans, lo, hi):
    """{log index (-1: outside every span): idle ns} over [lo, hi], the
    idle instants being those that no (name, start_ns, end_ns) device
    event covers."""
    busy = _union([(s, e) for _, s, e in events], lo, hi)
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = e
    if hi > t:
        idle.append((t, hi))
    out = defaultdict(int)
    segs = innermost(spans, lo, hi)
    k = 0
    for a, b in idle:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            s, e, i = segs[j]
            out[i] += min(b, e) - max(a, s)
            j += 1
    return dict(out)


def reduce(spans, events):
    """The context's ``spans``: the log, the window (the ``bench.window``
    span) and its idle ns by log index; None without a window span."""
    win = [s for s in spans or () if s.name == WINDOW]
    if not win:
        return None
    w = win[0]
    return {"log": spans, "window_ns": w.end_ns - w.start_ns,
            "idle": idle_by_span(events, spans, w.start_ns, w.end_ns)}


def table(red):
    """{span name: {count, total_s, self_s, idle_s}} and {"outside":
    {idle_s}}: self is a span's time less its children's, idle the idle
    time put down to it."""
    log = red["log"]
    child = defaultdict(int)
    for s in log:
        if s.parent >= 0:
            child[s.parent] += s.end_ns - s.start_ns
    out = defaultdict(lambda: {"count": 0, "total_s": 0.0, "self_s": 0.0,
                               "idle_s": 0.0})
    for i, s in enumerate(log):
        row = out[s.name]
        row["count"] += 1
        row["total_s"] += (s.end_ns - s.start_ns) * 1e-9
        row["self_s"] += (s.end_ns - s.start_ns - child[i]) * 1e-9
    for i, ns in red["idle"].items():
        if i >= 0:
            out[log[i].name]["idle_s"] += ns * 1e-9
    result = dict(out)
    result[OUTSIDE] = {"idle_s": red["idle"].get(-1, 0) * 1e-9}
    return result


def idle_under(red, name):
    """Idle ns put down to span ``name`` or to any span inside one."""
    log = red["log"]
    total = 0
    for i, ns in red["idle"].items():
        while i >= 0 and log[i].name != name:
            i = log[i].parent
        if i >= 0:
            total += ns
    return total


def _spans(ctx):
    return getattr(ctx, "spans", None)


def build_ms_per_job(ctx, root):
    """Host build of the right-hand side (``heom.build``) per job (span
    ``root``: ``heom.run`` or ``f2des.map``), in ms."""
    red = _spans(ctx)
    if red is None:
        return None
    log = red["log"]
    jobs = sum(s.name == root for s in log)
    build = sum(s.end_ns - s.start_ns for s in log if s.name == "heom.build")
    return build * 1e-6 / jobs if jobs else None


def idle_in_loop(ctx, loop):
    """% of the window with the device idle and the host inside span
    ``loop`` (``heom.window`` or ``f2des.loop``) or a span within it."""
    red = _spans(ctx)
    if red is None or red["window_ns"] <= 0:
        return None
    if not any(s.name == loop for s in red["log"]):
        return None
    return 100.0 * idle_under(red, loop) / red["window_ns"]


def field_us_per_step(ctx):
    """Host evaluations of the pulse (``heom.field``) per RK4 step (the
    ``nt`` of the window's ``heom.run`` spans), in us."""
    red = _spans(ctx)
    if red is None:
        return None
    log = red["log"]
    steps = sum(s.attrs.get("nt", 0) for s in log if s.name == "heom.run")
    field = [s.end_ns - s.start_ns for s in log if s.name == "heom.field"]
    return sum(field) * 1e-3 / steps if field and steps else None
