"""The device trace of a window: ``torch.profiler`` over CUDA activity
alone (host activity slows its post-processing and adds no device time),
reduced to what the per-layer readers take: the busy time (the union of
device operations), the operations by name and the idle gaps between
them, each gap named by the operation it follows."""
from __future__ import annotations

import re
from collections import defaultdict

NAME_CHARS = 120


def device_events(prof):
    """(name, start_ns, end_ns) of every device operation a finished
    ``torch.profiler.profile`` recorded."""
    from torch.autograd import DeviceType
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            if e.device_type() == DeviceType.CUDA:
                start = e.start_ns()
                out.append((e.name(), start, start + e.duration_ns()))
        return out
    except AttributeError:
        pass
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, int(e.time_range.start * 1e3),
                        int(e.time_range.end * 1e3)))
    return out


def reduce_events(events):
    """Summary of (name, start_ns, end_ns) device events: ``ops`` (their
    number), ``busy_s`` (the length of their union), ``by_name``
    ({name: [count, seconds]}) and ``gaps`` ({"after <name>": seconds},
    the idle time between the union's segments, by the operation that
    ended the segment before it)."""
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in events:
        row = by_name[name]
        row[0] += 1
        row[1] += (e - s) * 1e-9
    gaps = defaultdict(float)
    busy = 0
    seg_start = seg_end = None
    seg_name = None
    for name, s, e in sorted(events, key=lambda x: x[1]):
        if seg_end is None:
            seg_start, seg_end, seg_name = s, e, name
        elif s > seg_end:
            busy += seg_end - seg_start
            gaps["after " + seg_name[:NAME_CHARS]] += (s - seg_end) * 1e-9
            seg_start, seg_end, seg_name = s, e, name
        elif e > seg_end:
            seg_end, seg_name = e, name
    if seg_end is not None:
        busy += seg_end - seg_start
    return {"ops": len(events), "busy_s": busy * 1e-9,
            "by_name": dict(by_name), "gaps": dict(gaps)}


def breakdown(summary, top=10):
    """The ``breakdown`` of a result line: the device operations that
    took most time and the longest idle gaps, [name, seconds] each."""
    ops = sorted(((k[:NAME_CHARS], v[1]) for k, v in
                  summary["by_name"].items()), key=lambda r: -r[1])
    gaps = sorted(summary["gaps"].items(), key=lambda r: -r[1])
    return {"device_ops": [list(r) for r in ops[:top]],
            "idle_gaps": [list(r) for r in gaps[:top]]}


def kernel_seconds(summary, pattern):
    """(launches, seconds) of the device operations whose name matches
    the regular expression ``pattern``."""
    rx = re.compile(pattern)
    n, s = 0, 0.0
    for name, (count, secs) in summary["by_name"].items():
        if rx.search(name):
            n += count
            s += secs
    return n, s
