"""Tracing hooks (spans and profiler traces), NaN debugging and mid-run
checkpoints (PyTorch).

Counterpart of ``pyqed_tpu/core/diagnostics.py``:

- spans: named host intervals that the HEOM and field-2DES paths open
  at their layer boundaries (:func:`span`). They are off by default;
  :func:`start_spans` switches them on with an empty log and
  :func:`stop_spans` switches them off and returns the log
  (:class:`Span` records) on the clock ``torch.profiler`` stamps its
  events with, so a span can be laid over a trace (a device trace's
  stamps may sit off that clock by an offset constant over a session);
- :func:`trace` records a ``torch.profiler`` trace of the enclosed block
  (CPU and, with a card, CUDA activity) with the program's spans on, and
  writes it, the spans and the change of the port's counters (kernel
  launches, coupling plans and their launch arguments built) over the
  block to ``logdir`` as one Chrome trace (open it in Perfetto or
  ``chrome://tracing``);
- :func:`debug_nans` raises ``FloatingPointError`` naming the aten op
  that first makes a NaN (a ``TorchDispatchMode`` over every op, forward
  and backward; torch's anomaly mode sees only the backward);
- :func:`check_finite` checks a tensor, or a list, tuple or dict of them;
- ``save_checkpoint``/``load_checkpoint`` in the JAX package's file
  format: one NPZ with ``__step__``, ``__nleaves__``, ``leaf_<i>`` and
  ``meta_<key>`` entries, so a checkpoint written by either package loads
  in the other. The state is a list of tensors (the JAX package's pytree
  leaves).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# --------------------------------------------------------------- spans

class Span(NamedTuple):
    """One span of the log that :func:`stop_spans` returns: its ``name``,
    its ``start_ns`` and ``end_ns`` on the profiler's clock, ``parent``
    (the index in the log of the span that was open when it began, -1 for
    none) and ``attrs``, its integer attributes."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    attrs: dict


class _SpanLog:
    """The process's spans: one thread's, in the order they began, each a
    list [name, start, end, parent, attrs] stamped by
    ``time.perf_counter_ns``; ``anchor`` is (perf_counter_ns, offset to the
    profiler's clock) at :func:`start_spans`."""

    def __init__(self):
        self.on = False
        self.rows = []
        self.open = []          # indices of the open spans, innermost last
        self.anchor = (0, 0)


_LOG = _SpanLog()


class _Off:
    """The span of :func:`span` with spans off: records nothing, and
    yields a fresh dict, so a block that adds attributes leaves no trace."""
    __slots__ = ()

    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """One span being recorded; its end is dropped if the log was read out
    (:func:`stop_spans`) while it was open."""
    __slots__ = ("name", "attrs", "rows")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        log = _LOG
        self.rows = log.rows
        log.rows.append([self.name, time.perf_counter_ns(), None,
                         log.open[-1] if log.open else -1, self.attrs])
        log.open.append(len(log.rows) - 1)
        return self.attrs

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        if self.rows is _LOG.rows:
            self.rows[_LOG.open.pop()][2] = t
        return False


def _clock_offset():
    """(perf_counter_ns, profiler clock − perf_counter_ns) from the
    tightest of five reads of both clocks. ``torch.profiler`` (kineto)
    stamps host events on the system clock, ``time.time_ns()``
    (``tests/test_torch_spans.py``), and device events on it up to an
    offset constant over a session, 26 us and once 0.59 ms on an H100
    with torch 2.11 (``h100bench/tests/test_h100bench_spans_card.py``)."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        r = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, r - (a + b) // 2)
    return best[1:]


def spans_enabled() -> bool:
    """Whether the program records its spans (:func:`start_spans`)."""
    return _LOG.on


def start_spans():
    """Switch the program's spans on, with an empty log."""
    _LOG.rows, _LOG.open = [], []
    _LOG.anchor = _clock_offset()
    _LOG.on = True


def stop_spans() -> list:
    """Switch the spans off and return the log as :class:`Span` records
    on the profiler's clock (a span still open ends here)."""
    out = _records(0)
    _LOG.on = False
    _LOG.rows, _LOG.open = [], []
    return out


def _records(first):
    """The log from index ``first`` on as :class:`Span` records, parents
    counted from ``first`` (-1 for one before it); a span still open ends
    now. Each stamp is moved by the offset between the two clocks,
    interpolated between the reads at :func:`start_spans` and now, so a
    slew of the system clock in between is followed."""
    t_now = time.perf_counter_ns()
    (p0, d0), (p1, d1) = _LOG.anchor, _clock_offset()

    def conv(t):
        return t + d0 + (d1 - d0) * (t - p0) // max(p1 - p0, 1)

    return [Span(name, conv(s), conv(t_now if e is None else e),
                 parent - first if parent >= first else -1, dict(attrs))
            for name, s, e, parent, attrs in _LOG.rows[first:]]


def span(name: str, **attrs):
    """A context manager that records the enclosed block as span ``name``
    with the integer ``attrs`` (the block may add more to the dict it
    yields). With spans off it returns a shared do-nothing context at
    once, so a caller may open it per window; per-stage code wraps its
    callables with :func:`spanned` only when :func:`spans_enabled`."""
    return _Open(name, attrs) if _LOG.on else _OFF


def spanned(name: str, fn):
    """``fn`` with each call recorded as span ``name`` (while spans are
    on)."""
    def call(*args, **kw):
        with span(name):
            return fn(*args, **kw)
    return call


# ------------------------------------------------------------- tracing

def _counters():
    """The port's always-on counters, {"<function>.<counter>": value}:
    the integer attributes of the kernel wrappers (launches) and of
    ``heom_coupling_plan`` (plans built)."""
    from ..ops import kernels as kn
    fns = (kn.heom_coupling, kn.heom_coupling_plan, kn.spo_phase_multiply,
           kn.spo_potential_apply, kn.liouvillian_commutator)
    return {f"{fn.__name__}.{k}": v for fn in fns
            for k, v in vars(fn).items() if type(v) is int}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` and write a
    Chrome trace to ``logdir/trace.json``: the profiler's events, the
    program's spans of the block as complete events on a track of their
    own in the host process, and each of the port's counters
    (:func:`_counters`) as a counter track that rises from 0 at the
    block's start to its change over the block at its end. Spans are on
    for the block and left as they were found: a caller's log keeps its
    records. The profile itself is yielded, for ``key_averages()``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    was_on = spans_enabled()
    with torch.profiler.profile(activities=acts) as prof:
        if not was_on:
            start_spans()
        first = len(_LOG.rows)
        before, t0 = _counters(), time.time_ns()
        try:
            yield prof
        finally:
            _synchronize()
            after, t1 = _counters(), time.time_ns()
            spans = _records(first) if was_on else stop_spans()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), "pyqed_tpu_torch spans"
    doc["traceEvents"].append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tid, "args": {"name": tid}})
    doc["traceEvents"] += [
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": dict(s.attrs, parent=s.parent)} for s in spans]
    doc["traceEvents"] += [
        {"ph": "C", "cat": "counter", "name": name, "pid": pid,
         "ts": (t - base) / 1e3, "args": {"value": v}}
        for name in after for t, v in ((t0, 0),
                                       (t1, after[name] - before[name]))]
    with open(path, "w") as f:
        json.dump(doc, f)


# ------------------------------------------------------- debug toggles

class _NaNCheck(TorchDispatchMode):
    """Raise on the first aten op whose floating-point output holds a NaN
    that none of its floating-point inputs held."""

    @staticmethod
    def _tensors(tree):
        from torch.utils import _pytree as pytree
        return [t for t in pytree.tree_leaves(tree)
                if isinstance(t, torch.Tensor) and
                (t.is_floating_point() or t.is_complex())]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        made = [t for t in self._tensors(out) if bool(torch.isnan(t).any())]
        if made and not any(bool(torch.isnan(t).any())
                            for t in self._tensors((args, kwargs))):
            raise FloatingPointError(
                f"debug_nans: {func} produced a NaN (output shape "
                f"{tuple(made[0].shape)}, dtype {made[0].dtype})")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Inside the block, any aten op that makes a NaN from NaN-free
    inputs raises ``FloatingPointError`` naming the op. Every op is
    checked on the host, so the block runs much slower."""
    if not enable:
        yield
        return
    with _NaNCheck():
        yield


def check_finite(tree: Any, name: str = "state"):
    """Host-side finiteness assertion on a tensor, array, or a list, tuple
    or dict of them (nested); returns ``tree``."""
    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
        elif x is not None:
            yield x

    for i, leaf in enumerate(leaves(tree)):
        a = _host(leaf)
        if not np.all(np.isfinite(a)):
            bad = int(np.sum(~np.isfinite(a)))
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite entries "
                f"(shape {a.shape}, dtype {a.dtype})")
    return tree


# ---------------------------------------------------------- checkpoint


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def save_checkpoint(path, step: int, state, **metadata):
    """Persist (step, list of tensors, metadata) as one .npz (complex-safe,
    no pickle)."""
    leaves = list(state)
    payload = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    payload["__step__"] = np.asarray(step)
    payload["__nleaves__"] = np.asarray(len(leaves))
    for k, v in metadata.items():
        payload[f"meta_{k}"] = np.asarray(v)
    np.savez(path, **payload)
    return path


def load_checkpoint(path):
    """Returns (step, list of CPU tensors, metadata dict of arrays)."""
    path = str(path)
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as z:
        nl = int(z["__nleaves__"])
        leaves = [torch.from_numpy(np.array(z[f"leaf_{i}"]))
                  for i in range(nl)]
        step = int(z["__step__"])
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return step, leaves, meta
