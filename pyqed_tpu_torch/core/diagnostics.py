"""Tracing and timing hooks, NaN debugging and mid-run checkpoints
(PyTorch).

Counterpart of ``pyqed_tpu/core/diagnostics.py``:

- :func:`trace` records a ``torch.profiler`` trace of the enclosed block
  (CPU and, with a card, CUDA activity) and writes it to ``logdir`` as a
  Chrome trace (open it in Perfetto or ``chrome://tracing``);
- :class:`StepTimer` and :func:`benchmark` synchronise the CUDA device
  around each timed call, so they time the work and not its enqueue;
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
import os
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ------------------------------------------------------------- tracing

@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` and write a
    Chrome trace to ``logdir/trace.json`` (the profile itself is yielded,
    for ``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock step-timing hook for solver loops; each step ends with
    a CUDA synchronise when the card is in use.

    >>> timer = StepTimer()
    >>> with timer.step():
    ...     out = step_fn(state)
    >>> timer.summary()   # {'steps': n, 'mean_s': ..., 'p50_s': ...}
    """

    def __init__(self):
        self.samples = []

    @contextlib.contextmanager
    def step(self):
        _synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize()
            self.samples.append(time.perf_counter() - t0)

    def summary(self):
        if not self.samples:
            return {"steps": 0}
        s = np.asarray(self.samples)
        return {"steps": len(s), "mean_s": float(s.mean()),
                "p50_s": float(np.percentile(s, 50)),
                "p95_s": float(np.percentile(s, 95)),
                "total_s": float(s.sum())}


def benchmark(fn: Callable, *args, repeat: int = 3, **kw):
    """Seconds per call of ``fn(*args, **kw)`` over ``repeat`` calls after
    one warm-up call, the device synchronised around them."""
    fn(*args, **kw)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn(*args, **kw)
    _synchronize()
    return (time.perf_counter() - t0) / repeat


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
