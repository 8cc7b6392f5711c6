"""One run of one cell: set-up (a warm-up of the cell's own shapes, run
by its traffic's driver module), the measured window of whole jobs back
to back, the check of sampled jobs against the plain reference, and the
metrics.

The window runs jobs until ``seconds`` have passed; the last job is
counted whole, over its own time. Jobs are timed by the host clock from
the call to the moment their outputs are on the host. With ``trace`` the
window runs under ``torch.profiler`` (device activity alone) and the
cell's per-layer metrics are read from it; else its end-to-end ones."""
from __future__ import annotations

import math
import subprocess
import sys
import time
import traceback
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import torch

from harness import registry
from harness import trace as tr
from harness import traffic as tf

FORBIDDEN = ("jax", "jaxlib", "flax", "pyqed_tpu")
DTYPES = {"complex128": torch.complex128, "complex64": torch.complex64}


def forbidden_modules():
    """The top-level names of loaded modules that are JAX or the JAX
    package, compared whole (``pyqed_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    None where it cannot be read."""
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def build_seconds():
    """The seconds that ``nvcc`` took in this process for the program's
    CUDA libraries built so far (0.0 for those loaded from the build
    directory of the checkout)."""
    lib = sys.modules.get("pyqed_tpu_torch.ops._cuda_lib")
    if lib is None:
        return 0.0
    total = 0.0
    for name in lib.SIGNATURES:
        digest = lib.source_digest(lib.CSRC / f"{name}.cu")
        if (lib.BUILD / f"lib{name}-{digest}.so").is_file():
            total += lib.load(name).seconds
    return total


def check_picks(n, k, rng):
    """Indices of the ``k`` of ``n`` jobs that the check compares: the
    window's last job, which runs after every other, and ``k - 1`` drawn
    from the rest by ``rng``."""
    k = max(1, min(int(k), n))
    rest = rng.choice(n - 1, size=k - 1, replace=False).tolist()
    return sorted(rest) + [n - 1]


def run_cell(spec, name, seed, seconds, trace=False, device="cuda",
             t0=None, cfg=None, traffic=None, limits=None, dtype=None):
    """The result of one run of cell ``name`` (a dict in the result
    line's layout). ``cfg``, ``traffic``, ``limits`` and ``dtype``
    replace the cell's own (the tests run small copies on the CPU;
    ``calibrate.py`` runs the program at a lower precision)."""
    t_in = time.perf_counter()
    t0 = t_in if t0 is None else t0
    cell = registry.workload(spec, name)
    cfg = cfg or registry.config(spec, cell["config"])
    traffic = traffic or registry.data("traffic", cell["traffic"])
    limits = limits or registry.data("limits", name)
    dtype = dtype or DTYPES[cfg["dtype"]]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = registry.module("drivers", traffic["driver"]).Driver(
        cfg, traffic, device, dtype)
    t_warm = time.perf_counter()
    driver.warm_up(tf.job(traffic, cfg, seed, -1))
    sync()
    setup_s = time.perf_counter() - t0
    warm_s = time.perf_counter() - t_warm
    build_s = build_seconds()

    gen = tf.jobs(traffic, cfg, seed)
    jobs, outs, timing = [], [], []
    failed = 0
    before = driver.counters()
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
        if trace else nullcontext())
    with prof:
        w0 = time.perf_counter()
        while True:
            job = next(gen)
            a = time.perf_counter()
            try:
                out = driver.run(job)
            except RuntimeError:
                traceback.print_exc()
                failed += 1
                break
            b = time.perf_counter()
            jobs.append(job)
            outs.append(out)
            timing.append({"seconds": b - a, "steps": driver.steps(job)})
            if b - w0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - w0
    after = driver.counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
    summary = tr.reduce_events(tr.device_events(prof)) if trace else None

    rng = np.random.default_rng([int(seed) % (1 << 64), 0xC4EC])
    t_check = time.perf_counter()
    readings = {}
    if jobs:
        pick = check_picks(len(jobs), traffic.get("check_jobs", 1), rng)
        readings = driver.check([jobs[i] for i in pick],
                                [outs[i] for i in pick], rng, device)
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": float(readings.get(k, math.inf)),
                  "limit": float(v["limit"])} for k, v in limits.items()}
    correct = (failed == 0 and bool(jobs)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    ctx = SimpleNamespace(
        cfg=cfg, traffic=traffic, cell=cell, jobs=timing, setup_s=setup_s,
        window_s=window_s, trace=summary,
        counters={k: after[k] - before[k] for k in after},
        work=driver.work(jobs[0]) if jobs else None)
    metrics = {}
    for m in registry.metrics_of(spec, cell, trace):
        v = registry.module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=summary["busy_s"], window_s=window_s)
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": correct, "attempted": len(jobs) + failed,
              "failed": failed, "metrics": metrics, "device": dev,
              "counters": ctx.counters,
              "seconds": {"setup": setup_s, "imports": t_in - t0,
                          "build": build_s, "warm_up": warm_s,
                          "window": window_s, "check": check_s,
                          "jobs": [t["seconds"] for t in timing]}}
    if trace:
        result["breakdown"] = tr.breakdown(summary)
    result["checks"] = checks
    return result
