"""What the metric files read: each function takes the run's context
(:class:`harness.cell.Context`) and returns the metric's value, or None
where the run holds nothing to read (then the metric is left out)."""
from __future__ import annotations

from harness import peaks, registry, trace


def steps(ctx):
    return sum(j["steps"] for j in ctx.jobs)


def seconds(ctx):
    return sum(j["seconds"] for j in ctx.jobs)


def steps_per_s(ctx):
    """Every RK4 step of the window's jobs over all of their time."""
    return steps(ctx) / seconds(ctx) if ctx.jobs else None


def maps_per_min(ctx):
    """The window's whole maps over all of their time, in minutes."""
    return len(ctx.jobs) / (seconds(ctx) / 60.0) if ctx.jobs else None


def setup_s(ctx):
    return ctx.setup_s


def kernels_per_step(ctx):
    """Device operations launched in the traced window per RK4 step."""
    if ctx.trace is None or not ctx.jobs:
        return None
    return ctx.trace["ops"] / steps(ctx)


def device_idle_share(ctx):
    """% of the traced window in which no device operation ran."""
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.window_s)


def step_mfu(ctx):
    """% of the card's peak that the step reaches: the least time of one
    RK4 step's counted work (``counts/heom_rk4_step``) over the device
    time per step (the union of device activity over the steps)."""
    if ctx.trace is None or ctx.trace["busy_s"] <= 0 or not ctx.jobs:
        return None
    count = registry.module("counts", "heom_rk4_step").count
    least = peaks.least_seconds(*count(**ctx.work))
    return 100.0 * least / (ctx.trace["busy_s"] / steps(ctx))


def coupling_roofline(ctx, pattern):
    """% of its roofline that the coupling kernel matching ``pattern``
    reaches: the least time of one call's counted work
    (``counts/heom_coupling``) over its mean device time."""
    if ctx.trace is None:
        return None
    launches, secs = trace.kernel_seconds(ctx.trace, pattern)
    if launches == 0 or secs <= 0:
        return None
    w = ctx.work
    count = registry.module("counts", "heom_coupling").count
    least = peaks.least_seconds(*count(w["model"], w["batch"],
                                       w["itemsize"]))
    return 100.0 * least / (secs / launches)
