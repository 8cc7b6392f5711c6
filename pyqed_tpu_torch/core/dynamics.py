"""Generic propagation drivers.

PyTorch counterpart of ``pyqed_tpu/core/dynamics.py``: the time loop that
the solvers share. Where the JAX package nests a ``fori_loop`` of ``nout``
fine steps inside a ``lax.scan`` over windows, this is a Python loop over
windows of ``nout`` steps on the device of the state. Observables and
states are written into preallocated tensors, one row per window, so the
loop never synchronises with the host.

``step_fn`` is any ``(state, t) -> state`` update for one ``dt``;
``e_ops`` are applied through ``expect_fn`` at each sampling point.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..ops.linalg import as_tensor
from .result import Result


def _stack_eops(e_ops, like):
    """Stack a list of same-shape operators into one (k, n, n) tensor of
    ``like``'s device and of a dtype that holds both (None without
    operators), so the per-sample expectation is one batched product."""
    if e_ops is None or len(e_ops) == 0:
        return None
    ops = [as_tensor(op) for op in e_ops]
    dt = like.dtype
    for op in ops:
        dt = torch.promote_types(dt, op.dtype)
    return torch.stack([op.to(like.device, dt) for op in ops])


def expect_ket(eops_tensor, psi):
    """<psi|O_k|psi> for all k at once."""
    return torch.einsum("i, kij, j -> k", psi.conj(), eops_tensor, psi)


def expect_dm(eops_tensor, rho):
    """Tr[O_k rho] for all k at once."""
    return torch.einsum("kij, ji -> k", eops_tensor, rho)


def propagate(step_fn: Callable, y0, t0, dt, nt: int, nout: int = 1,
              eops_tensor=None, expect_fn: Callable = expect_ket,
              store_states: bool = False):
    """Run ``nt`` steps of ``step_fn``, sampling every ``nout`` steps.

    Returns (times, observables, states, y_final):
      times        (ns+1,) float64 with ns = nt // nout
      observables  (ns+1, k), the initial sample first, or None
      states       (ns+1, ...) or None
      y_final      state after nt steps

    Requires nout | nt: a remainder would be silently dropped while the
    requested nt is still reported, truncating sampled trajectories.
    """
    if nt % nout != 0:
        raise ValueError(
            f"nt={nt} must be divisible by nout={nout} "
            f"(the trailing {nt % nout} steps would be silently dropped)")
    ns = nt // nout
    obs = states = None
    if eops_tensor is not None:
        o0 = expect_fn(eops_tensor, y0)
        obs = torch.empty((ns + 1,) + tuple(o0.shape), dtype=o0.dtype,
                          device=o0.device)
        obs[0] = o0
    if store_states:
        states = torch.empty((ns + 1,) + tuple(y0.shape), dtype=y0.dtype,
                             device=y0.device)
        states[0] = y0

    y, t = y0, float(t0)
    for w in range(1, ns + 1):
        for _ in range(nout):
            y = step_fn(y, t)
            t = t + dt
        if obs is not None:
            obs[w] = expect_fn(eops_tensor, y)
        if states is not None:
            states[w] = y

    times = t0 + torch.arange(ns + 1, dtype=torch.float64,
                              device=y0.device) * dt * nout
    return times, obs, states, y


def run_solver(step_fn, y0, dt, nt, e_ops: Optional[Sequence] = None,
               nout: int = 1, t0: float = 0.0, store_states: bool = False,
               expect_fn=expect_ket, is_dm: Optional[bool] = None) -> Result:
    """High-level wrapper returning a :class:`Result`."""
    y0 = as_tensor(y0)
    if is_dm is None:
        is_dm = y0.dim() == 2
    if is_dm and expect_fn is expect_ket:
        expect_fn = expect_dm
    eops_tensor = _stack_eops(e_ops, y0)
    times, observables, states, yf = propagate(
        step_fn, y0, t0, dt, nt, nout=nout, eops_tensor=eops_tensor,
        expect_fn=expect_fn, store_states=store_states)
    res = Result(times=times, observables=observables, states=states,
                 dt=dt, nt=nt, nout=nout)
    if is_dm:
        res.rho0, res.rho = y0, yf
    else:
        res.psi0, res.psi = y0, yf
    return res


def _capture(step, bufs, spec, ins):
    """Capture ``step(carry, *ins) -> (carry, y)`` as a CUDA graph that
    writes the new carry into ``bufs`` (the carry's leaves, tree ``spec``);
    returns (graph, y's leaves, y's tree spec). Two calls on a side stream
    do the first-use set-up outside the capture."""
    from torch.utils import _pytree as pytree
    now = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(now)
    with torch.cuda.stream(side):
        for _ in range(2):
            step(pytree.tree_unflatten(bufs, spec), *ins)
    now.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c, y = step(pytree.tree_unflatten(bufs, spec), *ins)
        for b, o in zip(bufs, pytree.tree_leaves(c)):
            b.copy_(o)
        youts, yspec = pytree.tree_flatten(y)
    return graph, youts, yspec


def cuda_graph_stepper(step: Callable, state, *inputs, graph: bool = True):
    """``advance(*inputs) -> state`` for a fixed-shape step
    ``step(state, *inputs) -> state`` (``state`` a tuple tree of tensors).

    On CUDA with ``graph`` the step is captured once as a CUDA graph that
    writes the new state back into the graph's own buffers (initialised
    from ``state``), so one step costs the copy of ``inputs`` into the
    graph and one replay instead of the step's own host enqueue. The
    state it returns is those buffers: the next ``advance`` overwrites
    them, so a caller copies what it keeps. A step that reads the host
    (``torch.linalg.eigh`` checks its info flags on the host) cannot be
    captured: pass ``graph=False``. Then, and on the CPU, ``advance``
    runs the step eagerly from ``state``."""
    from torch.utils import _pytree as pytree
    leaves, spec = pytree.tree_flatten(state)
    if not graph or leaves[0].device.type != "cuda":
        cur = [state]

        def advance_eager(*values):
            cur[0] = step(cur[0], *values)
            return cur[0]

        return advance_eager
    bufs = [t.clone() for t in leaves]
    ins = [t.clone() for t in inputs]
    graph, _, _ = _capture(lambda s, *x: (step(s, *x), ()), bufs, spec, ins)

    def advance(*values):
        for b, v in zip(ins, values):
            b.copy_(v)
        graph.replay()
        return pytree.tree_unflatten(bufs, spec)

    return advance


class GraphScan:
    """``lax.scan`` of a fixed-shape step ``step(carry, *x) -> (carry, y)``
    over the leading axis of the tensors ``xs``:
    ``scan(carry, *xs) -> (last carry, ys)``, ``ys`` the ``y`` of every
    step stacked along a new first axis (a tuple tree like ``y``).

    The samplers feed their random draws in as ``xs``, so the step itself
    draws nothing and reads nothing back; a step without inputs takes
    ``length=`` in their place. On CUDA with ``graph`` the step is
    captured once per shape as a CUDA graph (the capture of
    :func:`cuda_graph_stepper`), kept across calls, so one step costs the
    copy of its ``x`` into the graph, one replay and the copy of ``y``
    out. The carry it returns is the graph's own buffers, which the next
    call overwrites: a caller copies what it keeps. Without ``graph``,
    and on the CPU, the step runs eagerly."""

    def __init__(self, step: Callable, graph: bool = True):
        self.step = step
        self.graph = graph
        self._captured = {}

    def __call__(self, carry, *xs, length=None):
        from torch.utils import _pytree as pytree
        n = xs[0].shape[0] if xs else length
        leaves, spec = pytree.tree_flatten(carry)
        if n == 0:
            return carry, None
        if not self.graph or leaves[0].device.type != "cuda":
            ys = []
            for k in range(n):
                carry, y = self.step(carry, *(x[k] for x in xs))
                ys.append(pytree.tree_flatten(y))
            yspec = ys[0][1]
            return carry, pytree.tree_unflatten(
                [torch.stack(col) for col in zip(*(y for y, _ in ys))],
                yspec)
        key = (spec, tuple((t.shape, t.dtype) for t in leaves),
               tuple((x.shape[1:], x.dtype) for x in xs))
        if key not in self._captured:
            bufs = [t.clone() for t in leaves]
            ins = [x[0].clone() for x in xs]
            self._captured[key] = (bufs, ins) + _capture(self.step, bufs,
                                                         spec, ins)
        bufs, ins, graph, youts, yspec = self._captured[key]
        for b, t in zip(bufs, leaves):
            if b is not t:
                b.copy_(t)
        ys = [y.new_empty((n,) + y.shape) for y in youts]
        for k in range(n):
            for b, x in zip(ins, xs):
                b.copy_(x[k])
            graph.replay()
            for out, y in zip(ys, youts):
                out[k].copy_(y)
        return (pytree.tree_unflatten(bufs, spec),
                pytree.tree_unflatten(ys, yspec))

    def blocks(self, carry, n, size, make_xs):
        """The scan over ``n`` steps, ``size`` at a time: ``make_xs(start,
        m)`` gives the inputs of steps ``start`` to ``start + m`` (so the
        draws of a long run are made a block at a time). Returns (last
        carry, the ys of all blocks joined along the step axis; None for
        ``n = 0``)."""
        from torch.utils import _pytree as pytree
        outs = []
        for start in range(0, n, size):
            m = min(size, n - start)
            carry, ys = self(carry, *make_xs(start, m), length=m)
            outs.append(pytree.tree_flatten(ys))
        if not outs:
            return carry, None
        return carry, pytree.tree_unflatten(
            [torch.cat(col) for col in zip(*(y for y, _ in outs))],
            outs[0][1])


def rk4_step(rhs: Callable):
    """Lift a time-independent RHS f(y) into a (y, t, dt) -> y RK4 stepper
    (reference integrator: pyqed/phys.py:1051)."""
    def step(y, t, dt):
        dt2 = dt / 2.0
        k1 = rhs(y)
        k2 = rhs(y + k1 * dt2)
        k3 = rhs(y + k2 * dt2)
        k4 = rhs(y + k3 * dt)
        return y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return step


def rk4_step_t(rhs: Callable):
    """Same for an explicitly time-dependent RHS f(y, t)."""
    def step(y, t, dt):
        dt2 = dt / 2.0
        k1 = rhs(y, t)
        k2 = rhs(y + k1 * dt2, t + dt2)
        k3 = rhs(y + k2 * dt2, t + dt2)
        k4 = rhs(y + k3 * dt, t + dt)
        return y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return step
