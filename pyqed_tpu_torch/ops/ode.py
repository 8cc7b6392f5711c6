"""Adaptive ODE integration (RKF45).

Counterpart of ``pyqed_tpu/ops/ode.py``: the embedded
Runge-Kutta-Fehlberg 4(5) pair with proportional step control. The JAX
package runs the adaptive loop inside ``lax.while_loop``; here the
stages are tensor operations on the state's device and the loop reads
the error norm, and so the accept/reject decision, on the host once a
step. ``t`` and ``h`` are host floats in the JAX package's arithmetic,
so the step sequence (accepted and rejected counts, final ``t``) is
JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

from .linalg import as_tensor

# Fehlberg 4(5) tableau
_A = np.array([
    [0, 0, 0, 0, 0],
    [1 / 4, 0, 0, 0, 0],
    [3 / 32, 9 / 32, 0, 0, 0],
    [1932 / 2197, -7200 / 2197, 7296 / 2197, 0, 0],
    [439 / 216, -8, 3680 / 513, -845 / 4104, 0],
    [-8 / 27, 2, -3544 / 2565, 1859 / 4104, -11 / 40],
])
_C = np.array([0.0, 1 / 4, 3 / 8, 12 / 13, 1.0, 1 / 2])
_B5 = np.array([16 / 135, 0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55])
_B4 = np.array([25 / 216, 0, 1408 / 2565, 2197 / 4104, -1 / 5, 0])


def _rkf_step(f, t, y, h):
    """One embedded step: (y5, y5 - y4), the 5th-order solution and the
    4/5 difference as the error estimate."""
    k = []
    for i in range(6):
        yi = y
        for j in range(i):
            yi = yi + h * _A[i][j] * k[j]
        k.append(f(t + _C[i] * h, yi))
    ks = torch.stack(k)
    b5 = torch.as_tensor(_B5, dtype=ks.real.dtype, device=ks.device)
    b4 = torch.as_tensor(_B4, dtype=ks.real.dtype, device=ks.device)
    y5 = y + h * torch.tensordot(b5.to(ks.dtype), ks, dims=1)
    y4 = y + h * torch.tensordot(b4.to(ks.dtype), ks, dims=1)
    return y5, y5 - y4


def rkf45(f, y0, t0, t1, rtol=1e-6, atol=1e-9, h0=None, max_steps=100000,
          safety=0.9):
    """Integrate dy/dt = f(t, y) from t0 to t1 with adaptive RKF45.

    ``f(t, y)`` takes a float ``t`` and a tensor ``y`` (real or complex,
    any shape) in torch operations. Returns (y(t1), stats) with stats =
    {'naccept', 'nreject', 'h_final', 't'}."""
    y = as_tensor(y0)
    t0, t1 = float(t0), float(t1)
    h = (t1 - t0) / 100.0 if h0 is None else float(h0)
    t, na, nr = t0, 0, 0
    done = False
    while not done and na + nr < max_steps:
        h = min(h, t1 - t)
        ynew, e = _rkf_step(f, t, y, h)
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(ynew))
        r = float(torch.sqrt(torch.mean(torch.abs(e / scale) ** 2)))
        accept = r <= 1.0
        # proportional controller, 5th-order error -> exponent 1/5
        fac = 5.0 if r == 0.0 else min(max(safety * r ** -0.2, 0.1), 5.0)
        if accept:
            t, y = t + h, ynew
            na += 1
        else:
            nr += 1
        h = h * fac
        done = t >= t1 - 1e-14 * abs(t1 - t0)
    return y, {"naccept": na, "nreject": nr, "h_final": h, "t": t}


def rkf45_sample(f, y0, ts, rtol=1e-6, atol=1e-9, max_steps=100000):
    """Adaptive integration sampled at the times ``ts`` (ascending,
    ts[0] = start). Returns ys with ys[0] = y0, shape (len(ts),) + y0."""
    ts = [float(s) for s in np.asarray(ts, dtype=float)]
    y = as_tensor(y0)
    ys = [y]
    for a, b in zip(ts[:-1], ts[1:]):
        y, _ = rkf45(f, y, a, b, rtol=rtol, atol=atol, max_steps=max_steps)
        ys.append(y)
    return torch.stack(ys)

