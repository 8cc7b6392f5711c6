"""Quantum-regression correlation functions with a pluggable right-hand
side (PyTorch).

PyTorch counterpart of ``pyqed_tpu/open/correlation.py`` (reference:
pyqed/correlation.py:17 ``correlation_3p_1t``; ``correlation_4p_2t:13`` is
an empty stub there). Any Liouville right-hand side ``dyn(rho, H, c_ops)
-> drho/dt`` of torch tensors works; the default is Lindblad. The RK4
loops run on ``device`` (the card when None, raises without one) and write
each correlation value into a preallocated tensor, without reading the
device.
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor


def _default_dyn(rho, H, c_ops):
    """Lindblad RHS: -i[H, rho] + sum_l l rho l+ - 1/2 {l+ l, rho}."""
    out = -1j * (H @ rho - rho @ H)
    for l in c_ops:
        ld = l.mH
        out = out + l @ rho @ ld - 0.5 * (ld @ l @ rho + rho @ ld @ l)
    return out


def _setup(H, rho0, ops, c_ops, device):
    dev = resolve_device(device)

    def t(a):
        return as_tensor(a, device=dev).to(torch.complex128)

    return dev, t(H), t(rho0), [t(o) for o in ops], [t(c) for c in c_ops]


def _rk4(dyn, H, c_ops, dt):
    def step(rho):
        k1 = dyn(rho, H, c_ops)
        k2 = dyn(rho + 0.5 * dt * k1, H, c_ops)
        k3 = dyn(rho + 0.5 * dt * k2, H, c_ops)
        k4 = dyn(rho + dt * k3, H, c_ops)
        return rho + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return step


def correlation_3p_1t(H, rho0, ops, c_ops=(), tlist=None, dyn=None,
                      dt=None, nt=None, device=None):
    """<A B(t) C> by the quantum regression theorem (reference:
    pyqed/correlation.py:17): rho' = C rho0 A is propagated and
    corr[k] = Tr[B rho'(t_k)]. ops = (A, B, C). Returns (times, corr):
    ``tlist`` when given (its spacing is dt), else dt, 2 dt, ..., nt dt."""
    dev, H, rho0, (A, B, C), c_ops = _setup(H, rho0, ops, c_ops, device)
    if dyn is None:
        dyn = _default_dyn
    if tlist is not None:
        tlist = torch.as_tensor(tlist, dtype=torch.float64, device=dev)
        dt = float(tlist[1] - tlist[0])
        nt = len(tlist)
    else:
        tlist = torch.arange(1, nt + 1, dtype=torch.float64,
                             device=dev) * dt
    step = _rk4(dyn, H, c_ops, dt)
    rho = C @ rho0 @ A
    corr = torch.empty(int(nt), dtype=torch.complex128, device=dev)
    for k in range(int(nt)):
        rho = step(rho)
        corr[k] = torch.trace(B @ rho)
    return tlist, corr


def correlation_4p_2t(H, rho0, ops, c_ops=(), dt=0.01, nt1=100, nt2=100,
                      dyn=None, device=None):
    """Two-time map (nt1, nt2) by nested quantum regression (the
    reference's correlation_4p_2t is an empty stub, pyqed/correlation.py:13):
    C[i, j] = Tr[A B r_{j+1}], where r_0 = C rho1_i, rho1_0 = D rho0, and
    rho1_i and r_j advance by one RK4 step of ``dt`` each."""
    dev, H, rho0, (A, B, C, D), c_ops = _setup(H, rho0, ops, c_ops, device)
    if dyn is None:
        dyn = _default_dyn
    step = _rk4(dyn, H, c_ops, dt)
    AB = A @ B
    cmat = torch.empty((int(nt1), int(nt2)), dtype=torch.complex128,
                       device=dev)
    rho1 = D @ rho0
    for i in range(int(nt1)):
        r = C @ rho1
        for j in range(int(nt2)):
            r = step(r)
            cmat[i, j] = torch.trace(AB @ r)
        rho1 = step(rho1)
    return cmat


def g2_coherence(H, rho0, a, c_ops=(), dt=0.01, nt=500, dyn=None,
                 device=None):
    """Normalised second-order coherence
    g2(tau) = <a+(0) a+(tau) a(tau) a(0)> / (<n>(0) <n>(tau)) by quantum
    regression: the numerator is Tr[n U(tau)[a rho0 a+]], <n>(tau) comes
    from the same function with A = C = 1. Returns (times, g2)."""
    dev = resolve_device(device)
    a = as_tensor(a, device=dev).to(torch.complex128)
    ad = a.mH
    n_op = ad @ a
    rho0 = as_tensor(rho0, device=dev).to(torch.complex128)
    tlist, num = correlation_3p_1t(H, rho0, (ad, n_op, a), c_ops=c_ops,
                                   dt=dt, nt=nt, dyn=dyn, device=dev)
    eye = torch.eye(rho0.shape[0], dtype=rho0.dtype, device=dev)
    _, nbar_t = correlation_3p_1t(H, rho0, (eye, n_op, eye), c_ops=c_ops,
                                  dt=dt, nt=nt, dyn=dyn, device=dev)
    nbar0 = torch.trace(n_op @ rho0)
    return tlist, num.real / (nbar0 * nbar_t).real
