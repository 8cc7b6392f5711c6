"""Exponential decomposition of a Drude-Lorentz bath, written from the
equations.

J(w) = 2 lam gam w / (w^2 + gam^2); the bath correlation function
C(t > 0) = (1/pi) int J(w) [coth(beta w / 2) cos(w t) - i sin(w t)] dw
is a sum of exponentials c_k exp(-nu_k t) once coth is written as a sum
over its poles. With the [N-1/N] Padé spectrum decomposition of the Bose
function (Hu, Xu and Yan, J. Chem. Phys. 133, 101106 (2010)),

  coth(x / 2) ~ 2 / x + sum_j 4 eta_j x / (x^2 + xi_j^2),

the Drude pole gives nu_0 = gam, c_0 = lam gam (cot~(beta gam / 2) - i),
cot~ the same sum at x = beta gam with the sign of xi_j^2 turned, and
each Padé pole nu_j = xi_j / beta gives
c_j = (4 eta_j lam gam / beta) nu_j / (nu_j^2 - gam^2).
"""
from __future__ import annotations

import numpy as np


def _positive_inverse_eigs(size, shift):
    """2 / lambda for the positive eigenvalues lambda of the symmetric
    tridiagonal matrix with off-diagonal 1 / sqrt(b_m b_{m+1}),
    b_m = 2 (m + shift) + 1, largest lambda first."""
    b = 2.0 * (np.arange(size) + shift) + 1.0
    off = 1.0 / np.sqrt(b[:-1] * b[1:])
    lam = np.linalg.eigvalsh(np.diag(off, 1) + np.diag(off, -1))
    return 2.0 / np.sort(lam[lam > 1e-12])[::-1]


def pade_bose(N):
    """Poles xi_j and weights eta_j of the [N-1/N] Padé spectrum
    decomposition of the Bose function, j = 1..N."""
    if N == 0:
        return np.zeros(0), np.zeros(0)
    xi = _positive_inverse_eigs(2 * N, 1)[:N]
    zeta = (_positive_inverse_eigs(2 * N - 1, 2)[:N - 1] if N > 1
            else np.zeros(0))
    eta = np.empty(N)
    for j in range(N):
        others = np.delete(xi, j)
        eta[j] = (0.5 * N * (2 * N + 3) * np.prod(zeta ** 2 - xi[j] ** 2)
                  / np.prod(others ** 2 - xi[j] ** 2))
    return xi, eta


def drude_pade(reorg, cutoff, temperature, nexp):
    """(c, nu) of a Drude bath: its pole and ``nexp`` Padé terms, in the
    units of the arguments (temperature as an energy)."""
    beta = 1.0 / temperature
    xi, eta = pade_bose(nexp)
    x = beta * cutoff
    cot = 2.0 / x + np.sum(4.0 * eta * x / (x ** 2 - xi ** 2))
    c = [reorg * cutoff * (cot - 1j)]
    nu = [cutoff]
    for j in range(nexp):
        nuj = xi[j] / beta
        nu.append(nuj)
        c.append(4.0 * eta[j] * reorg * cutoff / beta
                 * nuj / (nuj ** 2 - cutoff ** 2))
    return np.array(c, dtype=complex), np.array(nu, dtype=float)
