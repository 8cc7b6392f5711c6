"""GRAPE / CRAB pulse optimization (PyTorch).

Counterpart of ``pyqed_tpu/control/grape.py`` (no counterpart in the
reference): gradient-ascent pulse engineering [Khaneja et al., J. Magn.
Reson. 172, 296 (2005)] with the gradient of the fidelity with respect to
every control amplitude from ``torch.autograd``, exact to rounding rather
than first order in dt. The slice propagators are one batched
``torch.linalg.matrix_exp`` (the JAX package vmaps
``jax.scipy.linalg.expm``), their product a loop of matrix products on
the device (JAX: a ``lax.scan``).

Closed system:   U_k = exp(-i (H0 + sum_j u[k,j] Hc_j) dt)
Open system:     P_k = exp((L0 + sum_j u[k,j] Lc_j) dt)   in Liouville space
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..config import default_complex, default_real, resolve_device
from ..ops.linalg import as_tensor, dag
from ..ops.superoperator import liouvillian
from .fit import fit

__all__ = ["GRAPE", "OpenGRAPE", "CRAB",
           "amplitude_penalty", "smoothness_penalty"]


def _scan_apply(Us, x0):
    """x_N = U_{N-1} ... U_1 U_0 x0 (x0 a vector or a matrix)."""
    x = x0
    for U in Us:
        x = U @ x
    return x


def _scan_states(Us, x0):
    """(x0, U_0 x0, U_1 U_0 x0, ...) stacked, shape (N+1,) + x0.shape."""
    xs = [x0]
    for U in Us:
        xs.append(U @ xs[-1])
    return torch.stack(xs)


def amplitude_penalty(u, weight=1e-3):
    """Mean-square amplitude penalty (keeps pulses physical)."""
    return weight * torch.mean(torch.abs(u) ** 2)


def smoothness_penalty(u, weight=1e-3):
    """Mean-square slew-rate penalty on the piecewise-constant amplitudes."""
    return weight * torch.mean(torch.abs(torch.diff(u, dim=0)) ** 2)


class GRAPE:
    """Closed-system GRAPE: H(t) = H0 + sum_j u_j(t) Hc_j, piecewise
    constant.

    Parameters
    ----------
    H0 : (n, n) drift Hamiltonian.
    Hc : sequence of (n, n) control Hamiltonians.
    dt : time-slice length; n_steps slices of equal length.
    device : the card when None (raises without one).
    """

    def __init__(self, H0, Hc: Sequence, dt: float, n_steps: int,
                 device=None):
        self.device = resolve_device(device)
        cdt = default_complex()
        self.H0 = as_tensor(H0, cdt, self.device)
        self.Hc = torch.stack([as_tensor(h, cdt, self.device) for h in Hc])
        self.dt = float(dt)
        self.n_steps = int(n_steps)
        self.n = self.H0.shape[0]

    def _c(self, a):
        return as_tensor(a, default_complex(), self.device)

    def _u(self, u):
        return as_tensor(u, device=self.device)

    # -- propagation -------------------------------------------------
    def step_propagators(self, u):
        """All slice propagators at once, one batched matrix exponential
        over the time axis. u : (n_steps, n_ctrl) real amplitudes."""
        u = self._u(u)
        H = self.H0[None] + torch.einsum("kj, jab -> kab",
                                         u.to(self.Hc.dtype), self.Hc)
        return torch.linalg.matrix_exp(-1j * H * self.dt)

    def evolve(self, u, psi0):
        """Final state after the full pulse."""
        return _scan_apply(self.step_propagators(u), self._c(psi0))

    def total_propagator(self, u):
        return _scan_apply(self.step_propagators(u),
                           torch.eye(self.n, dtype=default_complex(),
                                     device=self.device))

    def trajectory(self, u, psi0):
        """All intermediate states, shape (n_steps+1, n)."""
        return _scan_states(self.step_propagators(u), self._c(psi0))

    # -- fidelities ---------------------------------------------------
    def fidelity_state(self, u, psi0, target):
        """|<target|U(T)|psi0>|^2 (phase-insensitive state transfer)."""
        return torch.abs(torch.vdot(self._c(target),
                                    self.evolve(u, psi0))) ** 2

    def fidelity_gate(self, u, U_target):
        """|Tr(U_target^dag U(T))|^2 / n^2 (global-phase-insensitive)."""
        U = self.total_propagator(u)
        return torch.abs(torch.trace(dag(self._c(U_target)) @ U)) ** 2 \
            / self.n ** 2

    # -- optimization -------------------------------------------------
    def optimize(self, loss_fn: Callable, u0, iters: int = 200,
                 learning_rate: float = 0.05, optimizer=None,
                 has_aux: bool = False):
        """Minimize ``loss_fn(u)`` from ``u0`` with :func:`control.fit`.

        Returns (u_opt, losses) with losses of shape (iters,)
        (``has_aux`` as in :func:`control.fit`).
        """
        return fit(loss_fn, as_tensor(u0, default_real(), self.device),
                   iters=iters, learning_rate=learning_rate,
                   optimizer=optimizer, has_aux=has_aux)

    def _optimize_fidelity(self, fidelity, p0, iters, learning_rate,
                           penalty, to_u=lambda p: p):
        """Maximize ``fidelity(u)`` over p (u = to_u(p)); returns (p_opt,
        the true per-iteration fidelities), tracked as an aux output so
        that an amplitude penalty cannot bias the reported history."""
        def loss(p):
            u = to_u(p)
            f = fidelity(u)
            return 1.0 - f + amplitude_penalty(u, penalty), f
        p, (_, fids) = self.optimize(loss, p0, iters, learning_rate,
                                     has_aux=True)
        return p, fids

    def _u0(self, u0):
        return 1e-2 * np.ones((self.n_steps, self.Hc.shape[0])) \
            if u0 is None else u0

    def optimize_state_transfer(self, psi0, target, u0=None, iters=200,
                                learning_rate=0.05, penalty=0.0):
        """Maximize the state-transfer fidelity. Returns (u_opt,
        fidelities)."""
        return self._optimize_fidelity(
            lambda u: self.fidelity_state(u, psi0, target), self._u0(u0),
            iters, learning_rate, penalty)

    def optimize_gate(self, U_target, u0=None, iters=300,
                      learning_rate=0.05, penalty=0.0):
        """Maximize the gate fidelity. Returns (u_opt, fidelities)."""
        return self._optimize_fidelity(
            lambda u: self.fidelity_gate(u, U_target), self._u0(u0),
            iters, learning_rate, penalty)


class OpenGRAPE(GRAPE):
    """Open-system GRAPE in Liouville space with Lindblad dissipation.

    The drift is L0 = -i[H0, .] + sum_k D[c_k]; each control enters as
    the coherent superoperator -i[Hc_j, .]. Propagation is a batched
    matrix exponential of the (n^2, n^2) Liouvillian per slice, exact for
    piecewise-constant controls and differentiable.
    """

    def __init__(self, H0, Hc: Sequence, dt: float, n_steps: int, c_ops=(),
                 device=None):
        super().__init__(H0, Hc, dt, n_steps, device=device)
        self.L0 = liouvillian(self.H0, [self._c(c) for c in c_ops])
        self.Lc = torch.stack([liouvillian(h, []) for h in self.Hc])

    def step_propagators(self, u):
        u = self._u(u)
        L = self.L0[None] + torch.einsum("kj, jab -> kab",
                                         u.to(self.Lc.dtype), self.Lc)
        return torch.linalg.matrix_exp(L * self.dt)

    def evolve(self, u, rho0):
        """Final density matrix after the full pulse."""
        v = _scan_apply(self.step_propagators(u), self._c(rho0).reshape(-1))
        return v.reshape(self.n, self.n)

    def total_propagator(self, u):
        """Full (n^2, n^2) Liouville-space propagator of the pulse."""
        return _scan_apply(self.step_propagators(u),
                           torch.eye(self.n ** 2, dtype=default_complex(),
                                     device=self.device))

    def trajectory(self, u, rho0):
        """All intermediate density matrices, shape (n_steps+1, n, n)."""
        return _scan_states(self.step_propagators(u),
                            self._c(rho0).reshape(-1)).reshape(
            -1, self.n, self.n)

    def fidelity_gate(self, u, U_target):
        """Process fidelity against a target unitary:
        F = Re Tr(S_tgt^dag S(T)) / n^2 with S_tgt = U (x) conj(U)
        (row-major vec), the superoperator of rho -> U rho U^dag."""
        S = self.total_propagator(u)
        tgt = self._c(U_target)
        S_tgt = torch.kron(tgt, tgt.conj())
        return torch.real(torch.trace(dag(S_tgt) @ S)) / self.n ** 2

    def fidelity_state(self, u, rho0, target):
        """Tr(rho_target rho(T)) for a pure target (overlap fidelity)."""
        rhoT = self.evolve(u, rho0)
        tgt = self._c(target)
        if tgt.dim() == 1:
            return torch.real(torch.vdot(tgt, rhoT @ tgt))
        return torch.real(torch.trace(dag(tgt) @ rhoT))

    def expect_final(self, u, rho0, op):
        return torch.real(torch.trace(self._c(op) @ self.evolve(u, rho0)))


class CRAB(GRAPE):
    """Chopped-random-basis control: u_j(t) = env(t) sum_n [a_n sin(w_n t)
    + b_n cos(w_n t)] [Caneva, Calarco, Montangero, PRA 84, 022326
    (2011)]: the (n_modes, 2, n_ctrl) Fourier coefficients are optimized
    instead of the per-slice amplitudes, through ``coeffs_to_u`` and the
    GRAPE propagation."""

    def __init__(self, H0, Hc: Sequence, dt: float, n_steps: int,
                 frequencies=None, n_modes: int = 5, envelope=None,
                 device=None):
        super().__init__(H0, Hc, dt, n_steps, device=device)
        T = dt * n_steps
        if frequencies is None:
            # principal harmonics of the pulse window
            frequencies = 2.0 * np.pi * np.arange(1, n_modes + 1) / T
        rdt = default_real()
        self.frequencies = as_tensor(np.asarray(frequencies, dtype=float),
                                     rdt, self.device)
        t = (np.arange(n_steps) + 0.5) * dt
        self.t = torch.as_tensor(t, dtype=rdt, device=self.device)
        if envelope is None:
            envelope = np.sin(np.pi * t / T) ** 2        # smooth on/off
        elif callable(envelope):
            envelope = np.asarray(envelope(t))
        envelope = as_tensor(envelope, rdt, self.device)
        if tuple(envelope.shape) != (n_steps,):
            raise ValueError(f"envelope shape {tuple(envelope.shape)} != "
                             f"({n_steps},)")
        self.envelope = envelope

    def coeffs_to_u(self, coeffs):
        """coeffs: (n_modes, 2, n_ctrl) -> u: (n_steps, n_ctrl)."""
        coeffs = self._u(coeffs)
        ph = torch.outer(self.t, self.frequencies)       # (n_steps, n_modes)
        u = torch.sin(ph) @ coeffs[:, 0, :] + torch.cos(ph) @ coeffs[:, 1, :]
        return self.envelope[:, None] * u

    def _c0(self, c0):
        return 1e-1 * np.ones((len(self.frequencies), 2, self.Hc.shape[0])) \
            if c0 is None else c0

    def optimize_state_transfer(self, psi0, target, c0=None, iters=300,
                                learning_rate=0.1, penalty=0.0):
        return self._optimize_fidelity(
            lambda u: self.fidelity_state(u, psi0, target), self._c0(c0),
            iters, learning_rate, penalty, to_u=self.coeffs_to_u)

    def optimize_gate(self, U_target, c0=None, iters=300,
                      learning_rate=0.1, penalty=0.0):
        """Gate optimization in the chopped Fourier basis."""
        return self._optimize_fidelity(
            lambda u: self.fidelity_gate(u, U_target), self._c0(c0),
            iters, learning_rate, penalty, to_u=self.coeffs_to_u)
