"""Nonadiabatic wavepacket dynamics in a Gaussian basis (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/nawpd.py`` (reference:
pyqed/moving_gaussian.py ``NAWPD:737``, ``NAWPD2:919``). From N real
Gaussians the overlap S and position X matrices give, through the
generalized eigenproblem X u = x S u, quadrature points and an orthogonal
(Gaussian-DVR) basis; that eigenproblem is static set-up and stays on
the host (SciPy), as in the JAX package. The diabatic potential is
diagonalized at every point by one batched ``eigh`` on the device
(chunked as ``grid/spo.py::_eigh``), the kinetic matrix is dressed with
the electronic overlaps, A[i a, j b] = K_ij <a(x_i)|b(x_j)>, and
i dpsi/dt = (A + diag(APES)) psi is stepped by RK4 with no host read
(a CUDA graph per step on the card). Solvers live on ``device`` (the
card when None; raises without one).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import scipy.linalg
import torch

from ..config import resolve_device
from ..core.dynamics import cuda_graph_stepper
from ..core.result import Result
from ..ops.linalg import as_tensor
from .gwp import GWP, moment_real, overlap_real
from .spo import _eigh


def _gaussian_dvr(gs, mass):
    """Host set-up of one dimension: (q, a, S, U, x, K_dvr) of the real
    Gaussians ``gs`` (NumPy; the generalized eigh is SciPy's)."""
    q = np.array([g.q for g in gs])
    a = np.array([g.a for g in gs])
    aj, ak = a[:, None], a[None, :]
    qj, qk = q[:, None], q[None, :]
    S = overlap_real(aj, qj, ak, qk).numpy()
    X = moment_real(aj, qj, ak, qk, n=1).numpy() + qj * S
    K = (-1.0 / (2 * mass)) * (
        ak ** 2 * moment_real(aj, qj, ak, qk, n=2).numpy() - ak * S)
    K = 0.5 * (K + K.T)
    w, U = scipy.linalg.eigh(X, S)
    return q, a, S, U, w, U.conj().T @ K @ U


def _basis(basis):
    return [g if isinstance(g, GWP) else GWP(q=g[0], a=g[1]) for g in basis]


def _rk4_run(rhs, psi0, dt, nt, nout, device):
    """RK4 of a linear, time-independent right-hand side, one row per
    window of ``nout`` steps (rows 1 .. nt // nout)."""
    def step(psi):
        k1 = rhs(psi)
        k2 = rhs(psi + k1 * (dt / 2))
        k3 = rhs(psi + k2 * (dt / 2))
        k4 = rhs(psi + k3 * dt)
        return psi + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)

    advance = cuda_graph_stepper(step, psi0)
    ns_steps = nt // nout
    psis = torch.empty((ns_steps,) + tuple(psi0.shape), dtype=psi0.dtype,
                       device=device)
    psi = psi0
    for w in range(ns_steps):
        for _ in range(nout):
            psi = advance()
        psis[w] = psi
    r = Result(dt=dt, nt=nt, nout=nout)
    r.times = torch.arange(1, ns_steps + 1, dtype=torch.float64,
                           device=device) * dt * nout
    r.states = psis
    r.psi = psis[-1].clone() if ns_steps else psi0
    return r


class NAWPD:
    """Nonadiabatic Gaussian-basis wavepacket dynamics (1D).

    Parameters
    ----------
    basis : sequence of GWP (real, p = 0) or (q, a) tuples.
    dpes : callable x (a float) -> (ns, ns) diabatic potential matrix
        (array or tensor), evaluated at each quadrature point.
    mass : nuclear mass.
    nstates : number of electronic states.
    device : the card when None (raises without one).
    """

    def __init__(self, basis: Sequence, dpes: Callable, mass=1.0,
                 nstates=2, device=None):
        self.device = resolve_device(device)
        gs = _basis(basis)
        self.basis = gs
        self.nbasis = len(gs)
        self.mass = mass
        self.nstates = nstates
        self.dpes = dpes
        q, a, S, U, w, K_dvr = _gaussian_dvr(gs, mass)
        self.q, self.a = q, a
        self.x_evals = w            # quadrature points
        self.U = U                  # (gaussian, dvr), U† S U = 1
        self.S = S
        self.K_dvr = K_dvr
        # adiabatic states at the quadrature points: one batched eigh
        V = torch.stack([as_tensor(dpes(float(x))) for x in w]).to(
            self.device)
        apes, ustates = _eigh(V)
        self._set_states(apes, ustates)

    def _set_states(self, apes, ustates):
        self.apes = apes                          # (N, ns)
        self.adiabatic_states = ustates           # (N, ns, ns)
        # dressed kinetic: A[i a, j b] = K_ij <a(x_i)|b(x_j)>
        ov = torch.einsum("ica, jcb -> iajb", ustates.conj(), ustates)
        K = torch.as_tensor(self.K_dvr, device=self.device)
        self.A = K[:, None, :, None] * ov

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's solver from the JAX package's ``NAWPD``: the same
        Gaussians, quadrature points and orthogonal basis (SciPy, host),
        and the JAX APES and adiabatic states (so both share the
        eigenvectors' phases), copied through NumPy to ``device``."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.basis = [GWP(q=g.q, p=g.p, a=g.a, phase=g.phase)
                      for g in ref.basis]
        self.nbasis, self.mass = ref.nbasis, ref.mass
        self.nstates, self.dpes = ref.nstates, None
        for k in ("q", "a", "x_evals", "U", "S", "K_dvr"):
            setattr(self, k, np.array(getattr(ref, k)))
        self._set_states(
            torch.as_tensor(np.asarray(ref.apes), device=self.device),
            torch.as_tensor(np.asarray(ref.adiabatic_states),
                            device=self.device))
        return self

    # -------------------------------------------------------------- init
    def project(self, psi_diabatic: Callable, state=None):
        """Project a diabatic wavefunction onto the (orthogonal basis x
        adiabatic states) representation (host quadrature).

        psi_diabatic: callable x -> scalar amplitude; ``state`` picks the
        diabatic surface it lives on (or pass a callable returning a
        (ns,) vector).
        """
        xs = np.linspace(self.q.min() - 6 / np.sqrt(self.a.max()),
                         self.q.max() + 6 / np.sqrt(self.a.max()), 4001)
        dx = xs[1] - xs[0]
        gvals = np.stack([g.evaluate(xs).numpy() for g in self.basis])
        if state is None:
            psivals = np.stack([np.asarray(psi_diabatic(x)) for x in xs])
        else:
            amp = np.array([psi_diabatic(x) for x in xs])
            psivals = np.zeros((len(xs), self.nstates), dtype=complex)
            psivals[:, state] = amp
        proj = gvals.conj() @ psivals * dx            # (N, ns) diabatic
        c = torch.as_tensor(self.U.conj().T @ proj, device=self.device)
        # rotate diabatic -> adiabatic at each point
        u = self.adiabatic_states.to(c.dtype)
        return torch.einsum("nda, nd -> na", u.conj(), c)

    # --------------------------------------------------------------- run
    def rhs(self, psi):
        A = self.A.to(psi.dtype)
        return -1j * (torch.einsum("iajb, jb -> ia", A, psi)
                      + self.apes * psi)

    def run(self, psi0, dt, nt, nout=1) -> Result:
        psi0 = as_tensor(psi0, device=self.device).to(torch.complex128)
        N, ns = psi0.shape
        A = self.A.to(psi0.dtype).reshape(N * ns, N * ns)
        V = self.apes.to(psi0.dtype)

        def rhs(psi):
            return -1j * ((A @ psi.reshape(-1)).reshape(N, ns) + V * psi)

        return _rk4_run(rhs, psi0, dt, nt, nout, self.device)

    # ------------------------------------------------------- observables
    def population(self, psi, representation="adiabatic"):
        """Adiabatic populations P_a = sum_n |psi[n, a]|^2 (the basis is
        orthogonal), or the diabatic ones."""
        psi = as_tensor(psi, device=self.device)
        if representation == "adiabatic":
            return torch.sum(psi.abs() ** 2, dim=0)
        u = self.adiabatic_states.to(psi.dtype)
        psid = torch.einsum("nda, na -> nd", u, psi)
        return torch.sum(psid.abs() ** 2, dim=0)

    def norm(self, psi):
        return float(torch.linalg.vector_norm(as_tensor(psi).reshape(-1)))


class NAWPD2:
    """2D nonadiabatic Gaussian-basis dynamics with a direct-product
    basis and per-dimension Gaussian-DVR transforms (reference:
    pyqed/moving_gaussian.py:919 ``NAWPD2``).

    Parameters
    ----------
    basis_x, basis_y : sequences of (q, a) or GWP per dimension.
    dpes : callable (x, y) -> (ns, ns), evaluated at each point.
    masses : [mx, my].
    device : the card when None (raises without one).
    """

    def __init__(self, basis_x, basis_y, dpes, masses=(1.0, 1.0),
                 nstates=2, device=None):
        self.device = resolve_device(device)
        self.dims = []
        for basis, mass in zip((basis_x, basis_y), masses):
            gs = _basis(basis)
            q, a, S, U, w, K_dvr = _gaussian_dvr(gs, mass)
            self.dims.append(dict(gs=gs, q=q, a=a, S=S, U=U, xe=w,
                                  K_dvr=K_dvr))
        self.nx = len(self.dims[0]["gs"])
        self.ny = len(self.dims[1]["gs"])
        self.nstates = nstates
        self.dpes = dpes
        X, Y = np.meshgrid(self.dims[0]["xe"], self.dims[1]["xe"],
                           indexing="ij")
        V = torch.stack([as_tensor(dpes(float(x), float(y)))
                         for x, y in zip(X.ravel(), Y.ravel())]).to(
            self.device)
        apes, ustates = _eigh(V)
        ns = V.shape[-1]
        self._set_states(apes.reshape(self.nx, self.ny, ns),
                         ustates.reshape(self.nx, self.ny, ns, ns))

    def _set_states(self, apes, ustates):
        self.apes = apes                       # (nx, ny, ns)
        self.adiabatic_states = ustates        # (nx, ny, ns, ns)
        # the kinetic term is separable: only pairs of points that share
        # one index couple, A_x[(i, i'), j] and A_y[i, (j, j')]
        u = ustates
        self.Ax = torch.einsum("ijca, kjcb -> ikjab", u.conj(), u)
        self.Ay = torch.einsum("ijca, ilcb -> ijlab", u.conj(), u)
        dev = self.device
        self.Kx = torch.as_tensor(self.dims[0]["K_dvr"], device=dev)
        self.Ky = torch.as_tensor(self.dims[1]["K_dvr"], device=dev)

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's solver from the JAX package's ``NAWPD2``: the same
        per-dimension Gaussian DVRs (host) and the JAX APES and adiabatic
        states, copied through NumPy to ``device``."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.dims = [dict(gs=[GWP(q=g.q, p=g.p, a=g.a, phase=g.phase)
                              for g in d["gs"]],
                          **{k: np.array(d[k]) for k in
                             ("q", "a", "S", "U", "xe", "K_dvr")})
                     for d in ref.dims]
        self.nx, self.ny, self.nstates = ref.nx, ref.ny, ref.nstates
        self.dpes = None
        self._set_states(
            torch.as_tensor(np.asarray(ref.apes), device=self.device),
            torch.as_tensor(np.asarray(ref.adiabatic_states),
                            device=self.device))
        return self

    def rhs(self, psi):
        """psi (nx, ny, ns): kinetic dressing per dimension + APES."""
        Kx, Ky = self.Kx.to(psi.dtype), self.Ky.to(psi.dtype)
        tx = torch.einsum("ik, ikjab, kjb -> ija", Kx,
                          self.Ax.to(psi.dtype), psi)
        ty = torch.einsum("jl, ijlab, ilb -> ija", Ky,
                          self.Ay.to(psi.dtype), psi)
        return -1j * (tx + ty + self.apes * psi)

    def project(self, psi_fn, state=0):
        """Project a diabatic amplitude psi(x, y) (host quadrature)."""
        d0, d1 = self.dims
        xs = np.linspace(d0["q"].min() - 4, d0["q"].max() + 4, 801)
        ys = np.linspace(d1["q"].min() - 4, d1["q"].max() + 4, 801)
        gx = np.stack([g.evaluate(xs).numpy() for g in d0["gs"]])
        gy = np.stack([g.evaluate(ys).numpy() for g in d1["gs"]])
        P = np.array([[psi_fn(x, y) for y in ys] for x in xs])
        dx, dy = xs[1] - xs[0], ys[1] - ys[0]
        proj = gx.conj() @ P @ gy.conj().T * dx * dy      # (nx, ny)
        c = torch.as_tensor(d0["U"].conj().T @ proj @ d1["U"].conj(),
                            device=self.device)
        # rotate diabatic -> adiabatic: only diabatic `state` populated
        u = self.adiabatic_states.to(c.dtype)
        return torch.einsum("ij, ija -> ija", c, u.conj()[:, :, state, :])

    def run(self, psi0, dt, nt, nout=1) -> Result:
        psi0 = as_tensor(psi0, device=self.device).to(torch.complex128)
        return _rk4_run(self.rhs, psi0, dt, nt, nout, self.device)

    def population(self, psi, representation="adiabatic"):
        psi = as_tensor(psi, device=self.device)
        if representation == "adiabatic":
            return torch.sum(psi.abs() ** 2, dim=(0, 1))
        u = self.adiabatic_states.to(psi.dtype)
        psid = torch.einsum("ijda, ija -> ijd", u, psi)
        return torch.sum(psid.abs() ** 2, dim=(0, 1))

    def norm(self, psi):
        return float(torch.linalg.vector_norm(as_tensor(psi).reshape(-1)))
