"""Adiabatic-representation nonadiabatic wavepacket dynamics on a 1D grid
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/namd.py`` (reference:
pyqed/namd/adiabatic.py:34 ``NAMD``). psi(x, a) on adiabatic surfaces
v_a(x), coupled by the derivative couplings D_ab(x) = <a|d/dx b>. With
P = -i d/dx and antisymmetric D the kinetic energy in the adiabatic basis
is

    T = (P - i D)^2 / 2m = [ -d^2/dx^2 - 2 D d/dx - D' - D^2 ] / 2m;

``order=2`` (default) keeps all of it, so the propagation is unitarily
equivalent to the diabatic one; ``order=1`` keeps -(D d/dx)/m only, the
reference's ``hpsi``. RK4 in a Python loop over fixed windows on the
device (on CUDA each step is one CUDA graph); each H psi is one FFT and
one batched inverse FFT of the kinetic and derivative terms.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..core.dynamics import cuda_graph_stepper
from ..core.result import Result
from ..ops.linalg import as_tensor


class NAMD:
    """Nonadiabatic dynamics in the adiabatic representation on a 1D grid.

    Parameters
    ----------
    x : (nx,) uniform grid.
    v : (nx, ns) adiabatic potential energy surfaces.
    nac : (nx, ns, ns) derivative couplings D_ab(x) = <a | d/dx b>.
    mass : nuclear mass.
    order : 1 keeps only -(D d/dx)/m (the reference's ``hpsi``); 2 adds
        -(D' + D^2)/2m, D' by non-periodic central differences.
    device : the card when None (raises without one); ``"cpu"`` on
        request.
    """

    def __init__(self, x, v, nac, mass=1.0, order=2, device=None):
        dev = self.device = resolve_device(device)
        self.x = np.asarray(x)
        nx = self.x.size
        self.dx = float(self.x[1] - self.x[0])
        v_np = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        nac_np = np.asarray(nac.cpu() if isinstance(nac, torch.Tensor)
                            else nac)
        if v_np.ndim != 2 or v_np.shape[0] != nx:
            raise ValueError("v must be (nx, nstates)")
        if nac_np.shape != (nx, v_np.shape[1], v_np.shape[1]):
            raise ValueError("nac must be (nx, nstates, nstates)")
        if order not in (1, 2):
            raise ValueError("order must be 1 or 2")
        self.v = torch.as_tensor(v_np, device=dev)
        self.nac = torch.as_tensor(nac_np, device=dev)
        self._nac_c = self.nac.to(torch.complex128)
        self.nstates = int(v_np.shape[1])
        self.mass = float(mass)
        self.order = order
        k = 2.0 * np.pi * np.fft.fftfreq(nx, d=self.dx)
        self.k = torch.as_tensor(k, device=dev)
        # the two spectral factors of H psi: k^2/2m and i k, stacked so one
        # batched inverse FFT gives T psi and d psi/dx
        self._kfac = torch.as_tensor(
            np.stack([k ** 2 / (2.0 * self.mass) + 0j, 1j * k]), device=dev)
        if order == 2:
            # D is not periodic over the box (adiabatic states swap
            # character across a crossing): central differences, not FFT
            dD = np.gradient(nac_np, self.dx, axis=0)
            self._second = torch.as_tensor(
                dD + np.einsum("xab, xbc -> xac", nac_np, nac_np),
                device=dev).to(torch.complex128)
        else:
            self._second = None

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's solver with the arrays of a JAX ``NAMD`` ``ref``
        (grid, surfaces, couplings, mass, order), on ``device``."""
        return cls(np.asarray(ref.x), np.asarray(ref.v), np.asarray(ref.nac),
                   mass=ref.mass, order=ref.order, device=device)

    # ------------------------------------------------------------------ rhs
    def hpsi(self, psi):
        """H psi for psi (nx, ns) on the solver's device (reference:
        pyqed/namd/adiabatic.py:252, first order only there)."""
        psi_k = torch.fft.fft(psi, dim=0)
        tpsi, dpsi = torch.fft.ifft(self._kfac[:, :, None] * psi_k[None],
                                    dim=1)
        hp = tpsi + self.v * psi - torch.einsum(
            "xab, xb -> xa", self._nac_c, dpsi) / self.mass
        if self._second is not None:
            hp = hp - torch.einsum("xab, xb -> xa", self._second,
                                   psi) / (2.0 * self.mass)
        return hp

    def rhs(self, psi):
        return -1j * self.hpsi(psi)

    # ------------------------------------------------------------------ run
    def run(self, psi0, dt, nt, nout=1, e_ops=None) -> Result:
        """RK4 propagation of psi0 (nx, ns) for ``nt`` steps, keeping the
        state after every window of ``nout`` steps and at t = 0
        (reference: pyqed/namd/adiabatic.py:172 ``evolve``).

        Result: ``states`` (nt // nout + 1, nx, ns), ``psi`` (final),
        ``times``, and ``observables`` (nsnap, k) for ``e_ops``, each an
        (nx, ns, ns) field or an (ns, ns) matrix."""
        dev = self.device
        psi0 = as_tensor(psi0, torch.complex128, dev)
        if tuple(psi0.shape) != (self.x.size, self.nstates):
            raise ValueError("psi0 must be (nx, nstates)")
        if nt % nout != 0:
            raise ValueError(f"nt={nt} must be a multiple of nout={nout}")
        nwin = nt // nout
        rhs = self.rhs

        def step(state):
            psi, = state
            k1 = rhs(psi)
            k2 = rhs(psi + 0.5 * dt * k1)
            k3 = rhs(psi + 0.5 * dt * k2)
            k4 = rhs(psi + dt * k3)
            return (psi + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4),)

        states = torch.empty((nwin + 1,) + tuple(psi0.shape),
                             dtype=psi0.dtype, device=dev)
        states[0] = psi0
        advance = cuda_graph_stepper(step, (psi0,))
        for w in range(1, nwin + 1):
            for _ in range(nout):
                psi, = advance()
            states[w] = psi
        psi = states[nwin]
        r = Result(dt=dt, nt=nt, nout=nout)
        r.times = torch.arange(nwin + 1, dtype=torch.float64,
                               device=dev) * (dt * nout)
        r.psi0 = psi0
        r.psi = psi
        r.states = states
        if e_ops is not None:
            obs = []
            for op in e_ops:
                op = as_tensor(op, device=dev).to(torch.complex128)
                spec = ("txa, xab, txb -> t" if op.dim() == 3
                        else "txa, ab, txb -> t")
                obs.append(torch.einsum(spec, states.conj(), op, states)
                           * self.dx)
            r.observables = torch.stack(obs, dim=-1)
        return r

    # ---------------------------------------------------------- observables
    def population(self, psi):
        """Adiabatic-state populations, (ns,) or (t, ns)."""
        psi = as_tensor(psi, device=self.device)
        return (psi.abs() ** 2).sum(dim=-2) * self.dx

    def norm(self, psi):
        psi = as_tensor(psi, device=self.device)
        return (psi.abs() ** 2).sum(dim=(-2, -1)) * self.dx

    def energy(self, psi):
        """<psi|H|psi> (real up to the truncation order)."""
        psi = as_tensor(psi, torch.complex128, self.device)
        return ((psi.conj() * self.hpsi(psi)).sum() * self.dx).real


def diabatic_to_adiabatic_1d(x, dpes, smooth_gauge=True, ddpes=None):
    """Diagonalize a diabatic PES matrix field and return smooth adiabatic
    surfaces, the transformation U(x) and the derivative couplings D(x),
    as NumPy arrays (a host builder, as in the JAX package).

    dpes : (nx, ns, ns) real symmetric diabatic matrix at each point.
    Returns (v (nx, ns), U (nx, ns, ns) with the adiabatic states as
    columns, sign-aligned along x, nac (nx, ns, ns) with
    D_ab = <a|d/dx b>: by Hellmann-Feynman when the analytic gradient
    ``ddpes`` is given, else by central differences of U).

    (reference: pyqed/namd/adiabatic.py:408 ``get_nac``, one 2-state
    model there.)"""
    dpes = np.asarray(dpes)
    nx, ns, _ = dpes.shape
    w, u = np.linalg.eigh(dpes)          # ascending surfaces, real U
    if smooth_gauge:
        for i in range(1, nx):
            # parallel transport: align each column with its predecessor
            s = np.sign(np.sum(u[i] * u[i - 1], axis=0))
            s[s == 0] = 1.0
            u[i] *= s[None, :]
    dx = x[1] - x[0]
    if ddpes is not None:
        dH = np.einsum("xia, xij, xjb -> xab", u, np.asarray(ddpes), u)
        dw = w[:, None, :] - w[:, :, None]               # w_b - w_a
        with np.errstate(divide="ignore", invalid="ignore"):
            nac = np.where(np.abs(dw) > 1e-14, dH / dw, 0.0)
        idx = np.arange(ns)
        nac[:, idx, idx] = 0.0
    else:
        du = np.gradient(u, dx, axis=0)
        nac = np.einsum("xia, xib -> xab", u, du)
    nac = 0.5 * (nac - np.transpose(nac, (0, 2, 1)))   # antisymmetric
    return w, u, nac
