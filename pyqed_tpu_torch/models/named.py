"""Named model systems (PyTorch): oscillators, spin chains, excitons,
displaced oscillators, Franck-Condon factors and the FMO complex.

PyTorch counterpart of ``pyqed_tpu/models/named.py`` (reference:
pyqed/phys.py — ``HarmonicOscillator:373``, ``Morse:394``, ``TFIM:1502``,
``HeisenbergModel:1629``; pyqed/models/exciton.py — ``Frenkel:15``;
pyqed/models/dho.py — ``FranckCondon:33``). The constructors run on the host:
operators are complex128 CPU tensors (as the port's operator constructors
give them), wavefunctions on a grid are float64 CPU tensors, and the
solvers they feed move them to their device. ``TFIM.ground_state`` and
``FMO.heom``/``FMO.redfield`` take ``device``.
"""
from __future__ import annotations

from math import factorial, pi, sqrt

import numpy as np
import torch
from scipy.special import gamma, genlaguerre, hermite

from ..config import resolve_device
from ..ops.linalg import dag, tensor
from ..ops.math import morse
from ..ops.operators import boson, destroy, multispin, pauli
from ..units import au2fs, au2k, au2wavenumber
from .mol import Mol


class HarmonicOscillator:
    """(reference: pyqed/phys.py:373)."""

    def __init__(self, omega, mass=1.0, x0=0.0):
        self.mass = mass
        self.omega = omega
        self.x0 = x0

    def eigenstate(self, x, n=0):
        x = np.asarray(x) - self.x0
        alpha = self.mass * self.omega
        return torch.as_tensor(
            1.0 / sqrt(2**n * factorial(n)) * (alpha / pi) ** 0.25
            * np.exp(-alpha * x**2 / 2.0) * hermite(n)(np.sqrt(alpha) * x))

    def eigval(self, n):
        return self.omega * (n + 0.5)

    def potential(self, x):
        return 0.5 * self.mass * self.omega**2 * (x - self.x0) ** 2


class Morse:
    """(reference: pyqed/phys.py:394)."""

    def __init__(self, D, a, re, mass=1.0):
        self.D = D
        self.a = a
        self.re = re
        self.mass = mass
        self.omega = a * sqrt(2.0 * D / mass)

    def eigval(self, n):
        return ((n + 0.5) * self.omega
                - (self.omega * (n + 0.5)) ** 2 / (4.0 * self.D))

    def nbound(self):
        """Number of bound states."""
        lam = sqrt(2.0 * self.mass * self.D) / self.a
        return int(lam - 0.5) + 1

    def eigenstate(self, x, n=0):
        lam = sqrt(2.0 * self.mass * self.D) / self.a
        alpha = 2 * lam - 2 * n - 1
        z = 2 * lam * np.exp(-self.a * (np.asarray(x) - self.re))
        C = sqrt(self.a * factorial(n) * alpha / gamma(2 * lam - n))
        return torch.as_tensor(C * z ** (alpha / 2.0) * np.exp(-0.5 * z)
                               * genlaguerre(n, alpha)(z))

    def potential(self, x):
        return morse(x, self.D, self.a, self.re)


class Frenkel(Mol):
    """Frenkel exciton chain of two-level sites (reference:
    pyqed/models/exciton.py:15)."""

    def __init__(self, onsite, hopping, nsites):
        H, lowering = multispin(onsite, hopping, nsites)
        edip = 0.0
        for l in lowering:
            edip = edip + l + dag(l)
        super().__init__(H, edip=edip)
        self.lowering_ops = lowering
        self.nsites = nsites


def _embed(op, i, nsites):
    s0 = pauli()[0]
    ops = [s0] * nsites
    ops[i] = op
    return tensor(ops)


class TFIM:
    """Transverse-field Ising model (reference: pyqed/phys.py:1502)."""

    def __init__(self, nsites, J=1.0, h=1.0):
        self.nsites = nsites
        self.J = J
        self.h = h
        self.dim = 2**nsites

    def buildH(self):
        _, sx, _, sz = pauli()
        L = self.nsites
        H = 0.0
        for i in range(L - 1):
            H = H - self.J * _embed(sz, i, L) @ _embed(sz, i + 1, L)
        for i in range(L):
            H = H - self.h * _embed(sx, i, L)
        self.H = H
        return H

    def ground_state(self, device=None):
        """(E0, psi0) by a dense ``eigh`` on ``device`` (the card when
        None, raises without one)."""
        if not hasattr(self, "H"):
            self.buildH()
        w, v = torch.linalg.eigh(self.H.to(resolve_device(device)))
        return w[0], v[:, 0]


class HeisenbergModel:
    """Heisenberg spin chain (reference: pyqed/phys.py:1629)."""

    def __init__(self, nsites, Jx=1.0, Jy=1.0, Jz=1.0, h=0.0):
        self.nsites = nsites
        self.Jx, self.Jy, self.Jz = Jx, Jy, Jz
        self.h = h
        self.dim = 2**nsites

    def buildH(self):
        _, sx, sy, sz = pauli()
        L = self.nsites
        H = 0.0
        for i in range(L - 1):
            H = H + (self.Jx * _embed(sx, i, L) @ _embed(sx, i + 1, L)
                     + self.Jy * _embed(sy, i, L) @ _embed(sy, i + 1, L)
                     + self.Jz * _embed(sz, i, L) @ _embed(sz, i + 1, L))
        for i in range(L):
            H = H + self.h * _embed(sz, i, L)
        self.H = H
        return H


def franck_condon(n1, omega1, n2, omega2, d, mass=1.0, nx=4000, xmax=None):
    """Numeric Franck-Condon factor <chi_{n1}(omega1)|chi_{n2}(omega2, d)>
    between displaced (possibly different-frequency) harmonic oscillators
    (reference: pyqed/models/dho.py:33), a float."""
    if xmax is None:
        xmax = 10.0 / np.sqrt(mass * min(omega1, omega2)) + abs(d)
    x = np.linspace(-xmax, xmax + abs(d), nx)
    psi1 = HarmonicOscillator(omega1, mass=mass, x0=0.0).eigenstate(x, n1)
    psi2 = HarmonicOscillator(omega2, mass=mass, x0=d).eigenstate(x, n2)
    return float(np.trapezoid((psi1 * psi2).numpy(), x))


FranckCondon = franck_condon


def franck_condon_analytic(n, S):
    """|<0|n>|^2 for equal-frequency displaced HOs with Huang-Rhys factor S:
    Poisson distribution e^{-S} S^n / n!."""
    return np.exp(-S) * S**n / factorial(n)


class DHO(Mol):
    """Displaced harmonic oscillator two-surface model
    (reference: pyqed/models/dho.py): ground |g, n> and excited |e, n>
    manifolds with linear displacement d, electronic gap E."""

    def __init__(self, E, omega, d, ntrunc=8):
        self.omega = omega
        self.d = d
        self.ntrunc = ntrunc
        a = destroy(ntrunc)
        x = (a + dag(a)) / sqrt(2.0)
        eye = torch.eye(ntrunc, dtype=a.dtype)
        hg = boson(omega, ntrunc)
        # excited surface displaced by d: omega (x - d)^2/2 shifted
        he = (boson(omega, ntrunc) - omega * d * x
              + 0.5 * omega * d**2 * eye) + E * eye
        zeros = torch.zeros_like(eye)
        H = torch.cat([torch.cat([hg, zeros], 1), torch.cat([zeros, he], 1)])
        # Condon dipole: electronic flip x vibrational identity
        edip = torch.cat([torch.cat([zeros, eye], 1),
                          torch.cat([eye, zeros], 1)])
        super().__init__(H, edip=edip)
        self.huang_rhys = d**2 / 2.0


def _onsite_hopping(onsites, hopping):
    inter, intra = (hopping if isinstance(hopping, (list, tuple))
                    else (hopping, hopping))
    e1, e2 = (onsites if isinstance(onsites, (list, tuple))
              else (onsites, onsites))
    return e1, e2, inter, intra


class Frenkel2(Mol):
    """Frenkel chain with TWO excited states per site (3-level sites
    |0>, |1>, |2>; reference: pyqed/models/exciton.py:33 ``Frenkel2``).

    onsites: scalar or [e1, e2]; hopping: scalar or [inter, intra] where
    ``inter`` couples |1>_i <-> |2>_i on-site and ``intra`` couples
    |1>_i <-> |2>_{i+1} between neighbors (reference conventions).
    """

    def __init__(self, onsites, hopping, nsites):
        onsite1, onsite2, inter, intra = _onsite_hopping(onsites, hopping)
        sp1 = np.zeros((3, 3))
        sp1[0, 1] = 1.0            # lowering |1> -> |0> (reference naming)
        sp2 = np.zeros((3, 3))
        sp2[0, 2] = 1.0

        def site_op(op, i):
            mats = [np.eye(3)] * nsites
            mats[i] = op
            out = mats[0]
            for m in mats[1:]:
                out = np.kron(out, m)
            return torch.as_tensor(out)

        low1 = [site_op(sp1, i) for i in range(nsites)]
        low2 = [site_op(sp2, i) for i in range(nsites)]
        H = 0.0
        for i in range(nsites):
            H = H + onsite1 * dag(low1[i]) @ low1[i] \
                + onsite2 * dag(low2[i]) @ low2[i]
            H = H + inter * (dag(low1[i]) @ low2[i]
                             + dag(low2[i]) @ low1[i])
        for i in range(nsites - 1):
            H = H + intra * (dag(low1[i]) @ low2[i + 1]
                             + dag(low2[i + 1]) @ low1[i])
        edip = 0.0
        for l in low1 + low2:
            edip = edip + l + dag(l)
        super().__init__(H, edip=edip)
        self.dim = 3 ** nsites
        # per-site operator LIST under lowering_ops; Mol.lowering stays the
        # dipole-derived matrix
        self.lowering_ops = low1 + low2
        self.nsites = nsites


class Frenkel2s(Mol):
    """Frenkel2 restricted to the single-excitation sector (reference:
    pyqed/models/exciton.py:100 ``Frenkel2_s``): dim = 2*nsites + 1.
    Basis |g>, |e1_i> (i=1..n), |e2_i> (i=1..n); ``inter`` couples
    |1>_i <-> |2>_i on-site, ``intra`` |1>_i <-> |2>_{i+1}, the topology of
    :class:`Frenkel2`, so the single-excitation blocks agree exactly.
    """

    def __init__(self, onsites, hopping, nsites):
        onsite1, onsite2, inter, intra = _onsite_hopping(onsites, hopping)
        dim = 2 * nsites + 1
        H = np.zeros((dim, dim))
        for i in range(nsites):
            H[1 + i, 1 + i] = onsite1
            H[1 + nsites + i, 1 + nsites + i] = onsite2
            H[1 + i, 1 + nsites + i] = inter           # |1>_i <-> |2>_i
            H[1 + nsites + i, 1 + i] = inter
        for i in range(nsites - 1):
            H[1 + i, 1 + nsites + i + 1] = intra       # |1>_i <-> |2>_{i+1}
            H[1 + nsites + i + 1, 1 + i] = intra
        low = []
        for i in range(2 * nsites):
            l = np.zeros((dim, dim))
            l[0, 1 + i] = 1.0
            low.append(torch.as_tensor(l))
        edip = 0.0
        for l in low:
            edip = edip + l + dag(l)
        super().__init__(torch.as_tensor(H), edip=edip)
        self.dim = dim
        self.lowering_ops = low
        self.nsites = nsites


Frenkel2_s = Frenkel2s      # reference drop-in name


class FMO:
    """Fenna-Matthews-Olson 7-site exciton model.

    Single-excitation Hamiltonian of one FMO monomer from Adolphs &
    Renger, Biophys. J. 91, 2778 (2006), as used by Ishizaki & Fleming,
    PNAS 106, 17255 (2009); site energies and couplings in cm^-1, stored
    in atomic units with the mean site energy removed (a global phase).

    Each site couples to an independent Drude-Lorentz bath through its
    projector |j><j| (reorganization ``reorg_cm`` = 35 cm^-1, bath
    correlation time ``tau_c_fs`` = 50 fs). Operators are complex128 CPU
    tensors; :meth:`heom` places the hierarchy on ``device``.
    """

    # cm^-1, Adolphs-Renger table 4 (trimer) / Ishizaki-Fleming Fig. 2
    H_CM = np.array([
        [12410.0,  -87.7,    5.5,   -5.9,    6.7,  -13.7,   -9.9],
        [-87.7,   12530.0,  30.8,    8.2,    0.7,   11.8,    4.3],
        [5.5,      30.8,  12210.0, -53.5,   -2.2,   -9.6,    6.0],
        [-5.9,      8.2,   -53.5, 12320.0, -70.7,  -17.0,  -63.3],
        [6.7,       0.7,    -2.2,  -70.7, 12480.0,  81.1,   -1.3],
        [-13.7,    11.8,    -9.6,  -17.0,   81.1, 12630.0,  39.7],
        [-9.9,      4.3,     6.0,  -63.3,   -1.3,   39.7, 12440.0],
    ])

    def __init__(self, reorg_cm=35.0, tau_c_fs=50.0):
        self.nsites = 7
        Hcm = self.H_CM.copy()
        np.fill_diagonal(Hcm, np.diag(Hcm) - np.mean(np.diag(Hcm)))
        self.H = torch.as_tensor((Hcm / au2wavenumber).astype(complex))
        self.reorg = reorg_cm / au2wavenumber
        self.cutoff = 1.0 / (tau_c_fs / au2fs)      # gamma = 1/tau_c [au]

    def site_projectors(self):
        return [torch.as_tensor(np.diag(np.eye(self.nsites)[j]).astype(complex))
                for j in range(self.nsites)]

    def _bath(self, temperature):
        from ..open.bath import DrudeBath
        b = DrudeBath(temperature=temperature / au2k, cutoff=self.cutoff,
                      reorg=self.reorg)
        b.set_bath_ops(self.site_projectors())
        return b

    def heom(self, temperature=300.0, lmax=3, nexp=1,
             decomposition="matsubara", device=None, **kw):
        """HEOMSolver with an independent Drude bath per site
        (temperature in Kelvin; nexp Matsubara/Pade terms per site on top
        of the Drude pole), its hierarchy on ``device``: the card when
        None (raises without one), ``"cpu"`` on request."""
        from ..open.heom import HEOMSolver
        return HEOMSolver(self.H, bath=self._bath(temperature), lmax=lmax,
                          decomposition=decomposition, nexp=nexp,
                          device=device, **kw)

    def redfield(self, temperature=300.0, nexp=30, device=None):
        """RedfieldSolver with the SAME exponential bath modes as
        :meth:`heom` (spectra built from the converged Matsubara series,
        so a weak-coupling comparison isolates the method, not the
        decomposition), on ``device``: the card when None (raises
        without one), ``"cpu"`` on request."""
        from ..open.redfield import RedfieldSolver
        Gamma = self._bath(temperature).redfield_spectrum(nexp=nexp)
        return RedfieldSolver(self.H, c_ops=self.site_projectors(),
                              spectra=[Gamma] * self.nsites, device=device)

    def initial_state(self, site=0):
        rho0 = np.zeros((self.nsites, self.nsites), dtype=complex)
        rho0[site, site] = 1.0
        return torch.as_tensor(rho0)
