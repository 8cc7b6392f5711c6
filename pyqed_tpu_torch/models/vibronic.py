"""Named vibronic and conical-intersection models (PyTorch).

PyTorch counterpart of ``pyqed_tpu/models/vibronic.py`` (reference:
pyqed/models/pyrazine.py — ``Pyrazine:212`` with the Schneider-Domcke
parameters (``buildV:255``); pyqed/models/ShinMetiu.py — ``ShinMetiu:76``;
the Jahn-Teller E(x)e model of pyqed/models/vibronic.py; triazine.py).

Diabatic matrices at a point are ``torch.stack``-built from tensors, so
they broadcast over coordinate arrays and work under ``torch.func``
(FSSH and Ehrenfest take them as their ``v``). Surfaces on a grid are
built on the host and kept on the model's device; every adiabatic
surface stack is one batched ``eigh`` (chunked on CUDA).
``Pyrazine.spo()`` and ``SpinVibronic.spo()`` return the port's
``SPO2``/``SPON``, whose steps run the split-operator kernels of
``csrc/spo.cu``.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import erf

from ..config import resolve_device
from ..grid.dvr import SineDVR
from ..grid.spo import _eigh
from ..ops.linalg import as_tensor
from ..units import au2angstrom, wavenum2au


def _entries(rows, device):
    """A nested list of scalars and tensors as one tensor (n, n, *shape):
    every entry is broadcast to the common shape (numbers and arrays are
    made float64 or complex128 tensors on ``device`` first)."""
    flat = [e for row in rows for e in row]
    ref = next((e for e in flat if isinstance(e, torch.Tensor)), None)
    dev = ref.device if ref is not None else device

    def tens(e):
        if isinstance(e, torch.Tensor):
            return e
        a = np.asarray(e)
        return torch.as_tensor(a.astype(complex if np.iscomplexobj(a)
                                        else float), device=dev)

    ts = torch.broadcast_tensors(*[tens(e) for e in flat])
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    n = len(rows)
    return torch.stack([torch.stack([t.to(dt) for t in ts[i * n:(i + 1) * n]])
                        for i in range(n)])


def grid_eigh(v, eigvals_only=False):
    """``eigh`` of a grid of (ns, ns) blocks, grid_shape + (ns, ns), as one
    batched call (chunked on CUDA, :func:`~pyqed_tpu_torch.grid.spo._eigh`).
    Returns (w, u) in the grid's shape, or w alone."""
    ns = v.shape[-1]
    w, u = _eigh(v.reshape(-1, ns, ns))
    w = w.reshape(v.shape[:-1])
    return w if eigvals_only else (w, u.reshape(v.shape))


class Pyrazine:
    """S0/S1/S2 pyrazine conical intersection, 2 modes (coupling 10a,
    tuning 6a) (reference: pyqed/models/pyrazine.py:212).

    Coordinates: x = coupling mode, y = tuning mode (dimensionless).
    ``device``: the card when None (raises without one).
    """

    freq_vc = 952.0 * wavenum2au
    freq_vt = 597.0 * wavenum2au
    Eshift = np.array([31800.0, 39000.0]) * wavenum2au
    kappa = np.array([-847.0, 1202.0]) * wavenum2au
    lam = 2110.0 * wavenum2au

    def __init__(self, x=None, y=None, device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x) if x is not None else None
        self.y = np.asarray(y) if y is not None else None
        if x is not None:
            self.nx, self.ny = len(x), len(y)
        self.nstates = 3
        self.edip = np.zeros((3, 3))
        self.edip[0, 2] = self.edip[2, 0] = 1.0
        self.mass = [1.0 / self.freq_vc, 1.0 / self.freq_vt]
        self.v = None

    def dpes(self, x, y):
        """Diabatic potential matrix at a point, (3, 3) (or (3, 3, *shape)
        for coordinate arrays) (reference: pyqed/models/pyrazine.py:295)."""
        vg = self.freq_vc * x ** 2 / 2 + self.freq_vt * y ** 2 / 2
        v0 = vg + self.kappa[0] * y + self.Eshift[0]
        v1 = vg + self.kappa[1] * y + self.Eshift[1]
        c = self.lam * x
        return _entries([[vg, 0.0, 0.0], [0.0, v0, c], [0.0, c, v1]],
                        self.device)

    def buildV(self):
        """(nx, ny, 3, 3) on the device (reference:
        pyqed/models/pyrazine.py:255)."""
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        vg = self.freq_vc * X ** 2 / 2 + self.freq_vt * Y ** 2 / 2
        v = np.zeros((self.nx, self.ny, 3, 3))
        v[..., 0, 0] = vg
        v[..., 1, 1] = vg + self.kappa[0] * Y + self.Eshift[0]
        v[..., 2, 2] = vg + self.kappa[1] * Y + self.Eshift[1]
        v[..., 1, 2] = v[..., 2, 1] = self.lam * X
        self.v = torch.as_tensor(v, device=self.device)
        return self.v

    def apes(self):
        """Batched adiabatic surfaces (nx, ny, 3)."""
        if self.v is None:
            self.buildV()
        return grid_eigh(self.v, eigvals_only=True)

    def spo(self):
        """SPO2 solver on the model's device, preloaded with this model."""
        from ..grid.spo import SPO2
        solver = SPO2(self.x, self.y, masses=self.mass, nstates=3,
                      device=self.device)
        solver.set_dpes(self.buildV())
        return solver


class JahnTeller:
    """Linear E (x) e Jahn-Teller model: two degenerate electronic states
    coupled to two degenerate modes (reference: pyqed/models/vibronic.py).

    V = omega(x^2+y^2)/2 I + k [[x, y], [y, -x]] (+ Delta sz)
    """

    def __init__(self, omega=1.0, kappa=0.5, delta=0.0, device=None):
        self.device = resolve_device(device)
        self.omega = omega
        self.kappa = kappa
        self.delta = delta
        self.nstates = 2

    def dpes(self, x, y):
        w, k = self.omega, self.kappa
        vg = w * (x ** 2 + y ** 2) / 2
        return _entries([[vg + k * x + self.delta, k * y],
                         [k * y, vg - k * x - self.delta]], self.device)

    def buildV(self, x, y):
        X, Y = np.meshgrid(x, y, indexing="ij")
        vg = self.omega * (X ** 2 + Y ** 2) / 2
        v = np.zeros((len(x), len(y), 2, 2))
        v[..., 0, 0] = vg + self.kappa * X + self.delta
        v[..., 1, 1] = vg - self.kappa * X - self.delta
        v[..., 0, 1] = v[..., 1, 0] = self.kappa * Y
        return torch.as_tensor(v, device=self.device)

    def apes(self, x, y):
        """Mexican-hat adiabatic surfaces (analytic):
        V± = w r^2/2 ± sqrt(k^2 r^2 + delta^2) for delta-shifted JT."""
        X, Y = np.meshgrid(x, y, indexing="ij")
        vg = self.omega * (X ** 2 + Y ** 2) / 2
        gap = np.sqrt((self.kappa * X + self.delta) ** 2
                      + (self.kappa * Y) ** 2)
        return torch.as_tensor(np.stack([vg - gap, vg + gap], axis=-1),
                               device=self.device)

    def geometric_phase(self, n=0, r=1.0, center=(0.0, 0.0), npts=400):
        """Discrete Berry phase of adiabatic state ``n`` around a circle of
        radius ``r`` about ``center`` (a host NumPy computation): pi when
        the loop encloses the conical intersection at (-delta/kappa, 0),
        0 otherwise (reference: pyqed/models/jahn_teller.py:410)."""
        thetas = np.linspace(0, 2 * np.pi, npts, endpoint=False)
        x = center[0] + r * np.cos(thetas)
        y = center[1] + r * np.sin(thetas)
        w_, k_ = self.omega, self.kappa
        vg = w_ * (x ** 2 + y ** 2) / 2
        v = np.zeros((npts, 2, 2))
        v[:, 0, 0] = vg + k_ * x + self.delta
        v[:, 1, 1] = vg - k_ * x - self.delta
        v[:, 0, 1] = v[:, 1, 0] = k_ * y
        _, u = np.linalg.eigh(v)
        un = u[:, :, n]
        ov = np.einsum("ki, ki -> k", un, np.roll(un, -1, axis=0))
        return abs(np.angle(np.prod(ov + 0j)))


class ShinMetiu:
    """1D Shin-Metiu proton-coupled electron transfer
    (reference: pyqed/models/ShinMetiu.py:76).

    One electron (coordinate r) and one proton (R) between fixed ions at
    +-L/2; soft-Coulomb interactions with cutoff Rc. The electronic
    Hamiltonians are built on the host; their BO surfaces are one batched
    eigh on ``device`` (the card when None).
    """

    def __init__(self, Rc=None, L=None, mass=1836.0, nstates=3, device=None):
        self.device = resolve_device(device)
        self.Rc = Rc if Rc is not None else 1.5 / au2angstrom
        self.L = L if L is not None else 10.0 / au2angstrom
        self.mass = mass
        self.nstates = nstates
        self.x = None

    def create_grid(self, nx=128, frac=0.45):
        lim = self.L * frac
        dvr = SineDVR(-lim, lim, nx, device="cpu")
        self.x = np.asarray(dvr.x)
        self.Te = dvr.t().numpy()
        return self.x

    def V_en(self, r, R):
        """Soft Coulomb -erf(|r-R|/Rc)/|r-R| (reference:
        pyqed/models/ShinMetiu.py:189)."""
        d = np.abs(r - R)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = -erf(d / self.Rc) / d
        return np.where(d < 1e-12, -2.0 / (self.Rc * np.sqrt(np.pi)), v)

    def _h_host(self, R):
        x = self.x
        V = (self.V_en(x, -self.L / 2) + self.V_en(x, self.L / 2)
             + self.V_en(x, R))
        return self.Te + np.diag(V)

    def electron_hamiltonian(self, R):
        """H_e(R) on the electron grid, on the device."""
        return torch.as_tensor(self._h_host(R), device=self.device)

    def energy_nuc(self, R):
        return 1.0 / abs(R + self.L / 2) + 1.0 / abs(self.L / 2 - R)

    def pes(self, Rgrid):
        """BO surfaces E_n(R) and electronic states: one batched eigh over
        the nuclear grid (reference: pyqed/models/ShinMetiu.py:125-170).
        Returns (E (nR, nstates), u (nR, nx, nstates)) on the device."""
        if self.x is None:
            self.create_grid()
        Rs = np.asarray(Rgrid)
        Hs = torch.as_tensor(np.stack([self._h_host(R) for R in Rs]),
                             device=self.device)
        w, u = torch.linalg.eigh(Hs)
        enuc = torch.as_tensor([self.energy_nuc(R) for R in Rs],
                               device=self.device)
        return w[:, :self.nstates] + enuc[:, None], u[:, :, :self.nstates]

    def overlap_matrix(self, states):
        """Electronic overlap A[m a, n b] = <phi_a(R_m)|phi_b(R_n)> of the
        discrete-normalized states of :meth:`pes`."""
        states = as_tensor(states, device=self.device)
        return torch.einsum("mia, nib -> manb", states.conj(), states)


class ShinMetiuInField(ShinMetiu):
    """1D Shin-Metiu model in a static electric field, length gauge
    (reference: pyqed/models/ShinMetiu.py:871, its 2D analogue): +E x for
    the electron and -E R for the proton."""

    def __init__(self, E=0.0, **kwargs):
        super().__init__(**kwargs)
        self.E = float(E)

    def _h_host(self, R):
        return super()._h_host(R) + np.diag(self.E * self.x)

    def energy_nuc(self, R):
        return super().energy_nuc(R) - self.E * R


class Pyrazine4:
    """Four-mode pyrazine S0/S1/S2 vibronic-coupling model (reference:
    pyqed/models/pyrazine_4Dimension_SparseGrid.py:1350 ``dpes`` — modes
    nu_1, nu_6a, nu_9a (tuning) and nu_10a (coupling), first- plus
    second-order couplings): the grid ``dpes(x, y, z, q)`` and the LVC
    export (H_el, omegas, couplings), and ``spectral_dynamics`` on the
    tensor-network vibronic module (``tn/vibronic``)."""

    def __init__(self, second_order=True, device=None):
        from ..units import au2ev, wavenumber
        self.device = resolve_device(device)
        self.omegas = np.array([1015.0, 596.0, 1230.0, 919.0]) * wavenumber
        self.Eshift = np.array([0.0, 3.94, 4.89]) / au2ev
        self.kappa1 = np.array([-0.0470, -0.0964, 0.1594]) / au2ev
        self.kappa2 = np.array([-0.2012, 0.1193, 0.0484]) / au2ev
        self.lam = 0.1825 / au2ev
        self.gamma = (-0.018 / au2ev) if second_order else 0.0
        self.nstates = 3
        self.ndim = 4

    def dpes(self, x, y, z, q):
        """(3, 3) diabatic matrix at dimensionless coordinates."""
        w = self.omegas
        vg = 0.5 * (w[0] * x ** 2 + w[1] * y ** 2 + w[2] * z ** 2
                    + w[3] * q ** 2)
        k1, k2 = self.kappa1, self.kappa2
        v1 = (vg + k1[0] * x + k1[1] * y + k1[2] * z
              + self.Eshift[1] + self.gamma * q ** 2)
        v2 = (vg + k2[0] * x + k2[1] * y + k2[2] * z
              + self.Eshift[2] + self.gamma * q ** 2)
        c = self.lam * q
        return _entries([[vg, 0.0, 0.0], [0.0, v1, c], [0.0, c, v2]],
                        self.device)

    def lvc(self):
        """(H_el, omegas, couplings) as NumPy arrays: linear kappa/lambda
        terms exactly; the quadratic gamma q^2 term is dropped."""
        H_el = np.diag(self.Eshift)
        Vs = [np.diag([0.0, self.kappa1[m], self.kappa2[m]])
              for m in range(3)]          # tuning modes 1, 6a, 9a
        V10a = np.zeros((3, 3))
        V10a[1, 2] = V10a[2, 1] = self.lam
        Vs.append(V10a)
        return H_el, self.omegas, Vs

    def spectral_dynamics(self, nb=8, chi_max=32, dt=None, nt=60, nout=10,
                          device=None):
        """S2 photoexcitation population dynamics by two-site TDVP on the
        MPS chain (the standard 4-mode pyrazine benchmark; dt 0.25 fs by
        default), on ``device`` (the model's own when None). Returns
        (times, populations) tensors."""
        from ..tn.vibronic import VibronicMPS
        from ..units import au2fs
        H_el, omegas, Vs = self.lvc()
        vm = VibronicMPS(H_el, omegas, Vs, nb=nb, chi_max=chi_max,
                         device=self.device if device is None else device)
        if dt is None:
            dt = 0.25 / au2fs
        return vm.run(el_state=2, dt=dt, nt=nt, nout=nout)


class SpinVibronic:
    """Spin-orbit vibronic coupling in a 2Pi state of a linear molecule
    (Poluyanov & Domcke, Chem. Phys. 301, 111 (2004)): four spin-orbital
    states |Lambda, Sigma> ordered (+1,+1/2), (-1,+1/2), (+1,-1/2),
    (-1,-1/2) and a doubly degenerate bending mode (x, y),

    H(x, y) = omega/2 (x^2 + y^2) I + (e_so/2) diag(+1, -1, -1, +1)
              + kappa rho e^{+i phi} + (g/2) rho^2 e^{+2i phi} (+ h.c.),

    rho e^{i phi} = x + i y, complex Hermitian, with cylindrical adiabatic
    surfaces (reference: pyqed/models/vibronic.py:314, a sketch there).
    """

    def __init__(self, omega=1.0, e_so=0.2, kappa=0.1, g=0.2,
                 nstates=4, mass=None, device=None):
        if nstates != 4:
            raise ValueError("SpinVibronic has 4 states")
        self.device = resolve_device(device)
        self.omega = omega
        self.e_so = e_so
        self.kappa = kappa
        self.g = g
        self.nstates = 4
        self.mass = [1.0, 1.0] if mass is None else mass

    def single_point(self, x, y):
        """Complex Hermitian H(x, y), (4, 4) complex128 on the device."""
        xp = complex(x) + 1j * complex(y)
        e, k, g = self.e_so, self.kappa, self.g
        h = np.diag(np.array([e / 2, -e / 2, -e / 2, e / 2], dtype=complex))
        h[0, 1] = h[2, 3] = k * xp
        h[0, 2] = g / 2 * xp ** 2
        h[1, 3] = -g / 2 * xp ** 2
        h = h + np.conj(h.T) - np.diag(np.diag(h))
        h = h + np.eye(4) * self.omega / 2 * (x ** 2 + y ** 2)
        return torch.as_tensor(h, device=self.device)

    def buildV(self, x, y):
        """Diabatic PES on the grid: (nx, ny, 4, 4) complex Hermitian."""
        X, Y = np.meshgrid(x, y, indexing="ij")
        XP = X + 1j * Y
        v = np.zeros((len(x), len(y), 4, 4), dtype=complex)
        e, k, g = self.e_so, self.kappa, self.g
        v[..., 0, 0] = v[..., 3, 3] = e / 2
        v[..., 1, 1] = v[..., 2, 2] = -e / 2
        v[..., 0, 1] = v[..., 2, 3] = k * XP
        v[..., 1, 0] = v[..., 3, 2] = np.conj(k * XP)
        v[..., 0, 2] = g / 2 * XP ** 2
        v[..., 2, 0] = np.conj(g / 2 * XP ** 2)
        v[..., 1, 3] = -g / 2 * XP ** 2
        v[..., 3, 1] = np.conj(-g / 2 * XP ** 2)
        v += np.eye(4) * (self.omega / 2 * (X ** 2 + Y ** 2))[..., None, None]
        return torch.as_tensor(v, device=self.device)

    def apes(self, x, y):
        """Adiabatic (spin-vibronic) surfaces: (nx, ny, 4), cylindrical."""
        return grid_eigh(self.buildV(x, y), eigvals_only=True)

    def spo(self, x, y):
        """4-state SPON on the bending plane, on the model's device,
        preloaded with the model (complex expV blocks)."""
        from ..grid.spo import SPON
        solver = SPON((x, y), masses=self.mass, nstates=4,
                      device=self.device)
        solver.set_dpes(self.buildV(x, y))
        return solver


class Triazine:
    """Complex E⊗e Jahn-Teller model of triazine: two degenerate excited
    states with complex linear coupling 2.2ω(X ∓ iY)
    (reference: pyqed/models/triazine.py:17; wilson_loop:76,
    berry_phase:97)."""

    def __init__(self, x=None, y=None, mass=(1.0, 1.0), nstates=3,
                 device=None):
        from ..units import wavenumber
        self.device = resolve_device(device)
        self.omega = 660.0 * wavenumber
        self.x, self.y = x, y
        self.mass = list(mass)
        self.nstates = nstates
        self.coupling = 2.2
        self.eshift = 7.0 / 27.2114
        self.v = None

    def _dpes_host(self, xy):
        x, y = float(xy[0]), float(xy[1])
        w = self.omega
        h = np.zeros((3, 3), dtype=complex)
        vg = w * (x ** 2 + y ** 2) / 2.0
        h[0, 0] = vg
        h[1, 1] = h[2, 2] = vg + self.eshift
        h[1, 2] = self.coupling * w * (x - 1j * y)
        h[2, 1] = self.coupling * w * (x + 1j * y)
        return h

    def dpes(self, xy):
        """(3, 3) complex diabatic matrix at a point, on the device."""
        return torch.as_tensor(self._dpes_host(xy), device=self.device)

    def dpes_global(self):
        """(reference: triazine.py:39)."""
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        w = self.omega
        v = np.zeros((len(self.x), len(self.y), 3, 3), dtype=complex)
        vg = w * (X ** 2 + Y ** 2) / 2.0
        v[..., 0, 0] = vg
        v[..., 1, 1] = vg + self.eshift
        v[..., 2, 2] = vg + self.eshift
        v[..., 1, 2] = self.coupling * w * (X - 1j * Y)
        v[..., 2, 1] = self.coupling * w * (X + 1j * Y)
        self.v = torch.as_tensor(v, device=self.device)
        return self.v

    def apes(self, xy):
        return torch.linalg.eigh(self.dpes(xy))

    def _loop_states(self, n, r, npts):
        """State ``n`` at ``npts`` points of a circle of radius r: one
        batched host eigh."""
        thetas = np.linspace(0, 2 * np.pi, npts, endpoint=False)
        h = np.stack([self._dpes_host((r * np.cos(t), r * np.sin(t)))
                      for t in thetas])
        return np.linalg.eigh(h)[1][:, :, n]

    def berry_phase(self, n=1, r=1.0, npts=200):
        """Discrete Berry phase of adiabatic state n around a loop of
        radius r (reference: triazine.py:97), a host computation."""
        us = self._loop_states(n, r, npts)
        z = 1.0 + 0j
        for k in range(npts):
            z *= np.vdot(us[k], us[(k + 1) % npts])
        return -np.angle(z)

    def wilson_loop(self, n=1, r=1.0, npts=200):
        """Tr of the ordered product of projectors along the loop
        (reference: triazine.py:76), a host computation."""
        L = np.eye(3, dtype=complex)
        for un in self._loop_states(n, r, npts):
            L = L @ np.outer(un, un.conj())
        return np.trace(L)


class VibronicAdiabatic:
    """1D vibronic model in the adiabatic representation: surfaces v_a(x)
    and derivative couplings D_ab(x) on a grid, with dipoles (reference:
    pyqed/models/vibronic.py:598, a holder there); ``run`` propagates with
    :class:`~pyqed_tpu_torch.grid.namd.NAMD` on ``device`` (the card when
    None)."""

    def __init__(self, x=None, v=None, nac=None, mass=1.0, nstates=2,
                 edip=None, mdip=None, equad=None, device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x) if x is not None else None
        self.nx = self.x.size if x is not None else None
        self.mass = mass
        self.nel = self.nstates = nstates
        self._v = np.asarray(v) if v is not None else None
        self.nac = np.asarray(nac) if nac is not None else None
        self.edip = edip
        self.mdip = mdip
        self.equad = equad

    @property
    def v(self):
        return self._v

    @v.setter
    def v(self, value):
        self._v = np.asarray(value)

    def set_nac(self, nac):
        self.nac = np.asarray(nac)

    @classmethod
    def from_diabatic(cls, x, dpes, mass=1.0, ddpes=None, **kwargs):
        """Build from a diabatic PES matrix field (diagonalized with a
        smooth gauge; NACs by Hellmann-Feynman when ``ddpes`` is given)."""
        from ..grid.namd import diabatic_to_adiabatic_1d
        v, u, nac = diabatic_to_adiabatic_1d(x, dpes, ddpes=ddpes)
        obj = cls(x=x, v=v, nac=nac, mass=mass, nstates=v.shape[1], **kwargs)
        obj.U = u
        return obj

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's model with the arrays of a JAX ``VibronicAdiabatic``
        ``ref`` (grid, surfaces, couplings, mass, dipoles)."""
        def host(a):
            return None if a is None else np.asarray(a)
        obj = cls(x=host(ref.x), v=host(ref.v), nac=host(ref.nac),
                  mass=ref.mass, nstates=ref.nstates, edip=host(ref.edip),
                  mdip=host(ref.mdip), equad=host(ref.equad), device=device)
        if hasattr(ref, "U"):
            obj.U = np.asarray(ref.U)
        return obj

    def run(self, psi0, dt, nt, nout=1, e_ops=None, order=2):
        from ..grid.namd import NAMD
        solver = NAMD(self.x, self._v, self.nac, mass=self.mass, order=order,
                      device=self.device)
        return solver.run(psi0, dt, nt, nout=nout, e_ops=e_ops)
