"""Grid-based vibronic polaritons and vibrational strong coupling
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/models/polariton_grid.py`` (reference:
pyqed/polariton/cavity.py — ``VibronicPolariton:936`` (``dpes:969``,
``ppes:1035``, ``run:1090``), ``VibronicPolariton2:1111``;
pyqed/polariton/vsc.py — ``VSC:28`` with the ``hpsi`` matvec :390;
pyqed/polariton/tdh.py — time-dependent Hartree ``:16``).

The polaritonic potential stacks are built on the model's device (the
card when None); ``run`` hands them to the port's ``SPON``/``SPO2``,
whose steps run the split-operator kernels of ``csrc/spo.cu`` (with
nel·ncav or ncav states, often more than 4: the kernels' generic
branch). Adiabatic surfaces are one batched ``eigh`` (chunked on CUDA).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..grid.spo import SPON, _eigh
from ..ops.linalg import as_tensor
from .cavity import Cavity


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _quadrature(cav, device):
    """a + a^dagger of the cavity, real float64 on ``device``."""
    a = cav.annihilate()
    return (a + a.mH).real.to(device)


class GridMol:
    """A vibronic model on a nuclear grid: diabatic V(x) (nx, ns, ns) and a
    (possibly coordinate-dependent) dipole, kept as given (array-likes
    as CPU tensors)."""

    def __init__(self, x, v, edip, mass=1.0):
        self.x = np.asarray(x)
        self.nx = len(self.x)
        self.v = as_tensor(v)
        self.nstates = self.v.shape[-1]
        self.edip = as_tensor(edip)
        self.mass = mass

    @classmethod
    def from_reference(cls, ref):
        """The port's GridMol with the arrays of a JAX ``GridMol``."""
        return cls(np.asarray(ref.x), np.asarray(ref.v), np.asarray(ref.edip),
                   mass=ref.mass)


class VibronicPolariton:
    """1D vibronic model coupled to a single cavity mode, on ``device``
    (the card when None) (reference: pyqed/polariton/cavity.py:936)."""

    def __init__(self, mol: GridMol, cav: Cavity, device=None):
        self.device = resolve_device(device)
        self.mol = mol
        self.cav = cav
        self.x = mol.x
        self.nx = mol.nx
        self.nstates = mol.nstates * cav.ncav
        self.v = None
        self.va = None
        self._u = None

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's model from a JAX ``VibronicPolariton`` ``ref``: its
        molecule, cavity and, where built, its polaritonic stack."""
        out = cls(GridMol.from_reference(ref.mol),
                  Cavity.from_reference(ref.cav), device=device)
        if ref.v is not None:
            out.v = torch.as_tensor(np.asarray(ref.v), device=out.device)
        return out

    def dpes(self, g, rwa=False, gauge="dipole"):
        """Polaritonic diabatic PES stack (nx, N, N), N = nel * ncav
        (reference: pyqed/polariton/cavity.py:969)."""
        dev = self.device
        mol, cav = self.mol, self.cav
        nel, ncav = mol.nstates, cav.ncav
        N = self.nstates
        mv = mol.v.to(dev)
        eyec = torch.eye(ncav, dtype=mv.dtype, device=dev)
        v = (mv[:, :, None, :, None] * eyec[None, None, :, None, :]).reshape(
            self.nx, N, N)
        nph = torch.kron(torch.eye(nel, dtype=torch.float64, device=dev),
                         torch.diag(torch.arange(ncav, dtype=torch.float64,
                                                 device=dev) * cav.omega))
        v = v + nph[None]
        qc = _quadrature(cav, dev)
        edip = mol.edip.to(dev)
        if edip.dim() == 2:                       # Condon approximation
            v = v + g * torch.kron(edip, qc.to(edip.dtype))[None]
        else:
            v = v + g * torch.einsum("xab, mn -> xambn", edip,
                                     qc.to(edip.dtype)).reshape(
                                         self.nx, N, N)
        self.v = v
        return v

    def add_coupling(self, ops):
        """Add sum_k mol_op_k (x) cav_op_k, mol_op constant (n, n) or per
        grid point (nx, n, n) (reference: pyqed/polariton/cavity.py:1012)."""
        for mol_op, cav_op in ops:
            mol_op = as_tensor(mol_op, device=self.device)
            cav_op = as_tensor(cav_op, device=self.device)
            dt = torch.promote_types(mol_op.dtype, cav_op.dtype)
            if mol_op.dim() == 2:
                term = torch.kron(mol_op.to(dt), cav_op.to(dt))[None]
            else:
                term = torch.einsum("xab, mn -> xambn", mol_op.to(dt),
                                    cav_op.to(dt)).reshape(
                                        self.nx, self.nstates, self.nstates)
            self.v = self.v + term
        return self.v

    def ppes(self):
        """Polaritonic (adiabatic) surfaces, one batched eigh
        (reference: pyqed/polariton/cavity.py:1035)."""
        w, u = _eigh(self.v)
        self.va = w
        self._u = u
        return w

    def photon_number_surface(self):
        """<n_ph> on each polaritonic surface, (nx, N)."""
        if self._u is None:
            self.ppes()
        num = torch.kron(torch.eye(self.mol.nstates, dtype=torch.float64),
                         torch.diag(torch.arange(self.cav.ncav,
                                                 dtype=torch.float64)))
        num = num.to(self.device, self._u.dtype)
        return torch.einsum("xin, ij, xjn -> xn", self._u.conj(), num,
                            self._u).real

    def run(self, psi0, dt, nt=1, nout=1):
        """SPO propagation on the polaritonic manifold
        (reference: pyqed/polariton/cavity.py:1090)."""
        spo = SPON([self.x], masses=[self.mol.mass], nstates=self.nstates,
                   device=self.device)
        spo.set_dpes(self.v)
        return spo.run(psi0, dt=dt, nt=nt, nout=nout)


class VSC:
    """Vibrational strong coupling: a single-surface nuclear grid mode
    coupled to a cavity in its ground electronic state, on ``device``
    (the card when None) (reference: pyqed/polariton/vsc.py:28, matvec
    ``hpsi:390``).

    H = T_N + V(x) + omega_c a^dag a + g x (a + a^dag) [+ g^2 x^2/omega_c]

    State psi(x, n_ph); the kinetic energy by FFT, the cavity part dense.
    """

    def __init__(self, x, v, cav: Cavity, mass=1.0, g=0.0, dse=True,
                 device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.v = torch.as_tensor(_host(v), device=self.device)
        self.cav = cav
        self.mass = mass
        self.g = g
        self.dse = dse
        self.nx = len(self.x)
        self.ncav = cav.ncav
        dx = self.x[1] - self.x[0]
        self.kx = 2 * np.pi * np.fft.fftfreq(self.nx, dx)

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's VSC with the arrays and parameters of a JAX ``VSC``."""
        return cls(np.asarray(ref.x), np.asarray(ref.v),
                   Cavity.from_reference(ref.cav), mass=ref.mass, g=ref.g,
                   dse=ref.dse, device=device)

    def hpsi(self, psi):
        """H|psi> for psi (..., nx, ncav) on the device (reference:
        pyqed/polariton/vsc.py:390); leading axes are a batch."""
        dev = self.device
        psi = as_tensor(psi, torch.complex128, dev)
        qc = _quadrature(self.cav, dev).to(psi.dtype)
        hcav = self.cav.getH().real.to(dev, psi.dtype)
        k2 = torch.as_tensor(self.kx ** 2 / (2 * self.mass), device=dev)
        x = torch.as_tensor(self.x, device=dev)[:, None]
        tpsi = torch.fft.ifft(k2[:, None] * torch.fft.fft(psi, dim=-2),
                              dim=-2)
        out = tpsi + self.v[:, None] * psi + psi @ hcav.T
        out = out + self.g * x * (psi @ qc.T)
        if self.dse:
            out = out + self.g ** 2 / self.cav.omega * x ** 2 * psi
        return out

    def spectrum(self, k=6):
        """Lowest polariton levels by dense diagonalization (small grids):
        H from one batched ``hpsi`` over the basis vectors."""
        nx, nc = self.nx, self.ncav
        dim = nx * nc
        eye = torch.eye(dim, dtype=torch.complex128, device=self.device)
        H = self.hpsi(eye.reshape(dim, nx, nc)).reshape(dim, dim).T
        return torch.linalg.eigvalsh((H + H.mH) / 2)[:k]

    def run(self, psi0, dt, nt, nout=1):
        """Split-operator propagation with V + H_cav + coupling as the
        potential part at each x (ncav states)."""
        cav = self.cav
        qc = _host(_quadrature(cav, "cpu"))
        hcav = _host(cav.getH().real)
        vx = _host(self.v)
        V = (vx[:, None, None] * np.eye(self.ncav)[None] + hcav[None]
             + self.g * self.x[:, None, None] * qc[None])
        if self.dse:
            V = V + (self.g ** 2 / cav.omega * (self.x ** 2)[:, None, None]
                     * np.eye(self.ncav)[None])
        spo = SPON([self.x], masses=[self.mass], nstates=self.ncav,
                   device=self.device)
        spo.set_dpes(torch.as_tensor(V, device=self.device))
        return spo.run(psi0, dt=dt, nt=nt, nout=nout)


class TDH:
    """Time-dependent Hartree mean field for system (x) cavity, on
    ``device`` (the card when None) (reference: pyqed/polariton/tdh.py:16).

    psi(x, n) ~ chi(x) phi(n); the coupled mean-field equations are
    integrated with RK4, one Python loop on the device."""

    def __init__(self, x, v, cav: Cavity, mass=1.0, g=0.0, device=None):
        self.device = resolve_device(device)
        self.x = np.asarray(x)
        self.v = torch.as_tensor(_host(v), device=self.device)
        self.cav = cav
        self.mass = mass
        self.g = g
        self.nx = len(self.x)
        dx = self.x[1] - self.x[0]
        self.dx = dx
        self.kx = torch.as_tensor(2 * np.pi * np.fft.fftfreq(self.nx, dx),
                                  device=self.device)

    def run(self, chi0, phi0, dt, nt, nout=1):
        """Returns dict(chi, phi (final), xave, nave (nt,)), every step
        recorded as in the JAX package (``nout`` is unused there too)."""
        dev = self.device
        qc = _quadrature(self.cav, dev).to(torch.complex128)
        hcav = self.cav.getH().real.to(dev, torch.complex128)
        x = torch.as_tensor(self.x, device=dev)
        k2 = self.kx ** 2 / (2 * self.mass)
        g, dx = self.g, self.dx
        nph = torch.arange(self.cav.ncav, dtype=torch.float64, device=dev)

        def rhs(chi, phi):
            xave = (chi.conj() * x * chi).sum().real * dx
            qave = (phi.conj() @ (qc @ phi)).real
            tchi = torch.fft.ifft(k2 * torch.fft.fft(chi))
            hchi = tchi + (self.v + g * qave * x) * chi
            hphi = phi @ hcav.T + g * xave * (qc @ phi)
            return -1j * hchi, -1j * hphi

        chi = as_tensor(chi0, torch.complex128, dev)
        phi = as_tensor(phi0, torch.complex128, dev)
        xaves = torch.empty(nt, dtype=torch.float64, device=dev)
        naves = torch.empty(nt, dtype=torch.float64, device=dev)
        for i in range(nt):
            k1 = rhs(chi, phi)
            k2_ = rhs(chi + dt / 2 * k1[0], phi + dt / 2 * k1[1])
            k3 = rhs(chi + dt / 2 * k2_[0], phi + dt / 2 * k2_[1])
            k4 = rhs(chi + dt * k3[0], phi + dt * k3[1])
            chi = chi + dt / 6 * (k1[0] + 2 * k2_[0] + 2 * k3[0] + k4[0])
            phi = phi + dt / 6 * (k1[1] + 2 * k2_[1] + 2 * k3[1] + k4[1])
            xaves[i] = ((chi.conj() * x * chi).sum().real * dx
                        / ((chi.conj() * chi).sum().real * dx))
            naves[i] = (phi.conj() * nph * phi).sum().real
        return dict(chi=chi, phi=phi, xave=xaves, nave=naves)


class GridMol2:
    """A vibronic model on a 2D nuclear grid: diabatic V(x, y) of shape
    (nx, ny, ns, ns) and a constant electronic dipole."""

    def __init__(self, x, y, v, edip, mass=(1.0, 1.0)):
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.nx, self.ny = len(self.x), len(self.y)
        self.v = as_tensor(v)
        self.nstates = self.v.shape[-1]
        self.edip = as_tensor(edip)
        self.mass = list(mass) if np.ndim(mass) else [mass, mass]


def berry_curvature_field(u, device=None):
    """Fukui-Hatsugai plaquette Berry curvature of an eigenvector field
    u (nx, ny, dim), on ``device`` (the card when None): F (nx-1, ny-1),
    the angle of the Wilson plaquette product, the discrete Berry
    curvature times the plaquette area (the reference's ``berry_curvature``
    at pyqed/polariton/cavity.py:1324 is a stub)."""
    u = as_tensor(u, device=resolve_device(device))
    ux = torch.einsum("ijd, ijd -> ij", u[:-1, :].conj(), u[1:, :])
    uy = torch.einsum("ijd, ijd -> ij", u[:, :-1].conj(), u[:, 1:])
    W = ux[:, :-1] * uy[1:, :] * ux[:, 1:].conj() * uy[:-1, :].conj()
    return torch.angle(W)


class VibronicPolariton2(VibronicPolariton):
    """2D vibronic model coupled to a single cavity mode, on ``device``
    (reference: pyqed/polariton/cavity.py:1111)."""

    def __init__(self, mol: GridMol2, cav: Cavity, g=None, device=None):
        self.device = resolve_device(device)
        self.mol = mol
        self.cav = cav
        self.x, self.y = mol.x, mol.y
        self.nx, self.ny = mol.nx, mol.ny
        self.nel = mol.nstates
        self.ncav = cav.ncav
        self.nstates = self.nel * self.ncav
        self.mass = mol.mass
        self.g = g
        self.v = None
        self.va = None
        self._u = None
        self._ground_state = None

    def dpes_global(self, g=None, rwa=False):
        """Polaritonic diabatic PES (nx, ny, N, N), built on the host
        (reference: pyqed/polariton/cavity.py:1173)."""
        if g is not None:
            self.g = g
        if self.g is None:
            raise ValueError("set the light-matter coupling g first")
        mol, cav = self.mol, self.cav
        nel, ncav, N = self.nel, self.ncav, self.nstates
        vm = _host(mol.v)
        v = np.einsum("xyab, mn -> xyambn", vm, np.eye(ncav)).reshape(
            self.nx, self.ny, N, N)
        v = v + cav.omega * np.kron(np.eye(nel), np.diag(np.arange(ncav)))
        a = _host(cav.annihilate())
        v = v + self.g * np.kron(_host(mol.edip).real, a + a.T)[None, None]
        self.v = torch.as_tensor(v, device=self.device)
        return self.v

    def ppes(self):
        """Adiabatic polaritonic surfaces and transformation (one batched
        eigh over the grid; reference: pyqed/polariton/cavity.py:1240)."""
        if self.v is None:
            self.dpes_global()
        N = self.nstates
        w, u = _eigh(self.v.reshape(-1, N, N))
        self.va = w.reshape(self.nx, self.ny, N)
        self._u = u.reshape(self.nx, self.ny, N, N)
        return self.va

    def ground_state(self, representation="adiabatic"):
        """Lowest nuclear eigenstate on the lowest polaritonic surface, by
        a host sine-DVR eigh (reference: pyqed/polariton/cavity.py:1145).
        Returns (energy, (nx, ny) NumPy state)."""
        from ..grid.dvr import SineDVR
        if self.va is None:
            self.ppes()
        V = _host(self.va[:, :, 0] if representation == "adiabatic"
                  else self.v[:, :, 0, 0])
        dx = self.x[1] - self.x[0]
        dy = self.y[1] - self.y[0]
        Tx = SineDVR(self.x[0] - dx, self.x[-1] + dx, self.nx,
                     mass=self.mass[0], device="cpu").t().numpy()
        Ty = SineDVR(self.y[0] - dy, self.y[-1] + dy, self.ny,
                     mass=self.mass[1], device="cpu").t().numpy()
        H = (np.kron(Tx, np.eye(self.ny)) + np.kron(np.eye(self.nx), Ty)
             + np.diag(V.real.ravel()))
        w, U = np.linalg.eigh(H)
        self._ground_state = U[:, 0].reshape(self.nx, self.ny)
        return w[0], self._ground_state

    def berry_curvature(self, state_id=0):
        """Plaquette Berry curvature of adiabatic polaritonic state
        ``state_id`` (reference: pyqed/polariton/cavity.py:1324, a stub)."""
        if self._u is None:
            self.ppes()
        return berry_curvature_field(self._u[:, :, :, state_id],
                                     device=self.device)

    def promote_op(self, a, kind="mol"):
        """(reference: pyqed/polariton/cavity.py:1378)."""
        a = as_tensor(a)
        if kind in ("mol", "m"):
            return torch.kron(a, torch.eye(self.ncav, dtype=a.dtype))
        return torch.kron(torch.eye(self.nel, dtype=a.dtype), a)

    def run(self, psi0=None, dt=0.1, nt=10, nout=1, **kw):
        """SPO2 propagation on the polaritonic surfaces, from the lowest
        nuclear state on the lowest surface by default
        (reference: pyqed/polariton/cavity.py:1328)."""
        from ..grid.spo import SPO2
        if self.v is None:
            self.dpes_global()
        if psi0 is None:
            if self._ground_state is None:
                self.ground_state()
            psi0 = np.zeros((self.nx, self.ny, self.nstates), complex)
            dvol = float((self.x[1] - self.x[0]) * (self.y[1] - self.y[0]))
            psi0[:, :, 0] = self._ground_state / np.sqrt(dvol)
        spo = SPO2(self.x, self.y, masses=self.mass, nstates=self.nstates,
                   device=self.device, **kw)
        spo.set_dpes(self.v)
        return spo.run(psi0, dt=dt, nt=nt, nout=nout)
