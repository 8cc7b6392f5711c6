"""Shin-Metiu model with two explicit electrons in 1D, and the
one-electron Shin-Metiu model in 3D.

PyTorch counterpart of ``pyqed_tpu/models/shinmetiu2e.py`` (reference:
pyqed/models/ShinMetiu2e1d.py:223 ``ShinMetiu1d`` — proton between two
fixed ions, two soft-Coulomb electrons; ``single_point:369`` exact
two-electron diagonalization, ``potential_energy:497``, ``pes:518``;
pyqed/models/ShinMetiu3d.py:50).

The JAX package builds the (nx², nx²) two-electron Hamiltonian with
NumPy on the host; here it is built on ``device`` (the card when None),
and ``pes`` diagonalizes the Hamiltonians of a batch of proton positions
with one batched ``eigvalsh``. ``ShinMetiu3d`` never forms its Hamiltonian:
the per-dimension kinetic contractions are the matvec of the block
Davidson of ``ops/davidson`` (the JAX package calls SciPy's Lanczos).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..units import au2angstrom
from ..qchem.dvr import soft_coulomb, MoleculeDVR, RHF1D
from ..grid.dvr import SineDVR

#: proton positions diagonalized together by ``ShinMetiu2e1d.pes`` (the
#: batch of (nx², nx²) Hamiltonians held at once)
PES_BATCH = 8


class ShinMetiu2e1d:
    """Proton-coupled two-electron transfer model.

    Two fixed ions at ±L/2 and a mobile proton at R, all charge +1;
    two electrons interacting through erf-screened Coulomb terms
    (screenings: Rf for the fixed ions, Rc for the proton, Re for e-e;
    reference defaults ShinMetiu2e1d.py:233-241). Computes on ``device``
    (the card when None).
    """

    def __init__(self, nstates=3, spin=0, device=None):
        self.device = resolve_device(device)
        self.Rc = 1.5 / au2angstrom
        self.Rf = 1.5 / au2angstrom
        self.Re = (2.5 if spin == 0 else 1.5) / au2angstrom
        self.L = 10.0 / au2angstrom
        self.left = -self.L / 2
        self.right = +self.L / 2
        self.nstates = nstates
        self.nelec = 2
        self.spin = spin
        self.x = None

    def create_grid(self, domain, nx):
        dvr = SineDVR(*domain, nx, device=self.device)
        self.dvr = dvr
        self.x = np.asarray(dvr.x)
        self.nx = nx
        self.domain = domain
        return self.x

    # ------------------------------------------------------- potentials
    def v_en_fixed(self, r):
        r = torch.as_tensor(r, dtype=torch.float64)
        return (-soft_coulomb(torch.abs(r - self.left), self.Rf)
                - soft_coulomb(torch.abs(r - self.right), self.Rf))

    def v_en_proton(self, r, R):
        r = torch.as_tensor(r, dtype=torch.float64)
        return -soft_coulomb(torch.abs(r - R), self.Rc)

    def energy_nuc(self, R):
        """(reference: ShinMetiu2e1d.py:491)."""
        return (1.0 / abs(R - self.left) + 1.0 / abs(R - self.right)
                + 1.0 / self.L)

    # ------------------------------------------------------ single point
    def _hamiltonians(self, Rs):
        """(len(Rs), nx², nx²) two-electron Hamiltonians on the device."""
        if self.x is None:
            raise ValueError("call create_grid(domain, nx) first")
        dev = self.device
        nx = self.nx
        x = torch.as_tensor(self.x, device=dev)
        T1 = self.dvr.t()
        eye = torch.eye(nx, dtype=T1.dtype, device=dev)
        T2 = torch.kron(T1, eye) + torch.kron(eye, T1)
        X1, X2 = torch.meshgrid(x, x, indexing="ij")
        v0 = (self.v_en_fixed(X1) + self.v_en_fixed(X2)
              + soft_coulomb(torch.abs(X1 - X2), self.Re)).reshape(-1)
        R = torch.as_tensor(np.asarray(Rs, dtype=float), device=dev)
        vp = (self.v_en_proton(X1[None], R[:, None, None])
              + self.v_en_proton(X2[None], R[:, None, None]))
        H = T2.expand(len(Rs), -1, -1).clone()
        H.diagonal(dim1=1, dim2=2).add_(v0[None] + vp.reshape(len(Rs), -1))
        return H

    def single_point(self, R, num_eigs=None):
        """Exact two-electron BO energies/states at proton position R
        (reference: ShinMetiu2e1d.py:369). Returns NumPy (w, u), u columns
        on the (x1, x2) product grid; energies INCLUDE the
        nuclear-repulsion constant (reference convention)."""
        w, u = torch.linalg.eigh(self._hamiltonians([R])[0])
        k = num_eigs or self.nstates
        return (w[:k].cpu().numpy() + self.energy_nuc(R),
                u[:, :k].cpu().numpy())

    def exchange_symmetry(self, u):
        """+1 (singlet spatial) / −1 (triplet spatial) of eigencolumns."""
        nx = self.nx
        out = []
        for k in range(u.shape[1]):
            psi = np.asarray(u[:, k]).reshape(nx, nx)
            s = np.sum(psi * psi.T) / np.sum(psi * psi)
            out.append(float(np.sign(s)))
        return np.array(out)

    def pes(self, Rs, num_eigs=None):
        """Born-Oppenheimer curves over proton positions (reference:
        ShinMetiu2e1d.py:518), NumPy (len(Rs), num_eigs): the
        Hamiltonians of ``PES_BATCH`` positions at a time go through one
        batched ``eigvalsh`` on the device."""
        k = num_eigs or self.nstates
        Rs = np.asarray(Rs, dtype=float)
        ws = [torch.linalg.eigvalsh(self._hamiltonians(Rs[i:i + PES_BATCH]))
              [:, :k] for i in range(0, len(Rs), PES_BATCH)]
        return torch.cat(ws).cpu().numpy() + np.array(
            [self.energy_nuc(R) for R in Rs])[:, None]

    # ------------------------------------------------------ HF reference
    def scf(self, R, nx=None):
        """Mean-field single point via the DVR RHF layer (reference
        path: ShinMetiu2e1d.py:932 ``RHF1D(mol)``). Uses the fixed-ion
        screening for every center (MoleculeDVR convention)."""
        mol = MoleculeDVR([(1, [self.left]), (1, [self.right]),
                           (1, [float(R)])], charge=1,
                          Rf=self.Rf, Re=self.Re, device=self.device)
        mf = RHF1D(mol, domain=self.domain, nx=nx or self.nx)
        mf.run()
        return mf


class ShinMetiu3d:
    """Shin-Metiu model in full 3D: one electron on an (x, y, z) grid,
    a mobile proton at 3D position R between two fixed ions at ±L/2 x̂
    (reference: pyqed/models/ShinMetiu3d.py:50 — softened Coulomb
    1/sqrt(a + r²) and the (|R|/R0)^4 bounding term), on ``device`` (the
    card when None).

    Single points use the matrix-free block Davidson with the kinetic
    matvec applied as per-dimension tensordots — no dense (nx ny nz)²
    Hamiltonian — from a seeded random block of num_eigs + 2 vectors.
    """

    def __init__(self, nstates=3, device=None):
        self.device = resolve_device(device)
        self.a = 0.5
        self.b = 10.0
        self.R0 = 3.5
        self.L = 4 * np.sqrt(3) / 5
        self.left = np.array([-self.L / 2, 0.0, 0.0])
        self.right = np.array([+self.L / 2, 0.0, 0.0])
        self.nstates = nstates
        self.x = None

    def create_grid(self, domain, nx):
        """domain: [(x0,x1), (y0,y1), (z0,z1)], nx points per dim."""
        self.dvrs = [SineDVR(*d, nx, device=self.device) for d in domain]
        self.grids = [np.asarray(d.x) for d in self.dvrs]
        self.x, self.y, self.z = self.grids
        self.nx = nx
        return self.grids

    def v_en(self, r2):
        """−1/sqrt(a + |r−R|²) summed over ions, broadcast on the grid;
        r2: squared distances."""
        return -1.0 / torch.sqrt(self.a + r2)

    def potential_grid(self, R):
        X, Y, Z = (torch.as_tensor(g, device=self.device)
                   for g in np.meshgrid(*self.grids, indexing="ij"))
        R = np.asarray(R, dtype=float)

        def d2(Rc):
            return ((X - Rc[0]) ** 2 + (Y - Rc[1]) ** 2
                    + (Z - Rc[2]) ** 2)

        v = (self.v_en(d2(self.left)) + self.v_en(d2(self.right))
             + self.v_en(d2(R)))
        vnn = (1 / np.sqrt(self.b + np.sum((R - self.left) ** 2))
               + 1 / np.sqrt(self.b + np.sum((R - self.right) ** 2))
               + 1 / np.sqrt(self.b + self.L ** 2))
        return v + vnn + (np.linalg.norm(R) / self.R0) ** 4

    def single_point(self, R, num_eigs=None, tol=1e-9):
        """(reference: ShinMetiu3d.py:98): BO energies and states at
        proton R by the block Davidson on the device, as NumPy."""
        from ..ops.davidson import block_davidson
        v = self.potential_grid(R)
        Ts = [d.t() for d in self.dvrs]
        nx = self.nx
        shape = (nx, nx, nx)

        def matvec(p):
            p = p.reshape(shape + p.shape[1:])
            out = v.reshape(shape + (1,) * (p.dim() - 3)) * p
            for d in range(3):
                out = out + torch.movedim(
                    torch.tensordot(Ts[d], torch.movedim(p, d, 0), dims=1),
                    0, d)
            return out.reshape(nx ** 3, -1)

        diag = v.clone()
        for d in range(3):
            s = [1, 1, 1]
            s[d] = -1
            diag = diag + torch.diagonal(Ts[d]).reshape(s)
        k = num_eigs or self.nstates
        # two more roots than asked (near-degenerate partners converge
        # together) from a seeded random block: unit vectors on the lowest
        # diagonal entries, the Davidson's default start, share the
        # molecule's symmetry and miss states odd under it
        m = k + 2
        gen = torch.Generator(device=v.device).manual_seed(0)
        v0 = torch.randn((nx ** 3, m), generator=gen, dtype=v.dtype,
                         device=v.device)
        w, u = block_davidson(matvec, neig=m, diag=diag.reshape(-1),
                              tol=tol, max_iterations=200, v0=v0,
                              max_space=max(8 * m, 40))
        return w[:k].cpu().numpy(), u[:, :k].cpu().numpy()

    def pes(self, Rs, num_eigs=None):
        """(reference: ShinMetiu3d.py:185), NumPy."""
        return np.stack([self.single_point(np.asarray(R), num_eigs)[0]
                         for R in Rs])
