"""Molecule container and integral driver.

PyTorch counterpart of ``pyqed_tpu/qchem/mol.py`` (reference:
pyqed/qchem/mol.py:817 — geometry, charge, basis dispatch to RHF/UHF;
Z-matrix/Eckart utilities there are geometry helpers). The integrals are
built on the host (:mod:`.basis`, :mod:`.engine`) and moved to the
molecule's device once; every mean-field and post-HF object computes on
that device.
"""
from __future__ import annotations

import copy
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device

from .basis import (
    ATOMIC_NUMBER, build_basis, overlap_matrix, kinetic_matrix,
    nuclear_matrix, eri_tensor, nuclear_repulsion,
)
from ..units import au2angstrom


class Molecule:
    """(reference: pyqed/qchem/mol.py:817).

    atoms: list of (symbol, (x, y, z)); unit='bohr'|'angstrom'.
    device: where the integrals live and the methods compute (the card
    when None; raises without one).
    """

    def __init__(self, atoms: Sequence[Tuple], charge=0, spin=0,
                 basis="sto-3g", unit="bohr", spherical=False, device=None):
        self.device = resolve_device(device)
        scale = 1.0 if unit.lower().startswith("b") else 1.0 / au2angstrom
        self.atoms = [(s, np.asarray(x, dtype=float) * scale)
                      for (s, x) in atoms]
        self.charge = charge
        self.spin = spin
        self.basis_name = basis
        self.spherical = bool(spherical)
        self.nelec = sum(ATOMIC_NUMBER[s] for s, _ in self.atoms) - charge
        self.bfs = build_basis(self.atoms, basis)
        # pure (real-spherical) angular functions: keep the Cartesian bfs
        # for integral evaluation and contract through csph everywhere
        # (chi_sph = csph @ chi_cart); L<2 shells pass through unchanged.
        if self.spherical:
            from .basis import spherical_transform
            self.csph = spherical_transform(self.bfs)
            self.nao = self.csph.shape[0]
        else:
            self.csph = None
            self.nao = len(self.bfs)
        self._ints = None
        self._deriv_ints = None     # grad.derivative_integrals' cache

    @classmethod
    def from_xyz(cls, fname, **kwargs):
        """Build from a standard .xyz file (Angstrom on disk)
        (reference: pyqed/qchem/mol.py:1174 ``readxyz`` +
        mol.py:271 ``fromfile``)."""
        if "unit" in kwargs:
            raise ValueError(
                "from_xyz: the .xyz format fixes the unit (Angstrom on "
                "disk, converted to bohr on read) — drop the unit kwarg")
        from .geometry import read_xyz
        return cls(read_xyz(fname), unit="bohr", **kwargs)

    @property
    def natm(self):
        return len(self.atoms)

    def energy_nuc(self):
        return nuclear_repulsion(self.atoms)

    def intor(self):
        """Compute on the host and cache (S, T, V, ERI) as float64 tensors
        on the molecule's device (in the pure spherical AO basis when
        ``spherical=True``). ``intor_seconds`` records the host seconds of
        the one-electron matrices, of the ERI tensor and of the copy to the
        device."""
        if self._ints is None:
            t0 = time.perf_counter()
            S = overlap_matrix(self.bfs)
            T = kinetic_matrix(self.bfs)
            V = nuclear_matrix(self.bfs, self.atoms)
            t1 = time.perf_counter()
            eri = eri_tensor(self.bfs)
            if self.csph is not None:
                from .basis import transform_eri
                C = self.csph
                S, T, V = (C @ M @ C.T for M in (S, T, V))
                eri = transform_eri(C, eri)
            t2 = time.perf_counter()
            self._ints = tuple(
                torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                                device=self.device)
                for x in (S, T, V, eri))
            self.intor_seconds = dict(one_electron=t1 - t0, eri=t2 - t1,
                                      to_device=time.perf_counter() - t2)
        return self._ints

    def to(self, device):
        """A copy of this molecule on ``device`` that takes over the
        integrals built so far (``intor``'s and the derivative integrals)
        instead of building them again on the host."""
        other = copy.copy(self)
        other.device = resolve_device(device)
        for name in ("_ints", "_deriv_ints"):
            ints = getattr(self, name)
            if ints is not None:
                setattr(other, name, tuple(x.to(other.device) for x in ints))
        return other

    def RHF(self, **kwargs):
        from .scf import RHF
        return RHF(self, **kwargs)

    def UHF(self, **kwargs):
        from .scf import UHF
        return UHF(self, **kwargs)

    def RKS(self, xc="svwn", **kwargs):
        """Restricted Kohn-Sham dispatch (reference: pyqed/qchem/mol.py:817
        ``Mole.RKS``)."""
        from .dft import RKS
        return RKS(self, xc=xc, **kwargs)

    def UKS(self, xc="svwn", **kwargs):
        from .dft import UKS
        return UKS(self, xc=xc, **kwargs)

    def FCI(self, **kwargs):
        from .ci import FCI
        return FCI(self.RHF().run(), **kwargs)

    # ------------------------------------------------- atom accessors
    # (reference: pyqed/qchem/mol.py Molecule.atom_coord(s)/atom_symbol(s)/
    # atom_charge(s)/atom_mass_list)
    def atom_coord(self, a):
        return self.atoms[a][1]

    def atom_coords(self):
        return np.array([x for _, x in self.atoms])

    def atom_symbol(self, i):
        return self.atoms[i][0]

    def atom_symbols(self):
        return [s for s, _ in self.atoms]

    def atom_charge(self, i):
        return ATOMIC_NUMBER[self.atoms[i][0]]

    def atom_charges(self):
        return np.array([ATOMIC_NUMBER[s] for s, _ in self.atoms])

    def atom_mass_list(self):
        from ..units import atomic_mass
        return np.array([atomic_mass[s.upper()] for s, _ in self.atoms])

    def center_of_mass(self):
        from ..units import atomic_mass, amu2au
        masses = np.array([atomic_mass[s.upper()] for s, _ in self.atoms])
        coords = np.array([x for _, x in self.atoms])
        return (masses[:, None] * coords).sum(0) / masses.sum()

    # ------------------------------------------------- molecular frames
    def molecular_frame(self):
        """Shift to the center-of-mass frame in place; returns self
        (reference: pyqed/qchem/mol.py Molecule.molecular_frame)."""
        com = self.center_of_mass()
        self.atoms = [(s, x - com) for s, x in self.atoms]
        self._ints = self._deriv_ints = None
        return self

    def eckart_frame(self, ref):
        """Rotate/translate into the Eckart frame of a reference geometry
        (reference: pyqed/qchem/mol.py:928; mass-weighted Kabsch here).
        `ref`: (natm, 3) coordinates or another Molecule. Returns the
        new coordinates."""
        from .geometry import eckart_frame as _eckart
        ref_coords = ref.atom_coords() if hasattr(ref, "atom_coords") else \
            np.asarray(ref, float)
        aligned, _, _ = _eckart(ref_coords, self.atom_coords(),
                                self.atom_mass_list())
        # eckart_frame returns COM-frame coords of ref; re-anchor to the
        # reference's center of mass
        m = self.atom_mass_list()
        ref_com = np.average(ref_coords, axis=0, weights=m)
        coords = aligned + ref_com
        self.atoms = [(s, c) for (s, _), c in zip(self.atoms, coords)]
        self._ints = self._deriv_ints = None
        return coords

    def principle_axes(self):
        """Principal axes of inertia: (moments, axes) with axes[:, i]
        the i-th axis (reference: pyqed/qchem/mol.py — a ``pass`` stub
        there)."""
        I = self.inertia_tensor()
        w, v = np.linalg.eigh(I)
        return w, v

    def zmat(self):
        """Z-matrix representation (symbol, bond, angle, dihedral) as a
        string (reference: pyqed/qchem/mol.py Molecule.zmat — prints to
        stdout there; returned here)."""
        coords = self.atom_coords()
        syms = self.atom_symbols()
        lines = []

        def dist(i, j):
            return np.linalg.norm(coords[i] - coords[j])

        def angle(i, j, k):
            u = coords[i] - coords[j]
            v = coords[k] - coords[j]
            c = np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
            return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))

        def dihedral(i, j, k, l):
            b1 = coords[j] - coords[i]
            b2 = coords[k] - coords[j]
            b3 = coords[l] - coords[k]
            n1 = np.cross(b1, b2)
            n2 = np.cross(b2, b3)
            m1 = np.cross(n1, b2 / np.linalg.norm(b2))
            return np.degrees(np.arctan2(np.dot(m1, n2), np.dot(n1, n2)))

        for i, s in enumerate(syms):
            if i == 0:
                lines.append(f"{s}")
            elif i == 1:
                lines.append(f"{s} 1 {dist(1, 0):.5f}")
            elif i == 2:
                lines.append(f"{s} 2 {dist(2, 1):.5f} 1 {angle(2, 1, 0):.3f}")
            else:
                lines.append(
                    f"{s} {i} {dist(i, i-1):.5f} {i-1} "
                    f"{angle(i, i-1, i-2):.3f} {i-2} "
                    f"{dihedral(i, i-1, i-2, i-3):.3f}")
        return "\n".join(lines)

    def tofile(self, fname):
        """Write an .xyz file (reference: pyqed/qchem/mol.py — a ``pass``
        stub there)."""
        from .geometry import save_to_xyz
        return save_to_xyz(self, fname)

    def inertia_tensor(self):
        from ..units import atomic_mass
        masses = np.array([atomic_mass[s.upper()] for s, _ in self.atoms])
        coords = np.array([x for _, x in self.atoms]) - self.center_of_mass()
        I = np.zeros((3, 3))
        for m, r in zip(masses, coords):
            I += m * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
        return I

    inertia_moment = inertia_tensor


def molecule_from_reference(ref, device=None):
    """The port's :class:`Molecule` with the atoms, basis, charge, spin and
    ``spherical`` flag of a JAX-package ``Molecule`` (``ref``; only plain
    attributes are read, so nothing of JAX is imported)."""
    return Molecule([(s, np.asarray(x, dtype=float)) for s, x in ref.atoms],
                    charge=ref.charge, spin=ref.spin, basis=ref.basis_name,
                    spherical=bool(ref.spherical), device=device)
