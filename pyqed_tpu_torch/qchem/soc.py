"""One-electron spin-orbit coupling integrals over GTOs.

PyTorch counterpart of ``pyqed_tpu/qchem/soc.py`` (reference:
pyqed/qchem/soc.py:20 ``soc`` — a pyscf call of
``int1e_prinvxp``; here the integrals are built natively from the
McMurchie-Davidson nuclear-attraction kernel).

The Breit-Pauli one-electron (spin-same-orbit) operator is

    h_SO = (alpha^2 / 2) sum_A Z_A  p x (1/|r - R_A|) p . s

Its orbital part for real GTOs reduces to the real antisymmetric
arrays (x-component shown; cyclic for y, z)

    W^A_x(mu, nu) = <d_y mu | 1/r_A | d_z nu> - <d_z mu | 1/r_A | d_y nu>

with the physical matrix element i * W. A Cartesian-Gaussian derivative
is the two-term shift  d_y G(l,m,n) = m G(l,m-1,n) - 2 alpha G(l,m+1,n),
so everything lands on ordinary nuclear-attraction integrals.

The JAX package evaluates those one primitive quartet at a time through
the scalar ``_nuclear_prim``; here they are evaluated over all primitive
pairs of an angular-momentum block at once (``basis._pair_matrix`` and
``basis._Pairs.nuclear``, the vectorized recursion the one-electron
matrices use). The integrals are host NumPy, as every integral of the
port; ``soc_mo`` and ``soc_matrix`` with orbitals contract on the
orbitals' device.
"""
from __future__ import annotations

import numpy as np
import torch

from .basis import _pair_matrix, _shift

FINE_STRUCTURE = 1.0 / 137.035999084

_Z = {"H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7,
      "O": 8, "F": 9, "Ne": 10}

_CYCLIC = ((1, 2), (2, 0), (0, 1))      # x: (y,z), y: (z,x), z: (x,y)


def _dV(P, la, lb, C, ax1, ax2):
    """<d_{ax1} a | 1/|r-C| | d_{ax2} b> over the pairs ``P`` of one
    angular-momentum block: each derivative is l G(l-1) - 2 alpha G(l+1)
    (the exponent of its own side)."""
    def terms(l, alpha, ax):
        out = [(-2.0 * alpha, _shift(l, ax, 1))]
        if l[ax] > 0:
            out.append((float(l[ax]), _shift(l, ax, -1)))
        return out

    val = 0.0
    for c1, l1 in terms(la, P.a, ax1):
        for c2, l2 in terms(lb, P.b, ax2):
            val = val + c1 * c2 * P.nuclear(l1, l2, C)
    return val


def soc_integrals(bfs, atoms, effective_charge=True):
    """W (3, n, n) NumPy: real antisymmetric orbital SOC arrays summed
    over nuclei with charge weights; physical h_SO = i (alpha^2/2) W . s.

    atoms : list of (symbol, (x, y, z)) in bohr.
    """
    n = len(bfs)
    W = np.zeros((3, n, n))
    for sym, xyz in atoms:
        Z = _Z[sym] if effective_charge else 1.0
        C = np.asarray(xyz, float)

        def w(P, la, lb):
            return np.stack([_dV(P, la, lb, C, u, v) - _dV(P, la, lb, C, v, u)
                             for u, v in _CYCLIC])

        W += Z * _pair_matrix(bfs, bfs, w, shape=(3,))
    # the diagonal vanishes identically (the JAX package skips it)
    W[:, np.arange(n), np.arange(n)] = 0.0
    return W


def soc_mo(W, mo_coeff):
    """Transform the AO SOC arrays to the MO basis: (3, nmo, nmo), on the
    orbitals' device when they are a tensor (NumPy otherwise)."""
    if isinstance(mo_coeff, torch.Tensor):
        Wt = torch.as_tensor(np.asarray(W) if not isinstance(W, torch.Tensor)
                             else W, device=mo_coeff.device)
        return torch.einsum("xpq, pi, qj -> xij", Wt.to(mo_coeff.dtype),
                            mo_coeff, mo_coeff)
    return np.einsum("xpq, pi, qj -> xij", W, mo_coeff, mo_coeff)


def soc_matrix(bfs, atoms, mo_coeff=None):
    """Full complex one-electron SOC operator i (alpha^2/2) W, optionally
    in the MO basis (reference pyqed/qchem/soc.py:74 h1 convention)."""
    W = soc_integrals(bfs, atoms)
    if mo_coeff is not None:
        W = soc_mo(W, mo_coeff)
    return 0.5j * FINE_STRUCTURE ** 2 * W
