"""Orbital localization and population analysis.

Foster-Boys and Pipek-Mezey localization (Jacobi 2x2 sweeps), intrinsic
atomic orbitals (IAO, Knizia JCTC 2013, 9, 4834) and intrinsic bond
orbitals (IBO = Pipek-Mezey in the orthonormal IAO charge metric), plus
Mulliken/IAO population analysis and HOMO/LUMO lookup.

The reference exposes this surface through pyscf.lo
(reference: pyqed/qchem/mol.py:1445 ``intrinsic_orbitals`` — pyscf
``lo.iao``/``lo.ibo``/``lo.vvo``; pyqed/qchem/mol.py:1528
``find_homo_lumo``). Here the whole stack is self-contained on the
in-house GTO integrals: the Jacobi pair-rotation maximization of
sum_A (M_A)_ii^2 is one generic routine instantiated with dipole
matrices (Boys) or atomic populations (PM / IBO).

PyTorch-package counterpart of ``pyqed_tpu/qchem/lo.py``: as in the JAX
package, this layer is NumPy on the host (sequential 2x2 Jacobi sweeps);
it reads the mean field's device tensors once.
"""
from __future__ import annotations

import numpy as np

from .ci import _host

__all__ = [
    "boys", "pipek_mezey", "iao", "ibo", "vec_lowdin",
    "mulliken_charges", "iao_charges", "find_homo_lumo",
    "orbital_centers", "orbital_spread",
]


# ------------------------------------------------------------- utilities

def cart_atom_indices(mol):
    """Atom index of every CARTESIAN basis function (``mol.bfs`` order),
    regardless of whether the SCF runs in the pure-spherical basis."""
    coords = [np.asarray(x) for _, x in mol.atoms]

    def which(center):
        for a, c in enumerate(coords):
            if np.allclose(center, c, atol=1e-12):
                return a
        raise ValueError("basis-function center matches no atom")

    return np.array([which(bf.center) for bf in mol.bfs])


def ao_atom_indices(mol):
    """Atom index of every AO (Cartesian or pure-spherical basis)."""
    cart = cart_atom_indices(mol)
    if getattr(mol, "csph", None) is None:
        return cart
    # each spherical AO mixes Cartesian components of ONE shell -> the
    # largest-|coefficient| Cartesian parent identifies the atom
    parent = np.argmax(np.abs(np.asarray(mol.csph)), axis=1)
    return cart[parent]


def vec_lowdin(C, S):
    """Symmetrically orthonormalize the columns of C in metric S:
    C (C^T S C)^{-1/2}."""
    C = np.asarray(_host(C), dtype=float)
    M = C.T @ _host(S) @ C
    w, V = np.linalg.eigh(M)
    if np.any(w < 1e-12):
        raise np.linalg.LinAlgError("vec_lowdin: singular metric")
    return C @ (V / np.sqrt(w)) @ V.T


def _jacobi_localize(Ms, max_sweeps=200, tol=1e-10):
    """Maximize sum_A sum_i (M_A)_ii^2 over orthogonal rotations.

    Ms: (nA, n, n) symmetric matrices in the orbital basis (updated in
    place on a copy). Returns (U, Ms_rot) with columns of U the rotated
    orbitals expressed in the input orbital basis.
    """
    Ms = np.array(Ms, dtype=float, copy=True)
    nA, n, _ = Ms.shape
    U = np.eye(n)
    for _ in range(max_sweeps):
        gain = 0.0
        for i in range(n - 1):
            for j in range(i + 1, n):
                mij = Ms[:, i, j]
                d = Ms[:, i, i] - Ms[:, j, j]
                A = float(np.sum(mij**2 - 0.25 * d**2))
                B = float(np.sum(mij * d))
                dD = A + np.hypot(A, B)
                if dD <= tol:
                    continue
                theta = 0.25 * np.arctan2(B, -A)
                c, s = np.cos(theta), np.sin(theta)
                # rotate columns i, j of U and rows+cols of every M_A
                U[:, [i, j]] = U[:, [i, j]] @ np.array([[c, -s], [s, c]])
                Mi = c * Ms[:, :, i] + s * Ms[:, :, j]
                Mj = -s * Ms[:, :, i] + c * Ms[:, :, j]
                Ms[:, :, i], Ms[:, :, j] = Mi, Mj
                Mi = c * Ms[:, i, :] + s * Ms[:, j, :]
                Mj = -s * Ms[:, i, :] + c * Ms[:, j, :]
                Ms[:, i, :], Ms[:, j, :] = Mi, Mj
                gain += dD
        if gain < tol:
            break
    return U, Ms


def _occ_coeff(mf, mo_coeff=None):
    C = _host(mf.mo_coeff if mo_coeff is None else mo_coeff)
    return C[:, : mf.nocc] if mo_coeff is None else C


def _overlap(mf):
    S = getattr(mf, "S", None)
    if S is not None:
        return _host(S)
    return _host(mf.mol.intor()[0])


def _dipole_ints(mf):
    fn = getattr(mf, "dipole_integrals", None)
    if fn is not None:
        return _host(fn())
    from .basis import dipole_matrix
    mol = mf.mol
    mu = dipole_matrix(mol.bfs, (0.0, 0.0, 0.0))
    if getattr(mol, "csph", None) is not None:
        mu = np.einsum("pi, kij, qj -> kpq", mol.csph, mu, mol.csph)
    return mu


# ----------------------------------------------------------- localizers

def boys(mf, mo_coeff=None):
    """Foster-Boys localization: maximize sum_i |<i|r|i>|^2 (equivalently
    minimize total orbital spread). Localizes the occupied block of
    ``mf`` unless ``mo_coeff`` (any orthonormal column set) is given.
    Returns the localized AO coefficients."""
    C = _occ_coeff(mf, mo_coeff)
    mu = _dipole_ints(mf)                            # (3, nao, nao)
    Ms = np.einsum("pi, kpq, qj -> kij", C, mu, C)
    U, _ = _jacobi_localize(Ms)
    return C @ U


def _population_matrices(C, S, ao_atoms, natm):
    """Symmetrized Mulliken population operators Q^A in the orbital
    basis: Q^A_ij = 1/2 sum_{mu in A} [(C^T S)_{i mu} C_{mu j} + (i<->j)]."""
    CS = C.T @ S                                      # (n, nao)
    Ms = np.empty((natm, C.shape[1], C.shape[1]))
    for a in range(natm):
        mask = ao_atoms == a
        Qa = CS[:, mask] @ C[mask, :]
        Ms[a] = 0.5 * (Qa + Qa.T)
    return Ms


def pipek_mezey(mf, mo_coeff=None):
    """Pipek-Mezey localization: maximize sum_A sum_i Q^A_ii^2 with
    Mulliken atomic populations (keeps sigma/pi separation, unlike
    Boys). Returns localized AO coefficients."""
    C = _occ_coeff(mf, mo_coeff)
    S = _overlap(mf)
    ao_atoms = ao_atom_indices(mf.mol)
    Ms = _population_matrices(C, S, ao_atoms, mf.mol.natm)
    U, _ = _jacobi_localize(Ms)
    return C @ U


# -------------------------------------------------------------- IAO/IBO

def _minao_bfs(mol, minao="sto-3g"):
    from .basis import build_basis
    return build_basis(mol.atoms, minao)


def iao(mf, minao="sto-3g"):
    """Intrinsic atomic orbitals (Knizia JCTC 2013, 9, 4834): a minimal,
    S-orthonormal set of atom-centered orbitals that exactly spans the
    occupied space. Returns (nao, n_minao) AO coefficients.

    (reference: pyqed/qchem/mol.py:1445 via pyscf ``lo.iao.iao``.)
    """
    from .ci_overlap import cross_overlap_ao
    from .basis import overlap_matrix

    mol = mf.mol
    C = _occ_coeff(mf)
    s1 = _overlap(mf)
    b2 = _minao_bfs(mol, minao)
    s2 = overlap_matrix(b2)
    s12 = cross_overlap_ao(mol.bfs, b2)
    if getattr(mol, "csph", None) is not None:
        s12 = np.asarray(mol.csph) @ s12

    p12 = np.linalg.solve(s1, s12)
    # occupied MOs depolarized through the minimal basis and back
    ct = np.linalg.solve(s1, s12 @ np.linalg.solve(s2, s12.T @ C))
    ct = vec_lowdin(ct, s1)
    O = C @ C.T @ s1
    Ot = ct @ ct.T @ s1
    a = p12 + 2.0 * (O @ (Ot @ p12)) - O @ p12 - Ot @ p12
    return vec_lowdin(a, s1)


def _iao_atoms(mol, minao="sto-3g"):
    coords = [np.asarray(x) for _, x in mol.atoms]
    out = []
    for bf in _minao_bfs(mol, minao):
        for a, c in enumerate(coords):
            if np.allclose(bf.center, c, atol=1e-12):
                out.append(a)
                break
    return np.array(out)


def ibo(mf, minao="sto-3g"):
    """Intrinsic bond orbitals: Pipek-Mezey localization of the occupied
    orbitals using IAO partial charges (basis-set-stable bonds/lone
    pairs). Returns localized AO coefficients.

    (reference: pyqed/qchem/mol.py:1445 via pyscf ``lo.ibo.ibo``.)
    """
    A = iao(mf, minao)
    C = _occ_coeff(mf)
    S = _overlap(mf)
    P = A.T @ S @ C                    # occ MOs in the orthonormal IAO basis
    atoms = _iao_atoms(mf.mol, minao)
    n = C.shape[1]
    Ms = np.empty((mf.mol.natm, n, n))
    for a in range(mf.mol.natm):
        Pa = P[atoms == a, :]
        Ms[a] = Pa.T @ Pa
    U, _ = _jacobi_localize(Ms)
    return C @ U


# ------------------------------------------------------------ populations

def mulliken_charges(mf):
    """Mulliken atomic partial charges q_A = Z_A - sum_{mu in A}(DS)_mumu."""
    if isinstance(mf.dm, (tuple, list)):       # UHF (Da, Db)
        D = _host(mf.dm[0]) + _host(mf.dm[1])
    else:
        D = _host(mf.dm)
    S = _overlap(mf)
    pop = np.real(np.diag(D @ S))
    ao_atoms = ao_atom_indices(mf.mol)
    Z = np.asarray(mf.mol.atom_charges(), dtype=float)
    q = Z.copy()
    for mu, a in enumerate(ao_atoms):
        q[a] -= pop[mu]
    return q


def iao_charges(mf, minao="sto-3g"):
    """IAO partial charges (basis-set-stable Mulliken analysis in the
    orthonormal IAO basis)."""
    A = iao(mf, minao)
    C = _occ_coeff(mf)
    S = _overlap(mf)
    P = A.T @ S @ C
    pop = 2.0 * np.sum(P**2, axis=1)   # closed shell
    atoms = _iao_atoms(mf.mol, minao)
    Z = np.asarray(mf.mol.atom_charges(), dtype=float)
    q = Z.copy()
    for mu, a in enumerate(atoms):
        q[a] -= pop[mu]
    return q


# -------------------------------------------------------------- analysis

def orbital_centers(mf, C):
    """<i|r|i> for each orbital column (3, n) -> (n, 3)."""
    mu = _dipole_ints(mf)
    return np.einsum("pi, kpq, qi -> ik", C, mu, C)


def orbital_spread(mf, C):
    """Boys spread sum_i (<r^2>_i - <r>_i^2) using the quadrupole trace
    from raising twice is avoided: returns the Boys OBJECTIVE
    -sum_i |<i|r|i>|^2 instead (monotone equivalent on a fixed span)."""
    r = orbital_centers(mf, C)
    return -float(np.sum(r**2))


def find_homo_lumo(mf):
    """(e_homo, homo_idx, e_lumo, lumo_idx)
    (reference: pyqed/qchem/mol.py:1528)."""
    if isinstance(mf.mo_energy, (tuple, list)):
        e = np.stack([_host(x) for x in mf.mo_energy])
    else:
        e = _host(mf.mo_energy)
    if e.ndim == 2:                    # UHF: treat spin channels jointly
        na, nb = mf.nocc
        if na >= e[0].size and nb >= e[1].size:
            raise ValueError("find_homo_lumo: no virtual orbitals in "
                             "either spin channel (nocc == nmo)")
        homo = max(e[0][na - 1], e[1][nb - 1] if nb else -np.inf)
        ch = 0 if e[0][na - 1] >= (e[1][nb - 1] if nb else -np.inf) else 1
        ea = e[0][na] if na < e[0].size else np.inf
        eb = e[1][nb] if nb < e[1].size else np.inf
        lumo = min(ea, eb)
        cl = 0 if ea <= eb else 1
        return homo, (ch, (na, nb)[ch] - 1), lumo, (cl, (na, nb)[cl])
    nocc = mf.nocc
    if nocc >= e.size:
        raise ValueError("find_homo_lumo: no virtual orbitals "
                         "(nocc == nmo)")
    return float(e[nocc - 1]), nocc - 1, float(e[nocc]), nocc
