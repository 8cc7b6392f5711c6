"""Lattice models: tight-binding chains, Fermi- and Bose-Hubbard chains,
Jordan-Wigner and Bravyi-Kitaev encodings (PyTorch).

PyTorch counterpart of ``pyqed_tpu/models/lattice.py`` (reference:
pyqed/lattice/hubbard.py ``FermiHubbard:30``, ``BoseHubbard:222``;
pyqed/lattice/chain.py; pyqed/qchem/jordan_wigner/). Hamiltonians are
dense tensors on ``device`` (the card when None; raises without one),
diagonalized there with ``torch.linalg.eigh``. The Fermi-Hubbard
Hamiltonian is assembled directly in the occupation basis of the
Jordan-Wigner encoding (the same matrix as the products of the dense
Jordan-Wigner operators, built by index arithmetic in O(4^L) and not by
dense products of 4^L x 4^L matrices); small index sets, the
Bravyi-Kitaev matrices and the tight-binding matrices are host set-up.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import dag, tensor
from ..ops.operators import destroy, pauli


def jordan_wigner_ops(nmodes, device=None):
    """Fermionic annihilation operators on nmodes spin-orbitals through
    the Jordan-Wigner transformation, c_j = (prod_{k<j} Z_k) sigma^-_j
    (reference: pyqed/qchem/jordan_wigner/spinful.py:231), dense on
    ``device`` (the card when None)."""
    dev = resolve_device(device)
    s0, _, _, sz = (m.to(dev) for m in pauli())
    sm = torch.tensor([[0.0, 1.0], [0.0, 0.0]], dtype=torch.complex128,
                      device=dev)                       # |0><1|
    return [tensor([sz] * j + [sm] + [s0] * (nmodes - j - 1))
            for j in range(nmodes)]


def _fenwick_tree(n):
    """Fenwick-tree parent map over modes 0..n-1 (root = n-1): the
    recursive bisection of the Bravyi-Kitaev encoding."""
    parent = {}
    children = {i: [] for i in range(n)}

    def build(left, right):
        if left >= right:
            return
        pivot = (left + right) >> 1
        parent[pivot] = right
        children[right].append(pivot)
        build(left, pivot)
        build(pivot + 1, right)

    if n > 0:
        build(0, n - 1)
    return parent, children


def bravyi_kitaev_sets(j, n):
    """Update / flip / parity / remainder index sets of mode j of n
    (Seeley-Richard-Love conventions on a Fenwick tree, any n)."""
    parent, children = _fenwick_tree(n)
    U = set()
    k = j
    while k in parent:
        k = parent[k]
        U.add(k)
    F = set(children[j])
    P = set(c for c in children[j] if c < j)
    k = j
    while k in parent:
        k = parent[k]
        P |= set(c for c in children[k] if c < j)
    return U, F, P, P - F


def bravyi_kitaev_ops(nmodes, device=None):
    """Fermionic annihilation operators in the Bravyi-Kitaev encoding,
    a_j = 1/2 X_{U(j)} (X_j Z_{P(j)} + i Y_j Z_{R(j)}), built on the host
    and returned as dense tensors on ``device`` (the card when None)."""
    dev = resolve_device(device)
    _, sx, sy, sz = (m.numpy() for m in pauli())
    eye = np.eye(2, dtype=complex)

    def pauli_string(spec):
        out = spec.get(0, eye)
        for q in range(1, nmodes):
            out = np.kron(out, spec.get(q, eye))
        return out

    ops = []
    for j in range(nmodes):
        U, F, P, R = bravyi_kitaev_sets(j, nmodes)
        spec_x = {q: sx for q in U}
        spec_x[j] = sx
        spec_x.update({q: sz for q in P})
        spec_y = {q: sx for q in U}
        spec_y[j] = sy
        spec_y.update({q: sz for q in R})
        a = 0.5 * (pauli_string(spec_x) + 1j * pauli_string(spec_y))
        ops.append(torch.as_tensor(a, device=dev))
    return ops


def bravyi_kitaev_matrix(n):
    """The (n, n) binary BK encoding matrix B (NumPy): qubit bits
    b = B x mod 2 of the mode occupations x."""
    _, children = _fenwick_tree(n)

    def subtree(i):
        out = {i}
        for c in children[i]:
            out |= subtree(c)
        return out

    B = np.zeros((n, n), dtype=int)
    for i in range(n):
        for jx in subtree(i):
            B[i, jx] = 1
    return B


bravyi_kitaev_transform = bravyi_kitaev_ops    # reference drop-in name


def _occupations(nmodes):
    """(2^nmodes, nmodes) occupation bits of the Jordan-Wigner basis:
    mode 0 is the leading factor of the Kronecker product, and an
    occupied mode is its basis state 1 (c_j = ... sigma^-_j = |0><1|)."""
    s = np.arange(2 ** nmodes)
    return (s[:, None] >> (nmodes - 1 - np.arange(nmodes))[None, :]) & 1


def _hop(occ, a, b):
    """Rows, columns and signs of c†_a c_b (a != b) in the occupation
    basis: |n> -> sign |n - e_b + e_a> where n_b = 1 and n_a = 0."""
    nmodes = occ.shape[1]
    ok = (occ[:, b] == 1) & (occ[:, a] == 0)
    src = np.nonzero(ok)[0]
    n1 = occ[src].copy()
    sign = (-1.0) ** n1[:, :b].sum(axis=1)      # c_b: Z on modes < b
    n1[:, b] = 0
    sign = sign * (-1.0) ** n1[:, :a].sum(axis=1)   # c†_a on the result
    n1[:, a] = 1
    dst = n1 @ (1 << (nmodes - 1 - np.arange(nmodes)))
    return dst, src, sign


class FermiHubbard:
    """Spin-half Fermi-Hubbard chain by the Jordan-Wigner encoding and
    dense diagonalization (reference: pyqed/lattice/hubbard.py:30),

    H = -t sum_{<ij>s} (c†_is c_js + hc) + U sum_i n_iu n_id - mu sum_i n_i,

    modes ordered (site0 up, site0 dn, site1 up, ...), on ``device`` (the
    card when None)."""

    def __init__(self, t, U, nsites, filling=None, nelec=None, mu=None,
                 device=None):
        self.device = resolve_device(device)
        self.t = t
        self.U = U
        self.mu = mu or 0.0
        self.L = self.nsites = nsites
        self.d = 4
        self.nelec = nelec
        self.H = None
        self.e_tot = None
        self.eigvecs = None

    def jordan_wigner(self):
        """The dense Hamiltonian (reference: pyqed/lattice/hubbard.py:115),
        complex128 on the device: the hopping entries placed by index
        arithmetic, the diagonal from the occupations."""
        n = 2 * self.nsites
        occ = _occupations(n)
        dim = occ.shape[0]
        rows, cols, vals = [], [], []
        for i in range(self.nsites - 1):
            for s in (0, 1):
                a, b = 2 * i + s, 2 * (i + 1) + s
                for x, y in ((a, b), (b, a)):
                    dst, src, sign = _hop(occ, x, y)
                    rows.append(dst)
                    cols.append(src)
                    vals.append(-self.t * sign)
        nu, nd = occ[:, 0::2], occ[:, 1::2]
        diag = (self.U * (nu * nd).sum(axis=1)
                - self.mu * occ.sum(axis=1)).astype(float)
        dev = self.device
        H = torch.zeros((dim, dim), dtype=torch.complex128, device=dev)
        H.diagonal().copy_(torch.as_tensor(diag, device=dev))
        if rows:
            r = torch.as_tensor(np.concatenate(rows), device=dev)
            c = torch.as_tensor(np.concatenate(cols), device=dev)
            H.index_put_((r, c), torch.as_tensor(
                np.concatenate(vals), device=dev).to(H.dtype),
                accumulate=True)
        self.H = H
        self._occ = occ
        return H

    def number_operator(self):
        """Total particle number, diagonal in the occupation basis."""
        if self.H is None:
            self.jordan_wigner()
        return torch.diag(torch.as_tensor(
            self._occ.sum(axis=1).astype(float),
            device=self.device)).to(torch.complex128)

    def run(self, nstates=1):
        """The lowest ``nstates`` energies (and ``eigvecs``), of the
        ``nelec`` sector when it is set: H commutes with the particle
        number, which is diagonal in the occupation basis, so the sector
        is the block of the basis states with ``nelec`` particles and is
        diagonalized on its own. (The JAX package diagonalizes the whole H
        and keeps the eigenvectors of integer occupation, which drops the
        sector's states that are degenerate with another sector's: their
        eigenvectors come out mixed.)"""
        if self.H is None:
            self.jordan_wigner()
        if self.nelec is None:
            w, v = torch.linalg.eigh(self.H)
        else:
            idx = torch.as_tensor(np.nonzero(
                self._occ.sum(axis=1) == self.nelec)[0], device=self.device)
            w, u = torch.linalg.eigh(self.H[idx][:, idx])
            v = self.H.new_zeros((self.H.shape[0], u.shape[1]))
            v[idx] = u
        self.e_tot = w[:nstates]
        self.eigvecs = v[:, :nstates]
        return self.e_tot


class BoseHubbard:
    """Bose-Hubbard chain (reference: pyqed/lattice/hubbard.py:222):
    H = -t sum (b†_i b_{i+1} + hc) + U/2 sum n(n-1) - mu sum n with the
    local truncation nmax, on ``device`` (the card when None)."""

    def __init__(self, t, U, nsites, nmax=3, mu=0.0, device=None):
        self.device = resolve_device(device)
        self.t = t
        self.U = U
        self.mu = mu
        self.nsites = nsites
        self.nmax = nmax
        self.H = None

    def buildH(self):
        d = self.nmax + 1
        b1 = destroy(d).to(self.device)
        n1 = dag(b1) @ b1
        I = torch.eye(d, dtype=b1.dtype, device=self.device)

        def embed(op, i):
            ops = [I] * self.nsites
            ops[i] = op
            return tensor(ops)

        bs = [embed(b1, i) for i in range(self.nsites)]
        H = 0.0
        for i in range(self.nsites - 1):
            H = H - self.t * (dag(bs[i]) @ bs[i + 1] + dag(bs[i + 1]) @ bs[i])
        for i in range(self.nsites):
            ni = embed(n1, i)
            H = H + 0.5 * self.U * ni @ (ni - embed(I, i)) - self.mu * ni
        self.H = H
        return H

    def run(self, nstates=1):
        if self.H is None:
            self.buildH()
        return torch.linalg.eigvalsh(self.H)[:nstates]


# ---------------------------------------------------------------------------
# Real-space tight-binding models (reference: pyqed/lattice/chain.py)
# ---------------------------------------------------------------------------

class Chain:
    """Open or periodic 1D tight-binding chain with norb orbitals per cell
    (reference: pyqed/lattice/chain.py:21), with its lattice and surface
    Green's functions. H is built on the host and kept on ``device`` (the
    card when None)."""

    def __init__(self, nsite, onsite, hopping, norb=1,
                 boundary_condition="open", device=None):
        self.device = resolve_device(device)
        self.nsite = nsite
        self.norb = norb
        self.size = nsite * norb
        self.onsite = np.atleast_1d(np.asarray(onsite, dtype=float))
        self.hopping = np.asarray(hopping)
        self.boundary_condition = boundary_condition
        self.H = None
        self.evals = self.evecs = None

    def position(self):
        """Cell-index position operator in the Wannier basis
        (reference: pyqed/lattice/chain.py:57)."""
        idx = np.repeat(np.arange(1, self.nsite + 1), self.norb)
        return torch.diag(torch.as_tensor(idx, dtype=torch.float64,
                                          device=self.device))

    def buildH(self):
        norb, nsite = self.norb, self.nsite
        H = np.zeros((self.size, self.size))
        if norb == 1:
            on = np.broadcast_to(self.onsite, (nsite,))
            H[np.arange(nsite), np.arange(nsite)] = on
            t = float(self.hopping)
            for n in range(nsite - 1):
                H[n, n + 1] = H[n + 1, n] = t
            if self.boundary_condition == "periodic" and nsite > 2:
                H[0, -1] = H[-1, 0] = t
        else:
            hop = self.hopping
            if hop.shape != (norb, norb):
                raise ValueError(f"hopping {hop.shape} != ({norb}, {norb})")
            for n in range(nsite):
                for j in range(norb):
                    H[norb * n + j, norb * n + j] = self.onsite[j]
            for n in range(nsite - 1):
                H[norb * n:norb * (n + 1),
                  norb * (n + 1):norb * (n + 2)] = hop
                H[norb * (n + 1):norb * (n + 2),
                  norb * n:norb * (n + 1)] = hop.conj().T
            if self.boundary_condition == "periodic" and nsite > 2:
                H[norb * (nsite - 1):, :norb] = hop
                H[:norb, norb * (nsite - 1):] = hop.conj().T
        self.H = torch.as_tensor(H, device=self.device)
        return self.H

    def run(self):
        if self.H is None:
            self.buildH()
        self.evals, self.evecs = torch.linalg.eigh(self.H)
        return self.evals, self.evecs

    def gf(self, omega, eta=1e-4):
        """Retarded lattice GF G(w) = (w + i eta - H)^{-1}, one batched
        solve over the frequency grid."""
        if self.H is None:
            self.buildH()
        dev = self.device
        omega = torch.atleast_1d(torch.as_tensor(np.asarray(omega, float),
                                                 device=dev))
        n = self.size
        eye = torch.eye(n, dtype=torch.complex128, device=dev)
        A = (omega[:, None, None] + 1j * eta) * eye[None] - self.H[None]
        G = torch.linalg.solve(A, eye.expand(A.shape))
        return G[0] if G.shape[0] == 1 else G

    def ldos(self, omega, eta=1e-4, site=0):
        """-Im G_ii(w)/pi local density of states."""
        G = self.gf(omega, eta)
        if G.dim() == 2:
            return float(-G[site, site].imag / np.pi)
        return -G[:, site, site].imag / np.pi

    def gf_surface(self, energy=0.0, delta=1e-3, max_iter=100):
        """Semi-infinite surface and bulk GF of the chain's repeating cell."""
        if self.norb == 1:
            intra = np.array([[float(np.broadcast_to(self.onsite, (1,))[0])]])
            inter = np.array([[float(self.hopping)]])
        else:
            intra = np.diag(self.onsite).astype(complex)
            inter = np.asarray(self.hopping, dtype=complex)
        return green_renormalization(intra, inter, energy=energy,
                                     delta=delta, max_iter=max_iter,
                                     device=self.device)


class RiceMele(Chain):
    """Rice-Mele / SSH dimerized chain (reference:
    pyqed/lattice/chain.py:290); ``nsites`` counts orbitals."""

    def __init__(self, v, w, nsites=None, boundary_condition="open",
                 device=None):
        self.device = resolve_device(device)
        self.intra = v
        self.inter = w
        self.norb = 2
        self.nsite = self.nsites = nsites
        self.size = nsites
        self.boundary_condition = boundary_condition
        self.H = None
        self.evals = self.evecs = None

    def buildH(self):
        n = self.nsite
        H = np.zeros((n, n))
        for i in range(0, n - 1, 2):
            H[i, i + 1] = H[i + 1, i] = self.intra
        for i in range(1, n - 1, 2):
            H[i, i + 1] = H[i + 1, i] = self.inter
        self.H = torch.as_tensor(H, device=self.device)
        return self.H

    def position(self):
        """Cell-index position operator: orbital j sits in cell j//2 + 1."""
        idx = np.arange(self.nsite) // 2 + 1
        return torch.diag(torch.as_tensor(idx, dtype=torch.float64,
                                          device=self.device))

    def band_structure(self, k=None):
        """Analytic two-band dispersion E(k) = ±|v + w e^{ik}|."""
        if k is None:
            k = np.linspace(-np.pi, np.pi, 101)
        k = torch.as_tensor(np.asarray(k, float), device=self.device)
        e = (self.intra + self.inter * torch.exp(1j * k)).abs()
        return torch.stack([-e, e], dim=-1)

    def gf_surface(self, energy=0.0, delta=1e-3, max_iter=100):
        intra = np.array([[0.0, self.intra], [self.intra, 0.0]], complex)
        inter = np.array([[0.0, 0.0], [self.inter, 0.0]], complex)
        return green_renormalization(intra, inter, energy=energy,
                                     delta=delta, max_iter=max_iter,
                                     device=self.device)


class Lattice2D:
    """Finite 2D lattice with per-orbital offsets and bond hoppings
    (reference: pyqed/lattice/chain.py:158 ``Lattice``); H on ``device``
    (the card when None)."""

    def __init__(self, size=(2, 2), norb=1, lattice_vectors=None,
                 orb_coords=None, device=None):
        self.device = resolve_device(device)
        self.size = tuple(size)
        self.norb = norb
        self.nsites = self.size[0] * self.size[1] * norb
        self.lattice_vectors = (np.eye(2) if lattice_vectors is None
                                else np.asarray(lattice_vectors))
        self.orb_coords = (np.zeros((norb, 2)) if orb_coords is None
                           else np.asarray(orb_coords))
        self._hops = []       # (J, a, b, R, boundary_condition)
        self._onsite = np.zeros(norb)
        self.H = None

    def index(self, i, j, n):
        nx, ny = self.size
        return (i % nx) * ny * self.norb + (j % ny) * self.norb + n

    def set_onsite(self, e):
        self._onsite = np.broadcast_to(np.asarray(e, float), (self.norb,))
        return self

    def set_hop(self, J, a, b, R, boundary_condition="open"):
        """Hopping J between orbital a in cell (i, j) and orbital b in
        cell (i, j) + R."""
        self._hops.append((J, a, b, tuple(R), boundary_condition))
        return self

    def buildH(self):
        nx, ny = self.size
        H = np.zeros((self.nsites, self.nsites), complex)
        for i in range(nx):
            for j in range(ny):
                for n in range(self.norb):
                    H[self.index(i, j, n), self.index(i, j, n)] = \
                        self._onsite[n]
        for (J, a, b, R, bc) in self._hops:
            for i in range(nx):
                for j in range(ny):
                    ii, jj = i + R[0], j + R[1]
                    wraps = not (0 <= ii < nx and 0 <= jj < ny)
                    if bc == "open" and wraps:
                        continue
                    # periodic wrap only for more than two cells along the
                    # wrapped direction (no doubled bond of a 2-cell ring,
                    # no self-bond of a 1-cell ring)
                    if wraps and ((R[0] and nx <= 2) or (R[1] and ny <= 2)):
                        continue
                    p, q = self.index(i, j, a), self.index(ii, jj, b)
                    H[p, q] += J
                    H[q, p] += np.conj(J)
        self.H = torch.as_tensor(H, device=self.device)
        return self.H

    def solve(self):
        if self.H is None:
            self.buildH()
        return torch.linalg.eigh(self.H)


def green_renormalization(intra, inter, energy=0.0, delta=1e-3,
                          max_iter=100, tol_scale=1e-6, device=None):
    """Sancho-Rubio decimation: bulk and surface GF of a semi-infinite
    chain of identical cells (reference: pyqed/lattice/chain.py:451,
    J. Phys. F 15, 851 (1985) Eq. 11), a fixed number of iterations of
    ``torch.linalg.inv_ex`` (no host read), on ``device`` (the card when
    None). Returns (g_bulk, g_surf)."""
    dev = resolve_device(device)
    intra = torch.as_tensor(np.asarray(intra), device=dev).to(
        torch.complex128)
    inter = torch.as_tensor(np.asarray(inter), device=dev).to(
        torch.complex128)
    n = intra.shape[0]
    e = (energy + 1j * abs(delta)) * torch.eye(n, dtype=torch.complex128,
                                               device=dev)
    alpha, beta, eps, eps_s = inter, inter.mH, intra, intra
    for _ in range(max_iter):
        einv = torch.linalg.inv_ex(e - eps)[0]
        eps_s = eps_s + alpha @ einv @ beta
        eps = eps + alpha @ einv @ beta + beta @ einv @ alpha
        alpha, beta = alpha @ einv @ alpha, beta @ einv @ beta
    return (torch.linalg.inv_ex(e - eps)[0],
            torch.linalg.inv_ex(e - eps_s)[0])


Lattice = Lattice2D        # reference drop-in name (pyqed/lattice/chain.py:158)
