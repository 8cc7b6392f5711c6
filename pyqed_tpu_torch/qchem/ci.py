"""Configuration interaction: FCI and CISD by Slater-Condon rules.

PyTorch counterpart of ``pyqed_tpu/qchem/ci.py`` (reference:
pyqed/qchem/ci/fci.py — ``FCI:363``; pyqed/qchem/ci/cisd.py — ``CISD:370``
with Slater-Condon matrix elements at :99).

Determinants are enumerated on the host (combinatorics); the CI
Hamiltonian is built once there and diagonalized with ``eigh`` on the mean
field's device. Suitable for the small active spaces the reference
targets. The spin-orbital integrals are built on the device by strided
block copies (the JAX package loops over (2n)^4 in Python).
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np
import torch

from .scf import ao2mo


def _tensor(x):
    """``x`` as a float64 tensor (on its own device when it is one)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=float))


def _host(x):
    """``x`` as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def spinorb_ints(hmo, eri_mo):
    """Spin-orbital integrals from spatial MO integrals.

    Ordering: spin-orbital 2p = spatial p alpha, 2p+1 = spatial p beta.
    Returns (h (2n, 2n), antisymmetrized <pq||rs> (2n,)*4 physicists') as
    float64 tensors on the device of ``hmo``; the values equal the JAX
    package's loops' bit for bit: <pq|rs> = (pr|qs) where spin(p) =
    spin(r) and spin(q) = spin(s), else 0, each of the four spin blocks
    written by one strided copy.
    """
    hmo = _tensor(hmo)
    eri = _tensor(eri_mo).to(hmo.device)
    n = hmo.shape[0]
    ns = 2 * n
    h = hmo.new_zeros((ns, ns))
    h[0::2, 0::2] = hmo
    h[1::2, 1::2] = hmo
    # <pq|rs> physicists' = (pr|qs) chemists' with spin delta
    phys = eri.permute(0, 2, 1, 3)
    g = hmo.new_zeros((ns, ns, ns, ns))
    for a in (0, 1):
        for b in (0, 1):
            g[a::2, b::2, a::2, b::2] = phys
    return h, g - g.transpose(2, 3)


def _excitation(det1, det2):
    """(holes, particles) between two determinants (as sorted tuples)."""
    s1, s2 = set(det1), set(det2)
    return sorted(s1 - s2), sorted(s2 - s1)


def _phase(det, removed, added):
    """Fermionic sign for exciting ``removed`` -> ``added``."""
    det = list(det)
    sign = 1
    for r, a in zip(removed, added):
        i = det.index(r)
        det[i] = a
        # count crossings to re-sort
        srt = sorted(det)
        perm = 0
        work = det[:]
        for k in range(len(work)):
            j = work.index(srt[k], k)
            if j != k:
                work[k], work[j] = work[j], work[k]
                perm += 1
        sign *= (-1) ** perm
        det = srt
    return sign


def slater_condon(det1, det2, h, g):
    """<det1|H|det2> by the Slater-Condon rules
    (reference: pyqed/qchem/ci/cisd.py:99)."""
    holes, parts = _excitation(det1, det2)
    ndiff = len(holes)
    if ndiff == 0:
        E = sum(h[p, p] for p in det1)
        E += 0.5 * sum(g[p, q, p, q] for p in det1 for q in det1)
        return E
    if ndiff == 1:
        m, p = holes[0], parts[0]
        sign = _phase(det1, [m], [p])
        val = h[m, p] + sum(g[m, q, p, q] for q in det1 if q != m)
        return sign * val
    if ndiff == 2:
        m, n = holes
        p, q = parts
        sign = _phase(det1, [m, n], [p, q])
        return sign * g[m, n, p, q]
    return 0.0


def enumerate_dets(norb_spin, nelec, ref=None, max_exc=None):
    """All determinants (or up to max_exc excitations from ref)."""
    all_dets = [tuple(sorted(c)) for c in
                itertools.combinations(range(norb_spin), nelec)]
    if max_exc is None:
        return all_dets
    ref_set = set(ref)
    return [d for d in all_dets if len(ref_set - set(d)) <= max_exc]


def build_hamiltonian(dets, h, g):
    """Dense H in a determinant basis via Slater-Condon (shared by CI
    and EOM-CCSD; no nuclear repulsion added)."""
    nd = len(dets)
    H = np.zeros((nd, nd))
    for i in range(nd):
        for j in range(i + 1):
            H[i, j] = H[j, i] = slater_condon(dets[i], dets[j], h, g)
    return H


class CI:
    def __init__(self, mf, max_exc=None):
        self.mf = mf
        self.max_exc = max_exc
        self.e_tot = None
        self.civec = None

    def run(self, nroots=1):
        mf = self.mf
        hmo, eri_mo = mf.mo_ints()
        h, g = (_host(x) for x in spinorb_ints(hmo, eri_mo))
        nelec = self.mf.mol.nelec
        ns = 2 * hmo.shape[0]
        ref = tuple(range(nelec))  # aufbau in spin-orbital ordering? build:
        # occupied spin orbitals: alpha+beta of the lowest nelec//2 spatials
        ref = tuple(sorted([2 * i for i in range(nelec // 2)]
                           + [2 * i + 1 for i in range(nelec // 2)]))
        dets = enumerate_dets(ns, nelec, ref=ref, max_exc=self.max_exc)
        H = build_hamiltonian(dets, h, g)
        w, v = torch.linalg.eigh(torch.as_tensor(H, device=mf.mol.device))
        enuc = mf.mol.energy_nuc()
        self.e_tot = w[:nroots].cpu().numpy() + enuc
        self.civec = v[:, :nroots]
        self.dets = dets
        self.ns = ns
        self.e_corr = float(self.e_tot[0] - mf.e_tot)
        return self.e_tot

    # ------------------------------------------------------- density
    def _rdm1_so(self, root=0):
        """Spin-orbital 1-RDM D[p, q] = <a+_p a_q> over the stored CI
        vector (same sign convention as ``slater_condon``)."""
        c = _host(self.civec)[:, root].real
        dets, ns = self.dets, self.ns
        pos = {d: i for i, d in enumerate(dets)}
        D = np.zeros((ns, ns))
        for j, det in enumerate(dets):
            cj = c[j]
            if abs(cj) < 1e-14:
                continue
            occ = set(det)
            for q in det:
                D[q, q] += cj * cj
                for p in range(ns):
                    if p in occ:
                        continue
                    deti = tuple(sorted((occ - {q}) | {p}))
                    i = pos.get(deti)
                    if i is None:
                        continue
                    D[p, q] += _phase(deti, [p], [q]) * c[i] * cj
        return D

    def make_rdm1(self, root=0, ao_repr=False):
        """Spin-traced 1-RDM in the MO basis (reference:
        pyqed/qchem/dvr/casci.py make_rdm1; here for the GTO CI family).
        ``ao_repr``: transform with the SCF MO coefficients."""
        if self.civec is None:
            self.run(nroots=root + 1)
        Dso = self._rdm1_so(root)
        nmo = self.ns // 2
        D = Dso[0::2, 0::2] + Dso[1::2, 1::2]
        if ao_repr:
            C = _host(self.mf.mo_coeff)[:, :nmo]
            D = C @ D @ C.T
        return D

    def natural_orbitals(self, root=0):
        """(occupations, orbitals): eigen-decomposition of the 1-RDM,
        occupations descending; orbitals returned in the AO basis
        (columns), i.e. mo_coeff rotated by the RDM eigenvectors
        (reference: pyqed/qchem/dvr/casci.py natural_orbitals)."""
        D = self.make_rdm1(root)
        w, V = np.linalg.eigh(D)
        order = np.argsort(w)[::-1]
        w, V = w[order], V[:, order]
        C = _host(self.mf.mo_coeff)[:, :D.shape[0]] @ V
        return w, C


class FCI(CI):
    """(reference: pyqed/qchem/ci/fci.py:363)."""

    def __init__(self, mf):
        super().__init__(mf, max_exc=None)


class CISD(CI):
    """(reference: pyqed/qchem/ci/cisd.py:370)."""

    def __init__(self, mf):
        super().__init__(mf, max_exc=2)


class CASCI(CI):
    """Minimal CASCI: FCI within an active window of spatial orbitals
    (reference: pyqed/qchem/ci/ casci)."""

    def __init__(self, mf, ncas, nelecas):
        super().__init__(mf, max_exc=None)
        self.ncas = ncas
        self.nelecas = nelecas

    def run(self, nroots=1):
        mf = self.mf
        hmo, eri_mo = mf.mo_ints()
        nocc = mf.nocc
        ncore = nocc - self.nelecas // 2
        act = list(range(ncore, ncore + self.ncas))
        hmo = _host(hmo)
        eri = _host(eri_mo)
        # core energy and effective 1e ints
        ecore = 2 * sum(hmo[i, i] for i in range(ncore))
        for i in range(ncore):
            for j in range(ncore):
                ecore += 2 * eri[i, i, j, j] - eri[i, j, j, i]
        heff = np.zeros((self.ncas, self.ncas))
        for ai, a in enumerate(act):
            for bi, b in enumerate(act):
                v = hmo[a, b]
                for c in range(ncore):
                    v += 2 * eri[a, b, c, c] - eri[a, c, c, b]
                heff[ai, bi] = v
        eri_act = eri[np.ix_(act, act, act, act)]
        h, g = (_host(x) for x in spinorb_ints(heff, eri_act))
        dets = enumerate_dets(2 * self.ncas, self.nelecas)
        H = build_hamiltonian(dets, h, g)
        w, v = torch.linalg.eigh(torch.as_tensor(H, device=mf.mol.device))
        self.e_tot = w[:nroots].cpu().numpy() + ecore + mf.mol.energy_nuc()
        self.civec = v[:, :nroots]
        self.dets = dets
        self.ns = 2 * self.ncas
        self.ncore = ncore
        return self.e_tot

    def make_rdm1(self, root=0, ao_repr=False):
        """Spin-traced 1-RDM over ALL MOs: doubly occupied core block +
        the active-space CI density (virtuals zero)."""
        if self.civec is None:
            self.run(nroots=root + 1)
        Dso = self._rdm1_so(root)
        Dact = Dso[0::2, 0::2] + Dso[1::2, 1::2]
        nmo = self.mf.mo_coeff.shape[1]
        D = np.zeros((nmo, nmo))
        nc = self.ncore
        D[:nc, :nc] = 2.0 * np.eye(nc)
        D[nc:nc + self.ncas, nc:nc + self.ncas] = Dact
        if ao_repr:
            C = _host(self.mf.mo_coeff)
            D = C @ D @ C.T
        return D


def dyson_orbital(ci_n, ci_m):
    """Dyson orbital between an N-electron and an (N−1)-electron CI
    state: phi_p = <Psi^{N-1} | a_p | Psi^N> over spin orbitals
    (reference: pyqed/qchem/dyson.py:15 ``dyson_orb_R/L`` — there via
    EOM-CC amplitudes; here directly from determinant expansions).

    ci_n, ci_m : converged CI objects (run() called) sharing the same
    MO set (same mean field). Returns (phi (nso,), norm).
    """
    dets_n = ci_n.dets
    dets_m = ci_m.dets
    cn = _host(ci_n.civec)[:, 0].real
    cm = _host(ci_m.civec)[:, 0].real
    index_m = {d: i for i, d in enumerate(dets_m)}
    nso = 2 * ci_n.mf.mo_coeff.shape[1]
    phi = np.zeros(nso)
    for I, det in enumerate(dets_n):
        for pos, p in enumerate(det):
            rest = det[:pos] + det[pos + 1:]
            J = index_m.get(rest)
            if J is None:
                continue
            sign = (-1.0) ** pos     # a_p moves past `pos` occupied orbs
            phi[p] += sign * cm[J] * cn[I]
    return phi, float(np.linalg.norm(phi))


# ---------------------------------------------------------------------------
# CASSCF — orbital-optimized CASCI by autodiff
# (reference: pyqed/qchem/mol.py names a CASSCF dispatch but no working
# implementation exists in the tree; capability made real here)
# ---------------------------------------------------------------------------

def _slater_condon_terms(det1, det2):
    """Symbolic Slater-Condon: [(kind, idx, coeff)] with kind 'h'/'g',
    so <det1|H|det2> = sum coeff * h[idx] (or g_as[idx]) for ANY ints —
    the fixed sparsity/sign structure that makes the CI matrix a linear
    (hence differentiable) map of the integrals."""
    holes, parts = _excitation(det1, det2)
    ndiff = len(holes)
    terms = []
    if ndiff == 0:
        for p in det1:
            terms.append(("h", (p, p), 1.0))
            for q in det1:
                terms.append(("g", (p, q, p, q), 0.5))
    elif ndiff == 1:
        m, p = holes[0], parts[0]
        sign = _phase(det1, [m], [p])
        terms.append(("h", (m, p), float(sign)))
        for q in det1:
            if q != m:
                terms.append(("g", (m, q, p, q), float(sign)))
    elif ndiff == 2:
        m, n = holes
        p, q = parts
        sign = _phase(det1, [m, n], [p, q])
        terms.append(("g", (m, n, p, q), float(sign)))
    return terms


def _ci_matrix_maps(dets, ns):
    """Precompute gather/scatter maps: H_ci = scatter(coef_h * h[ih]) +
    scatter(coef_g * g[ig]) over the fixed det-pair structure."""
    rows_h, idx_h, coef_h = [], [], []
    rows_g, idx_g, coef_g = [], [], []
    nd = len(dets)
    for i in range(nd):
        for j in range(nd):
            for (kind, idx, c) in _slater_condon_terms(dets[i], dets[j]):
                if kind == "h":
                    rows_h.append(i * nd + j)
                    idx_h.append(idx[0] * ns + idx[1])
                    coef_h.append(c)
                else:
                    p, q, r, s = idx
                    rows_g.append(i * nd + j)
                    idx_g.append(((p * ns + q) * ns + r) * ns + s)
                    coef_g.append(c)
    return (np.array(rows_h), np.array(idx_h), np.array(coef_h),
            np.array(rows_g), np.array(idx_g), np.array(coef_g))


class CASSCF:
    """Complete-active-space SCF: minimizes the CASCI ground-state energy
    over orbital rotations C -> C exp(kappa).

    The WHOLE energy functional — AO->MO transforms, core folding,
    spin-orbital expansion (gathers), CI-matrix assembly (precomputed
    Slater-Condon scatter maps), and the eigensolve — is one
    differentiable torch function on the mean field's device; the orbital
    gradient is autograd through it and ``torch.linalg.matrix_exp`` (no
    hand-derived generalized Fock needed), and L-BFGS drives kappa on the
    host.
    """

    def __init__(self, mf, ncas, nelecas):
        self.mf = mf
        self.ncas = ncas
        self.nelecas = nelecas
        nocc = mf.nocc
        self.ncore = nocc - nelecas // 2
        self.dets = enumerate_dets(2 * ncas, nelecas)
        self._maps = _ci_matrix_maps(self.dets, 2 * ncas)
        self.e_tot = None
        self.mo_coeff = None

    # -------------------------------------------------- energy functional
    def _energy_fn(self):
        mf = self.mf
        hao = mf.hcore
        eri_ao = mf.eri
        C0 = mf.mo_coeff
        dev = C0.device
        n = hao.shape[0]
        ncore, ncas = self.ncore, self.ncas
        act = slice(ncore, ncore + ncas)
        nso = 2 * ncas
        nd = len(self.dets)
        rh, ih, rg, ig = (torch.as_tensor(np.asarray(a, dtype=np.int64),
                                          device=dev)
                          for a in (self._maps[0], self._maps[1],
                                    self._maps[3], self._maps[4]))
        ch, cg = (torch.as_tensor(np.asarray(a, dtype=float), device=dev)
                  for a in (self._maps[2], self._maps[5]))

        # spin-orbital gather indices for the active-space g tensor
        P, Q, R, S = np.meshgrid(*[np.arange(nso)] * 4, indexing="ij")
        spin_ok = ((P % 2 == R % 2) & (Q % 2 == S % 2)).astype(float)
        eri_idx = (((P // 2) * ncas + (R // 2)) * ncas
                   + (Q // 2)) * ncas + (S // 2)
        spin_ok = torch.as_tensor(spin_ok.reshape(-1), device=dev)
        eri_idx = torch.as_tensor(eri_idx.reshape(-1), device=dev)

        tril = np.tril_indices(n, -1)
        tril_t = tuple(torch.as_tensor(t, device=dev) for t in tril)
        eye2 = torch.eye(2, dtype=torch.float64, device=dev)
        enuc = mf.mol.energy_nuc()
        nact_tot = ncore + ncas

        def energy(kappa):
            K = kappa.new_zeros((n, n)).index_put(tril_t, kappa)
            K = K - K.T
            C = C0 @ torch.linalg.matrix_exp(K)
            # only the core+active block of the MO integrals is consumed:
            # transform with the truncated C (n x (ncore+ncas)) so each
            # L-BFGS evaluation is (ncore+ncas)^4, not n^4
            Csub = C[:, :nact_tot]
            hmo = Csub.T @ hao @ Csub
            eri_mo = ao2mo(eri_ao, Csub)
            # fold the doubly-occupied core
            core = eri_mo[:ncore, :ncore, :ncore, :ncore]
            ecore = 2 * torch.trace(hmo[:ncore, :ncore])
            ecore = ecore + 2 * torch.einsum("iijj ->", core)
            ecore = ecore - torch.einsum("ijji ->", core)
            heff = (hmo[act, act]
                    + 2 * torch.einsum("abcc -> ab",
                                       eri_mo[act, act, :ncore, :ncore])
                    - torch.einsum("accb -> ab",
                                   eri_mo[act, :ncore, :ncore, act]))
            eri_act = eri_mo[act, act, act, act]
            # spin-orbital expansion by gather
            h_so = torch.kron(heff, eye2)
            g = (spin_ok * eri_act.reshape(-1)[eri_idx]).reshape((nso,) * 4)
            g_as = g - g.transpose(2, 3)
            # CI matrix via the precomputed Slater-Condon maps
            Hci = kappa.new_zeros(nd * nd)
            Hci = Hci.index_add(0, rh, ch * h_so.reshape(-1)[ih])
            Hci = Hci.index_add(0, rg, cg * g_as.reshape(-1)[ig])
            w = torch.linalg.eigvalsh(Hci.reshape(nd, nd))
            return w[0] + ecore + enuc

        return energy, tril, n

    def run(self, maxiter=200, tol=1e-10):
        import scipy.linalg
        import scipy.optimize
        energy, tril, n = self._energy_fn()
        dev = self.mf.mo_coeff.device

        def fun(x):
            kappa = torch.as_tensor(x, device=dev).requires_grad_(True)
            e = energy(kappa)
            (g,) = torch.autograd.grad(e, kappa)
            return float(e.detach()), g.cpu().numpy()

        x0 = np.zeros(len(tril[0]))
        res = scipy.optimize.minimize(
            fun, x0, jac=True, method="L-BFGS-B", tol=tol,
            options={"maxiter": maxiter})
        self.e_tot = float(res.fun)
        K = np.zeros((n, n))
        K[tril] = res.x
        K = K - K.T
        self.mo_coeff = _host(self.mf.mo_coeff) @ scipy.linalg.expm(K)
        self.converged = bool(res.success)
        return self.e_tot


# ---------------------------------------------------------------------------
# Unrestricted CI (UCISD / UFCI) on a UHF reference
# (reference: pyqed/qchem/ci/cisd.py ``UCISD`` — pyscf-backed there;
# self-contained here on our own UHF + spin-orbital Slater-Condon)
# ---------------------------------------------------------------------------

def spinorb_ints_uhf(mf):
    """Spin-orbital (h, antisymmetrized <pq||rs>) from a UHF reference:
    2p = alpha spatial p, 2p+1 = beta spatial p, with per-spin MO
    coefficient matrices (Ca, Cb)."""
    Ca, Cb = mf.mo_coeff
    hao = mf.hcore
    eri = mf.eri                      # AO chemists (pq|rs)
    n = hao.shape[0]
    ns = 2 * n
    h = hao.new_zeros((ns, ns))
    h[0::2, 0::2] = Ca.T @ hao @ Ca
    h[1::2, 1::2] = Cb.T @ hao @ Cb

    def mo_eri(C1, C2):
        # chemists (p q | r s) with bra-pair in C1 basis, ket-pair in C2
        return ao2mo(eri, C1, C1, C2, C2)

    g = hao.new_zeros((ns, ns, ns, ns))
    # physicists <pq|rs> = chemists (pr|qs), spin(p)=spin(r), spin(q)=spin(s)
    blocks = {(0, 0): (Ca, Ca), (0, 1): (Ca, Cb), (1, 0): (Cb, Ca),
              (1, 1): (Cb, Cb)}
    for (sp, sq), (C1, C2) in blocks.items():
        g[sp::2, sq::2, sp::2, sq::2] = mo_eri(C1, C2).permute(0, 2, 1, 3)
    return h, g - g.transpose(2, 3)


class UCI(CI):
    """CI on a UHF reference; max_exc=None -> UFCI, 2 -> UCISD."""

    def run(self, nroots=1):
        mf = self.mf
        h, g = (_host(x) for x in spinorb_ints_uhf(mf))
        na, nb = mf.nocc
        ns = h.shape[0]
        ref = tuple(sorted([2 * i for i in range(na)]
                           + [2 * i + 1 for i in range(nb)]))
        dets = enumerate_dets(ns, na + nb, ref=ref, max_exc=self.max_exc)
        H = build_hamiltonian(dets, h, g)
        w, v = torch.linalg.eigh(torch.as_tensor(H, device=mf.mol.device))
        enuc = mf.mol.energy_nuc()
        self.e_tot = w[:nroots].cpu().numpy() + enuc
        self.civec = v[:, :nroots]
        self.dets = dets
        self.e_corr = float(self.e_tot[0] - mf.e_tot)
        return self.e_tot


class UCISD(UCI):
    def __init__(self, mf):
        super().__init__(mf, max_exc=2)


class UFCI(UCI):
    def __init__(self, mf):
        super().__init__(mf, max_exc=None)
