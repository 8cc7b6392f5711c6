"""Time-dependent SCF: TDA (CIS), TDHF (RPA), and TDDFT excitation
energies.

PyTorch counterpart of ``pyqed_tpu/qchem/tdscf.py`` (reference:
pyqed/qchem/tdscf/, pyqed/qchem/core.py:444 — TDHF/TDA + core-excitation
RXS variants; the reference reaches TDDFT through pyscf,
pyqed/qchem/mol.py:817).

The A/B response matrices are built from the MO-basis ERIs and
diagonalized on the mean field's device. Kohn-Sham mean-fields get the
adiabatic LDA XC kernel f_xc = d^2 e_xc / d rho^2 by ``torch.func``
autodiff of the SAME
energy density used in the ground-state SCF (no hand-derived kernel);
the GGA/hybrid singlet kernel comes from the same autodiff applied to
the total-density channel F(rho, sigma) with grad-rho chain terms, and
the triplet kernel from the spin-resolved Hessian of
f(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb) in the spin-flip
direction (cross-validated against finite differences of the UKS
potential in tests).
"""
from __future__ import annotations

import numpy as np
import torch

from .scf import ao2mo


def _mo_blocks(mf):
    """(eri_mo, mo_energy, nocc, nvir) on the mean field's device."""
    hmo, eri_mo = mf.mo_ints()
    nocc = mf.nocc
    nmo = hmo.shape[0]
    nvir = nmo - nocc
    return eri_mo, mf.mo_energy, nocc, nvir


def _is_ks(mf):
    return hasattr(mf, "f_exc")


def _hfx(mf):
    """Fraction of exact exchange in the response kernel: 1 for HF."""
    return float(mf.hfx) if _is_ks(mf) else 1.0


def xc_kernel_ov(mf, singlet=True):
    """Adiabatic LDA XC kernel in the occ-virt product basis:
    K_{ia,jb} = sum_g w_g [f_aa +- f_ab](rho_g) phi_i phi_a phi_j phi_b
    (+ singlet, - triplet) with f_ss' = d^2 e_xc / d rho_s d rho_s' at
    rho_a = rho_b = rho/2, autodiffed (``torch.func``) from the
    ground-state energy density; the GGA/hybrid kernels likewise from
    ``mf.f_exc``. Computed on the mean field's device."""
    from .dft import _exc_density, _density_on_grid, _grad_density
    from torch.func import grad, jvp, vmap
    ao, w = mf.ao, mf.grid[1]
    D = mf.dm
    rho = torch.clamp(_density_on_grid(ao, D), min=1e-12)
    C = mf.mo_coeff
    mo = ao @ C                               # (P, nmo)
    nocc = mf.nocc
    phi = torch.einsum("pi, pa -> pia", mo[:, :nocc], mo[:, nocc:])
    nov = phi.shape[1] * phi.shape[2]
    phi2 = phi.reshape(phi.shape[0], nov)

    def bilinear(wk, a, b):
        """sum_p wk[p] a[p, ia] b[p, jb] -> (nov, nov)."""
        return a.reshape(a.shape[0], -1).T @ (
            b.reshape(b.shape[0], -1) * wk[:, None])

    if not mf._needs_grad:                    # ---- LDA
        faa = vmap(grad(grad(_exc_density, 0), 0))
        fab = vmap(grad(grad(_exc_density, 0), 1))
        sgn = 1.0 if singlet else -1.0
        k = faa(rho / 2, rho / 2) + sgn * fab(rho / 2, rho / 2)
        return bilinear(w * k, phi2, phi2)
    # ---- GGA / hybrid-DFT part ----
    gao = mf.ao_grad                          # (P, nao, 3)
    grho = _grad_density(gao, ao, D)
    sigma = torch.clamp(torch.sum(grho * grho, dim=1), min=1e-24)
    # MO-product values and gradients on the grid
    gmo = torch.einsum("pid, ij -> pjd", gao, C)        # (P, nmo, 3)
    gphi = (torch.einsum("pid, pa -> piad", gmo[:, :nocc], mo[:, nocc:])
            + torch.einsum("pi, pad -> piad", mo[:, :nocc],
                           gmo[:, nocc:]))               # (P, i, a, 3)

    def grad_bilinear(wk, g1, g2):
        """sum_p wk[p] g1[p, ia, :] . g2[p, jb, :] -> (nov, nov)."""
        return sum(bilinear(wk, g1[..., d], g2[..., d]) for d in range(3))

    if singlet:
        # singlet = total-density channel: E = int F(rho, sigma),
        # sigma = |grad rho|^2; perturbing rho -> rho + eps*u gives
        # K[u, u'] = int [F_rr u u' + F_rs (u s' + s u') + F_ss s s'
        #                 + 2 F_s grad u . grad u'],
        # s = 2 grad rho . grad u
        def F(r, s):
            return mf.f_exc(r / 2, r / 2, s / 4, s / 4, s / 4)

        Fs = vmap(grad(F, 1))
        Frr = vmap(grad(grad(F, 0), 0))
        Frs = vmap(grad(grad(F, 0), 1))
        Fss = vmap(grad(grad(F, 1), 1))
        fs, frr, frs, fss = (f(rho, sigma) for f in (Fs, Frr, Frs, Fss))
        s_ia = 2.0 * torch.einsum("pd, piad -> pia", grho, gphi)
        K = (bilinear(w * frr, phi, phi)
             + bilinear(w * frs, phi, s_ia)
             + bilinear(w * frs, s_ia, phi)
             + bilinear(w * fss, s_ia, s_ia)
             + 2.0 * grad_bilinear(w * fs, gphi, gphi))
        # spin adaptation: the singlet matrix element is the
        # spin-resolved sum f_aa + f_ab = 2 x the total-density kernel
        # (same convention that pairs 2(ia|jb) Coulomb with the LDA
        # faa+fab above)
        return 2.0 * K
    # triplet = spin-flip channel delta rho_a = -delta rho_b = u at the
    # closed-shell point. In the spin-resolved variables
    # v = (rho_a, rho_b, s_aa, s_ab, s_bb): d(s_aa) = grad rho . grad u
    # = s, d(s_bb) = -s, d(s_ab) = 0, and the second variations give
    # (2 f_saa - f_sab) grad u . grad u'. Half the bilinear form (the
    # same normalization that makes the LDA channel f_aa - f_ab):
    # K^T[u,u'] = int [(f_aa - f_ab) u u'
    #                  + (f_{ra,saa} - f_{ra,sbb})(u s' + s u')
    #                  + (f_{saa,saa} - f_{saa,sbb}) s s'
    #                  + (2 f_saa - f_sab) grad u . grad u']
    def f5(vec):
        return mf.f_exc(vec[0], vec[1], vec[2], vec[3], vec[4])

    pts = torch.stack([rho / 2, rho / 2, sigma / 4, sigma / 4, sigma / 4],
                      dim=1)                               # (P, 5)
    # only two Hessian-vector products are needed (not the full 5x5
    # Hessian): H d1 with d1 = e_ra - e_rb gives c_uu, and H d2 with
    # d2 = e_saa - e_sbb gives c_us and c_ss; the jvp also returns the
    # primal gradient for c_gg
    d1 = rho.new_tensor([1.0, -1.0, 0.0, 0.0, 0.0])
    d2 = rho.new_tensor([0.0, 0.0, 1.0, 0.0, -1.0])

    def hvps(p):
        _, hd1 = jvp(grad(f5), (p,), (d1,))
        g, hd2 = jvp(grad(f5), (p,), (d2,))
        return g, hd1, hd2

    g1, Hd1, Hd2 = vmap(hvps)(pts)
    c_uu = Hd1[:, 0]                      # f_aa - f_ab
    c_us = Hd2[:, 0]                      # f_{ra,saa} - f_{ra,sbb}
    c_ss = Hd2[:, 2]                      # f_{saa,saa} - f_{saa,sbb}
    c_gg = 2.0 * g1[:, 2] - g1[:, 3]
    s_ia = torch.einsum("pd, piad -> pia", grho, gphi)     # (P, i, a)
    return (bilinear(w * c_uu, phi, phi)
            + bilinear(w * c_us, phi, s_ia)
            + bilinear(w * c_us, s_ia, phi)
            + bilinear(w * c_ss, s_ia, s_ia)
            + grad_bilinear(w * c_gg, gphi, gphi))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def tda_matrix(mf, singlet=True):
    """A_{ia, jb} = delta (e_a - e_i) + 2(ia|jb) - c_x (ij|ab) [+ f_xc]
    (singlet) — c_x = 1 for HF, the hybrid fraction for KS; KS adds the
    adiabatic XC kernel (LDA/GGA/hybrid, both spin channels). Triplet:
    no Coulomb, same exchange, spin-flip f_xc. A tensor on the mean
    field's device."""
    eri, e, nocc, nvir = _mo_blocks(mf)
    o = slice(0, nocc)
    v = slice(nocc, nocc + nvir)
    ov = eri[o, v, o, v]          # (ia|jb)
    oo_vv = eri[o, o, v, v]       # (ij|ab)
    de = (e[None, nocc:] - e[:nocc, None])   # (i, a)
    A = torch.einsum("ia, ij, ab -> iajb", de, _eye(nocc, de),
                     _eye(nvir, de))
    cx = _hfx(mf)
    if singlet:
        A = A + 2.0 * ov - cx * oo_vv.permute(0, 2, 1, 3)
    else:
        A = A - cx * oo_vv.permute(0, 2, 1, 3)
    A = A.reshape(nocc * nvir, nocc * nvir)
    if _is_ks(mf):
        A = A + xc_kernel_ov(mf, singlet)
    return A


def b_matrix(mf, singlet=True):
    """B_{ia, jb} = 2(ia|jb) - c_x (ib|ja) [+ f_xc] (singlet)."""
    eri, e, nocc, nvir = _mo_blocks(mf)
    o = slice(0, nocc)
    v = slice(nocc, nocc + nvir)
    ov = eri[o, v, o, v]
    ov_swap = ov.permute(0, 3, 2, 1)  # (ib|ja)
    cx = _hfx(mf)
    if singlet:
        B = 2.0 * ov - cx * ov_swap
    else:
        B = -cx * ov_swap
    B = B.reshape(ov.shape[0] * ov.shape[1], -1)
    if _is_ks(mf):
        B = B + xc_kernel_ov(mf, singlet)
    return B


class TDA:
    """CIS/TDA excitations (reference: pyqed/qchem/tdscf)."""

    def __init__(self, mf, singlet=True):
        self.mf = mf
        self.singlet = singlet
        self.e = None
        self.xy = None

    def run(self, nroots=5):
        A = tda_matrix(self.mf, self.singlet)
        w, X = torch.linalg.eigh(A)
        self.e = w[:nroots].cpu().numpy()
        self.xy = X[:, :nroots]
        return self.e

    kernel = run

    def transition_dipole(self):
        """Transition dipoles <0|r|n> (nroots, 3) from the MO dipole
        occ->virt block."""
        mf = self.mf
        nocc = mf.nocc
        nvir = mf.mo_coeff.shape[1] - nocc
        Dmo = mf.transition_dipoles()                   # (3, nmo, nmo)
        dov = Dmo[:, :nocc, nocc:nocc + nvir]           # (3, no, nv)
        X = self.xy.reshape(nocc, nvir, -1)
        # sqrt(2): spin-adapted singlet CIS normalization
        return (torch.einsum("kia, ian -> nk", dov, X)
                * np.sqrt(2.0)).cpu().numpy()

    def oscillator_strength(self):
        """f_n = (2/3) omega_n |<0|r|n>|^2."""
        mu = self.transition_dipole()
        return (2.0 / 3.0) * self.e * np.sum(np.abs(mu) ** 2, axis=1)


class TDHF:
    """Full RPA/TDHF: solve the (A, B) non-Hermitian problem via the
    Hermitian (A-B)^{1/2} (A+B) (A-B)^{1/2} form."""

    def __init__(self, mf, singlet=True):
        self.mf = mf
        self.singlet = singlet
        self.e = None

    def run(self, nroots=5):
        A = tda_matrix(self.mf, self.singlet)
        B = b_matrix(self.mf, self.singlet)
        ApB = A + B
        AmB = A - B
        w, U = torch.linalg.eigh(AmB)
        sq = (U * torch.sqrt(torch.clamp(w, min=0))) @ U.T
        isq = (U * (1.0 / torch.sqrt(torch.clamp(w, min=1e-300)))) @ U.T
        M = sq @ ApB @ sq
        w2, T = torch.linalg.eigh(M)
        om = torch.sqrt(torch.clamp(w2, min=0))
        if float(om[0]) < 1e-10:
            # a zero/imaginary RPA root (clipped w2 <= 0 -> om exactly
            # 0 up to noise) means the reference state is unstable
            # (e.g. triplet instability); dividing by sqrt(om) below
            # would emit inf/NaN amplitudes
            raise RuntimeError(
                f"TDHF/RPA instability: lowest excitation energy "
                f"{float(om[0]):.3e} au is zero/near-zero — the "
                f"reference determinant is unstable (use TDA, or fix "
                f"the SCF solution)")
        self.e = om[:nroots].cpu().numpy()
        # RPA eigenvectors with X^2 - Y^2 = 1:
        # (X+Y) = om^{-1/2} (A-B)^{1/2} T, (X-Y) = om^{1/2} (A-B)^{-1/2} T
        xpy = (sq @ T[:, :nroots]) / torch.sqrt(om[:nroots])[None, :]
        xmy = (isq @ T[:, :nroots]) * torch.sqrt(om[:nroots])[None, :]
        #: per-root (X, Y) occ-virt amplitude pair, X^2 - Y^2 = 1
        self.xy = [(0.5 * (xpy[:, n] + xmy[:, n]),
                    0.5 * (xpy[:, n] - xmy[:, n]))
                   for n in range(nroots)]
        return self.e

    kernel = run


CIS = TDA


def tda_density_matrix(td, state_id):
    """AO density matrix of TDA excited state ``state_id`` (0 = first
    excited state), taking the TDA amplitudes as CIS coefficients
    (reference: pyqed/qchem/core.py:840 ``tda_denisty_matrix`` [sic]):

        D = D_gs + 2 (-X X^T)_oo + 2 (X^T X)_vv   in the MO basis.
    """
    mf = td.mf
    nocc = mf.nocc
    mo = mf.mo_coeff
    nmo = mo.shape[1]
    X = td.xy[:, state_id].reshape(nocc, nmo - nocc)
    dm = mo.new_zeros((nmo, nmo))
    dm[:nocc, :nocc] = 2.0 * _eye(nocc, mo)
    dm[:nocc, :nocc] += -2.0 * X @ X.T
    dm[nocc:, nocc:] += 2.0 * X.T @ X
    return mo @ dm @ mo.T


class UCIS:
    """CIS/TDA on a UHF reference (spin-orbital ov space, both spin
    blocks coupled by the Coulomb term; exchange within each spin) —
    excited states of radicals.  At a closed-shell point the spectrum
    is the union of the RHF singlet and triplet TDA roots.

    NOTE on open shells: the spin-contaminated UHF reference puts the
    configuration that completes the doublet spin eigenstate (beta
    HOMO -> beta orbital matching the alpha SOMO) at ~zero excitation
    energy — the first PHYSICAL excitation of a radical is usually
    root 2.

    Beyond the reference (its excited states are pyscf-wrapped,
    closed-shell only)."""

    def __init__(self, mf):
        self.mf = mf
        self.e = None
        self.xy = None          # per root: (X_a (na, nva), X_b (nb, nvb))

    def run(self, nroots=5):
        mf = self.mf
        Ca, Cb = mf.mo_coeff
        ea, eb = mf.mo_energy
        na, nb = mf.nocc
        nmo = Ca.shape[1]
        nva, nvb = nmo - na, nmo - nb
        eri = mf.eri

        def mo_ov(C1o, C1v, C2o, C2v):
            """(ia|jb) block: first pair spin-1, second spin-2."""
            return ao2mo(eri, C1o, C1v, C2o, C2v)

        def mo_oo_vv(Co, Cv):
            """(ij|ab) same-spin block."""
            return ao2mo(eri, Co, Co, Cv, Cv)

        Cao, Cav = Ca[:, :na], Ca[:, na:]
        Cbo, Cbv = Cb[:, :nb], Cb[:, nb:]
        Naa, Nbb = na * nva, nb * nvb
        A = Ca.new_zeros((Naa + Nbb, Naa + Nbb))
        # alpha-alpha
        de = ea[None, na:] - ea[:na, None]
        Aaa = (torch.einsum("ia, ij, ab -> iajb", de, _eye(na, de),
                            _eye(nva, de))
               + mo_ov(Cao, Cav, Cao, Cav)
               - mo_oo_vv(Cao, Cav).permute(0, 2, 1, 3))
        A[:Naa, :Naa] = Aaa.reshape(Naa, Naa)
        # beta-beta
        de = eb[None, nb:] - eb[:nb, None]
        Abb = (torch.einsum("ia, ij, ab -> iajb", de, _eye(nb, de),
                            _eye(nvb, de))
               + mo_ov(Cbo, Cbv, Cbo, Cbv)
               - mo_oo_vv(Cbo, Cbv).permute(0, 2, 1, 3))
        A[Naa:, Naa:] = Abb.reshape(Nbb, Nbb)
        # cross-spin Coulomb
        Aab = mo_ov(Cao, Cav, Cbo, Cbv).reshape(Naa, Nbb)
        A[:Naa, Naa:] = Aab
        A[Naa:, :Naa] = Aab.T
        w, V = torch.linalg.eigh(A)
        self.e = w[:nroots].cpu().numpy()
        self.xy = [(V[:Naa, n].reshape(na, nva),
                    V[Naa:, n].reshape(nb, nvb)) for n in range(nroots)]
        return self.e

    kernel = run

    def transition_dipole(self):
        """<0|r|n> (nroots, 3) from the per-spin occ-virt dipole
        blocks (no sqrt(2): the spin sum is explicit here)."""
        mf = self.mf
        Ca, Cb = mf.mo_coeff
        na, nb = mf.nocc
        from .basis import dipole_matrix
        mu_ao = dipole_matrix(mf.mol.bfs)
        csph = getattr(mf.mol, "csph", None)
        if csph is not None:
            mu_ao = np.einsum("pi, kij, qj -> kpq", csph, mu_ao, csph)
        mu_ao = torch.as_tensor(mu_ao, device=Ca.device)
        dova = torch.einsum("kpq, pi, qa -> kia", mu_ao,
                            Ca[:, :na], Ca[:, na:])
        dovb = torch.einsum("kpq, pi, qa -> kia", mu_ao,
                            Cb[:, :nb], Cb[:, nb:])
        out = [torch.einsum("kia, ia -> k", dova, Xa)
               + torch.einsum("kia, ia -> k", dovb, Xb)
               for Xa, Xb in self.xy]
        return torch.stack(out).cpu().numpy()

    def oscillator_strength(self):
        """f_n = (2/3) omega_n |<0|r|n>|^2."""
        mu = self.transition_dipole()
        return (2.0 / 3.0) * np.asarray(self.e) \
            * np.sum(np.abs(mu) ** 2, axis=1)


def tdscf_from_reference(mf, cls, *, e, xy, singlet=True):
    """An excited-state solver of the port (``TDA``, ``TDHF`` or
    ``UCIS``) on mean field ``mf`` holding another run's roots: ``e`` the
    excitation energies, ``xy`` the amplitudes as NumPy arrays — (nov,
    nroots) for TDA, a list of (X, Y) pairs for TDHF, a list of (X_a,
    X_b) pairs for UCIS. The tensors land on the mean field's device.
    Gradient parity tests start from the JAX package's own vectors this
    way (degenerate roots and signs do not enter); nothing of JAX is
    imported here."""
    td = cls(mf) if cls is UCIS else cls(mf, singlet=singlet)
    like = mf.mo_coeff[0] if isinstance(mf.mo_coeff, (tuple, list)) \
        else mf.mo_coeff

    def dev(x):
        return torch.as_tensor(np.array(x, dtype=float), device=like.device)

    td.e = np.array(e, dtype=float)
    td.xy = (dev(xy) if cls is TDA
             else [tuple(dev(z) for z in pair) for pair in xy])
    return td
