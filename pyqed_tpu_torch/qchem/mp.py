"""Moller-Plesset perturbation theory (closed-shell MP2, SCS-MP2).

The reference mentions MP2 only in comments and pyscf wrappers
(reference: pyqed/qchem/mol.py:1597, qchem/gto/gw/pyscf_gw.py); here it
is a real implementation (PyTorch counterpart of
``pyqed_tpu/qchem/mp.py``): one O(N^5) MO transform (already provided by
``RHF.mo_ints``) plus a single contraction over the amplitude denominator,
on the mean field's device.

    E2 = sum_{ijab} (ia|jb) [ 2 (ia|jb) - (ib|ja) ] / (e_i+e_j-e_a-e_b)

with chemists'-notation MO integrals.  SCS-MP2 [Grimme, JCP 118, 9095
(2003)] rescales the opposite-spin (1.2) and same-spin (1/3) parts.
"""
from __future__ import annotations

import torch

from .scf import ao2mo

__all__ = ["MP2", "UMP2"]


class MP2:
    """Closed-shell MP2 on a converged RHF object (``qchem.scf.RHF``)."""

    def __init__(self, mf):
        assert mf.mo_coeff is not None, "run RHF first"
        self.mf = mf
        self.e_corr = None
        self.e_corr_os = None
        self.e_corr_ss = None
        self.e_tot = None
        self.e_scs = None

    def run(self):
        mf = self.mf
        nocc = mf.nocc
        _, eri_mo = mf.mo_ints()
        e = mf.mo_energy
        o, v = slice(None, nocc), slice(nocc, None)
        ovov = eri_mo[o, v, o, v]                          # (ia|jb)
        denom = (e[o, None, None, None] - e[None, v, None, None]
                 + e[None, None, o, None] - e[None, None, None, v])
        t = ovov / denom                                   # amplitudes
        e_os = torch.sum(t * ovov)
        e_ss = e_os - torch.einsum("iajb, ibja ->", t, ovov)
        self.e_corr_os = float(e_os)
        self.e_corr_ss = float(e_ss)
        self.e_corr = float(e_os + e_ss)
        self.e_tot = float(mf.e_tot) + self.e_corr
        self.e_scs = (float(mf.e_tot) + 1.2 * self.e_corr_os
                      + self.e_corr_ss / 3.0)
        return self


class UMP2:
    """Unrestricted MP2 on a converged UHF object (``qchem.scf.UHF``):

        E2 = 1/4 sum_aa <ij||ab>^2/D + 1/4 sum_bb <ij||ab>^2/D
             + sum_ab (ia|jb)^2/D

    (same-spin blocks antisymmetrized, opposite-spin plain chemists'
    integrals).  Reduces to RMP2 when the UHF solution is closed-shell."""

    def __init__(self, mf):
        assert mf.mo_coeff is not None, "run UHF first"
        self.mf = mf
        self.e_corr = None
        self.e_tot = None

    @staticmethod
    def _ovov(eri, C1, o1, v1, C2, o2, v2):
        """(i a | j b) with pair 1 in C1-spin MOs, pair 2 in C2."""
        return ao2mo(eri, C1[:, o1], C1[:, v1], C2[:, o2], C2[:, v2])

    def run(self):
        mf = self.mf
        Ca, Cb = mf.mo_coeff
        ea, eb = mf.mo_energy
        na, nb = mf.nocc
        eri = mf.eri
        oa, va = slice(None, na), slice(na, None)
        ob, vb = slice(None, nb), slice(nb, None)

        def d2(eo1, ev1, eo2, ev2):
            return (eo1[:, None, None, None] - ev1[None, :, None, None]
                    + eo2[None, None, :, None] - ev2[None, None, None, :])

        def same_spin(C, o, v, e):
            ovov = self._ovov(eri, C, o, v, C, o, v)
            anti = ovov - ovov.transpose(1, 3)           # (ia|jb)-(ib|ja)
            D = d2(e[o], e[v], e[o], e[v])
            return 0.25 * torch.sum(anti ** 2 / D)

        e_aa = same_spin(Ca, oa, va, ea)
        e_bb = same_spin(Cb, ob, vb, eb)
        ovov = self._ovov(eri, Ca, oa, va, Cb, ob, vb)
        e_ab = torch.sum(ovov ** 2 / d2(ea[oa], ea[va], eb[ob], eb[vb]))

        self.e_corr_ss = float(e_aa + e_bb)
        self.e_corr_os = float(e_ab)
        self.e_corr = self.e_corr_ss + self.e_corr_os
        self.e_tot = float(mf.e_tot) + self.e_corr
        self.e_scs = (float(mf.e_tot) + 1.2 * self.e_corr_os
                      + self.e_corr_ss / 3.0)
        return self
