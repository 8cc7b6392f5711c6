"""Bethe-Salpeter equation on top of G0W0 quasiparticle energies.

PyTorch counterpart of ``pyqed_tpu/negf/gwbse.py`` (reference:
pyqed/gw/GW_BSE.py — ``bse_AB_matrices:362`` with GW QP energies +
RPA-screened static W, ``bse:407`` Casida solve, ``get_m_rpa:210``
intermediates). The reference's quadruple loops over (i, a, j, b, L)
are contractions on the mean field's device; spatial-orbital restricted
convention throughout. The Casida square root of A − B is taken by
``eigh`` (A − B is symmetric; the JAX package calls SciPy's ``sqrtm``).
Results are NumPy, as in the JAX package.
"""
from __future__ import annotations

import torch

from .gw import _rpa, _g0w0, _m_rpa


class GWBSE:
    """One-shot G0W0 + statically screened BSE.

    Parameters
    ----------
    mf : converged qchem RHF mean field (computes on its device).
    eta : broadening in the GW self-energy denominators.
    """

    def __init__(self, mf, eta=1e-3):
        self.mf = mf
        self.eta = eta
        self.e_gw = None
        self._prep()

    def _prep(self):
        mf = self.mf
        _, self._eri = mf.mo_ints()
        self._e = mf.mo_energy
        self.e_mf = self._e.cpu().numpy()
        self.nocc = mf.nocc
        self.nmo = self._eri.shape[0]
        self._modes = _rpa(mf)
        self.Omega, self.XpY = (x.cpu().numpy() for x in self._modes)

    def run_gw(self):
        nocc = self.nocc
        self.e_gw, self.e_hf, self.sigma_c = _g0w0(
            self.mf, self.eta, None, modes=self._modes,
            blocks=(self._eri, self._e, nocc, self.nmo - nocc))
        return self.e_gw

    # ------------------------------------------------------------- BSE
    def _m_rpa(self):
        """M_{pq,L} = Σ_ia (pq|ia) (X+Y)^L_{ia} (reference: GW_BSE.py:210
        ``get_m_rpa``), a tensor."""
        return _m_rpa(self._eri, self.nocc, self._modes[1])

    def _ab(self, use_gw=True, screened=True):
        nocc, nmo = self.nocc, self.nmo
        nvir = nmo - nocc
        if use_gw and self.e_gw is None:
            self.run_gw()
        eri = self._eri
        e = (torch.as_tensor(self.e_gw, device=eri.device) if use_gw
             else self._e)
        o, v = slice(0, nocc), slice(nocc, nmo)
        de = e[None, v] - e[o, None]                         # (i, a)
        eye_o = torch.eye(nocc, dtype=eri.dtype, device=eri.device)
        eye_v = torch.eye(nvir, dtype=eri.dtype, device=eri.device)
        A = (torch.einsum("ia, ij, ab -> iajb", de, eye_o, eye_v)
             + 2.0 * eri[v, o, v, o].permute(1, 0, 3, 2)
             - eri[v, v, o, o].permute(2, 0, 3, 1))
        ovvo = eri[v, o, o, v]
        B = 2.0 * ovvo.permute(1, 0, 2, 3) - ovvo.permute(2, 0, 1, 3)
        if screened:
            M = self._m_rpa()
            iO = 1.0 / self._modes[0]
            A = A - 2.0 * torch.einsum("ijL, abL -> iajb", M[o, o] * iO,
                                       M[v, v])
            B = B - 2.0 * torch.einsum("ibL, ajL -> iajb", M[o, v] * iO,
                                       M[v, o])
        d = nocc * nvir
        return A.reshape(d, d), B.reshape(d, d)

    def ab_matrices(self, use_gw=True, screened=True):
        """BSE A/B in the (ia) particle-hole basis (reference:
        GW_BSE.py:362), NumPy:
        A[ia,jb] = δ δ (E_a − E_i) + 2(ai|bj) − (ab|ij)
                   − 2 Σ_L M_ij,L M_ab,L / Ω_L   (static screening),
        B[ia,jb] = 2(ai|jb) − (aj|ib) − 2 Σ_L M_ib,L M_aj,L / Ω_L.
        With use_gw=False and screened=False this reduces EXACTLY to the
        TDHF A/B matrices."""
        return tuple(x.cpu().numpy() for x in self._ab(use_gw, screened))

    def run(self, tda=False, use_gw=True, screened=True):
        """Excitation energies (Casida form; reference GW_BSE.py:407),
        NumPy."""
        A, B = self._ab(use_gw=use_gw, screened=screened)
        if tda:
            self.e_bse = torch.linalg.eigvalsh(A).cpu().numpy()
            return self.e_bse
        w, U = torch.linalg.eigh(A - B)
        sq = (U * torch.sqrt(torch.clamp(w, min=0.0))) @ U.T
        w2 = torch.linalg.eigvalsh(sq @ (A + B) @ sq)
        self.e_bse = torch.sqrt(torch.clamp(w2, min=0.0)).cpu().numpy()
        return self.e_bse

    kernel = run
