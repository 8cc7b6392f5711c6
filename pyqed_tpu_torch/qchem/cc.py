"""Coupled-cluster singles and doubles (CCSD), spin-orbital formulation.

Beyond the reference (its tree has no coupled cluster at all; correlation
stops at CISD/CASSCF + pyscf wrappers).  Implementation follows the
standard intermediate factorization of Stanton, Gauss, Watts & Bartlett,
JCP 94, 4334 (1991) — every contraction is a dense einsum on the mean
field's device, the amplitude update is a fixed-point iteration with DIIS
acceleration (the DIIS vectors stay on the device too). PyTorch
counterpart of ``pyqed_tpu/qchem/cc.py``; float64 throughout.

Physics pins used by the tests: for any TWO-electron system CCSD is exact
(equals FCI to machine precision); the first iteration from zero
amplitudes reproduces MP2.
"""
from __future__ import annotations

import numpy as np
import torch

from .ci import spinorb_ints
from .scf import diis_extrapolate

__all__ = ["CCSD", "ccsd_from_reference"]


def _spin_fock(mf):
    """Canonical spin-orbital Fock matrix (diagonal eps, interleaved)."""
    return torch.diag(torch.repeat_interleave(mf.mo_energy, 2))


class CCSD:
    """Closed-shell molecules via the spin-orbital CCSD equations
    (exact spin adaptation not required; O(n^6) with small prefactor —
    fine for the basis sizes this package targets on-host, and every
    term is a batched einsum)."""

    def __init__(self, mf, max_cycle: int = 100, conv_tol: float = 1e-10,
                 diis_size: int = 8):
        assert mf.mo_coeff is not None, "run RHF first"
        self.mf = mf
        self.max_cycle = max_cycle
        # the port always runs float64, so 1e-10 is reachable (the JAX
        # package loosens it to 3e-7 without x64)
        self.conv_tol = conv_tol
        self.diis_size = diis_size
        self._cache = None
        self.e_corr = None
        self.e_tot = None
        self.t1 = None
        self.t2 = None
        self.converged = False

    # ------------------------------------------------------------- setup
    def _setup(self):
        if self._cache is not None:
            # run()/ccsd_t()/external consumers share one MO transform +
            # spin-orbital integral build (the O(N^5) + quadruple-loop
            # part) instead of repeating it per stage
            return self._cache
        mf = self.mf
        hmo, eri_mo = mf.mo_ints()
        _, g = spinorb_ints(hmo, eri_mo)      # <pq||rs> physicists'
        del hmo, eri_mo
        f = _spin_fock(mf)
        no = mf.nocc * 2
        nv = f.shape[0] - no
        o, v = slice(None, no), slice(no, None)
        eps = torch.diag(f)
        d1 = eps[o, None] - eps[None, v]
        d2 = (eps[o, None, None, None] + eps[None, o, None, None]
              - eps[None, None, v, None] - eps[None, None, None, v])
        self._cache = (f, g, o, v, d1, d2, no, nv)
        return self._cache

    @staticmethod
    def _tau(t1, t2, tilde=False):
        tt = torch.einsum("ia, jb -> ijab", t1, t1)
        tt = tt - tt.transpose(2, 3)
        return t2 + (0.5 * tt if tilde else tt)

    # ---------------------------------------------------------- residuals
    def _update(self, t1, t2, f, g, o, v, d1, d2):
        """One Stanton et al. amplitude update (canonical f: f_ov = 0)."""
        tau_t = self._tau(t1, t2, tilde=True)
        tau = self._tau(t1, t2)

        Fae = (- 0.5 * torch.einsum("me, ma -> ae", f[o, v], t1)
               + torch.einsum("mf, mafe -> ae", t1, g[o, v, v, v])
               - 0.5 * torch.einsum("mnaf, mnef -> ae", tau_t,
                                  g[o, o, v, v]))
        Fmi = (0.5 * torch.einsum("ie, me -> mi", t1, f[o, v])
               + torch.einsum("ne, mnie -> mi", t1, g[o, o, o, v])
               + 0.5 * torch.einsum("inef, mnef -> mi", tau_t,
                                  g[o, o, v, v]))
        Fme = f[o, v] + torch.einsum("nf, mnef -> me", t1, g[o, o, v, v])

        Wmnij = (g[o, o, o, o]
                 + torch.einsum("je, mnie -> mnij", t1, g[o, o, o, v])
                 - torch.einsum("ie, mnje -> mnij", t1, g[o, o, o, v])
                 + 0.25 * torch.einsum("ijef, mnef -> mnij", tau,
                                     g[o, o, v, v]))
        Wabef = (g[v, v, v, v]
                 - torch.einsum("mb, amef -> abef", t1, g[v, o, v, v])
                 + torch.einsum("ma, bmef -> abef", t1, g[v, o, v, v])
                 + 0.25 * torch.einsum("mnab, mnef -> abef", tau,
                                     g[o, o, v, v]))
        Wmbej = (g[o, v, v, o]
                 + torch.einsum("jf, mbef -> mbej", t1, g[o, v, v, v])
                 - torch.einsum("nb, mnej -> mbej", t1, g[o, o, v, o])
                 - torch.einsum("jnfb, mnef -> mbej",
                              0.5 * t2 + torch.einsum("jf, nb -> jnfb",
                                                    t1, t1),
                              g[o, o, v, v]))

        # T1
        r1 = (f[o, v]
              + torch.einsum("ie, ae -> ia", t1, Fae)
              - torch.einsum("ma, mi -> ia", t1, Fmi)
              + torch.einsum("imae, me -> ia", t2, Fme)
              - torch.einsum("nf, naif -> ia", t1, g[o, v, o, v])
              - 0.5 * torch.einsum("imef, maef -> ia", t2, g[o, v, v, v])
              - 0.5 * torch.einsum("mnae, nmei -> ia", t2, g[o, o, v, o]))

        # T2
        FbeH = Fae - 0.5 * torch.einsum("mb, me -> be", t1, Fme)
        FmjH = Fmi + 0.5 * torch.einsum("je, me -> mj", t1, Fme)

        r2 = g[o, o, v, v].to(t2.dtype)
        tmp = torch.einsum("ijae, be -> ijab", t2, FbeH)
        r2 = r2 + tmp - tmp.transpose(2, 3)
        tmp = torch.einsum("imab, mj -> ijab", t2, FmjH)
        r2 = r2 - tmp + tmp.transpose(0, 1)
        r2 = r2 + 0.5 * torch.einsum("mnab, mnij -> ijab", tau, Wmnij)
        r2 = r2 + 0.5 * torch.einsum("ijef, abef -> ijab", tau, Wabef)
        tmp = (torch.einsum("imae, mbej -> ijab", t2, Wmbej)
               - torch.einsum("ie, ma, mbej -> ijab", t1, t1,
                            g[o, v, v, o]))
        tmp = tmp - tmp.transpose(0, 1)
        r2 = r2 + tmp - tmp.transpose(2, 3)
        tmp = torch.einsum("ie, abej -> ijab", t1, g[v, v, v, o])
        r2 = r2 + tmp - tmp.transpose(0, 1)
        tmp = torch.einsum("ma, mbij -> ijab", t1, g[o, v, o, o])
        r2 = r2 - tmp + tmp.transpose(2, 3)

        return r1 / d1, r2 / d2

    def _energy_expr(self, t1, t2, f, g, o, v):
        return torch.real(
            torch.einsum("ia, ia ->", f[o, v], t1)
            + 0.25 * torch.einsum("ijab, ijab ->", g[o, o, v, v], t2)
            + 0.5 * torch.einsum("ijab, ia, jb ->", g[o, o, v, v], t1, t1))

    def energy(self, t1, t2, f, g, o, v):
        return float(self._energy_expr(t1, t2, f, g, o, v))

    # ---------------------------------------------------------------- run
    def run(self):
        f, g, o, v, d1, d2, no, nv = self._setup()
        t1 = f.new_zeros((no, nv))
        t2 = g[o, o, v, v] / d2                   # MP2 start

        e_old = self.energy(t1, t2, f, g, o, v)
        self.e_mp2 = e_old

        errs, vecs = [], []
        self.cycles = 0
        for it in range(self.max_cycle):
            t1n, t2n = self._update(t1, t2, f, g, o, v, d1, d2)
            # DIIS on the concatenated amplitude vector (on the device)
            vec = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
            err = vec - torch.cat([t1.reshape(-1), t2.reshape(-1)])
            errs.append(err); vecs.append(vec)
            if len(errs) > self.diis_size:
                errs.pop(0); vecs.pop(0)
            if len(errs) > 1:
                mix = diis_extrapolate(errs, vecs)
                if mix is not None:
                    t1n = mix[: no * nv].reshape(no, nv)
                    t2n = mix[no * nv:].reshape(no, no, nv, nv)
            t1, t2 = t1n, t2n
            e_new = self.energy(t1, t2, f, g, o, v)
            self.cycles = it + 1
            if abs(e_new - e_old) < self.conv_tol:
                self.converged = True
                e_old = e_new
                break
            e_old = e_new

        self.t1, self.t2 = t1, t2
        self.e_corr = e_old
        self.e_tot = float(self.mf.e_tot) + e_old
        return self

    # ------------------------------------------------------------ triples
    def ccsd_t(self):
        """Perturbative triples correction (T) [Raghavachari et al.,
        CPL 157, 479 (1989)], spin-orbital form per Crawford & Schaefer:

            E_(T) = 1/36 sum t^c_ijkabc D_ijkabc (t^c + t^d)_ijkabc

        with disconnected t^d D = P(i/jk) P(a/bc) t_i^a <jk||bc> and
        connected t^c D = P(i/jk) P(a/bc) [sum_e t_jk^ae <ei||bc>
        - sum_m t_im^bc <ma||jk>].  Identically zero for two-electron
        systems (no triples exist).  Sets .e_t and .e_tot_t.

        It builds several (no^3 nv^3) tensors at once, so it is for small
        molecules only (water in 6-31G** takes about 0.5 GB a tensor).
        """
        assert self.t2 is not None, "run CCSD first"
        f, g, o, v, d1, d2, no, nv = self._setup()
        if no < 3:
            self.e_t = 0.0
            self.e_tot_t = self.e_tot
            return self.e_t
        t1, t2 = self.t1, self.t2
        eps = torch.diag(f)
        eo, ev = eps[o], eps[v]
        d3 = (eo[:, None, None, None, None, None]
              + eo[None, :, None, None, None, None]
              + eo[None, None, :, None, None, None]
              - ev[None, None, None, :, None, None]
              - ev[None, None, None, None, :, None]
              - ev[None, None, None, None, None, :])

        def p_ijk(x):
            # P(i/jk): x - x(i<->j) - x(i<->k) on the first three axes
            return x - x.transpose(0, 1) - x.transpose(0, 2)

        def p_abc(x):
            # P(a/bc) on the last three axes
            return x - x.transpose(3, 4) - x.transpose(3, 5)

        disc = p_ijk(p_abc(
            torch.einsum("ia, jkbc -> ijkabc", t1, g[o, o, v, v])))
        conn = p_ijk(p_abc(
            torch.einsum("jkae, eibc -> ijkabc", t2, g[v, o, v, v])
            - torch.einsum("imbc, majk -> ijkabc", t2, g[o, v, o, o])))
        tc = conn / d3
        self.e_t = float(torch.sum(tc * (conn + disc)) / 36.0)
        self.e_tot_t = self.e_tot + self.e_t
        return self.e_t


def ccsd_from_reference(mf, *, t1, t2, e_corr, converged=True, **kwargs):
    """A converged :class:`CCSD` of the port on mean field ``mf`` holding
    another run's amplitudes (``t1`` (no, nv) and ``t2`` (no, no, nv, nv)
    in the interleaved spin-orbital basis, NumPy) and correlation energy;
    the tensors land on the mean field's device. Gradient parity tests
    start from the JAX package's amplitudes this way; nothing of JAX is
    imported here."""
    cc = CCSD(mf, **kwargs)
    f = cc._setup()[0]
    cc.t1 = torch.as_tensor(np.array(t1, dtype=float), device=f.device)
    cc.t2 = torch.as_tensor(np.array(t2, dtype=float), device=f.device)
    cc.e_corr = float(e_corr)
    cc.e_tot = float(mf.e_tot) + cc.e_corr
    cc.converged = bool(converged)
    return cc
