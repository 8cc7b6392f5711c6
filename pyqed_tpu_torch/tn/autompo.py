"""Automatic MPO construction for long-range fermionic Hamiltonians
(PyTorch).

Counterpart of ``pyqed_tpu/tn/autompo.py`` (reference: pyqed/mps/mps.py:1391
``autoMPO``; the Hubbard and DVR-space electronic DMRG drivers of
pyqed/dmrg/hubbard.py and pyqed/dmrg/dvr_1d.py:1249). The MPOs are
finite-state machines over Jordan-Wigner qubits, one in-flight channel
per source site, bond dimension 3N+2 for dense hoppings h_ij and
density-density interactions v_ij n_i n_j — on a real-space (DVR) grid,
where (ij|kl) = v_ik δ_ij δ_kl, the exact electronic Hamiltonian. The
W tensors are built in NumPy, exactly as the JAX package builds them,
and placed on ``device`` (the card when None).

JW convention: |0> = empty, |1> = occupied, c_j = (Π_{k<j} Z_k) σ⁻_j,
so for i<j:  c†_i c_j = σ⁺_i Z_{i+1}..Z_{j-1} σ⁻_j  and
c†_j c_i = σ⁻_i Z_{i+1}..Z_{j-1} σ⁺_j.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .mps import MPO, MPS


_SP = np.array([[0.0, 0.0], [1.0, 0.0]])    # sigma+ = c† (|1><0|)
_SM = np.array([[0.0, 1.0], [0.0, 0.0]])    # sigma- = c
_NUM = np.array([[0.0, 0.0], [0.0, 1.0]])   # n
_Z = np.array([[1.0, 0.0], [0.0, -1.0]])    # JW string (I - 2n)
_I = np.eye(2)


def _mpo(Ws, device):
    """An MPO of NumPy W tensors on ``device``."""
    return MPO([torch.as_tensor(W, device=device) for W in Ws])


def _host(mpo):
    """Copies of an MPO's W tensors as NumPy arrays (never views of the
    MPO's own CPU tensors: the callers write into them)."""
    return [np.array(W.detach().cpu().resolve_conj()) for W in mpo.Ws]


def autompo_fermion(t, v=None, device=None):
    """MPO of  H = Σ_ij t_ij c†_i c_j + Σ_{i<j} v_ij n_i n_j  on N
    Jordan-Wigner sites (t Hermitian, v used for i<j only).

    Channel layout per bond (total D = 3N + 2):
      0                 identity (nothing placed yet)
      1 + i             "σ⁺ at i" in flight (Z string)
      1 + N + i         "σ⁻ at i" in flight (Z string)
      1 + 2N + i        "n at i" in flight (identity string)
      3N + 1            done
    """
    dev = resolve_device(device)
    t = np.asarray(t)
    N = t.shape[0]
    v = np.zeros((N, N)) if v is None else np.asarray(v)
    D = 3 * N + 2
    done = D - 1
    cplx = np.iscomplexobj(t)

    Ws = []
    for k in range(N):
        W = np.zeros((D, D, 2, 2), dtype=t.dtype if cplx else float)
        W[0, 0] = _I
        W[done, done] = _I
        W[0, done] = (t[k, k] if cplx else t[k, k].real) * _NUM
        W[0, 1 + k] = _SP
        W[0, 1 + N + k] = _SM
        W[0, 1 + 2 * N + k] = _NUM
        for i in range(k):
            W[1 + i, 1 + i] = _Z
            W[1 + N + i, 1 + N + i] = _Z
            W[1 + 2 * N + i, 1 + 2 * N + i] = _I
            if t[i, k] != 0:
                W[1 + i, done] = t[i, k] * _SM               # c†_i c_k
                W[1 + N + i, done] = np.conj(t[i, k]) * _SP  # c†_k c_i
            if v[i, k] != 0:
                W[1 + 2 * N + i, done] = v[i, k] * _NUM
        Ws.append(W)
    return _mpo(Ws, dev)


def autoMPO(h1e, v, device=None):
    """Reference-named entry (pyqed/mps/mps.py:1391):
    H = Σ_ij h_ij c†_i c_j + Σ_{i<j} v_ij n_i n_j."""
    return autompo_fermion(h1e, v, device=device)


def spinful_to_sites(h_spatial, v_spatial=None, u_onsite=None):
    """Map a spatial-orbital Hamiltonian with diagonal (density-density)
    interactions onto interleaved JW sites [0↑, 0↓, 1↑, 1↓, ...]:

      H = Σ_ij h_ij Σ_σ c†_iσ c_jσ
          + Σ_{p<r} v_pr N_p N_r + Σ_p v_pp n_p↑ n_p↓

    (reference: pyqed/dmrg/dvr_1d.py). NumPy in, NumPy out: returns
    (t_site, v_site) for :func:`autompo_fermion`.
    """
    h = np.asarray(h_spatial)
    n = h.shape[0]
    N = 2 * n
    t = np.zeros((N, N), dtype=h.dtype)
    t[0::2, 0::2] = h
    t[1::2, 1::2] = h
    V = np.zeros((N, N))
    if v_spatial is not None:
        v = np.asarray(v_spatial)
        for s in range(N):
            for u in range(s + 1, N):
                V[s, u] = v[s // 2, u // 2]
    if u_onsite is not None:
        for p in range(n):
            V[2 * p, 2 * p + 1] += u_onsite
    return t, V


def hubbard_mpo(L, t=1.0, U=4.0, mu=0.0, device=None):
    """Spinful Fermi-Hubbard chain as a JW MPO
    (reference: pyqed/dmrg/hubbard.py):
    H = −t Σ_{iσ} (c†_iσ c_{i+1σ} + h.c.) + U Σ_i n_i↑ n_i↓ − μ N̂.
    """
    h = np.zeros((L, L))
    for i in range(L - 1):
        h[i, i + 1] = h[i + 1, i] = -t
    np.fill_diagonal(h, -mu)
    ts, V = spinful_to_sites(h, v_spatial=None, u_onsite=U)
    return autompo_fermion(ts, V, device=device)


def number_penalty(N_sites, nelec, lam=2.0):
    """(t_shift, v_shift, const) implementing lam*(N̂ − nelec)²:
    N̂² = Σ n_i + 2 Σ_{i<j} n_i n_j, so
    lam(N̂−n)² = lam[(1−2n) Σ n_i + 2 Σ_{i<j} n_i n_j + n²]."""
    tsh = lam * (1.0 - 2.0 * nelec) * np.eye(N_sites)
    vsh = 2.0 * lam * (np.triu(np.ones((N_sites, N_sites)), 1))
    return tsh, vsh, lam * nelec ** 2


class DMRGElectronicDVR:
    """DVR-space electronic DMRG: grid points -> JW sites, ground state by
    two-site DMRG (reference: pyqed/dmrg/dvr_1d.py:1249), with the
    electron number pinned by a quadratic penalty.

    ``mf`` is any mean-field object with ``hcore`` (or ``get_hcore()``),
    a diagonal ``eri`` grid (or ``get_eri()``), ``mol.nelec`` and
    ``mol.energy_nuc()``, as ``qchem.dvr.RHF1D`` of the JAX package.
    """

    def __init__(self, mf, lam=4.0, chi_max=64, device=None):
        self.mf = mf
        self.lam = lam
        self.chi_max = chi_max
        self.device = resolve_device(device)

    def run(self, sweeps=8):
        from .mps import two_site_dmrg
        mf = self.mf
        h = np.asarray(mf.hcore if mf.hcore is not None
                       else mf.get_hcore())
        vgrid = np.asarray(mf.eri if mf.eri is not None else mf.get_eri())
        nelec = mf.mol.nelec
        # v[p,p] goes onto the on-site up-down pair and v[p,r] onto every
        # inter-point spin pair: the DVR second-quantized Coulomb operator
        ts, V = spinful_to_sites(h, v_spatial=vgrid)
        n = h.shape[0]
        tsh, vsh, const = number_penalty(2 * n, nelec, self.lam)
        mpo = autompo_fermion(ts + tsh, V + vsh, device=self.device)
        # a random canonical seed: product eigenstates trap the sweeps
        mps = MPS.random(2 * n, d=2, chi=8, seed=7, device=self.device)
        energies, gs = two_site_dmrg(mpo, mps, chi_max=self.chi_max,
                                     sweeps=sweeps)
        # the MPO carries lam(N̂−n)² less its constant lam·n², so at the
        # pinned filling the raw energy sits const below E_elec
        self.e_tot = energies[-1] + const + mf.mol.energy_nuc()
        self.mps = gs
        self.energies = energies
        return self.e_tot


# ------------------------------------------------------------------
# MPO algebra and spin-sector control (reference: pyqed/qchem/dmrg.py
# ``DMRG.fix_nelec``/``fix_spin``, pyqed/dmrg/dvr_1d.py:1249). As in the
# JAX package the W tensors are combined on the host; the result lands on
# the first operand's device.
# ------------------------------------------------------------------

def mpo_add(A, B):
    """Direct sum of two FSM MPOs sharing the start/done convention
    (channel 0 = identity start with W[0,0]=I, channel D-1 = done with
    W[done,done]=I): (A+B).to_dense() == A.to_dense() + B.to_dense().
    """
    Da = A.Ws[0].shape[0]
    Db = B.Ws[0].shape[0]
    D = Da + Db - 2
    done = D - 1
    d = A.Ws[0].shape[2]
    amap = np.arange(Da)
    amap[-1] = done
    bmap = np.arange(Db) + Da - 2
    bmap[0], bmap[-1] = 0, done
    Ws = []
    for Wa, Wb in zip(_host(A), _host(B)):
        W = np.zeros((D, D, d, d), dtype=np.result_type(Wa, Wb))
        W[np.ix_(amap, amap)] += Wa
        Wb = Wb.copy()
        Wb[0, 0] = Wb[-1, -1] = 0.0          # identities already placed
        W[np.ix_(bmap, bmap)] += Wb
        Ws.append(W)
    return _mpo(Ws, A.device)


def mpo_scale(A, c):
    """c * H as an MPO. In the start/done FSM convention every term
    leaves channel 0 (the identity-start lane, W[0,0]=I at every site)
    exactly once and never returns, so scaling the opening transitions
    W_k[0, 1:] at every site k multiplies each term by c exactly once."""
    Ws = _host(A)
    for W in Ws:
        W[0, 1:] = c * W[0, 1:]
    return _mpo(Ws, A.device)


def mpo_shift(A, c):
    """H + c*I as an MPO: the whole constant on the first site's
    start->done transition."""
    Ws = _host(A)
    done = Ws[0].shape[1] - 1
    Ws[0][0, done] += c * np.eye(Ws[0].shape[2])
    return _mpo(Ws, A.device)


def spin_exchange_mpo(J, device=None):
    """MPO of  Σ_{i<j} J_ij (S⁺_i S⁻_j + S⁻_i S⁺_j)  on interleaved JW
    sites [0↑, 0↓, 1↑, 1↓, ...], where S⁺_i = c†_{i↑} c_{i↓} =
    σ⁺_{2i} σ⁻_{2i+1} (parity-even: no Z strings between pairs).

    Channels: per spatial site an S⁺-in-flight and an S⁻-in-flight lane
    (opened at 2i, completed at 2i+1, identity-propagated), plus two
    one-bond closing lanes. Bond dimension 2n + 4.
    """
    J = np.asarray(J)
    n = J.shape[0]
    D = 2 * n + 4
    done = D - 1
    cp, cm = 2 * n + 1, 2 * n + 2

    Ws = []
    for k in range(2 * n):
        i, dn = divmod(k, 2)
        W = np.zeros((D, D, 2, 2))
        W[0, 0] = _I
        W[done, done] = _I
        if not dn:                      # site 2i
            W[0, 1 + i] = _SP           # open S+_i
            W[0, 1 + n + i] = _SM       # open S-_i
            for l in range(i):          # terminate in-flight lanes here
                if J[l, i] != 0:
                    W[1 + l, cp] = J[l, i] * _SM
                    W[1 + n + l, cm] = J[l, i] * _SP
                W[1 + l, 1 + l] = _I
                W[1 + n + l, 1 + n + l] = _I
        else:                           # site 2i+1
            W[1 + i, 1 + i] = _SM           # complete S+_i
            W[1 + n + i, 1 + n + i] = _SP   # complete S-_i
            W[cp, done] = _SP               # finish S-_j of S+S-
            W[cm, done] = _SM               # finish S+_j of S-S+
            for l in range(i):
                W[1 + l, 1 + l] = _I
                W[1 + n + l, 1 + n + l] = _I
        Ws.append(W)
    return _mpo(Ws, resolve_device(device))


def spin_squared_mpo(n, device=None):
    """MPO of the total-spin operator S² on n spatial sites (interleaved
    JW layout), from S² = S⁺S⁻ − S_z + S_z² with
    S⁺S⁻ = Σ_{i≠j} S⁺_i S⁻_j + Σ_i n_{i↑}(1 − n_{i↓}): the density part
    rides the hopping/density FSM, the i≠j exchange part is
    :func:`spin_exchange_mpo`."""
    t = np.zeros((2 * n, 2 * n))
    v = np.zeros((2 * n, 2 * n))
    for i in range(n):
        a, b = 2 * i, 2 * i + 1
        t[a, a] += 1.0                  # S+_i S-_i = n_up (1 - n_dn)
        v[a, b] += -1.0
        t[a, a] += -0.5                 # -S_z = -1/2 (n_up - n_dn)
        t[b, b] += +0.5
        t[a, a] += 0.25                 # S_z^2: 1/4 (n_up + n_dn
        t[b, b] += 0.25                 #         - 2 n_up n_dn)
        v[a, b] += -0.5
        for j in range(i + 1, n):
            c, d2 = 2 * j, 2 * j + 1
            # S_z^2 off-diagonal: 1/2 (n_iu - n_id)(n_ju - n_jd)
            v[a, c] += 0.5
            v[a, d2] += -0.5
            v[b, c] += -0.5
            v[b, d2] += 0.5
    dens = autompo_fermion(t, v, device=device)
    exch = spin_exchange_mpo(np.ones((n, n)) - np.eye(n), device=device)
    return mpo_add(dens, exch)


def fix_spin_mpo(mpo, n, shift=0.5, ss=0.0):
    """H + shift (S² − ss): pushes higher-spin sectors up by
    shift*(S(S+1) − ss) (reference: pyqed/qchem/dmrg.py
    ``DMRG.fix_spin``; the linear penalty of pyscf's
    fci.addons.fix_spin_)."""
    pen = mpo_scale(spin_squared_mpo(n, device=mpo.device), shift)
    return mpo_shift(mpo_add(mpo, pen), -shift * ss)


def fix_nelec_mpo(mpo, nelec, shift=2.0):
    """H + shift (N̂ − nelec)² as an MPO on the same JW sites
    (reference ``DMRG.fix_nelec``)."""
    tsh, vsh, const = number_penalty(len(mpo.Ws), nelec, shift)
    pen = autompo_fermion(tsh, vsh, device=mpo.device)
    return mpo_shift(mpo_add(mpo, pen), const)
