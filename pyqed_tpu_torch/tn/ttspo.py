"""Tensor-train (MPS) compressed SPO / LDR nonadiabatic dynamics
(PyTorch).

Counterpart of ``pyqed_tpu/tn/ttspo.py`` (reference: pyqed/mps/namd.py:147
``TT_LDR``, an unfinished sketch there): a wavepacket on an ndim nuclear
grid x electronic index held as a tensor train |n_1 ... n_d alpha> with
bounded bond rank, propagated by Strang splitting

    U(dt) = e^{-i V dt/2} [ A ⊙ (⊗_d e^{-i T_d dt}) ] e^{-i V dt/2}

as the dense ``grid/ldr.py::LDRN``, so at full rank the two agree to
rounding. Without an electronic overlap A (diabatic dynamics) the kinetic
step is a product of single-site phase matrices and keeps the ranks; with
A it is an MPO from a TT-SVD of the A-dressed propagator. Bond ranks
depend on the data (each truncation reads its spectrum back to the
host), so the sweeps are host loops of einsums, QRs and SVDs on the
cores' device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..grid.dvr import SineDVR, SincDVR
from ..ops.linalg import as_tensor
from .ttals import tt_svd, tt_to_dense  # noqa: F401 (tt_to_dense: surface)


# --------------------------------------------------------------------------
# TT core algebra
# --------------------------------------------------------------------------

def _zipper(a, b):
    """The transfer-matrix product <a|b> as a (1, 1) tensor."""
    dtype = torch.promote_types(a[0].dtype, b[0].dtype)
    E = torch.ones((1, 1), dtype=dtype, device=a[0].device)
    for Ga, Gb in zip(a, b):
        E = torch.einsum("ac, anb, cnd -> bd", E, Ga.conj().to(dtype),
                         Gb.to(dtype))
    return E


def tt_norm(cores) -> float:
    """<psi|psi>**0.5 by the transfer-matrix zipper."""
    return float(_zipper(cores, cores)[0, 0].abs().sqrt())


def tt_inner(a, b):
    """<a|b> for two TTs with identical physical dims (Python complex)."""
    return complex(_zipper(a, b)[0, 0])


def tt_compress(cores, chi_max: int, eps: float = 0.0):
    """Canonicalize and truncate a TT to bond rank <= chi_max: an L→R QR
    sweep, then an R→L SVD sweep keeping the chi_max dominant singular
    vectors per bond (and those above ``eps`` times the largest)."""
    cores = [as_tensor(G) for G in cores]
    d = len(cores)
    for k in range(d - 1):
        r1, n, r2 = cores[k].shape
        Q, R = torch.linalg.qr(cores[k].reshape(r1 * n, r2))
        cores[k] = Q.reshape(r1, n, Q.shape[1])
        cores[k + 1] = torch.einsum("ab, bnc -> anc", R, cores[k + 1])
    for k in range(d - 1, 0, -1):
        r1, n, r2 = cores[k].shape
        U, S, Vh = torch.linalg.svd(cores[k].reshape(r1, n * r2),
                                    full_matrices=False)
        r = min(chi_max, S.shape[0])
        if eps > 0 and S.shape[0]:
            Snp = S.cpu().numpy()
            if Snp[0] > 0:
                r = min(r, max(1, int(np.sum(Snp > eps * Snp[0]))))
        cores[k] = Vh[:r].reshape(r, n, r2)
        cores[k - 1] = torch.einsum("anb, bc -> anc", cores[k - 1],
                                    U[:, :r] * S[None, :r].to(U.dtype))
    return cores


def hadamard_apply(v_tt, psi, chi_max: Optional[int] = None):
    """Apply a diagonal (Hadamard) operator in TT form:
    (V ⊙ psi) with cores  (a,n,b) x (c,n,d) -> (ac,n,bd)."""
    out = []
    for Gv, Gp in zip(v_tt, psi):
        Gv = as_tensor(Gv, device=Gp.device)
        a1, n, a2 = Gv.shape
        c1, _, c2 = Gp.shape
        dtype = torch.promote_types(Gv.dtype, Gp.dtype)
        A = torch.einsum("anb, cnd -> acnbd", Gv.to(dtype), Gp.to(dtype))
        out.append(A.reshape(a1 * c1, n, a2 * c2))
    return out if chi_max is None else tt_compress(out, chi_max)


def mpo_apply(T, psi, chi_max: Optional[int] = None):
    """Apply an MPO with cores (a, i, j, b) (i = out, j = in; tensors or
    arrays) to a TT."""
    out = []
    for W, G in zip(T, psi):
        W = as_tensor(W, device=G.device)
        a1, ni, nj, a2 = W.shape
        c1, _, c2 = G.shape
        dtype = torch.promote_types(W.dtype, G.dtype)
        A = torch.einsum("aijb, cjd -> acibd", W.to(dtype), G.to(dtype))
        out.append(A.reshape(a1 * c1, ni, a2 * c2))
    return out if chi_max is None else tt_compress(out, chi_max)


# --------------------------------------------------------------------------
# TT-LDR / TT-SPO propagator
# --------------------------------------------------------------------------

class TT_LDR:
    """TT/MPS-format LDR dynamics with the SPO integrator.

    Sites 1..ndim are nuclear DVR grids, the last site is the electronic
    index (reference: pyqed/mps/namd.py:147, layout |n_1 ... n_d alpha>).
    Diabatic dynamics: leave ``A`` unset, and the kinetic step is a
    rank-preserving product of single-site phase matrices. Exact
    nonadiabatic (LDR) dynamics: supply the electronic overlap tensor
    ``A`` of shape (*nx, ns, *nx, ns) as ``grid/ldr.py::LDRN.build_ovlp``
    builds it. ``device``: the card when None (raises without one).
    """

    def __init__(self, domains: Sequence, levels: Sequence, nstates: int = 2,
                 mass: Optional[Sequence] = None, dvr_type: str = "sine",
                 device=None):
        self.device = resolve_device(device)
        self.ndim = len(levels)
        self.nsites = self.L = self.ndim + 1
        self.nstates = nstates
        self.mass = list(mass) if mass is not None else [1.0] * self.ndim

        self.dvr = []
        for d in range(self.ndim):
            npts = 2 ** levels[d] - 1
            if dvr_type == "sine":
                self.dvr.append(SineDVR(*domains[d], npts, mass=self.mass[d],
                                        device=self.device))
            elif dvr_type == "sinc":
                a, b = domains[d]
                self.dvr.append(SincDVR(b - a, npts, x0=0.5 * (a + b),
                                        mass=self.mass[d],
                                        device=self.device))
            else:
                raise ValueError(f"DVR {dvr_type} is not supported.")
        self.x = [np.asarray(dvr.x) for dvr in self.dvr]
        self.nx = [len(x) for x in self.x]
        self.dims = self.nx + [nstates]

        self.apes = None        # (*nx, nstates) adiabatic/diabatic PES
        self.A = None           # electronic overlap tensor (LDR)
        self.exp_K = None

    # ------------------------------------------------------------- inputs
    def set_apes(self, v):
        v = as_tensor(v, device=self.device)
        if tuple(v.shape) != tuple(self.dims):
            raise ValueError(f"APES shape {tuple(v.shape)} != "
                             f"{tuple(self.dims)}")
        self.apes = v
        return self

    set_dpes = set_apes   # diabatic-diagonal naming alias

    def set_ovlp(self, A):
        A = as_tensor(A, device=self.device)
        want = (*self.nx, self.nstates, *self.nx, self.nstates)
        if tuple(A.shape) != want:
            raise ValueError(f"overlap shape {tuple(A.shape)} != {want}")
        self.A = A
        return self

    # ------------------------------------------------------------ builders
    def buildK(self, dt):
        """Per-dimension single-site kinetic propagators e^{-i T_d dt}."""
        self.exp_K = [dvr.expT(dt) for dvr in self.dvr]
        return self.exp_K

    def _kinetic_mpo(self, rank_ovlp: int):
        """The A-dressed kinetic propagator as an MPO (nonadiabatic path):
        A reshaped to (n_1 n_1', ..., n_d n_d', ns ns'), TT-SVD at
        ``rank_ovlp``, exp_K folded into the nuclear cores elementwise
        (the dense LDRN contraction is A ⊙ (⊗_d exp_K), a Hadamard
        product on the nuclear index pairs) (reference:
        pyqed/mps/namd.py:368-420)."""
        d = self.ndim
        ns = self.nstates
        perm = []
        for i in range(d):
            perm += [i, d + 1 + i]
        perm += [d, 2 * d + 1]
        shape = [n * n for n in self.nx] + [ns * ns]
        factors = tt_svd(self.A.permute(perm).reshape(shape),
                         max_rank=rank_ovlp, device=self.device)
        T = []
        for l in range(self.L):
            b1, _, b2 = factors[l].shape
            t = factors[l].reshape(b1, self.dims[l], self.dims[l], b2)
            if l < d:
                t = t * self.exp_K[l][None, :, :, None]
            T.append(t)
        return T

    def _v_tt(self, dt, rank_pes: int):
        """TT of the half-step potential propagator e^{-i V dt/2}."""
        return tt_svd(torch.exp(-0.5j * dt * self.apes), max_rank=rank_pes,
                      device=self.device)

    # ---------------------------------------------------------------- run
    def run(self, psi0, dt, nt, rank_state: int = 16,
            rank_pes: int = 16, rank_ovlp: int = 16, nout: int = 1,
            e_ops=()):
        """Propagate nt total steps, recording every nout (the (nt, nout)
        convention of LDRN.run).

        psi0: dense (*nx, nstates) array or tensor, or a list of TT cores.
        Returns a dict with 'cores_list' (TT snapshots, lists of tensors),
        'rdm_el' (nsnap, ns, ns) and 'norms' (nsnap,) tensors on the
        device, and 'expect' (nsnap, len(e_ops)) for diagonal
        observables.
        """
        if self.apes is None:
            raise ValueError("APES has not been constructed.")
        psi = (list(psi0) if isinstance(psi0, (list, tuple))
               else tt_svd(psi0, max_rank=rank_state, device=self.device))
        psi = [as_tensor(G, device=self.device) for G in psi]

        self.buildK(dt)
        v_tt = self._v_tt(dt, rank_pes)
        T = self._kinetic_mpo(rank_ovlp) if self.A is not None else None

        # diagonal observables O(R, alpha): TT-decomposed once, evaluated
        # as <psi| O ⊙ psi> per snapshot
        eop_tts = []
        for O in (e_ops or ()):
            O = as_tensor(O, device=self.device)
            if tuple(O.shape) != tuple(self.dims):
                raise ValueError(
                    f"e_op shape {tuple(O.shape)} != {tuple(self.dims)} "
                    "(diagonal grid x state observables only)")
            eop_tts.append(tt_svd(O, max_rank=rank_pes, device=self.device))

        snaps, rdms, norms, expects = [], [], [], []

        def record(p):
            snaps.append(list(p))
            rdms.append(self.rdm_el(p))
            norms.append(_zipper(p, p)[0, 0].abs().sqrt())
            if eop_tts:
                expects.append(torch.stack([
                    _zipper(p, hadamard_apply(ot, p))[0, 0]
                    for ot in eop_tts]))

        record(psi)
        for _ in range(max(nt // nout, 0)):
            for _ in range(nout):
                psi = hadamard_apply(v_tt, psi, chi_max=rank_state)
                if T is None:
                    psi = [torch.einsum("mn, anb -> amb", K.to(G.dtype), G)
                           for K, G in zip(self.exp_K, psi[:-1])] + [psi[-1]]
                else:
                    psi = mpo_apply(T, psi, chi_max=rank_state)
                psi = hadamard_apply(v_tt, psi, chi_max=rank_state)
            record(psi)

        out = {"cores_list": snaps, "rdm_el": torch.stack(rdms),
               "norms": torch.stack(norms)}
        if eop_tts:
            out["expect"] = torch.stack(expects)
        return out

    # ---------------------------------------------------------- observables
    def rdm_el(self, cores):
        """Electronic reduced density matrix rho[a, b] =
        <psi| (|b><a| ⊗ 1) |psi>, zipped over the nuclear sites with the
        electronic indices left open (no dense reconstruction)."""
        E = torch.ones((1, 1), dtype=cores[0].dtype, device=cores[0].device)
        for G in cores[:-1]:
            E = torch.einsum("ac, anb, cnd -> bd", E, G.conj(), G)
        Ge = cores[-1]                       # (chi, ns, 1)
        return torch.einsum("ac, amb, cnb -> mn", E, Ge.conj(), Ge)

    def population(self, cores):
        return torch.diagonal(self.rdm_el(cores)).real
