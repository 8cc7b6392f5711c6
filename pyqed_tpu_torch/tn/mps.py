"""Matrix-product states and operators, two-site DMRG and TEBD (PyTorch).

Counterpart of ``pyqed_tpu/tn/mps.py`` (reference: pyqed/mps/mps.py —
``MPS:37`` (B form with bond singular values), ``MPO:640``,
``apply_mpo:702``, the zipper expectation ``:788-834``,
``two_site_dmrg:1200`` with Lanczos ``HamiltonianMultiply:1117``,
``tebd:1422``).

Conventions: B tensors have legs (vL, p, vR); MPO W tensors have legs
(wL, wR, p_out, p_in); environments E[ket, w, bra]. The tensors live on
one device, the card unless the builder is given ``device="cpu"``: the
contractions run there as pairwise einsums (cuBLAS), the QR, SVD and
``eigh`` on cuSOLVER. The local DMRG eigensolve is the JAX package's
fixed-iteration Lanczos, dead iterations masked instead of broken off, so
its loop reads nothing back to the host and keeps JAX's iteration count.
JAX pads the bond dimensions to buckets of 8 (``_bucket``) so that XLA
compiles once per bucket; torch compiles nothing, so the port works on
the true shapes (the zero padding never enters the Krylov space, so the
energies agree to rounding).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor


def _left_qr(Ms):
    """L→R QR sweep in place: left-canonical Ms[:-1]; the last tensor
    keeps the norm."""
    for i in range(len(Ms) - 1):
        chiL, d, chiR = Ms[i].shape
        Q, R = torch.linalg.qr(Ms[i].reshape(chiL * d, chiR))
        Ms[i] = Q.reshape(chiL, d, Q.shape[1])
        Ms[i + 1] = torch.einsum("ab, bpc -> apc", R, Ms[i + 1])


def _right_svd(Ms, chi_max=None):
    """R→L SVD sweep of a left-canonical chain into (Bs, Ss), each bond
    truncated to ``chi_max`` where given; with the left side canonical
    the singular values are the Schmidt spectra. Returns (Bs, Ss, the
    summed discarded weight as a tensor)."""
    L = len(Ms)
    dev = Ms[0].device
    Bs = [None] * L
    Ss = [torch.ones(1, dtype=torch.float64, device=dev)] * L
    err = torch.zeros((), dtype=torch.float64, device=dev)
    M = Ms[-1]
    for i in range(L - 1, 0, -1):
        chiL, d, chiR = M.shape
        U, S, Vh = torch.linalg.svd(M.reshape(chiL, d * chiR),
                                    full_matrices=False)
        if chi_max is not None:
            keep = min(chi_max, S.shape[0])
            err = err + (S[keep:] ** 2).sum()
            U, S, Vh = U[:, :keep], S[:keep], Vh[:keep]
        Bs[i] = Vh.reshape(Vh.shape[0], d, chiR)
        Ss[i] = S / torch.linalg.vector_norm(S)
        M = torch.einsum("apb, bc -> apc", Ms[i - 1], U * S.to(U.dtype))
    Bs[0] = M / torch.linalg.vector_norm(M)
    return Bs, Ss, err


class MPS:
    """Finite MPS in right-canonical (B) form with bond singular values
    (reference: pyqed/mps/mps.py:37). ``Bs`` and ``Ss`` are tensors, kept
    where they are (arrays become CPU tensors; the builders below take
    ``device``); ``Ss`` defaults to ones."""

    def __init__(self, Bs: Sequence, Ss: Optional[Sequence] = None,
                 bc="finite", form="B"):
        self.Bs = [as_tensor(B) for B in Bs]
        self.L = len(Bs)
        dev = self.Bs[0].device
        if Ss is None:
            Ss = [torch.ones(1, dtype=torch.float64, device=dev)
                  for _ in range(self.L)]
        self.Ss = [as_tensor(S, device=dev) for S in Ss]
        self.bc = bc
        self.form = form

    @property
    def device(self):
        return self.Bs[0].device

    @classmethod
    def from_product_state(cls, local_states, device=None):
        dev = resolve_device(device)
        Bs = [torch.as_tensor(np.asarray(v, dtype=complex).reshape(1, -1, 1),
                              device=dev) for v in local_states]
        return cls(Bs)

    @classmethod
    def random(cls, L, d=2, chi=8, seed=0, device=None):
        """Random normalized MPS in proper (Ss, Bs) canonical form, the
        recommended DMRG seed for Hamiltonians whose product eigenstates
        trap local sweeps. The entries are NumPy draws from
        ``default_rng(seed)``, as the JAX package's, so both start from the
        same tensors; then an L→R QR and an R→L SVD sweep on ``device``."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        chis = [1] + [min(chi, d ** (i + 1), d ** (L - i - 1))
                      for i in range(L - 1)] + [1]
        Ms = [torch.as_tensor(
            rng.standard_normal((chis[i], d, chis[i + 1]))
            + 1j * rng.standard_normal((chis[i], d, chis[i + 1])),
            device=dev) for i in range(L)]
        return cls._canonical(Ms)

    @classmethod
    def _canonical(cls, Ms, **kw):
        _left_qr(Ms)
        Ms[-1] = Ms[-1] / torch.linalg.vector_norm(Ms[-1])
        Bs, Ss, _ = _right_svd(Ms)
        return cls(Bs, Ss, **kw)

    def pad_noise(self, chi, noise=1e-8, seed=0):
        """A copy with bond dimensions enlarged to ``chi`` by tiny random
        entries (NumPy draws from ``default_rng(seed)``, as JAX's),
        re-canonicalized. TDVP from a low-rank (product) state suffers an
        O(dt)-per-unit-time projection error until the rank grows; seeding
        the extra bond directions removes it (the state changes by the
        order of ``noise``)."""
        rng = np.random.default_rng(seed)
        L = self.L
        dims = [B.shape[1] for B in self.Bs]
        chis = [1] + [min(chi, int(np.prod(dims[:i + 1])),
                          int(np.prod(dims[i + 1:])))
                      for i in range(L - 1)] + [1]
        Ms = []
        for i in range(L):
            B = self.get_theta1(i) if i == 0 else self.Bs[i]
            tgt = (chis[i], dims[i], chis[i + 1])
            M = torch.as_tensor(noise * (rng.standard_normal(tgt)
                                         + 1j * rng.standard_normal(tgt)),
                                device=self.device)
            M[:B.shape[0], :, :B.shape[2]] += B
            Ms.append(M)
        return MPS._canonical(Ms)

    @classmethod
    def from_dense(cls, psi, dims, chi_max=None, device=None):
        """Exact MPS decomposition of a state vector by R→L SVDs (bonds
        truncated to ``chi_max`` and to singular values above 1e-14), on
        ``device`` (a tensor's own device when None and ``psi`` is one)."""
        dev = (psi.device if isinstance(psi, torch.Tensor) and device is None
               else resolve_device(device))
        m = as_tensor(psi, device=dev).reshape(int(np.prod(dims)), 1)
        L = len(dims)
        tensors, mats = [], []
        chi_r = 1
        for i in reversed(range(L)):
            d = dims[i]
            m = m.reshape(-1, d * chi_r)
            U, S, Vh = torch.linalg.svd(m, full_matrices=False)
            if chi_max is not None and S.shape[0] > chi_max:
                U, S, Vh = U[:, :chi_max], S[:chi_max], Vh[:chi_max]
            nk = int((S > 1e-14).sum())
            U, S, Vh = U[:, :nk], S[:nk], Vh[:nk]
            tensors.insert(0, Vh.reshape(nk, d, chi_r))
            mats.insert(0, S)
            m = U * S.to(U.dtype)[None, :]
            chi_r = nk
        Ss = [torch.ones(1, dtype=torch.float64, device=dev)] + mats[1:]
        mps = cls(tensors, Ss)
        # absorb the leftover scalar phase and norm
        mps.Bs[0] = mps.Bs[0] * m.reshape(())
        return mps

    def copy(self):
        return MPS(list(self.Bs), list(self.Ss), self.bc, self.form)

    def get_bond_dimensions(self):
        return [B.shape[2] for B in self.Bs]

    def to_dense(self):
        psi = self.Bs[0]
        for B in self.Bs[1:]:
            psi = torch.einsum("apb, bqc -> apqc", psi, B).reshape(
                psi.shape[0], -1, B.shape[2])
        return psi.reshape(-1)

    # ---------------------------------------------------------------- forms
    def get_theta1(self, i):
        """S_i B_i (reference: pyqed/mps/mps.py:103)."""
        B = self.Bs[i]
        return self.Ss[i].to(B.dtype)[:, None, None] * B

    def get_theta2(self, i):
        """Two-site wavefunction (reference: pyqed/mps/mps.py:110)."""
        return torch.einsum("apb, bqc -> apqc", self.get_theta1(i),
                            self.Bs[i + 1])

    # ---------------------------------------------------------- observables
    def site_expectation_value(self, op):
        """<op> on every site (reference: pyqed/mps/mps.py:118)."""
        op = as_tensor(op, device=self.device)
        out = []
        for i in range(self.L):
            th = self.get_theta1(i)
            out.append(torch.einsum("apb, pq, aqb ->", th.conj(),
                                    op.to(th.dtype), th))
        return torch.stack(out)

    def bond_expectation_value(self, op):
        """<op_two_site> on every bond (reference: pyqed/mps/mps.py:128)."""
        op = as_tensor(op, device=self.device)
        out = []
        for i in range(self.L - 1):
            th = self.get_theta2(i)
            d1, d2 = th.shape[1], th.shape[2]
            o = op.to(th.dtype).reshape(d1, d2, d1, d2)
            out.append(torch.einsum("apqb, pqrs, arsb ->", th.conj(), o, th))
        return torch.stack(out)

    def correlation_function(self, op_i, i, op_j, j):
        """<op_i(i) op_j(j)> (reference: pyqed/mps/mps.py:163)."""
        if not i < j:
            raise ValueError(f"correlation_function needs i < j, got {i}, {j}")
        th = self.get_theta1(i)
        op_i = as_tensor(op_i, device=self.device).to(th.dtype)
        op_j = as_tensor(op_j, device=self.device).to(th.dtype)
        C = torch.einsum("apb, pq, aqc -> bc", th.conj(), op_i, th)
        for k in range(i + 1, j):
            B = self.Bs[k]
            C = torch.einsum("bc, bpd, cpe -> de", C, B.conj(), B)
        B = self.Bs[j]
        return torch.einsum("bc, bpd, pq, cqd ->", C, B.conj(), op_j, B)

    def entanglement_entropy(self):
        """von Neumann entropy at every internal bond
        (reference: pyqed/mps/mps.py:91)."""
        out = []
        for i in range(1, self.L):
            S2 = self.Ss[i] ** 2
            S2 = S2 / S2.sum()
            out.append(-(S2 * torch.log(S2 + 1e-300)).sum())
        return torch.stack(out)

    def norm(self):
        return torch.linalg.vector_norm(self.to_dense())

    def compress(self, chi_max, return_error=False):
        """Truncate every bond to dimension <= chi_max by a two-pass
        canonicalization sweep (L→R QR, then R→L truncated SVD)
        (reference: pyqed/mps/mps.py MPS.compress). Returns a new MPS (and
        the summed discarded weight as a float if return_error)."""
        Ms = list(self.Bs)
        _left_qr(Ms)
        Bs, Ss, err = _right_svd(Ms, chi_max=chi_max)
        out = MPS(Bs, Ss, bc=self.bc, form=self.form)
        return (out, float(err)) if return_error else out

    def correlation_length(self):
        """Correlation length from the second-largest transfer-matrix
        eigenvalue, xi = -L / ln|lambda_2 / lambda_1| (reference:
        pyqed/mps/mps.py MPS.correlation_length — infinite bc only)."""
        if self.bc != "infinite":
            raise ValueError("correlation_length requires bc='infinite'")
        B = self.Bs[0]
        chi = B.shape[0]
        T = torch.einsum("apb, cpd -> acbd", B, B.conj())
        for B in self.Bs[1:]:
            T = torch.einsum("acbd, bpe, dpf -> acef", T, B, B.conj())
        lam = torch.linalg.eigvals(T.reshape(chi * chi, chi * chi))
        mags = torch.sort(lam.abs(), descending=True).values
        return float(-self.L / torch.log(mags[1] / mags[0]))

    def overlap(self, other):
        C = torch.einsum("apb, apc -> bc", self.Bs[0].conj(), other.Bs[0])
        for k in range(1, self.L):
            C = torch.einsum("bc, bpd, cpe -> de", C, self.Bs[k].conj(),
                             other.Bs[k])
        return C.reshape(())


class MPO:
    """Finite MPO; W legs (wL, wR, p, p*) (reference:
    pyqed/mps/mps.py:640). ``Ws`` are tensors, kept where they are (arrays
    become CPU tensors; the builders take ``device``)."""

    def __init__(self, Ws: Sequence):
        self.Ws = [as_tensor(W) for W in Ws]
        self.L = len(Ws)

    @property
    def device(self):
        return self.Ws[0].device

    def to_dense(self):
        M = self.Ws[0]
        for W in self.Ws[1:]:
            M = torch.einsum("awpq, wbrs -> abprqs", M, W).reshape(
                M.shape[0], W.shape[1], M.shape[2] * W.shape[2],
                M.shape[3] * W.shape[3])
        return M[0, -1] if M.shape[1] > 1 else M[0, 0]

    def __matmul__(self, other):
        """MPO @ MPS -> MPS (uncompressed; use ``.compress`` after), or
        MPO @ MPO -> MPO (reference: pyqed/mps/mps.py:680)."""
        if isinstance(other, MPS):
            return apply_mpo(self, other)
        if isinstance(other, MPO):
            return MPO([torch.einsum("abpq, cdqr -> acbdpr", W1, W2).reshape(
                W1.shape[0] * W2.shape[0], W1.shape[1] * W2.shape[1],
                W1.shape[2], W2.shape[3])
                for W1, W2 in zip(self.Ws, other.Ws)])
        return NotImplemented

    def expect(self, mps: MPS):
        """<mps|MPO|mps> via the zipper contraction
        (reference: pyqed/mps/mps.py:795)."""
        th0 = mps.get_theta1(0)
        E = torch.einsum("kpx, wqp, kqy -> xwy", th0,
                         self.Ws[0][0].to(th0.dtype), th0.conj())
        for k in range(1, mps.L):
            E = _push_left(E, mps.Bs[k], self.Ws[k])
        return E[:, -1, :].trace() if E.shape[1] > 1 else E[:, 0, :].trace()


# ------------------------------------------------------ contractions
# Pairwise forms of the JAX package's multi-operand einsums, in the order
# that keeps every intermediate at chi^2 D d^2 at most.

def _push_left(LP, A, W):
    """E'[x, v, y] = LP[k, w, b] A[k, p, x] W[w, v, q, p] A*[b, q, y]."""
    t = torch.einsum("kwb, kpx -> wbpx", LP, A)
    t = torch.einsum("wbpx, wvqp -> bxvq", t, W.to(t.dtype))
    return torch.einsum("bxvq, bqy -> xvy", t, A.conj())


def _push_right(RP, B, W):
    """E'[x, v, y] = RP[k, w, b] B[x, p, k] W[v, w, q, p] B*[y, q, b]."""
    t = torch.einsum("kwb, xpk -> wbxp", RP, B)
    t = torch.einsum("wbxp, vwqp -> bxvq", t, W.to(t.dtype))
    return torch.einsum("bxvq, yqb -> xvy", t, B.conj())


def _two_site_action(LP, W1, W2, RP, th):
    """H_eff th for two sites: LP[k,w,b] th[k,p,q,x] W1[w,v,r,p]
    W2[v,u,s,q] RP[x,u,y] -> [b, r, s, y]."""
    t = torch.einsum("kwb, kpqx -> wbpqx", LP, th)
    t = torch.einsum("wbpqx, wvrp -> bqxvr", t, W1)
    t = torch.einsum("bqxvr, vusq -> bxrus", t, W2)
    return torch.einsum("bxrus, xuy -> brsy", t, RP)


def _one_site_action(LP, W, RP, M):
    """LP[k,w,b] M[k,p,x] W[w,v,q,p] RP[x,v,y] -> [b, q, y]."""
    t = torch.einsum("kwb, kpx -> wbpx", LP, M)
    t = torch.einsum("wbpx, wvqp -> bxvq", t, W)
    return torch.einsum("bxvq, xvy -> bqy", t, RP)


def _bond_action(LP, RP, C):
    """LP[k,w,b] C[k,x] RP[x,w,y] -> [b, y]."""
    t = torch.einsum("kwb, kx -> wbx", LP, C)
    return torch.einsum("wbx, xwy -> by", t, RP)


def _boundary(chi, D, col, dtype, device):
    """The open-end environment: zeros with the identity in channel
    ``col`` (0 on the left, -1 on the right)."""
    E = torch.zeros((chi, D, chi), dtype=dtype, device=device)
    E[:, col, :] = torch.eye(chi, dtype=dtype, device=device)
    return E


def _same_device(mpo, mps, who):
    if mpo.device != mps.device:
        raise ValueError(f"{who}: the MPO is on {mpo.device}, the MPS on "
                         f"{mps.device}")


def apply_mpo(mpo: MPO, mps: MPS, chi_max=None):
    """Apply an MPO to an MPS: per site B'_{(a l), p, (b r)} =
    sum_q W_{a b p q} B_{l q r}, with the MPO boundary (row 0 left,
    column -1 right) contracted in, then optional SVD compression to
    ``chi_max`` (reference: pyqed/mps/mps.py:702, completed in the JAX
    package)."""
    _same_device(mpo, mps, "apply_mpo")
    Bs = []
    for W, B in zip(mpo.Ws, mps.Bs):
        dtype = torch.promote_types(W.dtype, B.dtype)
        T = torch.einsum("abpq, lqr -> albpr", W.to(dtype), B.to(dtype))
        a, l, b, p, r = T.shape
        Bs.append(T.permute(0, 1, 3, 2, 4).reshape(a * l, p, b * r))
    a0, l0 = mpo.Ws[0].shape[0], mps.Bs[0].shape[0]
    Bs[0] = Bs[0].reshape(a0, l0, *Bs[0].shape[1:])[0]
    aL, lL = mpo.Ws[-1].shape[1], mps.Bs[-1].shape[-1]
    Bs[-1] = Bs[-1].reshape(*Bs[-1].shape[:-1], aL, lL)[..., -1, :]
    out = MPS(Bs, bc=mps.bc, form=None)
    if chi_max is not None:
        out = out.compress(chi_max)
    return out


def mpo_nearest_neighbor(L, h_onsite, h_bond_left, h_bond_right, d=None,
                         device=None):
    """Standard W for H = sum_i h_onsite(i) + sum_i h_L(i) h_R(i+1):

        W = [[I, h_L, h_on], [0, 0, h_R], [0, 0, I]]
    """
    hs = np.asarray(h_onsite, dtype=complex)
    d = hs.shape[0]
    W = np.zeros((3, 3, d, d), dtype=complex)
    W[0, 0] = W[2, 2] = np.eye(d)
    W[0, 1] = np.asarray(h_bond_left)
    W[0, 2] = hs
    W[1, 2] = np.asarray(h_bond_right)
    W = torch.as_tensor(W, device=resolve_device(device))
    return MPO([W] * L)


def mpo_tfim(L, J=1.0, h=1.0, device=None):
    """TFIM MPO: H = -J sum sz sz - h sum sx."""
    sx = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    sz = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    return mpo_nearest_neighbor(L, -h * sx, -J * sz, sz, device=device)


def mpo_heisenberg(L, J=1.0, h=0.0, device=None):
    """Heisenberg MPO with a 5-dim bond."""
    sx = np.array([[0, 1], [1, 0]], dtype=complex) / 2
    sy = np.array([[0, -1j], [1j, 0]], dtype=complex) / 2
    sz = np.array([[1, 0], [0, -1]], dtype=complex) / 2
    I = np.eye(2, dtype=complex)
    W = np.zeros((5, 5, 2, 2), dtype=complex)
    for c, op in enumerate([I, J * sx, J * sy, J * sz, h * sz]):
        W[0, c] = op
    W[1, 4], W[2, 4], W[3, 4], W[4, 4] = sx, sy, sz, I
    W = torch.as_tensor(W, device=resolve_device(device))
    return MPO([W] * L)


# ------------------------------------------------------------------- DMRG

def _lanczos_core(matvec, v0, k):
    """One k-step Lanczos pass for the lowest eigenpair (the JAX package's
    ``_lanczos_core_jit``, which replaces the reference's scipy eigsh,
    pyqed/mps/mps.py:1117). No data-dependent control flow: an iteration
    after a breakdown is masked (its basis vector zeroed, its diagonal
    entry 1e30, so the small eigh ignores it), so the loop reads nothing
    back to the host. Full reorthogonalization against the basis."""
    n = v0.shape[0]
    dtype = v0.dtype
    dev = v0.device
    rdt = v0.real.dtype
    v0 = v0 / torch.linalg.vector_norm(v0)
    V = torch.zeros((k, n), dtype=dtype, device=dev)
    V[0] = v0
    alphas = torch.full((k,), 1e30, dtype=rdt, device=dev)
    betas = torch.zeros((max(k - 1, 0),), dtype=rdt, device=dev)
    alive = torch.ones((k,), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)

    w = matvec(v0)
    a = torch.vdot(v0, w).real
    alphas[0] = a
    w = w - a * v0
    for j in range(1, k):
        b = torch.linalg.vector_norm(w)
        ok = (b > 1e-13) & alive[j - 1]
        v = ok.to(rdt) * w / torch.where(b > 1e-13, b, one)
        # V.conj() @ v without materialising a conjugate copy of V
        v = v - V.T @ (V @ v.conj()).conj()
        nv = torch.linalg.vector_norm(v)
        v = v / torch.where(nv > 1e-13, nv, one)
        V[j] = (ok & (nv > 1e-13)).to(rdt) * v
        w = matvec(v)
        a = torch.vdot(v, w).real
        alphas[j] = torch.where(ok, a, 1e30)
        betas[j - 1] = torch.where(ok, b, 0.0)
        alive[j] = ok
        w = w - a * v - b * V[j - 1]
    T = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
    evals, evecs = torch.linalg.eigh(T)
    psi = V.T @ evecs[:, 0].to(dtype)
    return evals[0], psi / torch.linalg.vector_norm(psi)


def _local_ground(LP, W1, W2, RP, th0, k=20, restarts=3):
    """Restarted Lanczos for the ground state of the two-site effective
    Hamiltonian (the JAX package's ``_dmrg_local_ground``)."""
    shape = th0.shape

    def mv(x):
        return _two_site_action(LP, W1, W2, RP, x.reshape(shape)).reshape(-1)

    v = th0.reshape(-1)
    E = None
    for _ in range(restarts):
        E, v = _lanczos_core(mv, v, k)
    return E, v.reshape(shape)


class DMRG:
    """Two-site DMRG ground-state solver (reference:
    pyqed/mps/mps.py:1200 ``two_site_dmrg``), on the MPS's device; the MPO
    must be there too. Each bond update reads the host twice (the local
    energy and the kept rank), besides the syncs of cuSOLVER's SVD and
    ``eigh`` (PERF.md counts them on the card)."""

    def __init__(self, mpo: MPO, mps: MPS, chi_max=32, eps=1e-12):
        _same_device(mpo, mps, "DMRG")
        self.mpo = mpo
        self.psi = mps
        self.chi_max = chi_max
        self.eps = eps
        self.L = mps.L
        self.LPs = [None] * self.L
        self.RPs = [None] * self.L
        D = mpo.Ws[0].shape[0]
        dev = mps.device
        self.LPs[0] = _boundary(mps.Bs[0].shape[0], D, 0, torch.complex128,
                                dev)
        self.RPs[-1] = _boundary(mps.Bs[-1].shape[2], D, -1,
                                 torch.complex128, dev)
        for i in range(self.L - 1, 1, -1):
            self.update_RP(i)

    def update_LP(self, i):
        """LP[i+1] from LP[i] with the left-canonical tensor
        A_i = S_i B_i S_{i+1}^{-1} (reference: contract_from_left,
        pyqed/mps/mps.py:911)."""
        j = i + 1
        B = self.psi.Bs[i]
        Sj = (self.psi.Ss[j] if j < self.L
              else torch.ones(B.shape[2], dtype=torch.float64,
                              device=B.device))
        invSj = torch.where(Sj > 1e-12, 1.0 / Sj, 0.0)
        A = (self.psi.Ss[i][:, None, None] * B * invSj[None, None, :])
        self.LPs[j] = _push_left(self.LPs[i], A, self.mpo.Ws[i])

    def update_RP(self, i):
        self.RPs[i - 1] = _push_right(self.RPs[i], self.psi.Bs[i],
                                      self.mpo.Ws[i])

    def eff_matvec(self, i, shape):
        LP, RP = self.LPs[i], self.RPs[i + 1]
        W1, W2 = self.mpo.Ws[i], self.mpo.Ws[i + 1]

        def mv(x):
            return _two_site_action(LP, W1, W2, RP,
                                    x.reshape(shape)).reshape(-1)
        return mv

    def sweep(self):
        E = None
        for i in list(range(self.L - 1)) + list(range(self.L - 2, -1, -1)):
            E = self.update_bond(i)
        return E

    def update_bond(self, i):
        th = self.psi.get_theta2(i).to(torch.complex128)
        chiL, d1, d2, chiR = th.shape
        E, th = _local_ground(self.LPs[i], self.mpo.Ws[i].to(th.dtype),
                              self.mpo.Ws[i + 1].to(th.dtype),
                              self.RPs[i + 1], th,
                              k=min(40, th.numel()), restarts=3)
        E = float(E)
        U, S, Vh = torch.linalg.svd(th.reshape(chiL * d1, d2 * chiR),
                                    full_matrices=False)
        chi = max(1, min(self.chi_max, int((S > self.eps).sum())))
        U, S, Vh = U[:, :chi], S[:chi], Vh[:chi]
        S = S / torch.linalg.vector_norm(S)
        SL = self.psi.Ss[i]
        invSL = torch.where(SL > 1e-12, 1.0 / SL, 0.0)
        self.psi.Bs[i] = (invSL[:, None, None] * U.reshape(chiL, d1, chi)
                          * S[None, None, :])
        self.psi.Ss[i + 1] = S
        self.psi.Bs[i + 1] = Vh.reshape(chi, d2, chiR)
        self.update_LP(i)
        self.update_RP(i + 1)
        return E

    def run(self, sweeps=5, tol=1e-10, verbose=False):
        """Returns (energies per sweep, ground-state MPS); stops early
        once a sweep changes the energy by less than ``tol``."""
        energies = []
        for s in range(sweeps):
            self.sweep()
            energies.append(float(self.mpo.expect(self.psi).real))
            if verbose:
                print(f"sweep {s}: E = {energies[-1]:.12f}")
            if len(energies) > 1 and abs(energies[-1] - energies[-2]) < tol:
                break
        return energies, self.psi


def two_site_dmrg(mpo, mps, chi_max=32, sweeps=5):
    """Functional entry matching the reference name
    (pyqed/mps/mps.py:1200)."""
    return DMRG(mpo, mps, chi_max=chi_max).run(sweeps=sweeps)


# ------------------------------------------------------------------- TEBD

def tebd(mps: MPS, bond_op, dt, nt, chi_max=32, order=2):
    """Real-time TEBD with a uniform nearest-neighbor bond Hamiltonian
    (reference: pyqed/mps/mps.py:1422), on the MPS's device.

    bond_op: (d*d, d*d) two-site Hamiltonian h (a tensor must be on the
    MPS's device); evolution by Trotterized e^{-i h dt} over even/odd
    bonds, Strang-ordered for ``order=2``.
    """
    dev = mps.device
    if isinstance(bond_op, torch.Tensor) and bond_op.device != dev:
        raise ValueError(f"tebd: bond_op is on {bond_op.device}, the MPS on "
                         f"{dev}")
    d = mps.Bs[0].shape[1]
    h = as_tensor(bond_op, device=dev).to(torch.complex128)
    w, V = torch.linalg.eigh(h)

    def gate(tau):
        return ((V * torch.exp(-1j * w * tau)) @ V.mH).reshape(d, d, d, d)

    U_full, U_half = gate(dt), gate(dt / 2)

    def apply_gate(psi, i, U):
        th = torch.einsum("pqrs, arsb -> apqb", U,
                          psi.get_theta2(i).to(U.dtype))
        chiL, d1, d2, chiR = th.shape
        Um, S, Vh = torch.linalg.svd(th.reshape(chiL * d1, d2 * chiR),
                                     full_matrices=False)
        chi = max(1, min(chi_max, int((S > 1e-12).sum())))
        Um, S, Vh = Um[:, :chi], S[:chi], Vh[:chi]
        S = S / torch.linalg.vector_norm(S)
        SL = psi.Ss[i]
        invSL = torch.where(SL > 1e-12, 1.0 / SL, 0.0)
        psi.Bs[i] = (invSL[:, None, None] * Um.reshape(chiL, d1, chi)
                     * S[None, None, :])
        psi.Ss[i + 1] = S
        psi.Bs[i + 1] = Vh.reshape(chi, d2, chiR)

    psi = mps.copy()
    even = list(range(0, psi.L - 1, 2))
    odd = list(range(1, psi.L - 1, 2))
    for _ in range(nt):
        if order == 2:
            for i in even:
                apply_gate(psi, i, U_half)
            for i in odd:
                apply_gate(psi, i, U_full)
            for i in even:
                apply_gate(psi, i, U_half)
        else:
            for i in even + odd:
                apply_gate(psi, i, U_full)
    return psi


MatrixProductState = MPS    # reference drop-in name (pyqed/mps/mps.py)


def mps_from_reference(Bs, Ss=None, *, device):
    """The port's MPS from a JAX ``MPS``'s tensors given as NumPy arrays
    (``[np.asarray(B) for B in mps.Bs]``, likewise ``Ss``), on
    ``device``."""
    dev = resolve_device(device)
    return MPS([torch.as_tensor(np.array(B), device=dev) for B in Bs],
               None if Ss is None else
               [torch.as_tensor(np.array(S), device=dev) for S in Ss])


def mpo_from_reference(Ws, *, device):
    """The port's MPO from a JAX ``MPO``'s tensors given as NumPy arrays,
    on ``device``."""
    dev = resolve_device(device)
    return MPO([torch.as_tensor(np.array(W), device=dev) for W in Ws])
