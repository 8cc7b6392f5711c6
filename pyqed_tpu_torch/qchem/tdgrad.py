"""Analytic post-SCF nuclear gradients: a generic AD + Z-vector engine.

PyTorch counterpart of ``pyqed_tpu/qchem/tdgrad.py`` (the reference has
no excited-state or correlated forces; its ground-state gradients
delegate to pyscf — pyqed/qchem/grad.py:9). Analytic nuclear gradients
and relaxed dipoles for ANY frozen-amplitude orbital functional
ω(C; h, ERI) — CIS/TDA, TDHF/RPA, TDDFT/TDA (LDA), MP2, UCIS, UMP2 and
the CCSD Lagrangian:

* the orbital Lagrangian L_pq = ∂ω/∂κ_pq and the explicit-integral
  weights (∂ω/∂h, ∂ω/∂ERI) come from ``torch.func`` autodiff of the ω
  definition;
* the CPHF operator (the Jacobian of the Brillouin block F_vo over
  orbital rotations) is a ``torch.func.jacrev`` Jacobian, chunked;
* ONE Z-vector linear solve converts the 3N response sums into a
  single contraction (Handy-Schaefer).

Why frozen amplitudes are exact: the functionals are STATIONARY in
their amplitudes, so amplitude response drops; stationarity also makes
ω first-order invariant under the redundant occ-occ/virt-virt rotations,
so the symmetric U^ξ blocks are fixed by orthonormality, U_sym = −S^ξ/2.

Everything runs on the mean field's device; results are NumPy, as the
JAX package's. The nuclear gradient never builds the derivative of the
ERI tensor for an atom and axis (JAX's dA, natm × 3 tensors of nao⁴):
every dA-dependent term of dω is a contraction of dA with a weight W,
and dA = m_p E_pqkl + m_q E_qpkl + m_k E_klpq + m_l E_lkpq (E = the bra
derivative dERI[x], m the AO mask of the atom), so each such
contraction is Σ_p m_p Σ_qkl E_pqkl (W_pqkl + W_qpkl + W_klpq + W_klqp):
one share per AO and axis, summed per atom. The CPHF right-hand side's
Coulomb and exchange terms become scalars through the Z vector
(Zao = C_v Z C_oᵀ) and are contracted as rank-one weights without being
built. :meth:`ResponseEngine.domega` keeps the general route for any
other perturbation (fields; a single coordinate's dS, dh, dA).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.func import grad, jacfwd, jacrev

from .basis import ATOMIC_NUMBER

__all__ = ["cis_gradient", "tda_gradient", "cis_dipole",
           "mp2_gradient",
           "mp2_dipole", "ccsd_gradient", "tdhf_gradient",
           "tddft_tda_gradient", "tddft_tda_dipole", "ump2_gradient",
           "ump2_dipole", "ucis_gradient", "ucis_dipole", "tdhf_dipole",
           "ccsd_dipole",
           "response_gradient",
           "ResponseEngine", "ResponseEngineU"]

#: the orbital Jacobians (CPHF operators) are taken this many output rows
#: at a time (``jacrev(chunk_size=...)``); the XC block's chunk is cut
#: further so that one chunk's grid intermediates stay near 2**28 numbers
JAC_CHUNK = 256


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _on(x, dev):
    """``x`` as a float64 tensor on ``dev`` (None stays None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=float), device=dev)


def _check_cartesian(mol):
    if getattr(mol, "csph", None) is not None:
        raise NotImplementedError("ResponseEngine needs the "
                                  "Cartesian-AO SCF (spherical=False)")


def _jk(eri, D):
    """(J, K) of density ``D`` for a traced ERI tensor (the functionals'
    own builds: their ERI argument is differentiated)."""
    return (torch.einsum("pqkl, kl -> pq", eri, D),
            torch.einsum("pkql, kl -> pq", eri, D))


def _g_hat(G, no):
    """The weight of S^ξ_MO in Σ G·U with U_oo = −S_oo/2, U_vv = −S_vv/2,
    U_ov = −S_ov, U_vo = 0."""
    out = torch.zeros_like(G)
    out[:no, :no] = -0.5 * G[:no, :no]
    out[no:, no:] = -0.5 * G[no:, no:]
    out[:no, no:] = -G[:no, no:]
    return out


def _u_of_smo(Smo, no):
    U = torch.zeros_like(Smo)
    U[:no, :no] = -0.5 * Smo[:no, :no]
    U[no:, no:] = -0.5 * Smo[no:, no:]
    U[:no, no:] = -Smo[:no, no:]
    return U


def _nuclear_contraction(mol, Wh, Weri, Gao, j_terms, k_terms):
    """Σ over the nuclear displacements (natm, 3) of

        Wh · dh + Weri · dA + Gao · dS
        + Σ c Σ dA_pqkl Z_pq D_kl  (j_terms: (c, Z, D))
        + Σ c Σ dA_pkql Z_pq D_kl  (k_terms: (c, Z, D)),

    D symmetric, from the cached bra-derivative integrals of
    ``grad.derivative_integrals`` (dERI read a few times, never a dA).
    Returns a tensor on the integrals' device."""
    from .grad import derivative_integrals
    from .lo import cart_atom_indices
    dS1, dT1, dV, dE1 = derivative_integrals(mol)
    dev = dE1.device
    n = dS1.shape[-1]
    Z = torch.as_tensor([float(ATOMIC_NUMBER[s]) for s, _ in mol.atoms],
                        dtype=torch.float64, device=dev)
    dh1 = dT1 - torch.einsum("a, axpq -> xpq", Z, dV)
    Whs = Wh + Wh.T
    # one-electron and overlap terms: bra + ket shares by symmetry
    v = (torch.sum(dh1 * Whs, dim=2)
         + torch.sum(dS1 * (Gao + Gao.T), dim=2))           # (3, n)
    if Weri is not None:
        Wsym = (Weri + Weri.permute(1, 0, 2, 3) + Weri.permute(2, 3, 0, 1)
                + Weri.permute(3, 2, 0, 1))
        v = v + torch.stack([torch.einsum("pqkl, pqkl -> p", dE1[x], Wsym)
                             for x in range(3)])
        del Wsym
    mats, shares = [], []
    for kind, terms in (("J", j_terms), ("K", k_terms)):
        for c, Zm, D in terms:
            Zs = Zm + Zm.T
            mats += [D, Zs]
            shares.append((kind, c, Zs, D, len(mats) - 2, len(mats) - 1))
    if mats:
        M = torch.stack(mats).reshape(len(mats), n * n).T   # (n², m)
        # J-like: (E M)[x, p, q] = Σ_kl E[x,p,q,k,l] M_kl
        EJ = (dE1.reshape(3 * n * n, n * n) @ M).reshape(3, n, n, -1)
        # K-like: K(E, M)[x, p, k] = Σ_ql E[x,p,q,k,l] M_ql, read with
        # E_pqkl = E_pqlk as a batched product over (x, p)
        EK = (dE1.reshape(3 * n, n * n, n).transpose(1, 2) @ M) \
            .reshape(3, n, n, -1)
        for kind, c, Zs, D, iD, iZ in shares:
            E = EJ if kind == "J" else EK
            v = v + c * (torch.sum(Zs * E[..., iD], dim=2)
                         + torch.sum(D * E[..., iZ], dim=2))
    ao_atoms = torch.as_tensor(cart_atom_indices(mol), device=dev)
    g = torch.zeros((mol.natm, 3), dtype=torch.float64, device=dev)
    g.index_add_(0, ao_atoms, v.T)
    # the nuclear-attraction operator's own centre: Z_A (dV_A + dV_Aᵀ)
    return g + Z[:, None] * torch.einsum("axpq, pq -> ax", dV, Whs)


class ResponseEngine:
    """AD + Z-vector derivative engine for a frozen-amplitude orbital
    functional ω(κ; h, ERI): builds the Lagrangian, the CPHF Jacobian,
    and the Z vector ONCE; :meth:`domega` then evaluates dω for ANY
    perturbation given its AO derivative matrices (dS, dh, dA) —
    electric fields (dh = +μ_x in the h → h + F·μ_ao convention of
    dip_moment/polarizability, so μ_relaxed = μ_HF − dω/dF; dS = dA =
    None), a single nuclear coordinate, or anything else;
    :meth:`nuclear_gradient` takes every nuclear coordinate at once.

    ``omega_fn(kappa, h, eri)`` is written in torch ops (it is
    differentiated by ``torch.func``). ``hfx``: exact-exchange fraction
    in the CPHF Fock (1.0 = HF, the hybrid fraction for KS, 0.0 pure
    functionals). ``xc``: optional dict of differentiable XC blocks on the
    traceable Becke grid, 'omega_xc'(kappa, coords) -> scalar added to ω
    and 'fock_vo_xc'(kappa, coords) -> (nv, no) added to the Brillouin
    block, and the 'chunk_size' of their Jacobians. ``seconds`` records
    the stages (Lagrangian, CPHF Jacobian, Z solve; :meth:`nuclear_gradient`
    adds its contraction)."""

    def __init__(self, mf, omega_fn, check_value=None, check_tol=1e-6,
                 hfx=1.0, xc=None):
        mol = mf.mol
        _check_cartesian(mol)
        self.mf = mf
        no = mf.nocc
        C = mf.mo_coeff
        dev = C.device
        self.device = dev
        nmo = C.shape[1]
        nv = nmo - no
        h, ERI = mf.hcore, mf.eri
        self.hfx = hfx
        coords0 = torch.as_tensor(np.array([np.asarray(x, float)
                                            for _, x in mol.atoms]),
                                  device=dev)
        self.seconds = {}
        t0 = time.perf_counter()
        k0 = torch.zeros((nmo, nmo), dtype=torch.float64, device=dev)
        w0 = float(omega_fn(k0, h, ERI))
        if xc is not None:
            w0 += float(xc["omega_xc"](k0, coords0))
        if check_value is not None and abs(w0 - check_value) > check_tol:
            raise RuntimeError(f"omega functional ({w0}) != expected "
                               f"({check_value}) — stale mf/amplitudes?")
        self.w0 = w0

        # AD: orbital Lagrangian and explicit integral weights
        L, Wh, Weri = grad(omega_fn, argnums=(0, 1, 2))(k0, h, ERI)
        self.gx_omega = None
        if xc is not None:
            Lx, gx = grad(xc["omega_xc"], argnums=(0, 1))(k0, coords0)
            L = L + Lx
            self.gx_omega = gx                               # (natm, 3)
        # the oo/vv-invariance (amplitude stationarity) check
        asym = max(float(torch.max(torch.abs(L[:no, :no] - L[:no, :no].T))),
                   float(torch.max(torch.abs(L[no:, no:] - L[no:, no:].T))))
        if asym > 1e-5 * max(1.0, float(torch.max(torch.abs(L)))):
            raise RuntimeError("oo/vv Lagrangian not symmetric: the "
                               "functional is not stationary in its "
                               "amplitudes")
        _sync(dev)
        t1 = time.perf_counter()

        # CPHF operator: Jacobian of the Brillouin block
        from .scf import jk_builder
        Jf, Kf = jk_builder(ERI)

        def fock_vo(kappa):
            Cr = C + C @ kappa
            Co, Cv = Cr[:, :no], Cr[:, no:]
            D = 2.0 * Co @ Co.T
            F = h + Jf(D) - 0.5 * hfx * Kf(D)
            return Cv.T @ F @ Co                   # (nv, no)

        J1 = jacrev(fock_vo, chunk_size=JAC_CHUNK)(k0)
        del Jf, Kf
        self.gx_fockvo = None
        if xc is not None:
            cs = xc["chunk_size"]
            J1 = J1 + jacrev(xc["fock_vo_xc"], argnums=0,
                             chunk_size=cs)(k0, coords0)
            self.gx_fockvo = jacrev(xc["fock_vo_xc"], argnums=1,
                                    chunk_size=cs)(k0, coords0)
        _sync(dev)
        t2 = time.perf_counter()
        # linear operator on the vo unknown (U_ov = −Sξ_ov − U_voᵀ)
        Mlin = (J1[:, :, no:, :no].reshape(nv * no, nv * no)
                - J1[:, :, :no, no:].transpose(2, 3)
                .reshape(nv * no, nv * no))
        Lam = (L[no:, :no] - L[:no, no:].T).reshape(-1)
        self.Z = torch.linalg.solve(Mlin.T, Lam).reshape(nv, no)
        _sync(dev)
        self.seconds.update(lagrangian=t1 - t0, cphf_jacobian=t2 - t1,
                            z_solve=time.perf_counter() - t2)
        self.L, self.Wh, self.Weri, self.J1 = L, Wh, Weri, J1
        self.C, self.no, self.nmo, self.nv = C, no, nmo, nv
        self.D0 = mf.dm

    def domega(self, dS, dh, dA=None, atom_coord=None):
        """dω for one perturbation from its AO derivative matrices
        (tensors or NumPy; dS may be None for a field); ``atom_coord=(a,
        x)`` adds the XC grid-motion terms for that nuclear coordinate."""
        dev = self.device
        C, no, nmo = self.C, self.no, self.nmo
        dh = _on(dh, dev)
        dA = _on(dA, dev)
        dw = torch.sum(self.Wh * dh)
        if dA is not None:
            dw = dw + torch.sum(self.Weri * dA)
        # orthonormality (symmetric) parts of U^ξ
        U = (_u_of_smo(C.T @ _on(dS, dev) @ C, no) if dS is not None
             else torch.zeros((nmo, nmo), dtype=C.dtype, device=dev))
        dw = dw + torch.sum(self.L * U)
        # CPHF RHS: 0 = F^expl_vo + J1:U_known + Mlin U_vo
        Fx = dh
        if dA is not None:
            Fx = (Fx + torch.einsum("pqkl, kl -> pq", dA, self.D0)
                  - 0.5 * self.hfx * torch.einsum("pkql, kl -> pq", dA,
                                                  self.D0))
        Fexpl_vo = C[:, no:].T @ Fx @ C[:, :no]
        if atom_coord is not None and self.gx_fockvo is not None:
            a, x = atom_coord
            Fexpl_vo = Fexpl_vo + self.gx_fockvo[:, :, a, x]
        if atom_coord is not None and self.gx_omega is not None:
            dw = dw + self.gx_omega[atom_coord]
        rhs = -(Fexpl_vo + torch.einsum("aipq, pq -> ai", self.J1, U))
        return float(dw + torch.sum(self.Z * rhs))

    def nuclear_gradient(self):
        """dω/dR (natm, 3) NumPy over all nuclear displacements, by the
        fused dERI contraction (see the module docstring)."""
        t0 = time.perf_counter()
        C, no = self.C, self.no
        Co, Cv = C[:, :no], C[:, no:]
        Zao = Cv @ self.Z @ Co.T
        Jz = torch.einsum("ai, aipq -> pq", self.Z, self.J1)
        Gao = C @ _g_hat(self.L - Jz, no) @ C.T
        k_terms = [(0.5 * self.hfx, Zao, self.D0)] if self.hfx else []
        g = _nuclear_contraction(self.mf.mol, self.Wh - Zao, self.Weri,
                                 Gao, [(-1.0, Zao, self.D0)], k_terms)
        if self.gx_omega is not None:
            g = g + self.gx_omega
        if self.gx_fockvo is not None:
            g = g - torch.einsum("ai, aiAx -> Ax", self.Z, self.gx_fockvo)
        out = g.cpu().numpy()
        self.seconds["contraction"] = time.perf_counter() - t0
        return out


def response_gradient(mf, omega_fn, check_value=None, check_tol=1e-6):
    """dω/dR (natm, 3) for a frozen-amplitude orbital functional.

    omega_fn(kappa, h, eri) -> scalar: ω expressed in torch ops through
    rotated MO coefficients C(I + κ) and the AO integrals; MUST be
    stationary in its internal amplitudes and therefore first-order
    invariant under occ-occ/virt-virt rotations (validated at runtime
    through the symmetry of the oo/vv Lagrangian blocks).
    ``check_value``: if given, ω(0) must match it to ``check_tol``."""
    return ResponseEngine(mf, omega_fn, check_value,
                          check_tol).nuclear_gradient()


def _field_dipole(eng, mf, origin, mu_ref):
    """μ_ref − dω/dF over the three field directions (NumPy (3,))."""
    from .basis import dipole_matrix
    mu_ao = dipole_matrix(mf.mol.bfs, origin)
    corr = np.array([eng.domega(None, mu_ao[x]) for x in range(3)])
    return np.asarray(mu_ref) - corr


# =====================================================================
# CIS / TDA
# =====================================================================

def _cis_engine(td, state=1):
    """ResponseEngine for the frozen-X CIS/TDA functional (shared by
    gradient and dipole clients). Restricted closed-shell TDA (singlet
    or triplet) on the Cartesian-AO SCF."""
    mf = td.mf
    if hasattr(mf, "f_exc"):
        raise NotImplementedError("cis_gradient covers HF references; "
                                  "TDDFT gradients need the XC kernel "
                                  "in the functional")
    no = mf.nocc
    C = mf.mo_coeff
    nv = C.shape[1] - no
    X = td.xy[:, state - 1].to(C.dtype).reshape(no, nv)
    # singlet: A = dd(e) + 2(ia|jb) − (ij|ab); triplet drops the
    # Coulomb coupling (tdscf.tda_matrix semantics)
    c2 = 2.0 if getattr(td, "singlet", True) else 0.0

    def omega(kappa, h_, eri_):
        Cr = C + C @ kappa           # first order is exact for grads
        Co, Cv = Cr[:, :no], Cr[:, no:]
        J, K = _jk(eri_, 2.0 * Co @ Co.T)
        F = h_ + J - 0.5 * K
        R = Co @ X @ Cv.T
        return (torch.sum((X.T @ X) * (Cv.T @ F @ Cv))
                - torch.sum((X @ X.T) * (Co.T @ F @ Co))
                + c2 * torch.einsum("pqkl, pq, kl ->", eri_, R, R)
                - torch.einsum("pqkl, pk, ql ->", eri_, R, R))

    return ResponseEngine(mf, omega,
                          check_value=float(np.asarray(td.e)[state - 1]))


def cis_gradient(td, state=1):
    """Analytic nuclear gradient (natm, 3) of E_SCF + ω_TDA for
    ``state`` (1-based) — see :func:`_cis_engine`."""
    from .grad import rhf_gradient
    eng = _cis_engine(td, state)
    return np.asarray(rhf_gradient(td.mf), float) + eng.nuclear_gradient()


def tda_gradient(td, state=1):
    """Alias of :func:`cis_gradient`."""
    return cis_gradient(td, state)


def cis_dipole(td, state=1, origin=(0.0, 0.0, 0.0)):
    """Orbital-relaxed EXCITED-STATE dipole moment (3,) in a.u. for
    CIS/TDA state ``state``: μ* = μ_HF − dω/dF through the same Z-vector
    engine with a field perturbation."""
    mf = td.mf
    return _field_dipole(_cis_engine(td, state), mf, origin,
                         mf.dip_moment(origin=origin))


# =====================================================================
# MP2 (Hylleraas functional)
# =====================================================================

def _spin_maps(n, dev):
    """Interleaved spin-orbital maps (2p = spatial p alpha, 2p+1 = beta,
    the qchem.ci spinorb_ints convention): spatial index and same-spin
    mask."""
    spat = torch.arange(n, device=dev).repeat_interleave(2)
    spin = torch.arange(2, device=dev).repeat(n)
    same = (spin[:, None] == spin[None, :]).to(torch.float64)
    return spat, same


def _mp2_omega(mf):
    """(omega_fn, E2_ref): the frozen-t Hylleraas functional of ``mf``
    (see :func:`mp2_gradient`).

    Only the occ-occ-virt-virt block of <pq||rs> and the oo/vv Fock
    blocks enter the functional, so they are built from the (ia|jb)
    MO block alone: the JAX package builds the full (2 nmo)⁴
    spin-orbital tensor and indexes it (the same functional)."""
    from .scf import ao2mo
    no = mf.nocc
    C = mf.mo_coeff
    dev = C.device
    eps = mf.mo_energy
    spo, sameo = _spin_maps(no, dev)
    nv = C.shape[1] - no
    spv, samev = _spin_maps(nv, dev)
    same_ov = (torch.arange(2, device=dev).repeat(no)[:, None]
               == torch.arange(2, device=dev).repeat(nv)[None, :]) \
        .to(torch.float64)

    def goovv(Co, Cv, eri_):
        # <ij||ab> = (ia|jb) d(si,sa) d(sj,sb) − (ib|ja) d(si,sb) d(sj,sa)
        ovov = ao2mo(eri_, Co, Cv, Co, Cv)           # (i a | j b) spatial
        g = ovov[spo][:, spv][:, :, spo][:, :, :, spv]   # (I, A, J, B)
        g = g.permute(0, 2, 1, 3)                     # <IJ|AB>
        return (g * same_ov[:, None, :, None] * same_ov[None, :, None, :]
                - g.transpose(2, 3) * same_ov[:, None, None, :]
                * same_ov[None, :, :, None])

    Co0, Cv0 = C[:, :no], C[:, no:]
    g0 = goovv(Co0, Cv0, mf.eri)
    eo, ev = eps[:no][spo], eps[no:][spv]
    Dden = (eo[:, None, None, None] + eo[None, :, None, None]
            - ev[None, None, :, None] - ev[None, None, None, :])
    t0 = g0 / Dden
    e2_ref = 0.25 * float(torch.sum(t0 * g0))
    del g0, Dden

    def omega(kappa, h_, eri_):
        Cr = C + C @ kappa
        Co, Cv = Cr[:, :no], Cr[:, no:]
        J, K = _jk(eri_, 2.0 * Co @ Co.T)
        F = h_ + J - 0.5 * K
        Foo = (Co.T @ F @ Co)[spo][:, spo] * sameo
        Fvv = (Cv.T @ F @ Cv)[spv][:, spv] * samev
        # Hylleraas: J2 = 1/4 [ 2 t·g + t·(A t) ],
        # (A t) = P(ab) Fvv t − P(ij) Foo t
        At = (torch.einsum("ca, ijcb -> ijab", Fvv, t0)
              + torch.einsum("cb, ijac -> ijab", Fvv, t0)
              - torch.einsum("ik, kjab -> ijab", Foo, t0)
              - torch.einsum("jk, ikab -> ijab", Foo, t0))
        return 0.25 * (2.0 * torch.sum(t0 * goovv(Co, Cv, eri_))
                       + torch.sum(t0 * At))

    return omega, e2_ref


def mp2_gradient(mf):
    """Analytic MP2 nuclear gradient d(E_SCF + E2)/dR (natm, 3).

    E2 enters as the HYLLERAAS functional with the converged canonical
    amplitudes FROZEN — stationarity in t makes the frozen-t J2[t]
    first-order invariant under the redundant rotations (the canonical
    closed-form E2 with diagonal-F denominators is NOT, and would give a
    wrong gradient)."""
    from .grad import rhf_gradient
    omega, e2_ref = _mp2_omega(mf)
    dw = response_gradient(mf, omega, check_value=e2_ref)
    return np.asarray(rhf_gradient(mf), float) + dw


def mp2_dipole(mf, origin=(0.0, 0.0, 0.0)):
    """Orbital-RELAXED MP2 dipole moment (3,) in a.u.: the HF dipole
    plus the correlation correction from the SAME Z-vector engine with
    an electric-field perturbation (dh = +μ_ao[x], dS = dA = 0) —
    μ_MP2 = −d(E_SCF + E2)/dF."""
    omega, e2_ref = _mp2_omega(mf)
    eng = ResponseEngine(mf, omega, check_value=e2_ref)
    return _field_dipole(eng, mf, origin, mf.dip_moment(origin=origin))


# =====================================================================
# CCSD (Lagrangian with numerically-solved Λ multipliers)
# =====================================================================

def _so_ints(Cr, h_, eri_, spat, same, no):
    """Traceable spin-orbital (F_so full, <pq||rs>) from rotated MO
    coefficients: the Fock matrix is NOT diagonal under rotations — the
    residuals below carry the full non-canonical terms."""
    from .scf import ao2mo
    J, K = _jk(eri_, 2.0 * Cr[:, :no] @ Cr[:, :no].T)
    Fmo = Cr.T @ (h_ + J - 0.5 * K) @ Cr
    Fso = Fmo[spat][:, spat] * same
    emo = ao2mo(eri_, Cr)
    gso = emo[spat][:, spat][:, :, spat][:, :, :, spat].permute(0, 2, 1, 3)
    s1 = same[:, None, :, None] * same[None, :, None, :]
    s2 = same[:, None, None, :] * same[None, :, :, None]
    return Fso, gso * s1 - gso.transpose(2, 3) * s2


def _antisym_cols(V, n1, shape2):
    """The projector onto the antisymmetric t2 subspace applied to every
    column of ``V`` (N, k) at once."""
    a, b = V[:n1], V[n1:].reshape(*shape2, -1)
    b = 0.25 * (b - b.permute(1, 0, 2, 3, 4) - b.permute(0, 1, 3, 2, 4)
                + b.permute(1, 0, 3, 2, 4))
    return torch.cat([a, b.reshape(-1, V.shape[1])])


def _ccsd_engine(cc):
    """ResponseEngine for the CCSD Lagrangian (shared by
    :func:`ccsd_gradient` and :func:`ccsd_dipole`).

    CCSD is not variational in T, so the engine gets the LAGRANGIAN
    E(T) + Λ·R(T) with multipliers solved NUMERICALLY from the autodiff
    (``torch.func.jacfwd``) Jacobian of the amplitude residuals
    (∂R/∂T)ᵀ Λ = −∂E/∂T, projected onto the antisymmetric t2 subspace
    (the projector is built for every unit vector in one batched call)
    and solved for its minimum-norm solution. The residual is the cc.py
    Stanton update times the canonical denominators PLUS the
    non-canonical f_oo/f_vv one-particle terms. The Λ system is dense:
    small molecules only."""
    mf = cc.mf
    if cc.t1 is None:
        raise ValueError("run CCSD first (cc.run())")
    f0, g0, o, v, d1, d2, no_s, nv_s = cc._setup()
    t1c, t2c = cc.t1, cc.t2
    no = mf.nocc
    C = mf.mo_coeff
    dev = C.device
    spat, same = _spin_maps(C.shape[1], dev)

    def residual_full(t1_, t2_, f_, g_):
        r1, r2 = cc._update(t1_, t2_, f_, g_, o, v, 1.0, 1.0)
        R1 = (r1 + torch.einsum("ie, ae -> ia", t1_, f_[v, v])
              - torch.einsum("ma, mi -> ia", t1_, f_[o, o]))
        tmp = torch.einsum("ijae, be -> ijab", t2_, f_[v, v])
        R2 = r2 + tmp - tmp.transpose(2, 3)
        tmp = torch.einsum("imab, mj -> ijab", t2_, f_[o, o])
        R2 = R2 - tmp + tmp.transpose(0, 1)
        return R1, R2

    # consistency: at the converged amplitudes the residual vanishes
    R1c, R2c = residual_full(t1c, t2c, f0, g0)
    rmax = max(float(torch.max(torch.abs(R1c))),
               float(torch.max(torch.abs(R2c))))
    if rmax > 1e-6:
        raise RuntimeError(f"CCSD residual {rmax:.2e} at the converged "
                           "amplitudes — non-canonical extension "
                           "inconsistent with cc._update, or CCSD not "
                           "converged")

    n1 = t1c.numel()
    shape2 = t2c.shape

    def unpack(tvec):
        return tvec[:n1].reshape(t1c.shape), tvec[n1:].reshape(shape2)

    def Rflat(tvec):
        R1, R2 = residual_full(*unpack(tvec), f0, g0)
        return torch.cat([R1.reshape(-1), R2.reshape(-1)])

    def Eflat(tvec):
        return cc._energy_expr(*unpack(tvec), f0, g0, o, v)

    tvec = torch.cat([t1c.reshape(-1), t2c.reshape(-1)])
    JR = jacfwd(Rflat)(tvec)
    dE = grad(Eflat)(tvec)
    # the flattened parametrization is redundant (t_ijab = −t_jiab =
    # −t_ijba) and the full-space system inconsistent; projected onto the
    # antisymmetric subspace it is exactly solvable
    N = tvec.numel()
    P = _antisym_cols(torch.eye(N, dtype=tvec.dtype, device=dev), n1, shape2)
    lam = torch.linalg.pinv(P @ JR.T) @ (-(P @ dE))
    resid = float(torch.max(torch.abs(P @ (dE + JR.T @ lam))))
    if resid > 1e-8:
        raise RuntimeError(f"Lambda equations not solved ({resid:.2e})")
    l1, l2 = unpack(lam)
    e_ref = float(cc.e_corr)

    def omega(kappa, h_, eri_):
        Cr = C + C @ kappa
        Fso, gaso = _so_ints(Cr, h_, eri_, spat, same, no)
        E = cc._energy_expr(t1c, t2c, Fso, gaso, o, v)
        R1, R2 = residual_full(t1c, t2c, Fso, gaso)
        return E + torch.sum(l1 * R1) + torch.sum(l2 * R2)

    return ResponseEngine(mf, omega, check_value=e_ref)


def ccsd_gradient(cc):
    """Analytic CCSD nuclear gradient d(E_SCF + E_CCSD)/dR (natm, 3):
    see :func:`_ccsd_engine`."""
    from .grad import rhf_gradient
    eng = _ccsd_engine(cc)
    return np.asarray(rhf_gradient(cc.mf), float) + eng.nuclear_gradient()


def ccsd_dipole(cc, origin=(0.0, 0.0, 0.0)):
    """Orbital-relaxed CCSD dipole moment (3,) in a.u. — the HF dipole
    plus the correlation correction from the SAME CCSD Lagrangian engine
    with a field perturbation (μ = −dE/dF)."""
    mf = cc.mf
    return _field_dipole(_ccsd_engine(cc), mf, origin,
                         mf.dip_moment(origin=origin))


# =====================================================================
# TDHF / RPA excited states
# =====================================================================

def _tdhf_engine(td, state=1):
    """ResponseEngine for the frozen-(X, Y) RPA bilinear (shared by the
    gradient and dipole clients):

        ω = (X,Y)·[[A, B], [B, A]]·(X,Y)   with  X² − Y² = 1,

    stationary at the RPA eigenpair, so the frozen-(X, Y) functional rides
    the same engine as CIS."""
    mf = td.mf
    if hasattr(mf, "f_exc"):
        raise NotImplementedError("tdhf_gradient covers HF references; "
                                  "TDDFT gradients need the XC kernel "
                                  "in the functional")
    no = mf.nocc
    C = mf.mo_coeff
    nv = C.shape[1] - no
    X, Y = (z.to(C.dtype).reshape(no, nv) for z in td.xy[state - 1])
    c2 = 2.0 if getattr(td, "singlet", True) else 0.0

    def omega(kappa, h_, eri_):
        Cr = C + C @ kappa
        Co, Cv = Cr[:, :no], Cr[:, no:]
        J, K = _jk(eri_, 2.0 * Co @ Co.T)
        F = h_ + J - 0.5 * K
        RX = Co @ X @ Cv.T
        RY = Co @ Y @ Cv.T
        return (torch.sum((X.T @ X + Y.T @ Y) * (Cv.T @ F @ Cv))
                - torch.sum((X @ X.T + Y @ Y.T) * (Co.T @ F @ Co))
                + c2 * (torch.einsum("pqkl, pq, kl ->", eri_, RX, RX)
                        + torch.einsum("pqkl, pq, kl ->", eri_, RY, RY)
                        + 2.0 * torch.einsum("pqkl, pq, kl ->", eri_,
                                             RX, RY))
                - torch.einsum("pqkl, pk, ql ->", eri_, RX, RX)
                - torch.einsum("pqkl, pk, ql ->", eri_, RY, RY)
                - 2.0 * torch.einsum("pqkl, pl, kq ->", eri_, RX, RY))

    return ResponseEngine(mf, omega,
                          check_value=float(np.asarray(td.e)[state - 1]))


def tdhf_gradient(td, state=1):
    """Analytic TDHF/RPA excited-state nuclear gradient — see
    :func:`_tdhf_engine`."""
    from .grad import rhf_gradient
    eng = _tdhf_engine(td, state)
    return np.asarray(rhf_gradient(td.mf), float) + eng.nuclear_gradient()


def tdhf_dipole(td, state=1, origin=(0.0, 0.0, 0.0)):
    """Relaxed TDHF/RPA EXCITED-STATE dipole moment (3,) in a.u."""
    mf = td.mf
    return _field_dipole(_tdhf_engine(td, state), mf, origin,
                         mf.dip_moment(origin=origin))


# =====================================================================
# TDDFT (TDA on an LDA Kohn-Sham reference)
# =====================================================================

def _tddft_tda_engine(td, state=1):
    """The TDDFT/TDA response engine of :func:`tddft_tda_gradient` and
    :func:`tddft_tda_dipole`: every XC response object is a DIRECTIONAL
    DERIVATIVE of the plain E_xc[D] evaluator on the traceable Becke grid
    (grad.traceable_xc_setup's exc_dm):

      one-particle Tr[T V_xc]    = d/dε E_xc[D + ε T]
      singlet kernel ⟨u|f_xc|u⟩  = 2 d²/dε² E_xc[ρ ± ε u/2 per spin]
      triplet (spin-flip)        = ½ d²/dε² E_xc[ρ_a + ε u, ρ_b − ε u]
      V_xc matrix                = ∂E_xc/∂D

    so the g_xc third derivatives (through ρ(κ)) and the grid/Becke/
    AO-center motion (through coords) come from ``torch.func`` of ONE
    scalar function. LDA only, as in the JAX package."""
    mf = td.mf
    if not hasattr(mf, "f_exc"):
        raise TypeError("tddft_tda_gradient expects an RKS mean-field; "
                        "use cis_gradient for HF")
    if getattr(mf, "_needs_grad", True):
        raise NotImplementedError(
            "analytic TDDFT gradients cover LDA (xc='svwn'): for GGA/"
            "hybrids the shipped kernel (tdscf.xc_kernel_ov, FD-pinned "
            "to 2e-6) and the differentiable E_xc evaluator regularize "
            "the small-density tail differently (analytic-at-floor vs "
            "clamped derivatives; measured 1.9e-3 kernel offset on "
            "LiH), so the analytic derivative would not match FD of "
            "the shipped omega.  Use tda_gradient_fd(..., method='RKS',"
            " xc=...) for GGA excited-state forces.")
    from .grad import traceable_xc_setup

    mol = mf.mol
    no = mf.nocc
    C = mf.mo_coeff
    dev = C.device
    nv = C.shape[1] - no
    X = td.xy[:, state - 1].to(C.dtype).reshape(no, nv)
    singlet = bool(getattr(td, "singlet", True))
    c2 = 2.0 if singlet else 0.0
    hfx = float(getattr(mf, "hfx", 0.0))
    tools = traceable_xc_setup(mol, mf)
    exc_dm = tools["exc_dm"]
    zero = torch.zeros((), dtype=torch.float64, device=dev)

    def omega_nonxc(kappa, h_, eri_):
        Cr = C + C @ kappa
        Co, Cv = Cr[:, :no], Cr[:, no:]
        J, K = _jk(eri_, 2.0 * Co @ Co.T)
        F = h_ + J - 0.5 * hfx * K
        R = Co @ X @ Cv.T
        return (torch.sum((X.T @ X) * (Cv.T @ F @ Cv))
                - torch.sum((X @ X.T) * (Co.T @ F @ Co))
                + c2 * torch.einsum("pqkl, pq, kl ->", eri_, R, R)
                - hfx * torch.einsum("pqkl, pk, ql ->", eri_, R, R))

    def omega_xc(kappa, coords):
        Cr = C + C @ kappa
        Co, Cv = Cr[:, :no], Cr[:, no:]
        Dh = Co @ Co.T                         # per-spin density
        T = Cv @ (X.T @ X) @ Cv.T - Co @ (X @ X.T) @ Co.T
        R = Co @ X @ Cv.T

        def e_one(eps):
            return exc_dm(coords, Dh + 0.5 * eps * T, Dh + 0.5 * eps * T)

        one = grad(e_one)(zero)
        if singlet:
            def e_ker(eps):
                return exc_dm(coords, Dh + 0.5 * eps * R,
                              Dh + 0.5 * eps * R)
            ker = 2.0 * grad(grad(e_ker))(zero)
        else:
            def e_ker(eps):
                return exc_dm(coords, Dh + eps * R, Dh - eps * R)
            ker = 0.5 * grad(grad(e_ker))(zero)
        return one + ker

    def fock_vo_xc(kappa, coords):
        Cr = C + C @ kappa
        Co, Cv = Cr[:, :no], Cr[:, no:]
        D = 2.0 * Co @ Co.T
        Vxc = grad(lambda Dt: exc_dm(coords, 0.5 * Dt, 0.5 * Dt))(D)
        return Cv.T @ Vxc @ Co

    # one jacrev chunk carries a vmapped double backward over every grid
    # point of an atom cell: keep chunk x points x nao near 2**28
    npts = int(tools["atom_grid"](tools["coords0"], 0)[0].shape[0])
    chunk = max(1, min(JAC_CHUNK, 2 ** 28 // max(1, npts * mol.nao)))
    return ResponseEngine(
        mf, omega_nonxc, hfx=hfx,
        xc=dict(omega_xc=omega_xc, fock_vo_xc=fock_vo_xc, chunk_size=chunk),
        check_value=float(np.asarray(td.e)[state - 1]),
        check_tol=5e-5)      # the TDA matrix and this functional build
    # the kernel with the same quadrature but different groupings; the
    # agreement floor is the grid resolution, not exactness


def tddft_tda_gradient(td, state=1):
    """Analytic TDDFT excited-state nuclear gradient d(E_KS + ω)/dR for
    TDA on an RKS/LDA reference; see :func:`_tddft_tda_engine` (GGA
    raises with the documented kernel-tail offset)."""
    from .grad import ks_gradient
    eng = _tddft_tda_engine(td, state)
    return np.asarray(ks_gradient(td.mf), float) + eng.nuclear_gradient()


def tddft_tda_dipole(td, state=1, origin=(0.0, 0.0, 0.0)):
    """Orbital-relaxed TDDFT/TDA (LDA) EXCITED-STATE dipole moment (3,):
    μ* = μ_KS − dω/dF on the same engine — the field enters h only, so
    no XC grid-motion terms."""
    mf = td.mf
    return _field_dipole(_tddft_tda_engine(td, state), mf, origin,
                         mf.dip_moment(origin=origin))


# =====================================================================
# open-shell (UHF) engine + UMP2
# =====================================================================

class ResponseEngineU:
    """Open-shell version of :class:`ResponseEngine`: per-spin orbital
    rotations κ = (κ_a, κ_b) stacked as one (2, nmo, nmo) tensor, two
    Brillouin blocks (F^a_vo, F^b_vo) in one CPHF operator (the cross-spin
    Coulomb coupling rides the autodiff Jacobian), one stacked Z-vector
    solve."""

    def __init__(self, mf, omega_fn, check_value=None, check_tol=1e-6):
        _check_cartesian(mf.mol)
        self.mf = mf
        Ca, Cb = mf.mo_coeff
        dev = Ca.device
        self.device = dev
        na, nb = mf.nocc
        nmo = Ca.shape[1]
        nva, nvb = nmo - na, nmo - nb
        h, ERI = mf.hcore, mf.eri
        self.seconds = {}
        t0 = time.perf_counter()
        k0 = torch.zeros((2, nmo, nmo), dtype=torch.float64, device=dev)
        w0 = float(omega_fn(k0, h, ERI))
        if check_value is not None and abs(w0 - check_value) > check_tol:
            raise RuntimeError(f"omega functional ({w0}) != expected "
                               f"({check_value})")
        self.w0 = w0

        L, Wh, Weri = grad(omega_fn, argnums=(0, 1, 2))(k0, h, ERI)
        for s, n_o in ((0, na), (1, nb)):
            asym = max(
                float(torch.max(torch.abs(L[s, :n_o, :n_o]
                                          - L[s, :n_o, :n_o].T))),
                float(torch.max(torch.abs(L[s, n_o:, n_o:]
                                          - L[s, n_o:, n_o:].T))))
            if asym > 1e-5 * max(1.0, float(torch.max(torch.abs(L)))):
                raise RuntimeError("oo/vv Lagrangian not symmetric "
                                   f"(spin {s}): functional not "
                                   "stationary in its amplitudes")
        _sync(dev)
        t1 = time.perf_counter()
        from .scf import jk_builder
        Jf, Kf = jk_builder(ERI)

        def fock_vo(kappa):
            Car = Ca + Ca @ kappa[0]
            Cbr = Cb + Cb @ kappa[1]
            Da = Car[:, :na] @ Car[:, :na].T
            Db = Cbr[:, :nb] @ Cbr[:, :nb].T
            J = Jf(Da + Db)
            Fa = h + J - Kf(Da)
            Fb = h + J - Kf(Db)
            return torch.cat(
                [(Car[:, na:].T @ Fa @ Car[:, :na]).reshape(-1),
                 (Cbr[:, nb:].T @ Fb @ Cbr[:, :nb]).reshape(-1)])

        J1 = jacrev(fock_vo, chunk_size=JAC_CHUNK)(k0)  # (N, 2, nmo, nmo)
        del Jf, Kf
        N = J1.shape[0]
        _sync(dev)
        t2 = time.perf_counter()
        # unknowns: [U^a_vo.ravel(), U^b_vo.ravel()]
        cols = []
        for s, (n_o, n_v) in ((0, (na, nva)), (1, (nb, nvb))):
            blk = (J1[:, s, n_o:, :n_o]
                   - J1[:, s, :n_o, n_o:].transpose(1, 2))
            cols.append(blk.reshape(N, n_v * n_o))
        Mlin = torch.cat(cols, dim=1)               # (N, N)
        Lam = torch.cat(
            [(L[0, na:, :na] - L[0, :na, na:].T).reshape(-1),
             (L[1, nb:, :nb] - L[1, :nb, nb:].T).reshape(-1)])
        self.Z = torch.linalg.solve(Mlin.T, Lam)
        _sync(dev)
        self.seconds.update(lagrangian=t1 - t0, cphf_jacobian=t2 - t1,
                            z_solve=time.perf_counter() - t2)
        self.L, self.Wh, self.Weri, self.J1 = L, Wh, Weri, J1
        self.Ca, self.Cb = Ca, Cb
        self.na, self.nb, self.nmo = na, nb, nmo
        self.Da, self.Db = mf.dm

    def _spins(self):
        return ((self.Ca, self.na, self.Da), (self.Cb, self.nb, self.Db))

    def domega(self, dS, dh, dA=None):
        """dω for one perturbation from its AO derivative matrices
        (tensors or NumPy; dS may be None for a field)."""
        dev = self.device
        dh, dA = _on(dh, dev), _on(dA, dev)
        dw = torch.sum(self.Wh * dh)
        if dA is not None:
            dw = dw + torch.sum(self.Weri * dA)
        U = torch.zeros((2, self.nmo, self.nmo), dtype=torch.float64,
                        device=dev)
        if dS is not None:
            dS = _on(dS, dev)
            for s, (C, n_o, _) in enumerate(self._spins()):
                U[s] = _u_of_smo(C.T @ dS @ C, n_o)
        dw = dw + torch.sum(self.L * U)
        dJ = (torch.einsum("pqkl, kl -> pq", dA, self.Da + self.Db)
              if dA is not None else 0.0)
        parts = []
        for C, n_o, Ds in self._spins():
            Fx = dh
            if dA is not None:
                Fx = Fx + dJ - torch.einsum("pkql, kl -> pq", dA, Ds)
            parts.append((C[:, n_o:].T @ Fx @ C[:, :n_o]).reshape(-1))
        rhs = -(torch.cat(parts)
                + torch.einsum("nspq, spq -> n", self.J1, U))
        return float(dw + self.Z @ rhs)

    def nuclear_gradient(self):
        """dω/dR (natm, 3) NumPy by the fused dERI contraction."""
        t0 = time.perf_counter()
        Jz = torch.einsum("n, nspq -> spq", self.Z, self.J1)
        G = self.L - Jz
        Gao = 0.0
        Zaos, k_terms, off = [], [], 0
        for s, (C, n_o, Ds) in enumerate(self._spins()):
            n_v = self.nmo - n_o
            Zs = self.Z[off:off + n_v * n_o].reshape(n_v, n_o)
            off += n_v * n_o
            Zao = C[:, n_o:] @ Zs @ C[:, :n_o].T
            Zaos.append(Zao)
            k_terms.append((1.0, Zao, Ds))
            Gao = Gao + C @ _g_hat(G[s], n_o) @ C.T
        Zt = Zaos[0] + Zaos[1]
        g = _nuclear_contraction(self.mf.mol, self.Wh - Zt, self.Weri, Gao,
                                 [(-1.0, Zt, self.Da + self.Db)], k_terms)
        out = g.cpu().numpy()
        self.seconds["contraction"] = time.perf_counter() - t0
        return out


def _uhf_dipole(eng, mf, origin):
    """UHF dipole μ = Σ Z R − Tr[(Da + Db) r] minus the engine's dω/dF."""
    from .basis import dipole_matrix
    mu_ao = dipole_matrix(mf.mol.bfs, origin)
    Da, Db = (d.cpu().numpy() for d in mf.dm)
    el = -np.einsum("kpq, qp -> k", mu_ao, Da + Db)
    R = np.asarray(mf.mol.atom_coords()) - np.asarray(origin)
    Z = np.asarray(mf.mol.atom_charges(), float)
    return _field_dipole(eng, mf, origin, Z @ R + el)


def _ump2_engine(mf):
    """ResponseEngineU for the open-shell Hylleraas functional (shared
    by :func:`ump2_gradient` and :func:`ump2_dipole`): one (nao, 2nmo)
    spin-MO matrix Cso(κ) built from (C_a(κ_a), C_b(κ_b)) makes the
    construction the same as the closed-shell :func:`mp2_gradient`."""
    from .scf import ao2mo
    Ca, Cb = mf.mo_coeff
    dev = Ca.device
    na, nb = mf.nocc
    nmo = Ca.shape[1]
    ea, eb = mf.mo_energy
    nso = 2 * nmo
    spin = torch.arange(2, device=dev).repeat(nmo)
    eps_s = torch.stack([ea, eb], dim=1).reshape(-1)
    occ_s = torch.cat([2 * torch.arange(na, device=dev),
                       2 * torch.arange(nb, device=dev) + 1])
    occ_set = set(occ_s.tolist())
    vir_s = torch.as_tensor([p for p in range(nso) if p not in occ_set],
                            device=dev)
    same = (spin[:, None] == spin[None, :]).to(torch.float64)
    eye2 = torch.eye(2, dtype=torch.float64, device=dev)

    def so_ints(kappa, h_, eri_):
        Car = Ca + Ca @ kappa[0]
        Cbr = Cb + Cb @ kappa[1]
        Cso = torch.stack([Car, Cbr], dim=2).reshape(Ca.shape[0], nso)
        Da = Car[:, :na] @ Car[:, :na].T
        Db = Cbr[:, :nb] @ Cbr[:, :nb].T
        J = torch.einsum("pqkl, kl -> pq", eri_, Da + Db)
        Fa = h_ + J - torch.einsum("pkql, kl -> pq", eri_, Da)
        Fb = h_ + J - torch.einsum("pkql, kl -> pq", eri_, Db)
        Fs = torch.stack([Car.T @ Fa @ Car, Cbr.T @ Fb @ Cbr])
        Fso = torch.einsum("spq, st -> psqt", Fs, eye2).reshape(nso, nso)
        gso = ao2mo(eri_, Cso).permute(0, 2, 1, 3)        # <pq|rs>
        s1 = same[:, None, :, None] * same[None, :, None, :]
        s2 = same[:, None, None, :] * same[None, :, :, None]
        return Fso, gso * s1 - gso.transpose(2, 3) * s2

    def blocks(Fso, gaso):
        go = gaso[occ_s][:, occ_s][:, :, vir_s][:, :, :, vir_s]
        return go, Fso[occ_s][:, occ_s], Fso[vir_s][:, vir_s]

    # frozen canonical amplitudes
    k0 = torch.zeros((2, nmo, nmo), dtype=torch.float64, device=dev)
    goovv, _, _ = blocks(*so_ints(k0, mf.hcore, mf.eri))
    eo, ev = eps_s[occ_s], eps_s[vir_s]
    Dden = (eo[:, None, None, None] + eo[None, :, None, None]
            - ev[None, None, :, None] - ev[None, None, None, :])
    t0 = goovv / Dden
    e2_ref = 0.25 * float(torch.sum(t0 * goovv))

    def omega(kappa, h_, eri_):
        go, Foo, Fvv = blocks(*so_ints(kappa, h_, eri_))
        At = (torch.einsum("ca, ijcb -> ijab", Fvv, t0)
              + torch.einsum("cb, ijac -> ijab", Fvv, t0)
              - torch.einsum("ik, kjab -> ijab", Foo, t0)
              - torch.einsum("jk, ikab -> ijab", Foo, t0))
        return 0.25 * (2.0 * torch.sum(t0 * go) + torch.sum(t0 * At))

    return ResponseEngineU(mf, omega, check_value=e2_ref)


def ump2_gradient(mf):
    """Analytic UMP2 nuclear gradient for open shells (UHF reference) —
    see :func:`_ump2_engine`."""
    from .grad import rhf_gradient
    eng = _ump2_engine(mf)
    return np.asarray(rhf_gradient(mf), float) + eng.nuclear_gradient()


def ump2_dipole(mf, origin=(0.0, 0.0, 0.0)):
    """Orbital-relaxed UMP2 dipole moment for open shells (3,) in a.u.:
    the UHF dipole plus the correlation correction from the open-shell
    Z-vector engine with a field perturbation."""
    return _uhf_dipole(_ump2_engine(mf), mf, origin)


def _ucis_engine(td, state=1):
    """ResponseEngineU for the frozen (X_a, X_b) UCIS functional (shared
    by gradient and dipole clients): Coulomb couples the total
    transition density, exchange stays within each spin."""
    mf = td.mf
    Ca, Cb = mf.mo_coeff
    na, nb = mf.nocc
    Xa, Xb = (x.to(Ca.dtype) for x in td.xy[state - 1])

    def omega(kappa, h_, eri_):
        Car = Ca + Ca @ kappa[0]
        Cbr = Cb + Cb @ kappa[1]
        Cao, Cav = Car[:, :na], Car[:, na:]
        Cbo, Cbv = Cbr[:, :nb], Cbr[:, nb:]
        Da = Cao @ Cao.T
        Db = Cbo @ Cbo.T
        J = torch.einsum("pqkl, kl -> pq", eri_, Da + Db)
        Fa = h_ + J - torch.einsum("pkql, kl -> pq", eri_, Da)
        Fb = h_ + J - torch.einsum("pkql, kl -> pq", eri_, Db)
        Ra = Cao @ Xa @ Cav.T
        Rb = Cbo @ Xb @ Cbv.T
        Rt = Ra + Rb
        return (torch.sum((Xa.T @ Xa) * (Cav.T @ Fa @ Cav))
                - torch.sum((Xa @ Xa.T) * (Cao.T @ Fa @ Cao))
                + torch.sum((Xb.T @ Xb) * (Cbv.T @ Fb @ Cbv))
                - torch.sum((Xb @ Xb.T) * (Cbo.T @ Fb @ Cbo))
                + torch.einsum("pqkl, pq, kl ->", eri_, Rt, Rt)
                - torch.einsum("pqkl, pk, ql ->", eri_, Ra, Ra)
                - torch.einsum("pqkl, pk, ql ->", eri_, Rb, Rb))

    return ResponseEngineU(mf, omega,
                           check_value=float(np.asarray(td.e)[state - 1]))


def ucis_gradient(td, state=1):
    """Analytic UCIS excited-state nuclear gradient — see
    :func:`_ucis_engine`."""
    from .grad import rhf_gradient
    eng = _ucis_engine(td, state)
    return np.asarray(rhf_gradient(td.mf), float) + eng.nuclear_gradient()


def ucis_dipole(td, state=1, origin=(0.0, 0.0, 0.0)):
    """Relaxed UCIS EXCITED-STATE dipole moment for radicals (3,)."""
    return _uhf_dipole(_ucis_engine(td, state), td.mf, origin)
