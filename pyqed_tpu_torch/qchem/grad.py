"""Nuclear gradients and geometry optimization.

PyTorch counterpart of ``pyqed_tpu/qchem/grad.py`` (reference:
pyqed/qchem/grad.py:9 ``Grad`` — there a 21-line skeleton whose
``get_hcore``/``get_overlap``/``run`` bodies are empty; made real here).

Analytic gradients for all four mean fields: RHF/UHF via derivative
integrals (:func:`rhf_gradient`), RKS/UKS via the same HF-like core plus
an autodiff exchange-correlation term (:func:`ks_gradient` /
:func:`xc_nuclear_gradient` — ``torch.autograd`` straight through grid
points, Becke weights, and AO values, so the grid-weight derivative terms
are exact). The derivative-integral contractions run on the molecule's
device. The central-difference :class:`Grad` remains as the universal
cross-check. Geometry optimization is BFGS (``scipy.optimize``, on the
host) with the analytic Jacobian.
"""
from __future__ import annotations

import numpy as np
import torch

from .mol import Molecule

__all__ = ["Grad", "optimize_geometry", "GeometryOptimizer",
           "scan_pes", "rhf_gradient", "scf_gradient", "ks_gradient",
           "xc_nuclear_gradient"]


def _method_energy(atoms, basis, method, charge=0, spin=0, xc=None,
                   spherical=False, device=None, **method_kw):
    """Total energy of ``method`` at geometry ``atoms`` (bohr)."""
    mol = Molecule(atoms, charge=charge, spin=spin, basis=basis,
                   spherical=spherical, device=device)
    method = method.upper()
    if method == "RHF":
        mf = mol.RHF(**method_kw)
    elif method == "UHF":
        mf = mol.UHF(**method_kw)
    elif method == "RKS":
        mf = mol.RKS(xc=xc or "svwn", **method_kw)
    elif method == "UKS":
        mf = mol.UKS(xc=xc or "svwn", **method_kw)
    else:
        raise ValueError(f"unknown method {method!r}")
    mf.run()
    if not mf.converged:
        raise RuntimeError(f"{method} SCF failed to converge during "
                           "gradient evaluation")
    return float(mf.e_tot)


class Grad:
    """Central-difference nuclear gradient dE/dR, shape (natm, 3).

    Accepts either a converged (or not-yet-run) mean-field object from
    :mod:`pyqed_tpu_torch.qchem.scf`/:mod:`~pyqed_tpu_torch.qchem.dft` — the
    reference calling convention ``Grad(mf)``
    (pyqed/qchem/grad.py:10) — or an explicit geometry:

    >>> g = Grad(mol.RHF()).run()          # pyscf-style
    >>> g = Grad(atoms=[...], method="RKS", xc="pbe").run()

    After ``run()``, ``self.de`` holds the gradient (Eh/bohr). Every SCF
    runs on ``device`` (the mean field's molecule's when ``mf`` is given,
    else the card when None).
    """

    def __init__(self, mf=None, atoms=None, basis="sto-3g", method="RHF",
                 step=5e-3, charge=0, spin=0, xc=None, device=None,
                 **method_kw):
        if mf is not None:
            mol = mf.mol
            atoms = mol.atoms
            basis = mol.basis_name
            charge = mol.charge
            spin = mol.spin
            method = type(mf).__name__
            xc = getattr(mf, "xc", xc)
            device = mol.device
            self.spherical = bool(getattr(mol, "csph", None) is not None)
        else:
            self.spherical = bool(method_kw.pop("spherical", False))
        self.device = device
        if atoms is None:
            raise ValueError("pass a mean-field object or atoms=")
        self.atoms = [(s, np.asarray(x, dtype=float)) for s, x in atoms]
        self.basis = basis
        self.method = method
        self.charge = charge
        self.spin = spin
        self.xc = xc
        self.step = step
        self.method_kw = method_kw
        self.natm = len(self.atoms)
        self.de = None
        self.e_tot = None

    def _energy(self, coords_flat):
        coords = np.asarray(coords_flat, dtype=float).reshape(self.natm, 3)
        atoms = [(s, c) for (s, _), c in zip(self.atoms, coords)]
        return _method_energy(atoms, self.basis, self.method,
                              charge=self.charge, spin=self.spin,
                              xc=self.xc, spherical=self.spherical,
                              device=self.device, **self.method_kw)

    def _grad_flat(self, x):
        """Central-difference gradient at flat coordinates x (3N,)."""
        h = self.step
        g = np.zeros_like(x)
        for i in range(x.size):
            dp = x.copy(); dp[i] += h
            dm = x.copy(); dm[i] -= h
            g[i] = (self._energy(dp) - self._energy(dm)) / (2 * h)
        return g

    def run(self):
        """Compute the (natm, 3) gradient; returns ``self``."""
        x0 = np.concatenate([x for _, x in self.atoms])
        g = self._grad_flat(x0)
        self.e_tot = self._energy(x0)
        self.de = g.reshape(self.natm, 3)
        return self

    def kernel(self):
        """pyscf-style alias: run and return the gradient array."""
        return self.run().de


class GeometryOptimizer:
    """BFGS geometry optimization on the FD-gradient surface.

    The reference exposes no working optimizer (its Grad.run is empty);
    this drives :class:`scipy.optimize.minimize` with the central-
    difference Jacobian, stopping on ``gtol`` (max |dE/dR| component).
    """

    def __init__(self, atoms, basis="sto-3g", method="RHF", charge=0,
                 spin=0, xc=None, step=5e-3, gtol=3e-4, maxiter=60,
                 analytic=None, device=None, **method_kw):
        self.grad = Grad(atoms=atoms, basis=basis, method=method,
                         charge=charge, spin=spin, xc=xc, step=step,
                         device=device, **method_kw)
        #: analytic gradients: default on for all four mean-field
        #: methods (RHF/UHF via rhf_gradient; RKS/UKS via ks_gradient,
        #: incl. the autodiff XC + grid-weight terms)
        self.analytic = (method.upper() in ("RHF", "UHF", "RKS", "UKS")
                         if analytic is None else bool(analytic))
        self.gtol = gtol
        self.maxiter = maxiter
        self.atoms_opt = None
        self.e_tot = None
        self.converged = False

    def _eg_analytic_flat(self, x):
        """(energy, flat analytic gradient) from ONE converged SCF —
        scipy BFGS evaluates fun and jac at the same point, so a
        combined callable halves the SCF work per step."""
        g = self.grad
        coords = np.asarray(x, float).reshape(g.natm, 3)
        atoms = [(s, c) for (s, _), c in zip(g.atoms, coords)]
        mol = Molecule(atoms, charge=g.charge, spin=g.spin,
                       basis=g.basis, spherical=g.spherical,
                       device=g.device)
        meth = g.method.upper()
        if meth == "UHF":
            mf = mol.UHF(**g.method_kw)
        elif meth == "RKS":
            mf = mol.RKS(xc=g.xc or "svwn", **g.method_kw)
        elif meth == "UKS":
            mf = mol.UKS(xc=g.xc or "svwn", **g.method_kw)
        else:
            mf = mol.RHF(**g.method_kw)
        mf.run()
        # scf_gradient raises on non-convergence (Brillouin condition)
        return float(mf.e_tot), scf_gradient(mf).reshape(-1)

    def _grad_analytic_flat(self, x):
        return self._eg_analytic_flat(x)[1]

    def run(self):
        from scipy.optimize import minimize
        g = self.grad
        x0 = np.concatenate([x for _, x in g.atoms])
        fun, jac = ((self._eg_analytic_flat, True) if self.analytic
                    else (g._energy, g._grad_flat))

        res = minimize(fun, x0, jac=jac, method="BFGS",
                       options=dict(gtol=self.gtol, maxiter=self.maxiter))
        coords = res.x.reshape(g.natm, 3)
        self.atoms_opt = [(s, c) for (s, _), c in zip(g.atoms, coords)]
        self.e_tot = float(res.fun)
        self.grad_final = res.jac.reshape(g.natm, 3)
        # honest convergence: scipy's own verdict, or the gradient
        # actually meeting the requested tolerance (BFGS can stop on
        # "precision loss" after having converged)
        self.converged = bool(res.success
                              or np.max(np.abs(res.jac)) < self.gtol)
        self.niter = int(res.nit)
        return self


def optimize_geometry(atoms, basis="sto-3g", method="RHF", **kw):
    """Convenience wrapper: optimized ``(atoms, e_tot)``."""
    opt = GeometryOptimizer(atoms, basis=basis, method=method, **kw).run()
    return opt.atoms_opt, opt.e_tot


def scan_pes(atoms_fn, grid, method="RHF", basis="sto-3g", charge=0,
             spin=0, xc=None, device=None, **method_kw):
    """Potential-energy-surface scan: total energy at every point of a
    1D parameter grid (reference: pyqed/qchem/mol.py:1374 ``scan_pes``
    — a pyscf-scanner demo hard-wired to HF; generic here).

    atoms_fn : callable s -> atoms list (bohr) for scan parameter s
    grid : 1D array of scan-parameter values
    Returns energies (len(grid),).
    """
    return np.array([_method_energy(atoms_fn(s), basis, method,
                                    charge=charge, spin=spin, xc=xc,
                                    device=device, **method_kw)
                     for s in np.asarray(grid)])


def excited_state_energy(atoms, basis="sto-3g", state=1, singlet=True,
                         nroots=None, method="RHF", xc=None, device=None,
                         **scf_kw):
    """E_SCF + ω_TDA of excited ``state`` (1-based) at geometry
    ``atoms`` (bohr); ``method``: 'RHF' or 'RKS' (with ``xc``).
    Returns (energy, mf, td)."""
    from .tdscf import TDA
    mol = Molecule(atoms, basis=basis, device=device)
    if method.upper() == "RKS":
        mf = mol.RKS(xc=xc or "svwn", **scf_kw).run()
    else:
        mf = mol.RHF(**scf_kw).run()
    if not mf.converged:
        raise RuntimeError("SCF failed to converge at excited-state "
                           "gradient displacement")
    td = TDA(mf, singlet=singlet)
    td.run(nroots=nroots or max(state, 3))
    return float(mf.e_tot + np.asarray(td.e)[state - 1]), mf, td


def tda_gradient_fd(atoms, basis="sto-3g", state=1, singlet=True,
                    step=5e-3, richardson=False, method="RHF", xc=None,
                    device=None, **scf_kw):
    """Excited-state nuclear gradient d(E_SCF + ω_TDA)/dR by central
    finite differences (O(h²); ``richardson`` upgrades to O(h⁴) with
    twice the SCF+TDA count).  State tracking is by ENERGY ORDER —
    near conical intersections follow the root by overlap instead.

    The reference has no excited-state forces at all (its gradients
    delegate to pyscf ground state only: pyqed/qchem/grad.py:9).
    Returns (natm, 3) in Eh/bohr.
    """
    atoms = [(s, np.asarray(x, float)) for s, x in atoms]
    natm = len(atoms)

    def E(disp):
        d = disp.reshape(natm, 3)
        geo = [(s, x + dd) for (s, x), dd in zip(atoms, d)]
        return excited_state_energy(geo, basis, state, singlet,
                                    method=method, xc=xc, device=device,
                                    **scf_kw)[0]

    g = np.zeros(3 * natm)
    for i in range(3 * natm):
        d = np.zeros(3 * natm)
        d[i] = step
        if richardson:
            d2 = 2 * d
            g[i] = (8 * (E(d) - E(-d)) - (E(d2) - E(-d2))) / (12 * step)
        else:
            g[i] = (E(d) - E(-d)) / (2 * step)
    return g.reshape(natm, 3)


class ExcitedGeometryOptimizer:
    """BFGS geometry optimization on the TDA excited-state surface
    E_SCF + ω_TDA — excited-state relaxed geometries, adiabatic
    excitation energies, and excited-state frequencies feed the
    vibronic-model builders (qchem/vibronic.py).

    ``analytic``: the Jacobian. None (the default) takes the analytic
    gradient of :mod:`.tdgrad` (one SCF+TDA per point instead of 2*3N)
    for RHF and for RKS with SVWN, and central differences otherwise
    (the analytic TDDFT path covers LDA only); True takes
    ``tddft_tda_gradient`` on an RKS reference and ``cis_gradient``
    otherwise; False always takes the central differences."""

    def __init__(self, atoms, basis="sto-3g", state=1, singlet=True,
                 step=5e-3, gtol=5e-4, maxiter=50, analytic=None,
                 method="RHF", xc=None, device=None, **scf_kw):
        self.atoms = [(s, np.asarray(x, float)) for s, x in atoms]
        self.basis = basis
        self.state = state
        self.singlet = singlet
        self.step = step
        self.gtol = gtol
        self.maxiter = maxiter
        self.method = method
        self.xc = xc
        if analytic is None:
            m = method.upper()
            analytic = (m == "RHF"
                        or (m == "RKS"
                            and (xc or "svwn").lower() == "svwn"))
        self.analytic = bool(analytic)
        self.device = device
        self.scf_kw = scf_kw
        self.converged = False
        self.atoms_opt = None
        self.e_tot = None

    def run(self):
        from scipy.optimize import minimize
        syms = [s for s, _ in self.atoms]
        x0 = np.concatenate([x for _, x in self.atoms])

        def fun(x):
            geo = [(s, x[3 * k:3 * k + 3]) for k, s in enumerate(syms)]
            return excited_state_energy(geo, self.basis, self.state,
                                        self.singlet,
                                        method=self.method, xc=self.xc,
                                        device=self.device,
                                        **self.scf_kw)[0]

        def jac(x):
            geo = [(s, x[3 * k:3 * k + 3]) for k, s in enumerate(syms)]
            if self.analytic:
                from .tdgrad import cis_gradient, tddft_tda_gradient
                _, mf, td = excited_state_energy(
                    geo, self.basis, self.state, self.singlet,
                    method=self.method, xc=self.xc, device=self.device,
                    **self.scf_kw)
                g = (tddft_tda_gradient(td, self.state)
                     if hasattr(mf, "f_exc")
                     else cis_gradient(td, self.state))
                return np.asarray(g).reshape(-1)
            return tda_gradient_fd(geo, self.basis, self.state,
                                   self.singlet, self.step,
                                   method=self.method, xc=self.xc,
                                   device=self.device,
                                   **self.scf_kw).reshape(-1)

        res = minimize(fun, x0, jac=jac, method="BFGS",
                       options={"gtol": self.gtol,
                                "maxiter": self.maxiter})
        self.converged = bool(res.success or
                              np.max(np.abs(res.jac)) < 5 * self.gtol)
        self.e_tot = float(res.fun)
        self.atoms_opt = [(s, res.x[3 * k:3 * k + 3])
                          for k, s in enumerate(syms)]
        return self


def rhf_gradient(mf):
    """ANALYTIC RHF/UHF nuclear gradient (natm, 3) in Eh/bohr (NumPy).

    dE/dR_A = sum D dh/dR_A + Gamma . dERI/dR_A - W dS/dR_A + dE_nn/dR_A
    with W the energy-weighted density. Derivative integrals come from
    the per-primitive raising/lowering rule (basis.py) and the C++
    engine's ``eri_deriv_native``; the Hellmann-Feynman nuclear-operator
    term uses translational invariance (dV/dC = -(bra + ket
    derivatives)). The contractions run on the molecule's device.

    (reference: pyqed/qchem/grad.py:9 — an empty skeleton; pyqed reaches
    gradients through pyscf.) UHF mean-fields are detected by their
    (Ca, Cb) coefficient pair; alias :func:`scf_gradient`.
    """
    if hasattr(mf, "f_exc"):
        raise TypeError(
            "rhf_gradient handles RHF/UHF only; for a KS mean-field "
            "(RKS/UKS) use ks_gradient (analytic, incl. the XC and "
            "grid-weight derivative terms)")
    if not getattr(mf, "converged", True):
        raise RuntimeError(
            "SCF not converged: the analytic gradient assumes a "
            "converged mean-field (Brillouin condition)")
    return _scf_gradient_core(mf, hfx=1.0)


def derivative_integrals(mol):
    """The derivative integrals of ``mol``'s Cartesian basis, built once
    and cached on the molecule: (dS (3, n, n), dT (3, n, n), dV
    (natm, 3, n, n) per attraction center, dERI (3, n, n, n, n)) as
    tensors on ``mol.device``. dERI comes from the C++ engine (a failed
    build raises)."""
    if mol._deriv_ints is not None:
        return mol._deriv_ints
    from .basis import (overlap_deriv_bra, kinetic_deriv_bra,
                        nuclear_deriv_bra, eri_deriv)
    bfs = mol.bfs

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                               device=mol.device)

    dS = dev(overlap_deriv_bra(bfs))
    dT = dev(kinetic_deriv_bra(bfs))
    dV = dev(np.stack([nuclear_deriv_bra(bfs, xyz) for _, xyz in mol.atoms]))
    dE1 = dev(eri_deriv(bfs))
    mol._deriv_ints = (dS, dT, dV, dE1)
    return mol._deriv_ints


def _scf_gradient_core(mf, hfx):
    """Shared HF-like gradient body: one-electron + Pulay + Coulomb +
    ``hfx``-weighted exact exchange (1.0 for HF, the hybrid fraction
    for KS; 0.0 for pure functionals).

    The JAX package builds the exact dERI/dR_A for every atom and axis
    from the four index positions and contracts it with D D; with D
    symmetric and (ij|kl) = (ij|lk), the four positions contribute
    equally, so here each AO's share is contracted once,
    2 sum_q D_pq sum_kl dERI[x,p,q,k,l] D_kl for Coulomb and
    -2 hfx sum_s sum_k Ds_pk sum_ql dERI[x,p,q,k,l] Ds_ql for exchange,
    and summed over the AOs of each atom."""
    from .basis import ATOMIC_NUMBER
    from .geometry import grad_nuc
    from .lo import cart_atom_indices

    mol = mf.mol
    dS, dT, dV, dE1 = derivative_integrals(mol)
    n = dS.shape[-1]
    unrestricted = isinstance(mf.mo_coeff, (tuple, list))
    if unrestricted:
        Da, Db = mf.dm
        D = Da + Db
        Dspin = (Da, Db)
        W = torch.zeros_like(D)
        for s in range(2):
            ns = mf.nocc[s]
            C = mf.mo_coeff[s][:, :ns]
            W = W + (C * mf.mo_energy[s][:ns]) @ C.T
    else:
        D = mf.dm
        Dspin = (D / 2.0, D / 2.0)
        C = mf.mo_coeff[:, : mf.nocc]
        W = 2.0 * (C * mf.mo_energy[: mf.nocc]) @ C.T
    if getattr(mol, "csph", None) is not None:
        # SCF ran in the pure-spherical AO basis; pull D, W back to the
        # Cartesian integral basis (M_sph = csph M_cart csph^T)
        B = torch.as_tensor(mol.csph, device=D.device)
        D = B.T @ D @ B
        W = B.T @ W @ B
        Dspin = tuple(B.T @ d @ B for d in Dspin)

    Z = torch.as_tensor([float(ATOMIC_NUMBER[s]) for s, _ in mol.atoms],
                        dtype=D.dtype, device=D.device)
    # one-electron basis-center terms: dV_bf = -sum_C Z_C dV_C
    dh_bf = dT - torch.einsum("a, axpq -> xpq", Z, dV)
    # per-AO shares (bra + ket by symmetry), then summed per atom
    v = 2.0 * torch.sum(dh_bf * D, dim=2) - 2.0 * torch.sum(dS * W, dim=2)
    # two-electron term
    Jd = (dE1.reshape(3 * n * n, n * n) @ D.reshape(-1)).reshape(3, n, n)
    v = v + 2.0 * torch.sum(Jd * D, dim=2)
    if hfx:
        Ds = torch.stack(Dspin)
        Kd = torch.einsum("xpqkl, sql -> sxpk", dE1, Ds)
        v = v - 2.0 * hfx * torch.einsum("sxpk, spk -> xp", Kd, Ds)
    ao_atoms = torch.as_tensor(cart_atom_indices(mol), device=D.device)
    g_el = torch.zeros((mol.natm, 3), dtype=D.dtype, device=D.device)
    g_el.index_add_(0, ao_atoms, v.T)
    # Hellmann-Feynman nuclear-operator term:
    # d(-Z_A/|r-R_A|)/dR_A = +Z_A (bra + ket derivative kernels)
    g_el = g_el + 2.0 * Z[:, None] * torch.einsum("axpq, pq -> ax", dV, D)
    return grad_nuc(mol) + g_el.cpu().numpy()


def scf_gradient(mf):
    """Dispatch: analytic nuclear gradient for RHF/UHF/RKS/UKS."""
    if hasattr(mf, "f_exc"):
        return ks_gradient(mf)
    return rhf_gradient(mf)


# =====================================================================
# Kohn-Sham analytic gradients
# =====================================================================

def traceable_xc_setup(mol, mf):
    """Differentiable quadrature building blocks shared by
    :func:`xc_nuclear_gradient` and the TDDFT response blocks: per-atom
    radial/angular grids, Becke partition weights, and AO values — ALL as
    differentiable torch functions of the atom coordinates, so autograd
    carries grid-point, grid-weight, and AO-center motion exactly.
    Returns a dict of helpers."""
    from .dft import (_radial_gc, _angular, _BRAGG, _becke_adjust,
                      becke_cell_weights, _gga_safe)
    from .lo import cart_atom_indices

    dev = mol.device
    natm = mol.natm
    syms = [s for s, _ in mol.atoms]
    coords0 = torch.as_tensor(np.array([np.asarray(x, float)
                                        for _, x in mol.atoms]), device=dev)
    n_rad = getattr(mf, "n_rad", 60)
    n_theta = getattr(mf, "n_theta", 14)
    needs_grad = getattr(mf, "_needs_grad", True)
    f_exc = mf.f_exc
    ang, wa = _angular(n_theta)
    ang = torch.as_tensor(ang, device=dev)
    wa = torch.as_tensor(wa, device=dev)
    radial = [tuple(torch.as_tensor(a, device=dev)
                    for a in _radial_gc(n_rad, _BRAGG.get(s, 1.0)))
              for s in syms]
    aij = torch.as_tensor(_becke_adjust(syms), device=dev)
    # the basis functions grouped by contraction length, each group's
    # primitives as (functions, primitives) tensors; ``order`` puts the
    # groups' columns back in basis order
    ao_atom = torch.as_tensor(np.asarray(cart_atom_indices(mol)), device=dev)
    nprim = np.array([len(g.exps) for g in mol.bfs])
    groups = []
    for k in np.unique(nprim):
        idx = np.flatnonzero(nprim == k)
        groups.append((
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(np.array([mol.bfs[i].exps for i in idx]),
                            device=dev),
            torch.as_tensor(np.array([np.asarray(mol.bfs[i].coefs)
                                      * np.asarray(mol.bfs[i].norms)
                                      for i in idx]), device=dev)))
    order = torch.as_tensor(np.argsort(np.concatenate(
        [np.flatnonzero(nprim == k) for k in np.unique(nprim)])), device=dev)
    lmn = torch.as_tensor(np.array([g.lmn for g in mol.bfs]),
                          device=dev)[None]                   # (1, n, 3)
    lmax = int(lmn.max())
    lmn_f = lmn.to(torch.float64)

    def becke_w(coords, pts, ia, w0):
        if natm == 1:
            return w0
        P_cell = becke_cell_weights(coords, pts, aij)
        return w0 * P_cell[:, ia] / torch.sum(P_cell, dim=1)

    def ao_on(coords, pts):
        """AO values (P, nao) and gradients (P, nao, 3), centers from
        ``coords`` (differentiable version of dft.ao_values_grad), the
        basis functions of one contraction length at once."""
        d = pts[:, None, :] - coords[ao_atom][None, :, :]      # (P, n, 3)
        r2 = torch.sum(d * d, dim=2)
        rads, drads = [], []
        for idx, ex, cn in groups:
            expo = torch.exp(-r2[:, idx, None] * ex[None]) * cn[None]
            rads.append(expo.sum(dim=2))
            if needs_grad:
                drads.append(-2.0 * (expo * ex[None]).sum(dim=2))
        rad = torch.cat(rads, dim=1)[:, order]
        # d^l and l d^(l-1) by masked products (no pow: its backward at
        # d = 0 and l = 0 is 0 * inf)
        mono = torch.ones_like(d)
        for k in range(1, lmax + 1):
            mono = torch.where(lmn >= k, mono * d, mono)
        poly = mono[..., 0] * mono[..., 1] * mono[..., 2]
        ao = poly * rad
        if not needs_grad:
            return ao, None
        drad = torch.cat(drads, dim=1)[:, order]
        dmono = torch.ones_like(d)
        for k in range(1, lmax):
            dmono = torch.where(lmn > k, dmono * d, dmono)
        dmono = lmn_f * dmono
        others = torch.stack([mono[..., 1] * mono[..., 2],
                              mono[..., 0] * mono[..., 2],
                              mono[..., 0] * mono[..., 1]], dim=2)
        gao = (dmono * others * rad[..., None]
               + (poly * drad)[..., None] * d)
        return ao, gao

    if getattr(mol, "csph", None) is not None:
        csph = torch.as_tensor(mol.csph, device=dev)
    else:
        csph = None

    def atom_grid(coords, ia):
        """(pts, base weights) of atom ia's radial x angular shell."""
        r, wr = radial[ia]
        pts = (coords[ia][None, None, :]
               + r[:, None, None] * ang[None, :, :]).reshape(-1, 3)
        w0 = (wr[:, None] * wa[None, :]).reshape(-1)
        return pts, w0

    def exc_dm(coords, Da, Db):
        """E_xc of arbitrary (traced) spin density matrices at
        arbitrary (traced) atom coordinates — the single building
        block behind the XC nuclear gradient AND the TDDFT response."""
        E = 0.0
        for ia in range(natm):
            E = E + exc_atom(coords, Da, Db, ia)
        return E

    def exc_atom(coords, Da, Db, ia):
        """Atom ``ia``'s share of :func:`exc_dm` (its Becke cell)."""
        pts, w0 = atom_grid(coords, ia)
        w = becke_w(coords, pts, ia, w0)
        ao, gao = ao_on(coords, pts)
        if csph is not None:
            ao = ao @ csph.T
            if gao is not None:
                gao = torch.einsum("pid, qi -> pqd", gao, csph)
        ra = torch.clamp(torch.sum((ao @ Da.T) * ao, dim=1), min=0.0)
        rb = torch.clamp(torch.sum((ao @ Db.T) * ao, dim=1), min=0.0)
        if needs_grad:
            gra = 2.0 * torch.einsum("pid, pi -> pd", gao, ao @ Da.T)
            grb = 2.0 * torch.einsum("pid, pi -> pd", gao, ao @ Db.T)
            saa = torch.sum(gra * gra, dim=1)
            sab = torch.sum(gra * grb, dim=1)
            sbb = torch.sum(grb * grb, dim=1)
        else:
            saa = sab = sbb = torch.zeros_like(ra)
        # substitution guards exactly as dft.gga_exc_vxc: dead
        # channels replaced BEFORE differentiation (no NaN paths
        # under autograd)
        safe = (ra + rb) > 1e-10
        exc = f_exc(*_gga_safe(safe, ra, rb, saa, sab, sbb))
        return torch.sum(w * torch.where(safe, exc, 0.0))

    return dict(natm=natm, coords0=coords0, becke_w=becke_w,
                ao_on=ao_on, atom_grid=atom_grid, csph=csph,
                needs_grad=needs_grad, f_exc=f_exc, exc_dm=exc_dm,
                exc_atom=exc_atom)


def xc_nuclear_gradient(mf):
    """dE_xc/dR_A (natm, 3) by ``torch.autograd`` through a fully
    differentiable re-expression of the XC quadrature: grid points and
    Becke cell weights move with the atoms (so the grid-weight derivative
    terms are included EXACTLY, not dropped as in common 'fixed-grid'
    gradients) and AO centers move with their atoms. Zero hand-derived XC
    algebra — the same closed-form energy densities (dft.FUNCTIONALS) are
    differentiated end to end. Returns a NumPy array.

    (reference: pyqed delegates DFT gradients to pyscf —
    pyqed/qchem/mol.py:817 dispatch; native here.)"""
    mol = mf.mol
    tools = traceable_xc_setup(mol, mf)
    # spin densities in the CARTESIAN integral basis
    if isinstance(mf.mo_coeff, (tuple, list)):
        Da, Db = mf.dm
    else:
        Da = Db = mf.dm / 2.0
    if getattr(mol, "csph", None) is not None:
        B = torch.as_tensor(mol.csph, device=Da.device)
        Da = B.T @ Da @ B
        Db = B.T @ Db @ B
    coords = tools["coords0"].clone().requires_grad_(True)
    Da, Db = Da.detach(), Db.detach()
    # one backward per atom's cell: its graph is freed before the next
    g = torch.zeros_like(coords)
    for ia in range(tools["natm"]):
        (ga,) = torch.autograd.grad(tools["exc_atom"](coords, Da, Db, ia),
                                    coords)
        g = g + ga
    return g.cpu().numpy()


def ks_gradient(mf):
    """ANALYTIC RKS/UKS nuclear gradient (natm, 3) in Eh/bohr:
    the Hartree-Fock-like core (one-electron + Pulay + Coulomb + the
    hybrid's exact-exchange fraction ``mf.hfx``) plus the autodiff XC
    term of :func:`xc_nuclear_gradient` (grid-weight derivatives
    included).

    (reference: pyqed/qchem/mol.py:817 delegates DFT jacobians to
    pyscf.)"""
    if not hasattr(mf, "f_exc"):
        raise TypeError("ks_gradient expects an RKS/UKS mean-field; "
                        "use rhf_gradient for RHF/UHF")
    if not getattr(mf, "converged", True):
        raise RuntimeError(
            "SCF not converged: the analytic gradient assumes a "
            "converged mean-field")
    g = _scf_gradient_core(mf, hfx=float(getattr(mf, "hfx", 0.0)))
    return g + xc_nuclear_gradient(mf)
