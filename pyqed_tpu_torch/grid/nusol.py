"""NuSol-style config-driven Schroedinger solver: Numerov, sinc DVR,
finite differences or Chebyshev collocation in 1-3 dimensions (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/nusol.py`` (reference:
pyqed/dvr/NuSol/NuSol.py:15 ``numerov``). The operators are small dense
or Kronecker-sum pencils built on the host. A dense symmetric problem is
diagonalized with ``torch.linalg.eigh`` on ``device``; the Numerov pencil
(a generalized, nonsymmetric problem) and grids too large for a dense
matrix go through SciPy on the host (``scipy.linalg.eig``,
``scipy.sparse.linalg.eigs``/``eigsh`` with shift-invert), as in the JAX
package. :class:`VibrationalDVR3D` applies a 3-mode sinc-DVR Hamiltonian
matrix-free on the device and solves it with the port's block Davidson.
"""
from __future__ import annotations

from functools import reduce
from typing import Callable, Optional, Union

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..config import resolve_device
from ..ops.linalg import as_tensor


def _numerov_pair(n, h):
    A = (np.diag(np.full(n - 1, 1.0), -1) + np.diag(np.full(n, -2.0))
         + np.diag(np.full(n - 1, 1.0), 1)) / h ** 2
    B = (np.diag(np.full(n - 1, 1.0), -1) + np.diag(np.full(n, 10.0))
         + np.diag(np.full(n - 1, 1.0), 1)) / 12.0
    return A, B


def _fd2(n, h):
    return (np.diag(np.full(n - 1, 1.0), -1) + np.diag(np.full(n, -2.0))
            + np.diag(np.full(n - 1, 1.0), 1)) / h ** 2


def _sinc_d2(n, h):
    """Colbert-Miller sinc-DVR second derivative, negated (the matrix of
    -d^2/dx^2)."""
    i = np.arange(n)
    dij = i[:, None] - i[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        off = 2.0 * (-1.0) ** dij / dij.astype(float) ** 2
    D = -np.where(dij == 0, np.pi ** 2 / 3.0, off) / h ** 2
    return -D


def cheb_D2(n, a, b):
    """Chebyshev collocation second-derivative matrix on [a, b] with
    Dirichlet ends (Trefethen's D^2, interior points, ascending order).

    Returns NumPy (D2 (n, n), points (n,))."""
    N = n + 1
    x = np.cos(np.pi * np.arange(N + 1) / N)
    c = np.hstack([2.0, np.ones(N - 1), 2.0]) * (-1.0) ** np.arange(N + 1)
    dX = x[:, None] - x[None, :]
    D = np.outer(c, 1.0 / c) / (dX + np.eye(N + 1))
    D -= np.diag(D.sum(axis=1))
    D2 = (D @ D)[1:-1, 1:-1]                # Dirichlet: drop endpoints
    D2 = D2[::-1, ::-1] * (2.0 / (b - a)) ** 2
    pts = 0.5 * (a + b) + 0.5 * (b - a) * x[1:-1][::-1]
    return D2, pts


class NuSol:
    """Config-driven bound-state solver.

    Parameters (dict keys / INI ``[NuSol]`` options, case-insensitive):
      method   'numerov' | 'dvr' | 'primitive' | 'chebyshev'
      ndim     1, 2 or 3
      xmin/xmax/ngridx  (+ y, z variants; y/z default to x's)
      mass     particle mass (a.u.)
      n_eval   number of eigenpairs
      potential  callable V(x[, y, z]) on NumPy grids, or a NumPy
                 expression string in x/y/z, e.g. "0.5*(x**2 + y**2)".
    device : where the dense symmetric eigensolve runs (the card when
        None; raises without one).
    """

    def __init__(self, cfg: Union[dict, str],
                 potential: Optional[Callable] = None, device=None):
        self.device = resolve_device(device)
        if isinstance(cfg, str):
            import configparser
            p = configparser.ConfigParser()
            if not p.read(cfg):
                raise FileNotFoundError(cfg)
            sec = p["NuSol"] if p.has_section("NuSol") else p[p.sections()[0]]
            cfg = dict(sec)
        cfg = {k.lower(): v for k, v in cfg.items()}
        self.method = str(cfg.get("method", "numerov")).lower()
        self.ndim = int(cfg.get("ndim", 1))
        self.mass = float(cfg.get("mass", 1.0))
        self.n_eval = int(cfg.get("n_eval", 5))
        axes = []
        for d, name in zip(range(self.ndim), "xyz"):
            lo = float(cfg.get(f"{name}min", cfg.get("xmin", -10.0)))
            hi = float(cfg.get(f"{name}max", cfg.get("xmax", 10.0)))
            n = int(cfg.get(f"ngrid{name}", cfg.get("ngridx", 64)))
            axes.append((lo, hi, n))
        self.axes = axes
        V = potential if potential is not None else cfg.get("potential")
        if V is None:
            raise ValueError("no potential given")
        if isinstance(V, str):
            expr = V

            def V(*coords):
                env = {"np": np, "exp": np.exp, "cos": np.cos,
                       "sin": np.sin, "sqrt": np.sqrt, "tanh": np.tanh,
                       "abs": np.abs, "pi": np.pi}
                env.update({n: c for n, c in zip("xyz", coords)})
                return eval(expr, {"__builtins__": {}}, env)
        self.potential = V
        self.grids = None
        self.eigvals = None
        self.eigvecs = None

    def _grids(self):
        gs, hs = [], []
        for lo, hi, n in self.axes:
            if self.method == "chebyshev":
                _, pts = cheb_D2(n, lo, hi)
                gs.append(pts)
                hs.append(None)
            else:
                x = np.linspace(lo, hi, n + 2)[1:-1]    # Dirichlet box
                gs.append(x)
                hs.append(x[1] - x[0])
        return gs, hs

    def run(self, k: Optional[int] = None):
        """Solve; returns tensors on the device (eigenvalues (k,),
        eigenvectors grid_shape + (k,))."""
        k = k or self.n_eval
        gs, hs = self._grids()
        self.grids = gs
        mesh = np.meshgrid(*gs, indexing="ij")
        Vd = np.asarray(self.potential(*mesh), dtype=float).ravel()
        ns = [len(g) for g in gs]
        ntot = int(np.prod(ns))

        def kron_all(factors):
            return (reduce(sp.kron, factors) if len(factors) > 1
                    else sp.csr_matrix(factors[0]))

        if self.method == "numerov":
            As, Bs = zip(*[_numerov_pair(n, h) for n, h in zip(ns, hs)])
            # H = -1/(2m) sum_d B x..x A_d x..x B ; M = B x B x B
            H = None
            for d in range(len(ns)):
                factors = [sp.csr_matrix(Bs[i]) for i in range(len(ns))]
                factors[d] = sp.csr_matrix(As[d])
                term = kron_all(factors)
                H = term if H is None else H + term
            H = -H / (2 * self.mass)
            M = kron_all([sp.csr_matrix(B) for B in Bs])
            H = H + M @ sp.diags(Vd)
            if ntot <= 1500:
                from scipy.linalg import eig
                w, v = eig(H.toarray(), M.toarray())
            else:
                w, v = spla.eigs(H, k=k, M=M, sigma=float(Vd.min()),
                                 which="LM")
            idx = np.argsort(w.real)[:k]
            w, v = w.real[idx], v[:, idx].real
            w, v = (torch.as_tensor(a, device=self.device) for a in (w, v))
        else:
            if self.method == "dvr":
                D2s = [-_sinc_d2(n, h) for n, h in zip(ns, hs)]
            elif self.method == "primitive":
                D2s = [_fd2(n, h) for n, h in zip(ns, hs)]
            elif self.method == "chebyshev":
                D2s = [cheb_D2(n, lo, hi)[0]
                       for (lo, hi, _), n in zip(self.axes, ns)]
            else:
                raise ValueError(self.method)
            H = None
            for d, D in enumerate(D2s):
                factors = [sp.identity(n, format="csr") for n in ns]
                factors[d] = sp.csr_matrix(-D / (2 * self.mass))
                term = kron_all(factors)
                H = term if H is None else H + term
            H = H + sp.diags(Vd)
            if ntot <= 2000:
                Hd = torch.as_tensor(H.toarray(), device=self.device)
                w, v = torch.linalg.eigh(0.5 * (Hd + Hd.T))
                w, v = w[:k], v[:, :k]
            else:
                w, v = spla.eigsh(H.tocsc(), k=k, sigma=float(Vd.min()),
                                  which="LM")
                idx = np.argsort(w)
                w, v = (torch.as_tensor(a, device=self.device)
                        for a in (w[idx], v[:, idx]))
        self.eigvals = w
        self.eigvecs = v.reshape(*ns, -1)
        return w, self.eigvecs


class VibrationalDVR3D:
    """Vibrational eigenstates of a 3-mode PES on a direct-product sinc-DVR
    grid, matrix-free with block Davidson (reference: pyqed/qchem/sg.py:440
    ``Triatomic``, whose ``run`` is empty there): H is applied on the
    device as the port's ``DVRN.apply_H`` on a block of columns at once
    (per-dimension tensor contractions, no dense H).

    pes : callable V(q1, q2, q3) on NumPy meshgrids (host set-up).
    device : the card when None (raises without one).
    """

    def __init__(self, pes, masses, domains, nxs, device=None):
        from .dvr import DVRN, SincDVR
        self.device = resolve_device(device)
        self.dvrs = [SincDVR(b - a, nxs[d], x0=0.5 * (a + b)
                             + 0.5 * (b - a) / nxs[d], mass=masses[d],
                             device=self.device)
                     for d, (a, b) in enumerate(domains)]
        self.grid = DVRN(self.dvrs, device=self.device)
        X, Y, Z = np.meshgrid(*self.grid.x, indexing="ij")
        self.Vg = torch.as_tensor(np.asarray(pes(X, Y, Z), float),
                                  device=self.device)

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's solver from the JAX package's ``VibrationalDVR3D``:
        the same sinc DVRs (spans, points, masses) and its grid potential,
        copied through NumPy to ``device``."""
        from .dvr import DVRN, SincDVR
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.dvrs = [SincDVR(d.L, d.npts, x0=d.x0, mass=d.mass,
                             device=self.device) for d in ref.dvrs]
        self.grid = DVRN(self.dvrs, device=self.device)
        self.Vg = torch.as_tensor(np.asarray(ref.Vg, float),
                                  device=self.device)
        return self

    def apply_H(self, psi_flat):
        """H psi for psi (N,) or a block of columns (N, k)."""
        psi = as_tensor(psi_flat, device=self.device)
        shape = tuple(self.grid.nx) + tuple(psi.shape[1:])
        return self.grid.apply_H(psi.reshape(shape),
                                 self.Vg).reshape(psi.shape)

    def run(self, neig=4, tol=1e-9, max_iterations=150):
        from ..ops.davidson import block_davidson
        diag = self.Vg.clone()
        for d in range(3):
            t = torch.diagonal(self.dvrs[d].t()).to(self.device)
            shape = [1, 1, 1]
            shape[d] = -1
            diag = diag + t.reshape(shape)
        E, U = block_davidson(self.apply_H, neig=neig, diag=diag.reshape(-1),
                              tol=tol, max_iterations=max_iterations)
        self.energies, self.states = E, U
        return E
