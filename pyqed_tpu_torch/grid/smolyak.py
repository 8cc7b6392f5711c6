"""Smolyak sparse grids (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/smolyak.py`` (reference:
pyqed/smolyak/sg.py ``SparseGrid:260``, ``combination_technique:323``;
pyqed/smolyak/interpolator.py ``SparseInterpolator:278``). The grids,
multi-indices and the hierarchical-surplus solve (``nodal2hier``) are
static set-up on the host (NumPy), as in the JAX package; evaluations of
an interpolant are one design- or weight-matrix product on the device.
:class:`SGCT_LDR` runs the port's ``SPON`` on every level grid of the
combination technique with ``kernel='xla'`` (the plain torch forms, as
the JAX package does). Objects live on ``device`` (the card when None;
raises without one).
"""
from __future__ import annotations

import itertools
import math
from typing import Callable

import numpy as np
import torch

from ..config import resolve_device


def _level_indices(d, level):
    """Multi-indices l (each >= 1) with sum(l) <= level + d - 1."""
    return [l for l in itertools.product(range(1, level + 1), repeat=d)
            if sum(l) <= level + d - 1]


def _points_1d(l):
    """Odd-indexed interior points of level l."""
    return [(l, i) for i in range(1, 2 ** l, 2)]


class SparseGrid:
    """Interior (no-boundary) hierarchical sparse grid on a box
    (reference: pyqed/smolyak/sg.py:260): level-l 1D points i/2^l, i odd;
    multi-indices with |l|_1 <= level + d - 1."""

    def __init__(self, ndim=1, level=1, domain=None, device=None):
        self.device = resolve_device(device)
        self.ndim = self.dim = ndim
        self.level = level
        if domain is None:
            domain = ((0.0, 1.0),) * ndim
        self.domain = domain
        self.indices = []        # [(l1, i1, l2, i2, ...)]
        self.points = None       # (npts, d) coordinates on [0,1]^d
        self.fv = None           # nodal values
        self.surplus = None      # hierarchical surpluses (NumPy)

    # ------------------------------------------------------------ build
    def generate_points(self):
        idx = []
        for lvl in _level_indices(self.dim, self.level):
            for combo in itertools.product(*[_points_1d(l) for l in lvl]):
                idx.append(tuple(x for li in combo for x in li))
        self.indices = idx
        self.points = np.array([[flat[2 * k + 1] / 2 ** flat[2 * k]
                                 for k in range(self.dim)] for flat in idx])
        return self.points

    generatePoints = generate_points

    def physical_points(self):
        lo = np.array([d[0] for d in self.domain])
        hi = np.array([d[1] for d in self.domain])
        return lo[None, :] + self.points * (hi - lo)[None, :]

    @property
    def npts(self):
        return len(self.indices)

    # ---------------------------------------------------------- surplus
    @staticmethod
    def _hat(l, i, x):
        """1D hierarchical hat basis phi_{l,i}(x) on [0,1]."""
        return np.maximum(0.0, 1.0 - np.abs(2.0 ** l * x - i))

    def nodal2hier(self):
        """Hierarchical surpluses from the interpolation system (host
        set-up, NumPy; reference: pyqed/smolyak/sg.py ``nodal2Hier``)."""
        if self.fv is None:
            raise ValueError("fit() first: no nodal values")
        self.surplus = np.linalg.solve(self._design_matrix(self.points),
                                       self.fv)
        return self.surplus

    nodal2Hier = nodal2hier

    def _design_matrix(self, x):
        """Phi[a, b] = prod_k phi_{l_b, i_b}(x_a) (NumPy)."""
        x = np.atleast_2d(x)
        Phi = np.ones((x.shape[0], len(self.indices)))
        for b, flat in enumerate(self.indices):
            for k in range(self.dim):
                Phi[:, b] *= self._hat(flat[2 * k], flat[2 * k + 1], x[:, k])
        return Phi

    # ------------------------------------------------------------- eval
    def fit(self, f: Callable):
        if self.points is None:
            self.generate_points()
        phys = self.physical_points()
        self.fv = np.asarray(f(*[phys[:, k] for k in range(self.dim)]))
        self.nodal2hier()
        return self

    def eval(self, x):
        """The interpolant at unit-cube points x ((nq, d) or (d,)): one
        design-matrix product on the device."""
        x = np.atleast_2d(np.asarray(x, dtype=float))
        Phi = torch.as_tensor(self._design_matrix(x), device=self.device)
        return Phi @ torch.as_tensor(self.surplus, device=self.device)

    evalFunct = eval

    def eval_physical(self, x):
        lo = np.array([d[0] for d in self.domain])
        hi = np.array([d[1] for d in self.domain])
        return self.eval((np.atleast_2d(x) - lo[None, :])
                         / (hi - lo)[None, :])

    # ---------------------------------------------- combination technique
    def combination_technique(self):
        """(levels, coefficients) of the combination technique
        (reference: pyqed/smolyak/sg.py:323):
        u_sg = sum_q (-1)^q C(d-1, q) sum_{|l| = level + d - 1 - q} u_l."""
        return combination_technique(self.dim, self.level + self.dim - 1)


class AdaptiveSparseGrid(SparseGrid):
    """Dimension-adaptive refinement: children of the points with the
    largest surpluses (reference: pyqed/smolyak/sg.py:634)."""

    def refine(self, f, tol=1e-3, max_new=64):
        if self.surplus is None:
            raise ValueError("fit() first: no surpluses")
        order = np.argsort(-np.abs(self.surplus))
        existing = set(self.indices)
        new = []
        for a in order:
            if abs(self.surplus[a]) < tol or len(new) >= max_new:
                break
            flat = self.indices[a]
            for k in range(self.dim):
                l, i = flat[2 * k], flat[2 * k + 1]
                for child_i in (2 * i - 1, 2 * i + 1):
                    child = list(flat)
                    child[2 * k] = l + 1
                    child[2 * k + 1] = child_i
                    child = tuple(child)
                    if child not in existing:
                        existing.add(child)
                        new.append(child)
        if new:
            self.indices = self.indices + new
            self.points = np.array([[fl[2 * k + 1] / 2 ** fl[2 * k]
                                     for k in range(self.dim)]
                                    for fl in self.indices])
            self.fit_values(f)
        return len(new)

    def fit_values(self, f):
        phys = self.physical_points()
        self.fv = np.asarray(f(*[phys[:, k] for k in range(self.dim)]))
        self.nodal2hier()


# reference-compatible aliases
sparseGrid = SparseGrid
AdapativeSparseGrid = AdaptiveSparseGrid


def combination_technique(ndim, q):
    """Combination-technique index sets and coefficients:
    u_SG = Σ_{k=0}^{d-1} (-1)^k C(d-1, k) Σ_{|l|_1 = q-k} u_l
    (reference: pyqed/smolyak/sg.py:670)."""
    index_set, coeffs = [], []
    for k in range(ndim):
        c = (-1) ** k * math.comb(ndim - 1, k)
        target = q - k
        for l in itertools.product(range(1, target + 1), repeat=ndim):
            if sum(l) == target:
                index_set.append(l)
                coeffs.append(c)
    return index_set, coeffs


class SGCT_LDR:
    """Sparse-grid combination technique around the grid propagators:
    the full-tensor solve on every anisotropic level grid, combined with
    the technique's coefficients (reference intent: pyqed/smolyak/sg.py:670).

    Parameters
    ----------
    domains : [(xmin, xmax)] * ndim.
    q : combination level (per-dimension levels l, |l|_1 <= q).
    dpes_fn : (grids) -> diabatic V of shape grid_shape + (ns, ns).
    psi0_fn : (grids) -> initial psi of shape grid_shape + (ns,).
    masses, nstates : forwarded to the port's ``SPON`` (``kernel='xla'``).
    device : the card when None (raises without one).
    """

    def __init__(self, domains, q, dpes_fn, psi0_fn, masses=None,
                 nstates=1, device=None):
        self.device = resolve_device(device)
        self.domains = domains
        self.ndim = len(domains)
        self.q = q
        self.dpes_fn = dpes_fn
        self.psi0_fn = psi0_fn
        self.masses = masses
        self.nstates = nstates

    def run(self, dt, nt, nout=1, observable="x"):
        """Propagate on every level grid and combine the observable
        series; returns (times, combined, per_level dict) as tensors."""
        from .spo import SPON
        index_set, coeffs = combination_technique(self.ndim, self.q)
        dev = self.device
        combined = None
        per_level = {}
        for l, c in zip(index_set, coeffs):
            grids = [np.linspace(*self.domains[d], 2 ** l[d] + 1)[:-1]
                     for d in range(self.ndim)]
            spo = SPON(grids, masses=self.masses, nstates=self.nstates,
                       kernel="xla", device=dev)
            spo.set_dpes(self.dpes_fn(grids))
            psi0 = np.asarray(self.psi0_fn(grids), dtype=complex)
            psi0 = psi0 / np.sqrt(np.sum(np.abs(psi0) ** 2) * spo.dvol)
            r = spo.run(psi0, dt=dt, nt=nt, nout=nout)
            if observable == "x":
                X = torch.as_tensor(
                    np.meshgrid(*grids, indexing="ij")[0], device=dev)
                axes = tuple(range(1, self.ndim + 2))
                series = torch.sum(X[None, ..., None]
                                   * r.states.abs() ** 2, dim=axes) * spo.dvol
            elif observable == "population":
                series = r.population
            else:
                series = observable(r, grids, spo)
            per_level[tuple(l)] = series
            combined = (c * series if combined is None
                        else combined + c * series)
        times = torch.arange(len(combined), dtype=torch.float64,
                             device=dev) * dt * nout
        return times, combined, per_level


# ----------------------------------------------------------------------
# spinterp-style hierarchical sparse-grid interpolation (CC / Chebyshev)
# ----------------------------------------------------------------------

def _m_nodes(level):
    """Nodes per 1-D level: m_0 = 1, m_l = 2^l + 1 (spinterp counting)."""
    return 1 if level == 0 else 2 ** level + 1


def _nodes_1d(level, kind):
    """1-D node coordinates on [0, 1]: the midpoint at level 0, then
    equispaced (CC) or Chebyshev-Gauss-Lobatto (CH)."""
    m = _m_nodes(level)
    if m == 1:
        return np.array([0.5])
    j = np.arange(m)
    if kind == "ch":
        return 0.5 * (1.0 - np.cos(np.pi * j / (m - 1)))
    return j / (m - 1.0)


class SparseInterpolator:
    """Hierarchical sparse-grid interpolation with piecewise-linear
    Clenshaw-Curtis ('CC') or barycentric Chebyshev ('CH') bases and early
    stopping (Klimke & Wohlmuth, ACM TOMS 31, 561 (2005) ``spinterp``;
    reference: pyqed/smolyak/interpolator.py:278). The node sets and the
    function values are host set-up (NumPy); each level's (nout, nnodes)
    weight matrix is built and applied on ``device`` (the card when None;
    raises without one).
    """

    def __init__(self, maximum_level, n_dimensions,
                 interpolation_type="CC", interpolation_interval=None,
                 tol=1e-3, device=None):
        self.device = resolve_device(device)
        self.maximum_level = maximum_level
        self.d = n_dimensions
        self.kind = interpolation_type.lower()
        if self.kind not in ("cc", "ch"):
            raise ValueError(f"interpolation_type {interpolation_type!r}")
        if interpolation_interval is None:
            interpolation_interval = np.stack(
                [np.zeros(n_dimensions), np.ones(n_dimensions)])
        self.interval = np.asarray(interpolation_interval, float)
        self.tol = tol
        self.levels = []          # per level: dict(Xn, idx, surplus, ...)

    @classmethod
    def from_reference(cls, ref, device=None):
        """The port's interpolator from a fitted JAX ``SparseInterpolator``:
        its settings and levels (nodes, multi-indices, surpluses), the
        surpluses moved to ``device``."""
        self = cls(ref.maximum_level, ref.d, ref.kind.upper(), ref.interval,
                   ref.tol, device=device)
        self.levels = [dict(lv, Xn=np.array(lv["Xn"]),
                            idx=np.array(lv["idx"]),
                            surplus=torch.as_tensor(np.asarray(lv["surplus"]),
                                                    device=self.device))
                       for lv in ref.levels]
        return self

    # ------------------------------------------------------------ grids
    def _denormalize(self, X01):
        return self.interval[0] + X01 * (self.interval[1] - self.interval[0])

    def _normalize(self, X):
        return (X - self.interval[0]) / (self.interval[1] - self.interval[0])

    def sparse_sample(self, level):
        """Unit-cube nodes and per-node multi-indices of sparse level
        ``level``: full subgrids with |i|_1 = level, deduplicated within
        the level (the first occurrence keeps its multi-index)."""
        pts, idxs = [], []
        for comb in itertools.product(range(level + 1), repeat=self.d):
            if sum(comb) != level:
                continue
            axes = [_nodes_1d(l, self.kind) for l in comb]
            for p in itertools.product(*axes):
                pts.append(p)
                idxs.append(comb)
        pts = np.asarray(pts)
        idxs = np.asarray(idxs)
        _, keep = np.unique(np.round(pts, 12), axis=0, return_index=True)
        keep = np.sort(keep)
        return pts[keep], idxs[keep]

    # ------------------------------------------------------------ basis
    def _weights(self, Xn_out, Xn_in, idx):
        """(nout, nnodes) product-basis weight matrix on the unit cube, on
        the device."""
        dev = self.device
        t = lambda a: torch.as_tensor(np.asarray(a, float), device=dev)
        nout, nn = len(Xn_out), len(Xn_in)
        W = torch.ones((nout, nn), dtype=torch.float64, device=dev)
        for d in range(self.d):
            xo = t(Xn_out[:, d])[:, None]           # (nout, 1)
            ld = idx[:, d]
            if self.kind == "cc":
                c = t(Xn_in[:, d])[None, :]         # (1, nn)
                m = t([_m_nodes(l) for l in ld])[None, :]
                B = torch.where(m == 1, torch.ones_like(m),
                                torch.clamp(1.0 - (m - 1) * (xo - c).abs(),
                                            min=0.0))
            else:
                B = torch.ones((nout, nn), dtype=torch.float64, device=dev)
                for lv in np.unique(ld):
                    if _m_nodes(lv) == 1:
                        continue
                    P = _nodes_1d(lv, "ch")
                    sel = np.nonzero(ld == lv)[0]
                    cs = Xn_in[sel, d]
                    # exact Lagrange: the node's own point is left out by
                    # index, not by a distance tolerance
                    own = np.argmin(np.abs(cs[:, None] - P[None, :]), axis=1)
                    den = cs[:, None] - P[None, :]    # (nsel, m)
                    den[np.arange(len(cs)), own] = 1.0
                    skip = np.zeros((len(cs), len(P)), dtype=bool)
                    skip[np.arange(len(cs)), own] = True
                    num = xo[:, :, None] - t(P)[None, None, :]
                    num = torch.where(torch.as_tensor(skip, device=dev),
                                      1.0, num)       # (nout, nsel, m)
                    B[:, torch.as_tensor(sel, device=dev)] = torch.prod(
                        num / t(den)[None], dim=2)
            W *= B
        return W

    # ------------------------------------------------------------- fit
    def fit(self, func, grid_out):
        """Build the surpluses level by level, stopping early on the
        largest surplus; returns the interpolant at ``grid_out``
        (a tensor on the device). ``func`` takes the NumPy nodes (n, d)."""
        dev = self.device
        Xn_out = self._normalize(np.asarray(grid_out, float))
        interpol = torch.zeros(len(Xn_out), dtype=torch.float64, device=dev)
        self.levels = []
        for level in range(self.maximum_level + 1):
            Xn, idx = self.sparse_sample(level)
            resid = torch.as_tensor(
                np.asarray(func(self._denormalize(Xn)), float), device=dev)
            for prev in self.levels:
                resid = resid - self._weights(Xn, prev["Xn"], prev["idx"]) \
                    @ prev["surplus"]
            err = resid.abs()
            self.levels.append(dict(Xn=Xn, idx=idx, surplus=resid,
                                    max_error=float(err.max()),
                                    mean_error=float(err.mean())))
            interpol = interpol + self._weights(Xn_out, Xn, idx) @ resid
            if level > 0 and self.levels[-1]["max_error"] < self.tol:
                break
        return interpol

    @property
    def depth(self):
        return len(self.levels) - 1

    def evaluate(self, grid_out):
        """The interpolant of the fitted surpluses at new points."""
        Xn_out = self._normalize(np.asarray(grid_out, float))
        out = torch.zeros(len(Xn_out), dtype=torch.float64,
                          device=self.device)
        for lv in self.levels:
            out = out + self._weights(Xn_out, lv["Xn"], lv["idx"]) \
                @ lv["surplus"]
        return out
