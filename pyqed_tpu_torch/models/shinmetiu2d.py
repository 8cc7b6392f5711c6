"""2D Shin-Metiu model for proton-coupled electron transfer (PCET)
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/models/shinmetiu2d.py`` (reference:
pyqed/models/ShinMetiu.py:289 ``ShinMetiu2``, ``:706``
``ShinMetiu2InMagneticField``, ``:871`` ``ShinMetiu2InElectricField``):
one electron on an (x, y) sine-DVR grid, a mobile proton at 2D position R
between two fixed ions at (±L/2, 0), softened Coulomb interactions
V_en = −1/sqrt(a + |r−R|²), V_nn = 1/sqrt(b + |R1−R2|²) and a (|R|/R0)^4
bounding term.

The kinetic matrix and the field terms are built once on the host and
kept on the model's device (the card when None); the potential of a batch
of proton positions is one broadcast evaluation there, and a
Born-Oppenheimer scan is a batched dense ``torch.linalg.eigh`` over
chunks of :data:`PES_CHUNK` proton positions (the JAX package's
``lax.map(batch_size=8)``).

Field variants follow the reference conventions:

- magnetic (Landau gauge, B ∥ z): hcore = T + B·(X ⊗ P_y) and the
  diamagnetic ½B²x² added to the potential (complex Hermitian H;
  reference: pyqed/models/ShinMetiu.py:760-815);
- electric (length gauge, E in the x-y plane): hcore = T + Ex·X + Ey·Y
  with the reference's +(Ex²+Ey²)/2 energy offset
  (reference: pyqed/models/ShinMetiu.py:918-996).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..grid.dvr import SineDVR
from ..ops.linalg import as_tensor
from ..units import au2tesla

#: proton positions per batched eigh in :meth:`ShinMetiu2D.pes`
PES_CHUNK = 8


class ShinMetiu2D:
    """2D Shin-Metiu PCET model (reference: pyqed/models/ShinMetiu.py:289).

    Electron on an (x, y) grid; proton coordinate R = (Rx, Ry).
    ``device``: the card when None (raises without one).
    """

    def __init__(self, nstates=3, method=None, dvr_type="sine", device=None):
        # a positional reference-style call ShinMetiu2('exact', 3) passes
        # the method string first — shift it over
        if isinstance(nstates, str):
            method, nstates = nstates, (3 if method is None else method)
        if dvr_type != "sine":
            raise NotImplementedError("only dvr_type='sine' (as the "
                                      "reference classes use)")
        self.device = resolve_device(device)
        self.a = 0.5
        self.b = 10.0
        self.R0 = 3.5
        self.L = 4.0 * np.sqrt(3.0) / 5.0
        self.left = np.array([-self.L / 2.0, 0.0])
        self.right = np.array([+self.L / 2.0, 0.0])
        self.nstates = nstates
        self.x = None
        self.u = None        # adiabatic-state stack set by pes()
        self._T = None       # kinetic (kron) matrix, cached
        self._hcore = None   # field terms beyond T (subclasses)
        self._H0 = None      # T + field terms on the device

    # ------------------------------------------------------------- grid
    def create_grid(self, domains, npts=None):
        """domains: [(x0, x1), (y0, y1)]; npts: points per dim (int or
        pair): the interior sine-DVR points, as the reference's
        ``discretize(..., endpoints=False)``. Also accepts the reference
        order ``create_grid(level, domains)`` with npts = 2**level - 1."""
        if np.isscalar(domains):            # reference order: (level, domains)
            level, domains = int(domains), npts
            npts = 2 ** level - 1
        if npts is None:
            raise TypeError("create_grid(domains, npts) or "
                            "create_grid(level, domains)")
        if np.isscalar(npts):
            npts = (int(npts), int(npts))
        self.dvr_x = SineDVR(*domains[0], npts[0], device="cpu")
        self.dvr_y = SineDVR(*domains[1], npts[1], device="cpu")
        self.x = np.asarray(self.dvr_x.x)
        self.y = np.asarray(self.dvr_y.x)
        self.nx, self.ny = npts
        self.domains = domains
        self._T = None
        self._hcore = None
        self._H0 = None
        return self.x, self.y

    # ------------------------------------------------------- potentials
    def v_en(self, d2):
        """−1/sqrt(a + |r−R|²), broadcast over squared distances."""
        return -1.0 / torch.sqrt(self.a + d2)

    def v_nn(self, R1, R2):
        """Proton-ion repulsion, batched over the leading axes of R1/R2."""
        d = as_tensor(R1, torch.float64) - as_tensor(R2, torch.float64)
        return 1.0 / torch.sqrt(self.b + (d ** 2).sum(-1))

    def _grid(self):
        X = torch.as_tensor(self.x, device=self.device)[:, None]
        Y = torch.as_tensor(self.y, device=self.device)[None, :]
        return X, Y

    def potential_grid(self, R):
        """V(x, y; R) on the full grid for a proton position R (2,), or a
        batch (B, 2) -> (B, nx, ny), on the device."""
        R = as_tensor(R, torch.float64, self.device)
        X, Y = self._grid()
        Rb = R.reshape(-1, 2)[:, :, None, None]           # (B, 2, 1, 1)
        left = torch.as_tensor(self.left, device=self.device)
        right = torch.as_tensor(self.right, device=self.device)

        def d2(cx, cy):
            return (X - cx) ** 2 + (Y - cy) ** 2

        v = (self.v_en(d2(left[0], left[1])) + self.v_en(d2(right[0],
                                                            right[1]))
             + self.v_en(d2(Rb[:, 0], Rb[:, 1])))
        Rf = R.reshape(-1, 2)
        vnn = (self.v_nn(Rf, left) + self.v_nn(Rf, right)
               + self.v_nn(left, right))
        bound = (torch.linalg.vector_norm(Rf, dim=-1) / self.R0) ** 4
        v = v + (vnn + bound)[:, None, None] + self._extra_potential(X, Y)
        return v.reshape(R.shape[:-1] + v.shape[-2:])

    def _extra_potential(self, X, Y):
        return torch.zeros((), dtype=X.dtype, device=X.device)

    # ------------------------------------------------------ Hamiltonian
    # The reference's base class builds T with ldr.ldr:kinetic(x,
    # dvr='sine'), which uses L = x[-1] - x[0] — the span of the INTERIOR
    # points, not the sine-DVR box length (reference: pyqed/ldr/ldr.py:122
    # vs dvr_1d.py:556). The field subclasses use the proper SineDVR.t().
    _kinetic_box = False

    def _t1d(self, dvr):
        T = dvr.t().numpy()
        if not self._kinetic_box:
            span = dvr.x[-1] - dvr.x[0]          # = L (npts-1)/(npts+1)
            T = T * (dvr.L / span) ** 2
        return T

    def _kinetic(self):
        """The kinetic (kron) matrix, NumPy, cached."""
        if self._T is None:
            tx = self._t1d(self.dvr_x)
            ty = self._t1d(self.dvr_y)
            self._T = (np.kron(tx, np.eye(self.ny))
                       + np.kron(np.eye(self.nx), ty))
        return self._T

    def _field_hcore(self):
        """Field terms added to T by subclasses (NumPy); None for the
        base."""
        return None

    def _hcore_dev(self):
        """T + field terms as one tensor on the device, cached."""
        if self._H0 is None:
            H0 = self._kinetic()
            hf = self._field_hcore()
            if hf is not None:
                H0 = H0 + hf
            self._H0 = torch.as_tensor(H0, device=self.device)
        return self._H0

    def hamiltonian(self, R):
        """Dense H(R) on the flattened (x, y) grid, on the device; a batch
        of positions (B, 2) gives (B, n, n)."""
        H0 = self._hcore_dev()
        v = self.potential_grid(R)
        v = v.reshape(v.shape[:-2] + (-1,))
        return H0 + torch.diag_embed(v).to(H0.dtype)

    def _energy_offset(self):
        return 0.0

    # ------------------------------------------------------ solvers
    def single_point(self, R, num_eigs=None):
        """BO energies and states at proton position R by dense eigh, on
        the device (reference: pyqed/models/ShinMetiu.py:360)."""
        if self.x is None:
            raise ValueError("call create_grid(domains, npts) first")
        w, u = torch.linalg.eigh(self.hamiltonian(R))
        k = num_eigs or self.nstates
        return w[:k] + self._energy_offset(), u[:, :k]

    def pes(self, Rs, num_eigs=None):
        """Batched APES over proton positions: batched dense eighs of
        :data:`PES_CHUNK` positions each (reference: a double loop,
        pyqed/models/ShinMetiu.py:836-860). Returns (E (npoints, k),
        U (npoints, nx*ny, k)) on the device, and keeps U for
        :meth:`electronic_overlap`."""
        if self.x is None:
            raise ValueError("call create_grid(domains, npts) first")
        k = num_eigs or self.nstates
        Rs = as_tensor(Rs, torch.float64, self.device).reshape(-1, 2)
        Es, Us = [], []
        for i in range(0, Rs.shape[0], PES_CHUNK):
            w, u = torch.linalg.eigh(self.hamiltonian(Rs[i:i + PES_CHUNK]))
            Es.append(w[:, :k])
            Us.append(u[:, :, :k])
        self.u = torch.cat(Us)
        return torch.cat(Es) + self._energy_offset(), self.u

    # ------------------------------------------- derivative couplings
    def dH(self, R):
        """∂H/∂R_mu on the grid (diagonal in r): (a + |r−R|²)^(−3/2)
        (R−r)_mu (reference: pyqed/models/ShinMetiu.py:427); (nx, ny, 2)."""
        R = as_tensor(R, torch.float64, self.device)
        X, Y = self._grid()
        d2 = (X - R[0]) ** 2 + (Y - R[1]) ** 2
        pref = (self.a + d2) ** (-1.5)
        return torch.stack([pref * (R[0] - X), pref * (R[1] - Y)], dim=-1)

    def nonadiabatic_coupling(self, w, u, R):
        """First-order NACs F_mu^{ba} = <b|∂_mu H|a> / (E_a − E_b)
        (reference: pyqed/models/ShinMetiu.py:460): (k, k, 2) with zeros
        on the diagonal."""
        dv = self.dH(R).reshape(-1, 2)
        u = as_tensor(u, device=self.device)
        me = torch.einsum("ib, im, ia -> bam", u.conj(), dv.to(u.dtype), u)
        w = as_tensor(w, torch.float64, self.device)
        dE = w[None, :] - w[:, None]       # E_a - E_b
        safe = torch.where(dE.abs() < 1e-12, torch.inf, dE)
        return me / safe[:, :, None]

    def parallel_transport(self, points):
        """APES and phase-transported adiabatic states along a path, a
        host loop over :meth:`single_point` (reference:
        pyqed/models/ShinMetiu.py:553): each eigencolumn is rotated so that
        <u_old|u> is real positive (the reference's sign flip for real
        states). Returns (E (npts, k), U (npts, n, k)) on the device."""
        wold, uold = self.single_point(points[0])
        E, U = [wold], [uold]
        for point in points[1:]:
            w, u = self.single_point(point)
            ov = (uold.conj() * u).sum(0)
            mag = ov.abs()
            big = mag > 1e-14
            phase = torch.where(big, ov / torch.where(big, mag, 1.0), 1.0)
            u = u * phase.conj()[None, :]
            wold, uold = w, u
            E.append(w)
            U.append(u)
        return torch.stack(E), torch.stack(U)

    def electronic_overlap(self):
        """A[a, m, c, n] = <u_am | u_cn> between scan points
        (reference: pyqed/models/ShinMetiu.py:580)."""
        if self.u is None:
            raise ValueError("call pes(Rs) first (fills the "
                             "adiabatic-state stack)")
        return torch.einsum("aim, cin -> amcn", self.u.conj(), self.u)


class ShinMetiu2DMagnetic(ShinMetiu2D):
    """2D Shin-Metiu in a static out-of-plane magnetic field, Landau
    gauge (reference: pyqed/models/ShinMetiu.py:706): the paramagnetic
    B·x·p_y enters hcore, the diamagnetic ½B²x² the potential.

    B is given in Tesla (converted with au2tesla, reference :735)."""

    _kinetic_box = True     # field variants use the true SineDVR box T

    def __init__(self, nstates=3, B=0.0, gauge="landau", method=None,
                 dvr_type="sine", device=None):
        super().__init__(nstates=nstates, method=method,
                         dvr_type=dvr_type, device=device)
        if gauge != "landau":
            raise NotImplementedError("only the Landau gauge is "
                                      "implemented (as the reference)")
        self.B = B / au2tesla
        self.gauge = gauge

    @property
    def B(self):
        return self._B

    @B.setter
    def B(self, value):
        """Setting B invalidates the cached field hcore."""
        self._B = float(value)
        self._hcore = self._H0 = None

    def _field_hcore(self):
        if self._hcore is None:
            Py = self.dvr_y.momentum().numpy()
            self._hcore = self.B * np.kron(np.diag(self.x), Py)
        return self._hcore

    def _extra_potential(self, X, Y):
        return 0.5 * self.B ** 2 * X ** 2 + torch.zeros_like(Y)


class ShinMetiu2DElectric(ShinMetiu2D):
    """2D Shin-Metiu in a static in-plane electric field, length gauge
    (reference: pyqed/models/ShinMetiu.py:871): hcore += Ex·X + Ey·Y;
    eigenvalues carry the reference's +(Ex²+Ey²)/2 offset (reference
    :996). E = [Ex, Ey] in atomic units."""

    _kinetic_box = True     # field variants use the true SineDVR box T

    def __init__(self, nstates=3, E=(0.0, 0.0), method=None,
                 dvr_type="sine", device=None):
        super().__init__(nstates=nstates, method=method,
                         dvr_type=dvr_type, device=device)
        self.E = E

    @property
    def E(self):
        return self._E

    @E.setter
    def E(self, value):
        """Setting E invalidates the cached field hcore."""
        self._E = tuple(float(e) for e in value)
        self._hcore = self._H0 = None

    def _field_hcore(self):
        if self._hcore is None:
            Ex, Ey = self.E
            self._hcore = (Ex * np.kron(np.diag(self.x), np.eye(self.ny))
                           + Ey * np.kron(np.eye(self.nx), np.diag(self.y)))
        return self._hcore

    def _energy_offset(self):
        Ex, Ey = self.E
        return (Ex ** 2 + Ey ** 2) / 2.0


# reference drop-in names (pyqed/models/ShinMetiu.py:289,706,871)
ShinMetiu2 = ShinMetiu2D
ShinMetiu2InMagneticField = ShinMetiu2DMagnetic
ShinMetiu2InElectricField = ShinMetiu2DElectric
