"""Split-operator nonadiabatic wavepacket dynamics on uniform grids
(PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/spo.py`` (reference: pyqed/wpd.py
``SPO:191``, ``SPO2:379``, ``SPO3:1105``). Strang splitting for
H = K + V(x) with an ns-state diabatic potential matrix V(x) at every
grid point:

    e^{-iH dt} = e^{-iV dt/2} e^{-iK dt} e^{-iV dt/2}

- build: the per-grid-point eigendecomposition of V(x) is one batched
  ``torch.linalg.eigh`` (``matrix_exp`` for non-Hermitian V); ``expK``,
  ``expV`` and ``expV/2`` are complex tensors on the device, in the JAX
  package's public layout (grid + (ns, ns));
- step: kinetic factor = N-d FFT (cuFFT) and the phase multiply,
  potential factor = one ns×ns matvec per grid point. The two elementwise
  passes run through the hand-written kernels of ``csrc/spo.cu``
  (``kernel='cuda'``, the default on a CUDA device) or as plain torch
  (``kernel='xla'``, the JAX package's default formulation);
- time loop: a Python loop over the fixed-shape step that never
  synchronises with the host inside a run; the electronic density matrix
  is written on the device once per window of ``nout`` steps.

The TPU workarounds of the JAX module are not carried over: build products
stay complex (no real/imag pairs), and nothing is padded or transposed
for the kernels. The state keeps the layout its last operation gave it: a
batched FFT over the grid axes returns it states-first in memory, and the
kernels take that layout as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config import complex_dtype_for, resolve_device
from ..core.diagnostics import load_checkpoint, save_checkpoint
from ..core.result import Result
from ..ops import kernels as kn
from ..ops.math import interval
from ..parallel.mesh import check_mesh

KERNELS = ("cuda", "xla", "dft")


def _kernel_name(kernel):
    """Validate a kernel name; ``pallas`` is an alias of ``cuda``."""
    if kernel is None:
        return None
    if kernel == "pallas":
        return "cuda"
    if kernel not in KERNELS:
        raise ValueError(f"unknown SPO kernel {kernel!r}; expected None, "
                         f"one of {KERNELS} or 'pallas'")
    return kernel


def _host(a):
    """A NumPy view or copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(a, device):
    """An array or tensor as a tensor on ``device`` (dtype kept; an array
    is copied, so the caller's buffer is never shared)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.tensor(np.asarray(a), device=device)


def _kgrid(n, d):
    return 2.0 * np.pi * np.fft.fftfreq(n, d)


# cuSOLVER's batched syev, which torch.linalg.eigh calls for a batch of
# small matrices on CUDA, rejects batches of 32768 and more with
# CUSOLVER_STATUS_INVALID_VALUE (torch 2.11, CUDA 12.8, H100); 16384 works.
EIGH_CHUNK = 16384


def _eigh(a, chunk=None):
    """Batched ``torch.linalg.eigh`` of (npts, ns, ns) blocks, ``chunk``
    blocks per call (default: :data:`EIGH_CHUNK` on CUDA, all on the
    CPU)."""
    if chunk is None:
        chunk = EIGH_CHUNK if a.device.type == "cuda" else a.shape[0]
    if a.shape[0] <= chunk:
        return torch.linalg.eigh(a)
    w = torch.empty(a.shape[:-1], dtype=a.real.dtype, device=a.device)
    u = torch.empty_like(a)
    for i in range(0, a.shape[0], chunk):
        w[i:i + chunk], u[i:i + chunk] = torch.linalg.eigh(a[i:i + chunk])
    return w, u


def _complex_of(t):
    """``t`` as a complex tensor of its precision."""
    if t.is_complex():
        return t
    return t.to(torch.complex64 if t.dtype == torch.float32
                else torch.complex128)


@dataclasses.dataclass
class ResultSPO(Result):
    """Result with grid metadata (reference: pyqed/wpd.py:57 ResultSPO2).
    ``population`` is (nwindows+1, ns) and ``rho_el`` (nwindows+1, ns, ns),
    on the solver's device."""
    grids: Any = None
    population: Optional[torch.Tensor] = None
    rho_el: Optional[torch.Tensor] = None

    @property
    def x(self):
        return self.grids[0] if self.grids else None

    @property
    def y(self):
        return self.grids[1] if self.grids and len(self.grids) > 1 else None

    def _dvol(self):
        return float(np.prod([g[1] - g[0] for g in self.grids]))

    def get_population(self, fname=None):
        """Per-state populations from the stored snapshots, (nt, ns)
        (reference: pyqed/wpd.py ResultSPO2.get_population)."""
        psis = self.states
        p = torch.einsum("t...a, t...a -> ta", psis.conj(),
                         psis).real * self._dvol()
        self.population = p
        if fname is not None:
            np.savez(fname, p.cpu().numpy())
        return p

    def position(self):
        """Position expectations <x_d>(t), (nt, ndim) (reference:
        pyqed/wpd.py ResultSPO2.position)."""
        psis = self.states
        ndim = len(self.grids)
        prob = (psis.abs() ** 2).sum(dim=-1)           # (t, grid...)
        axes = tuple(range(1, ndim + 1))
        cols = []
        for d, g in enumerate(self.grids):
            shape = [1] * (ndim + 1)
            shape[d + 1] = len(g)
            gt = torch.as_tensor(np.asarray(g), dtype=prob.dtype,
                                 device=prob.device).reshape(shape)
            cols.append((prob * gt).sum(dim=axes) * self._dvol())
        return torch.stack(cols, dim=-1)


ResultSPO2 = ResultSPO      # reference drop-in name (pyqed/spo.py)


class SPON:
    """N-dimensional, ns-state split-operator propagator.

    kernel : None, ``'cuda'`` (alias ``'pallas'``), ``'xla'`` or ``'dft'``.
        None and ``'cuda'`` send the phase multiply and the potential
        apply through the hand-written kernels (their wrappers run the
        plain versions for CPU tensors); ``'xla'`` is the plain torch form
        (broadcast multiply and einsum); ``'dft'`` folds the whole Strang
        step of a 1-D grid into one dense matrix.
    nonherm : a full non-Hermitian diabatic potential matrix; the
        potential propagator is then a batched matrix exponential.
    device : the card (``cuda``) when None, which raises without one;
        ``"cpu"`` on request.
    mesh : a :class:`~torch.distributed.device_mesh.DeviceMesh` whose
        first axis shards the first grid axis in :meth:`run`: each rank
        steps its slab, the potential kernel on its slab of expV and the
        kinetic step through the pencil FFT
        (:func:`~pyqed_tpu_torch.parallel.make_keo_pencil`, the phase
        kernel on the rank's slab of expK; Jacobi coordinates through
        :func:`~pyqed_tpu_torch.parallel.make_keo_factors_pencil`), at
        any number of ranks, one included. A grid that does not divide
        raises.
    """

    def __init__(self, grids: Sequence, masses=None, nstates: int = 2,
                 abc: bool = False, kernel=None, mesh=None,
                 nonherm: bool = False, device=None):
        self.mesh = check_mesh(mesh)
        self.kernel = _kernel_name(kernel)
        self.device = resolve_device(device)
        self.nonherm = nonherm
        self.grids = [_host(g) for g in grids]
        self.ndim = len(self.grids)
        self.shape = tuple(len(g) for g in self.grids)
        self.dxs = [float(interval(g)) for g in self.grids]
        self.dvol = float(np.prod(self.dxs))
        if masses is None:
            masses = [1.0] * self.ndim
        if np.isscalar(masses):
            masses = [float(masses)] * self.ndim
        self.masses = self.mass = masses
        self.nstates = self.ns = nstates
        self.abc = abc
        self.v = self.V = None
        self.apes = None
        self.d2a = None
        self._exp_K = None
        self._exp_V = None
        self._exp_V_half = None
        self._step_mat = None
        self._built_key = None   # (dt, dtype, dft) of the factors run() uses

    # ------------------------------------------------------------- potential
    def set_dpes(self, v):
        """Set the diabatic potential-energy matrix, shape
        grid_shape + (ns, ns) (or grid_shape for a single surface)."""
        v = _tensor(v, self.device)
        if self.nstates == 1 and tuple(v.shape) == self.shape:
            v = v[..., None, None]
        want = self.shape + (self.nstates, self.nstates)
        if tuple(v.shape) != want:
            raise ValueError(f"dpes shape {tuple(v.shape)} != {want}")
        self.v = self.V = v
        self._built_key = None
        return self

    set_DPEM = set_dpes
    set_potential = set_dpes

    def set_DPES(self, surfaces, diabatic_couplings=(), eta=None,
                 abc_center=None, abc_width=None):
        """Build the diabatic PE matrix from surfaces + couplings
        (reference: pyqed/wpd.py:444).

        With ``abc=True``, a quadratic complex absorbing potential
        −i·eta·(x − x0)² is applied on the diagonal beyond ``abc_center``
        (x0), which defaults to the start of the last ``abc_width``
        fraction (10%) of the first coordinate's range.
        """
        ns = self.nstates
        v = np.zeros(self.shape + (ns, ns),
                     dtype=complex if self.abc else float)
        for a in range(ns):
            v[..., a, a] = _host(surfaces[a])
        for dc in diabatic_couplings:
            a, b = dc[0][:2]
            v[..., a, b] = _host(dc[1])
            v[..., b, a] = np.conj(v[..., a, b])
        if self.abc:
            if eta is None:
                raise ValueError(
                    "abc=True needs an absorbing strength: set_DPES(..., "
                    "eta=<float>, abc_center=<x0>)")
            x = self.grids[0]
            if abc_center is None:
                frac = 0.1 if abc_width is None else abc_width
                abc_center = x[-1] - frac * (x[-1] - x[0])
            X = np.meshgrid(*self.grids, indexing="ij", copy=False)[0]
            cap = np.where(X > abc_center, (X - abc_center) ** 2, 0.0)
            for n in range(ns):
                v[..., n, n] = v[..., n, n] - 1j * eta * cap
        return self.set_dpes(v)

    # ----------------------------------------------------------------- build
    def build(self, dt, dtype=torch.complex128):
        """Precompute the kinetic and potential propagator factors for a
        step of ``dt``, as ``dtype`` (complex128 or complex64) tensors."""
        dt = float(dt)
        dev = self.device
        self._built_key = None
        ks = [_kgrid(n, d) for n, d in zip(self.shape, self.dxs)]
        self.ks = ks
        K2 = torch.zeros((), dtype=torch.float64, device=dev)
        for axis, (k, m) in enumerate(zip(ks, self.masses)):
            shape = [1] * self.ndim
            shape[axis] = len(k)
            K2 = K2 + torch.as_tensor(k.reshape(shape) ** 2 / (2.0 * m),
                                      device=dev)
        self._exp_K = torch.exp(-1j * K2 * dt).to(dtype).contiguous()

        if self.v is None:
            raise ValueError("The diabatic PES is not specified.")
        ns = self.nstates
        npts = int(np.prod(self.shape))
        vflat = self.v.reshape(npts, ns, ns)
        sh = self.shape + (ns, ns)
        self._step_mat = None

        if self.nonherm and ns > 1:
            # general non-Hermitian blocks: exp(-i V dt) per grid point by
            # a batched matrix exponential, no eigendecomposition
            if self.kernel == "dft":
                raise NotImplementedError("kernel='dft' with nonherm")
            vc = _complex_of(vflat)
            self._exp_V = torch.linalg.matrix_exp(-1j * dt * vc).to(
                dtype).reshape(sh)
            self._exp_V_half = torch.linalg.matrix_exp(-0.5j * dt * vc).to(
                dtype).reshape(sh)
            self.apes = None          # complex eigenvalues not tracked
            self.d2a = torch.eye(ns, dtype=vc.dtype, device=dev).expand(
                sh)
            return self

        if ns == 1:
            w = vflat[:, 0, 0][:, None]
            u = torch.ones((npts, 1, 1), dtype=_complex_of(vflat).dtype,
                           device=dev)
        elif vflat.is_complex():
            # absorbing-boundary blocks: the CAP of set_DPES is a multiple
            # of the identity at each grid point, so exp(-i(V_h + cap)dt)
            # factorizes exactly into the Hermitian propagator times the
            # scalar phase of cap = tr(cap)/ns
            vh = 0.5 * (vflat + vflat.conj().transpose(-1, -2))
            cap = vflat - vh
            w, u = _eigh(vh)
            w = w + cap.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True) / ns
        else:
            w, u = _eigh(vflat)                 # batched over grid points
        uc = _complex_of(u)
        uh = uc.conj().transpose(-1, -2)
        phase = torch.exp(-1j * w * dt)         # (npts, ns)
        phase2 = torch.exp(-1j * w * dt / 2)
        self._exp_V = ((uc * phase[:, None, :]) @ uh).to(dtype).reshape(sh)
        self._exp_V_half = ((uc * phase2[:, None, :]) @ uh).to(
            dtype).reshape(sh)
        if w.is_complex() and not bool((w.imag != 0).any()):
            w = w.real
        self.apes = w.reshape(self.shape + (ns,))
        self.d2a = uc.reshape(sh)

        if self.kernel == "dft":
            # fold the whole Strang step into ONE dense matrix
            #   M[(p,a),(q,c)] = sum_b expV2[p,a,b] C[p,q] expV2[q,b,c],
            #   C = F^H diag(expK) F / n  (the DFT as a matmul)
            if self.ndim != 1:
                raise NotImplementedError("kernel='dft' is 1D-only")
            n0 = self.shape[0]
            j = torch.arange(n0, dtype=torch.float64, device=dev)
            F = torch.exp(-2j * np.pi * torch.outer(j, j) / n0).to(dtype)
            C = (F.conj().T * self._exp_K[None, :]) @ F / n0
            V2 = self._exp_V_half
            M = torch.einsum("pab, pq, qbc -> paqc", V2, C, V2)
            self._step_mat = M.reshape(n0 * ns, n0 * ns)
        return self

    # ------------------------------------------------------------------ step
    def _use_kernels(self):
        return self.kernel in (None, "cuda")

    def _keo(self, psi):
        axes = tuple(range(self.ndim))
        psik = torch.fft.fftn(psi, dim=axes)
        if self._use_kernels():
            psik = kn.spo_phase_multiply(self._exp_K, psik)
        else:
            psik = psik * self._exp_K[..., None]
        return torch.fft.ifftn(psik, dim=axes)

    def _peo(self, psi, half=False, M=None):
        if M is None:
            M = self._exp_V_half if half else self._exp_V
        if self._use_kernels():
            return kn.spo_potential_apply(M, psi)
        return torch.einsum("...ab, ...b -> ...a", M, psi)

    def _step_dft(self, psi):
        """Folded one-matmul Strang step (kernel='dft')."""
        return (self._step_mat @ psi.reshape(-1)).reshape(psi.shape)

    def step(self, psi):
        """One full Strang step V/2 . K . V/2 (reference loop:
        pyqed/wpd.py:723-732)."""
        if self._step_mat is not None:
            return self._step_dft(psi)
        psi = self._peo(psi, half=True)
        psi = self._keo(psi)
        return self._peo(psi, half=True)

    # ------------------------------------------------------------------- run
    def run(self, psi0, dt=0.01, nt=1, e_ops=None, t0=0.0, nout=1,
            return_states=True, checkpoint=None, checkpoint_every=10,
            resume=None) -> ResultSPO:
        """Propagate ``psi0`` (grid_shape + (ns,)) for ``nt`` steps of
        ``dt``, recording the electronic density matrix (and the state,
        ``return_states=True``) after each window of ``nout`` steps.

        ``checkpoint=``: npz path written every ``checkpoint_every``
        windows with (psi, window index); ``resume=`` continues from such
        a file (also one the JAX package wrote), and the resumed run
        equals the uninterrupted one. ``e_ops`` is accepted for the
        reference signature and unused, as in the JAX package."""
        dev = self.device
        psi0 = _tensor(psi0, dev)
        if tuple(psi0.shape) == self.shape and self.nstates == 1:
            psi0 = psi0[..., None]
        if tuple(psi0.shape) != self.shape + (self.nstates,):
            raise ValueError(f"psi0 shape {tuple(psi0.shape)} != "
                             f"{self.shape + (self.nstates,)}")
        dtype = complex_dtype_for(psi0)
        psi0 = psi0.to(dtype)
        built = (float(dt), dtype, self.kernel == "dft")
        if self._built_key != built:    # else reuse the last run's factors
            self.build(dt, dtype=dtype)
            self._built_key = built
        nwin = nt // nout
        ns = self.nstates
        dvol = self.dvol

        def observe(psi):
            # electronic reduced density matrix; populations = diagonal
            return torch.einsum("...a, ...b -> ab", psi.conj(), psi) * dvol

        start_window = 0
        if resume is not None:
            start_window, (psi_r,), meta = load_checkpoint(resume)
            for key, val in (("dt", dt), ("nout", nout)):
                saved = meta.get(key)
                if saved is not None and abs(float(saved) - val) > 1e-15:
                    raise ValueError(
                        f"resume {key}={val} != checkpointed {key}={saved}"
                        " — the resumed trajectory would silently differ")
            if start_window > nwin:
                raise ValueError(
                    f"checkpoint already at window {start_window} > "
                    f"requested nt//nout = {nwin}")
            psi0 = psi_r.to(dev, dtype)

        rho0 = observe(psi0)
        if self.mesh is not None:
            psi, advance, observe, whole, write = self._sharded(psi0, nout,
                                                                 observe)
        else:
            psi, whole, write = psi0, (lambda p: p), (lambda fn: fn())
            if self._step_mat is not None:
                # compose the nout fine steps once: M^nout by squaring
                Mk = torch.linalg.matrix_power(self._step_mat, nout)

                def advance(psi):
                    return (Mk @ psi.reshape(-1)).reshape(psi.shape)
            else:
                def advance(psi):
                    for _ in range(nout):
                        psi = self.step(psi)
                    return psi

        nrun = nwin - start_window
        rho_el = torch.empty((nrun + 1, ns, ns), dtype=dtype, device=dev)
        rho_el[0] = rho0
        states = None
        if return_states:
            states = torch.empty((nrun + 1,) + tuple(psi0.shape),
                                 dtype=dtype, device=dev)
            states[0] = psi0
        every = max(1, int(checkpoint_every))
        for i in range(1, nrun + 1):
            psi = advance(psi)
            rho_el[i] = observe(psi)
            full = None
            if states is not None:
                full = states[i] = whole(psi)
            if checkpoint is not None and (i % every == 0 or i == nrun):
                full = whole(psi) if full is None else full
                write(lambda: save_checkpoint(checkpoint, start_window + i,
                                              [full], dt=dt, nout=nout))

        r = ResultSPO(grids=self.grids, dt=dt, nt=nt, psi0=psi0, nout=nout)
        r.times = t0 + (start_window + torch.arange(
            nrun + 1, dtype=torch.float64, device=dev)) * dt * nout
        r.rho_el = rho_el
        r.population = rho_el.diagonal(dim1=-2, dim2=-1).real
        r.states = states
        r.psi = whole(psi)
        return r

    def _keo_sharded(self):
        """The pencil KEO of the mesh for this solver's grid and factors."""
        from ..parallel.pencil_fft import (make_keo_factors_pencil,
                                           make_keo_pencil)
        if getattr(self, "coords", "linear") == "linear":
            return make_keo_pencil(self.shape, self.nstates, self._exp_K,
                                   self.mesh, kernel=self._use_kernels())
        return make_keo_factors_pencil(self.shape, self.nstates,
                                       self._jacobi_factors(), self.mesh)

    def _sharded(self, psi0, nout, observe):
        """:meth:`run`'s hooks with the first grid axis cut over the mesh's
        first axis: every rank steps rows [r·n0/d, (r+1)·n0/d) of psi.
        Returns (the rank's rows of psi0, advance, observe, whole, write):
        the electronic density matrix is one all-reduce and the state one
        all-gather per output window; rank 0 writes the checkpoints."""
        from ..parallel.mesh import (all_reduce_sum, axis_group, gather_rows,
                                     rank0_write)
        if self._step_mat is not None:
            raise ValueError("kernel='dft' folds the 1-D step into one dense "
                             "matrix, which does not shard; use kernel='cuda'"
                             " or 'xla' with a mesh")
        group, rank, d = axis_group(self.mesh)
        keo = self._keo_sharded()       # raises where the grid does not divide
        rows = self.shape[0] // d
        own = slice(rank * rows, (rank + 1) * rows)
        Vh = self._exp_V_half[own].contiguous()

        def advance(psi):
            for _ in range(nout):
                psi = self._peo(psi, M=Vh)
                psi = keo(psi)
                psi = self._peo(psi, M=Vh)
            return psi

        return (psi0[own].contiguous(), advance,
                lambda psi: all_reduce_sum(observe(psi), group),
                lambda psi: gather_rows(psi, group, d),
                lambda fn: rank0_write(group, fn))

    # ----------------------------------------------------------- observables
    def population(self, psi, representation="diabatic"):
        """Electronic populations (ns,) (reference: pyqed/wpd.py:627).
        The adiabatic amplitudes are d2a^H psi, the projections of psi on
        the adiabatic states (the columns of d2a), so they do not depend
        on the phases ``eigh`` gives its eigenvectors; ``build`` (or
        ``run``) must have run."""
        if isinstance(psi, list):
            return torch.stack([self.population(p, representation)
                                for p in psi])
        psi = _tensor(psi, self.device)
        if representation == "adiabatic":
            if self.d2a is None:
                raise ValueError("adiabatic populations need build(dt) "
                                 "or run() first")
            psi = torch.einsum("...ba, ...b -> ...a", self.d2a.conj(),
                               psi.to(self.d2a.dtype))
        elif representation != "diabatic":
            raise ValueError("representation must be diabatic or adiabatic")
        axes = tuple(range(self.ndim))
        return (psi.abs() ** 2).sum(dim=axes) * self.dvol

    def rdm_el(self, psi):
        """Reduced electronic density matrix (reference: pyqed/wpd.py:760)."""
        if isinstance(psi, list):
            return [self.rdm_el(p) for p in psi]
        psi = _tensor(psi, self.device)
        return torch.einsum("...a, ...b -> ab", psi.conj(), psi) * self.dvol

    def norm(self, psi):
        psi = _tensor(psi, self.device)
        return (psi.abs() ** 2).sum() * self.dvol

    def position_expectation(self, psi, axis=0):
        psi = _tensor(psi, self.device)
        shape = [1] * self.ndim
        shape[axis] = self.shape[axis]
        X = torch.as_tensor(self.grids[axis], dtype=torch.float64,
                            device=self.device).reshape(shape)
        return (X[..., None] * psi.abs() ** 2).sum() * self.dvol

    def current_density(self, psi, state_id=0):
        """Probability-current vector field of one electronic component,
        j_d = Im(chi* d_d chi)/m_d, via spectral (FFT) derivatives
        (reference: pyqed/wpd.py:796). Returns ndim grid-shaped tensors."""
        chi = _tensor(psi, self.device)[..., state_id]
        js = []
        for d in range(self.ndim):
            n = chi.shape[d]
            shape = [1] * self.ndim
            shape[d] = n
            k = torch.as_tensor(2 * np.pi * np.fft.fftfreq(n, d=self.dxs[d]),
                                device=self.device).reshape(shape)
            dchi = torch.fft.ifft(1j * k * torch.fft.fft(chi, dim=d), dim=d)
            js.append((chi.conj() * dchi).imag / self.masses[d])
        return js


class SPO(SPON):
    """1D single- or multi-surface SPO (reference: pyqed/wpd.py:191)."""

    def __init__(self, x, mass=1.0, nstates=1, abc=False, kernel=None,
                 mesh=None, device=None):
        super().__init__([x], masses=[mass], nstates=nstates, abc=abc,
                         kernel=kernel, mesh=mesh, device=device)
        self.x = self.grids[0]

    def set_potential(self, potential):
        """Accepts a callable V(x) (reference: pyqed/wpd.py:213) or an
        array."""
        v = potential(self.x) if callable(potential) else potential
        return self.set_dpes(v)


class SPO2(SPON):
    """2D nonadiabatic SPO (reference: pyqed/wpd.py:379).

    coords='jacobi' treats y as an angle with x-dependent inertia:
    K = p_x^2/(2 mu) + p_y^2 / (2 I(x)), factorized
    e^{-iK dt} ~ e^{-iK_x dt} e^{-iK_y dt} (reference: pyqed/wpd.py:850
    ``_KEO_jacobi``); masses = [mu, I(x) callable]. The jacobi factors are
    plain broadcast multiplies, as in the JAX package.
    """

    def __init__(self, x, y, mass=None, masses=None, nstates=2,
                 coords="linear", G=None, abc=False, kernel=None, mesh=None,
                 nonherm=False, device=None):
        masses = masses if masses is not None else mass
        self.coords = coords
        kw = dict(nstates=nstates, abc=abc, kernel=kernel, mesh=mesh,
                  nonherm=nonherm, device=device)
        if coords == "jacobi":
            mu, inertia = masses
            super().__init__([x, y], masses=[mu, 1.0], **kw)
            self._inertia = inertia
        elif coords == "linear":
            super().__init__([x, y], masses=masses, **kw)
        else:
            raise ValueError(f"unknown coords {coords!r}")
        self.x, self.y = self.grids
        self.X, self.Y = np.meshgrid(self.x, self.y, indexing="ij",
                                     copy=False)

    def build(self, dt, dtype=torch.complex128):
        super().build(dt, dtype)
        if self.coords == "jacobi":
            dt = float(dt)
            kx, ky = self.ks
            mu = self.masses[0]
            Iinv = 1.0 / np.asarray(self._inertia(self.x))   # (nx,)
            dev = self.device
            self._exp_Kx = torch.exp(-1j * torch.as_tensor(
                kx ** 2, device=dev) / (2 * mu) * dt).to(dtype)
            self._exp_Ky = torch.exp(-1j * torch.as_tensor(
                np.outer(Iinv, ky ** 2 / 2.0), device=dev) * dt).to(dtype)
        return self

    def _jacobi_factors(self):
        """(axis, phase) factors of the Jacobi KEO, for the mesh's pencil
        KEO."""
        return [(0, self._exp_Kx), (1, self._exp_Ky)]

    def _keo(self, psi):
        if self.coords == "linear":
            return super()._keo(psi)
        # jacobi: sequential 1D factors (reference: pyqed/wpd.py:850)
        psik = torch.fft.fft(psi, dim=0) * self._exp_Kx[:, None, None]
        psi = torch.fft.ifft(psik, dim=0)
        psik = torch.fft.fft(psi, dim=1) * self._exp_Ky[:, :, None]
        return torch.fft.ifft(psik, dim=1)


class SPO2NH(SPO2):
    """Non-Hermitian 2D SPO: complex diabatic potential matrices
    (reference: pyqed/wpd.py:921 ``SPO2NH``); a batched matrix exponential
    builds the exact non-unitary potential propagator."""

    def __init__(self, x, y, *args, **kwargs):
        kwargs["nonherm"] = True
        super().__init__(x, y, *args, **kwargs)

    def norm(self, psi):
        """Decaying norm integral |psi|^2 dV."""
        return float(super().norm(psi))


class SPO3(SPON):
    """3D nonadiabatic SPO (reference: pyqed/wpd.py:1105).

    ``coords="jacobi"``: triatomic Jacobi coordinates (r, R, theta) for
    J = 0, with the KEO

        T = p_r^2/(2 mu1) + p_R^2/(2 mu2)
            + [1/(2 mu1 r^2) + 1/(2 mu2 R^2)] p_theta^2

    (``masses=(mu1, mu2)``, third grid = theta) as three sequential
    FFT-diagonal factors, plain broadcast multiplies as in the JAX package.
    """

    def __init__(self, x, y, z, masses=None, nstates=2, coords="linear",
                 G=None, abc=False, kernel=None, mesh=None, device=None):
        if coords not in ("linear", "jacobi"):
            raise ValueError(f"unknown coords {coords!r}")
        self.coords = coords
        kw = dict(nstates=nstates, abc=abc, kernel=kernel, mesh=mesh,
                  device=device)
        if coords == "jacobi":
            if masses is None or np.isscalar(masses) or len(masses) < 2:
                raise ValueError("jacobi coords need masses=(mu1, mu2)")
            mu1, mu2 = float(masses[0]), float(masses[1])
            super().__init__([x, y, z], masses=[mu1, mu2, 1.0], **kw)
            self._mu12 = (mu1, mu2)
        else:
            super().__init__([x, y, z], masses=masses, **kw)
        self.x, self.y, self.z = self.grids
        self.X, self.Y, self.Z = np.meshgrid(self.x, self.y, self.z,
                                             indexing="ij", copy=False)

    def build(self, dt, dtype=torch.complex128):
        super().build(dt, dtype)
        if self.coords == "jacobi":
            dt = float(dt)
            mu1, mu2 = self._mu12
            kx, ky, kz = self.ks
            binv = (1.0 / (2.0 * mu1 * self.x ** 2)[:, None]
                    + 1.0 / (2.0 * mu2 * self.y ** 2)[None, :])  # (nx, ny)
            dev = self.device

            def phase(a):
                return torch.exp(-1j * torch.as_tensor(a, device=dev)
                                 * dt).to(dtype)

            self._exp_Kx = phase(kx ** 2 / (2 * mu1))
            self._exp_Ky = phase(ky ** 2 / (2 * mu2))
            self._exp_Kz = phase(binv[:, :, None] * (kz ** 2)[None, None, :])
        return self

    def _jacobi_factors(self):
        """(axis, phase) factors of the Jacobi KEO, for the mesh's pencil
        KEO."""
        return [(0, self._exp_Kx), (1, self._exp_Ky), (2, self._exp_Kz)]

    def _keo(self, psi):
        if self.coords == "linear":
            return super()._keo(psi)
        # jacobi: three sequential FFT-diagonal factors
        psik = torch.fft.fft(psi, dim=0) * self._exp_Kx[:, None, None, None]
        psi = torch.fft.ifft(psik, dim=0)
        psik = torch.fft.fft(psi, dim=1) * self._exp_Ky[None, :, None, None]
        psi = torch.fft.ifft(psik, dim=1)
        psik = torch.fft.fft(psi, dim=2) * self._exp_Kz[:, :, :, None]
        return torch.fft.ifft(psik, dim=2)


def spo_from_reference(ref, *, device, kernel=None):
    """A port solver on the same grid, masses, states and potential as a
    JAX ``SPON``/``SPO``/``SPO2``/``SPO2NH``/``SPO3`` (by class name; the
    JAX package is not imported): grids, masses, ``nstates``, ``abc``,
    ``nonherm``, ``coords``, the jacobi inertia and the DPES as NumPy."""
    cls = type(ref).__name__
    coords = getattr(ref, "coords", "linear")
    grids = [np.asarray(g) for g in ref.grids]
    kw = dict(nstates=ref.nstates, abc=ref.abc, kernel=kernel, device=device)
    if cls == "SPO":
        sol = SPO(grids[0], mass=ref.masses[0], **kw)
    elif cls in ("SPO2", "SPO2NH"):
        masses = ([ref.masses[0], ref._inertia] if coords == "jacobi"
                  else list(ref.masses))
        sol = (SPO2NH if cls == "SPO2NH" else SPO2)(
            *grids, masses=masses, coords=coords, nonherm=ref.nonherm, **kw)
    elif cls == "SPO3":
        masses = ref._mu12 if coords == "jacobi" else list(ref.masses)
        sol = SPO3(*grids, masses=masses, coords=coords, **kw)
    else:
        sol = SPON(grids, masses=list(ref.masses), nonherm=ref.nonherm, **kw)
    if ref.v is not None:
        sol.set_dpes(np.asarray(ref.v))
    return sol
