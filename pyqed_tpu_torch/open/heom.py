"""Hierarchical equations of motion (HEOM) in PyTorch.

PyTorch counterpart of ``pyqed_tpu/open/heom.py`` (reference: pyqed/oqs.py
``HEOMSolver:1332``; pyqed/HEOM/heom.py ``HEOMSolver:161``; pyqed/heom/
deom.py ``rem_cal:641``). Equation (unscaled ADOs):

  d rho_n/dt = -i[H, rho_n] - (n . nu) rho_n
               - i sum_m [Q_m, rho_{n+e_m}]
               - i sum_m n_m (c_m Q_m rho_{n-e_m} - c_m^* rho_{n-e_m} Q_m)

The hierarchy is flattened at setup into one ``(nado, n, n)`` tensor plus
static neighbour maps, and the right-hand side is a few batched torch
operations (or the hand-written CUDA coupling kernel, ``kernel='cuda'``).
The step loop is a Python loop over a fixed-shape RK4/Euler step that
never synchronises with the host (a checkpoint write does); observables
are written on the device, one row per window of ``nout`` steps. A laser
drive H + E(t) μ takes its field from a callable evaluated on the host.
"""
from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch

from ..config import (complex_dtype_for, not_yet_ported, numpy_dtype_of,
                      resolve_device)
from ..core.diagnostics import (load_checkpoint, save_checkpoint, span,
                                spanned, spans_enabled)
from ..core.dynamics import rk4_step
from ..core.result import Result
from ..ops import kernels as kn
from ..parallel.mesh import check_mesh
from .bath import DrudeBath

KERNELS = ("einsum", "matmul", "levels", "rowcol", "cuda")


def _numpy(a):
    """A host copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


def _kernel_name(kernel):
    """Validate a kernel name; ``pallas`` is an alias of ``cuda``, and
    ``levels-fast`` runs as ``levels``: the JAX package's reduced-precision
    levels form (``Precision.DEFAULT``, which on its CPU in float64 gives
    the numbers of ``levels``) has no reduced FP64 mode to take on an
    H100, and at complex64 the port keeps FP32 (no TF32). ``matmul-fast``
    is no JAX kernel (JAX lets unknown names fall through to its einsum
    form) and stays refused."""
    if kernel is None:
        return None
    if kernel == "pallas":
        return "cuda"
    if kernel == "levels-fast":
        return "levels"
    if kernel.endswith("-fast"):
        raise not_yet_ported(f"kernel={kernel!r} (reduced precision)")
    if kernel not in KERNELS:
        raise ValueError(f"unknown HEOM kernel {kernel!r}; expected one of "
                         f"{KERNELS}, 'pallas' or 'levels-fast'")
    return kernel


def enumerate_hierarchy(nmodes: int, lmax: int):
    """All occupation vectors n with sum(n) <= lmax, graded by level
    (reference: pyqed/HEOM/heom.py:40 ``state_number_enumerate``).

    Returns (keys (nado, nmodes) int32 array, index dict)."""
    keys = []
    for level in range(lmax + 1):
        for comb in itertools.combinations_with_replacement(range(nmodes),
                                                            level):
            n = [0] * nmodes
            for c in comb:
                n[c] += 1
            keys.append(tuple(n))
    index = {k: i for i, k in enumerate(keys)}
    return np.array(keys, dtype=np.int32), index


def neighbor_maps(keys, index):
    """Static gather maps: plus_idx[N, m] = index of n+e_m (or nado if
    outside the hierarchy), minus_idx likewise for n-e_m."""
    nado, nmodes = keys.shape
    plus_idx = np.full((nado, nmodes), nado, dtype=np.int32)
    minus_idx = np.full((nado, nmodes), nado, dtype=np.int32)
    for N in range(nado):
        n = keys[N].tolist()
        for m in range(nmodes):
            up = list(n)
            up[m] += 1
            j = index.get(tuple(up))
            if j is not None:
                plus_idx[N, m] = j
            if n[m] > 0:
                dn = list(n)
                dn[m] -= 1
                j = index.get(tuple(dn))
                if j is not None:
                    minus_idx[N, m] = j
    return plus_idx, minus_idx


class HEOMSolver:
    """General multi-exponential HEOM solver.

    Parameters
    ----------
    H : (n, n) system Hamiltonian (array or tensor).
    bath : a :class:`DrudeBath` (``decomposition`` chooses 'matsubara' or
        'pade' with ``nexp`` terms), or a list of (Q, c, nu) tuples or
        (Q, DrudeBath) pairs.
    lmax : hierarchy depth (max total occupation).
    kernel : right-hand side, one of ``einsum``, ``matmul``, ``levels``
        (``levels-fast`` is the same), ``rowcol`` (site-projector
        couplings only) or ``cuda`` (the hand-written coupling kernel;
        ``pallas`` is an alias). None picks ``cuda`` on a CUDA device and
        ``einsum`` on the CPU. Complex bath
        rates (underdamped or Prony baths) run through the kernel too: the
        damping is applied outside it, in full (the JAX package routes its
        level kernel to ``matmul`` there, a TPU limitation).
    mesh : a :class:`~torch.distributed.device_mesh.DeviceMesh` (from
        :func:`pyqed_tpu_torch.parallel.make_mesh`) whose first axis
        shards the ADO axis in :meth:`run` (None: unsharded).
    device : where the hierarchy lives; the card (``cuda``) when None,
        which raises without one. Pass ``"cpu"`` to run on the CPU.
    """

    def __init__(self, H, bath=None, c_ops=None, e_ops=None, lmax: int = 4,
                 decomposition="matsubara", nexp: int = 1, kernel=None,
                 mesh=None, device=None):
        with span("heom.init"):
            self.mesh = check_mesh(mesh)
            self.device = resolve_device(device)
            self._H_np = _numpy(H)
            self.H = torch.as_tensor(self._H_np, device=self.device)
            self.n = self._H_np.shape[-1]
            self.e_ops = e_ops
            self.c_ops = c_ops
            self.lmax = lmax
            self.decomposition = decomposition
            self.nexp = nexp
            self.kernel = _kernel_name(kernel)
            self._modes = None      # list of (Q, c, nu) over baths and terms
            if bath is not None:
                self.set_bath(bath)

    def set_bath(self, bath):
        if isinstance(bath, (list, tuple)):
            modes = []
            for entry in bath:
                if len(entry) == 2 and hasattr(entry[1], "matsubara"):
                    Q, b = entry
                    cs, nus = (b.pade(self.nexp)
                               if self.decomposition == "pade"
                               else b.matsubara(self.nexp))
                else:
                    Q, cs, nus = entry
                for c, nu in zip(np.atleast_1d(cs), np.atleast_1d(nus)):
                    # nu kept complex: underdamped/Prony baths carry
                    # oscillatory complex rates
                    modes.append((_numpy(Q), complex(c), complex(nu)))
            self._modes = modes
        elif isinstance(bath, DrudeBath):
            if bath.bath_ops is None and self.c_ops is None:
                raise ValueError("bath needs bath_ops (coupling operators)")
            ops = bath.bath_ops if bath.bath_ops is not None else self.c_ops
            c, nu = (bath.pade(self.nexp) if self.decomposition == "pade"
                     else bath.matsubara(self.nexp))
            self._modes = [(_numpy(Q), complex(ck), complex(nuk))
                           for Q in ops for ck, nuk in zip(c, nu)]
        else:
            raise TypeError("bath must be DrudeBath or list of (Q, c, nu)")
        return self

    # ------------------------------------------------------------ setup
    def _build(self, dtype):
        """Host-side (NumPy) hierarchy operands:
        (keys, plus_idx, minus_idx, Q, c, nu)."""
        modes = self._modes
        keys, index = enumerate_hierarchy(len(modes), self.lmax)
        plus_idx, minus_idx = neighbor_maps(keys, index)
        npdt = numpy_dtype_of(dtype)
        Q = np.stack([m[0].astype(npdt) for m in modes])
        c = np.asarray([m[1] for m in modes], dtype=npdt)
        nus = np.array([m[2] for m in modes])
        rdtype = np.float64 if dtype == torch.complex128 else np.float32
        nu = (nus.astype(npdt) if np.any(nus.imag != 0)
              else nus.real.astype(rdtype))
        return keys, plus_idx, minus_idx, Q, c, nu

    def rhs_fn(self, dtype, kernel=None, edip=None, rows=None, nsrc=None):
        """The hierarchy RHS ``ados (nado, n, n) -> d ados/dt`` and nado.
        Every kernel's closure also takes a batch of hierarchies, ados
        (nado, B, n, n), the ADO axis outermost (``cuda``: one launch of
        the coupling kernel for the whole batch).

        ``dtype`` is torch.complex128 or torch.complex64; ``kernel`` as in
        the class docstring (None: the solver's kernel, else automatic).
        With a dipole ``edip`` the closure is ``rhs(ados, E)``: a field
        ``E`` (a Python float) adds the drive −i E [μ, ρ] to every ADO,
        the H + E(t) μ of the JAX package (pyqed_tpu/open/heom.py:416-426),
        for every kernel as one more product of the ADO stack with the
        drive's (n², n²) superoperator.

        ``rows`` = (lo, hi) and ``nsrc``: the closure takes a stack of
        ``nsrc`` ADOs (default nado) and returns the destination rows
        [lo, hi) (default all) of the right-hand side, rows past nado
        zero: a sharded run's rank calls it on its all-gathered stack for
        its own ADOs (every kernel; ``cuda`` launches once a call on those
        destinations' edges).

        With spans on (:mod:`..core.diagnostics`), the build is span
        ``heom.build`` and each call of the closure span ``heom.rhs``."""
        with span("heom.build"):
            rhs, nado = self._rhs(dtype, kernel, edip, rows, nsrc)
        if spans_enabled():
            rhs = spanned("heom.rhs", rhs)
        return rhs, nado

    def _rhs(self, dtype, kernel, edip, rows, nsrc):
        """:meth:`rhs_fn`'s host build."""
        kernel = _kernel_name(kernel) or self.kernel
        with span("heom.build.hierarchy"):
            keys, plus_idx, minus_idx, Q, c, nu = self._build(dtype)
        nado = keys.shape[0]
        lo, hi, nsrc = kn.rhs_rows(nado, rows, nsrc)
        sub = dict(rows=(lo, hi), nsrc=nsrc)
        dev = self.device
        if kernel is None:
            kernel = "cuda" if dev.type == "cuda" else "einsum"
        args = (self._H_np, Q, c, nu, keys, plus_idx, minus_idx)
        damp = kn.damp_tensor(kn.dest_rows(keys @ nu, (lo, hi), 0), dtype,
                              dev)
        if kernel == "cuda":
            rhs = kn.heom_rhs_coupling_factory(*args, dtype=dtype, device=dev,
                                               **sub)
        elif kernel == "levels":
            rhs = kn.heom_rhs_levels_xla_factory(*args, dtype=dtype,
                                                 device=dev, **sub)
        elif kernel == "rowcol":
            rhs = kn.heom_rhs_rowcol_factory(*args, dtype=dtype, device=dev,
                                             **sub)
        elif kernel == "matmul":
            rhs = self._rhs_matmul(dtype, keys, plus_idx, minus_idx, Q, c,
                                   damp, **sub)
        else:
            rhs = self._rhs_einsum(dtype, keys, plus_idx, minus_idx, Q, c,
                                   damp, **sub)
        if edip is None:
            return rhs, nado
        V = self.n * self.n
        Cmu = kn.to_tensor(kn.drive_superop(_numpy(edip)), dtype, dev)

        def rhs_driven(ados, E):
            # reshape copies where a kernel's output is not contiguous
            # (rowcol), so the drive goes into the tensor returned
            own = ados[lo:hi]
            out = rhs(ados).reshape(-1, V)
            out.addmm_(own.reshape(-1, V), Cmu, alpha=E)
            return out.reshape(own.shape)

        return rhs_driven, nado

    def _neighbour_index(self, plus_idx, minus_idx, rows, nsrc):
        """[plus | minus] neighbour indices of the destination rows, a
        missing neighbour pointing at row nsrc (the zero row appended to
        the source stack)."""
        nado = plus_idx.shape[0]
        idx = np.concatenate([plus_idx, minus_idx], axis=1)
        idx = np.where(idx >= nado, nsrc, idx)
        return torch.as_tensor(kn.dest_rows(idx, rows, nsrc),
                               dtype=torch.long, device=self.device)

    def _rhs_einsum(self, dtype, keys, plus_idx, minus_idx, Q, c, damp,
                    rows, nsrc):
        """One gather over [plus; minus] neighbours with complex left/right
        weights (destinations ``rows`` of a stack of ``nsrc`` ADOs)."""
        H = self._H_np
        dev = self.device
        lo, hi = rows
        nd = hi - lo
        npdt = numpy_dtype_of(dtype)
        all_idx = self._neighbour_index(plus_idx, minus_idx, rows,
                                        nsrc)                 # (N, 2M)
        Q2 = kn.to_tensor(np.concatenate([Q, Q]), dtype, dev)  # (2M, n, n)
        ones = np.ones(keys.shape, dtype=npdt)
        wl = kn.to_tensor(kn.dest_rows(np.concatenate(
            [ones, keys * c[None, :]], axis=1), rows, 0), dtype,
            dev)[:, :, None, None]
        wr = kn.to_tensor(kn.dest_rows(np.concatenate(
            [ones, keys * np.conj(c)[None, :]], axis=1), rows, 0), dtype,
            dev)[:, :, None, None]
        H_t = kn.to_tensor(H, dtype, dev)

        def rhs(ados):
            # ados (nsrc, n, n) or a batch (nsrc, B, n, n)
            ones = (1,) * (ados.dim() - 3)
            padded = torch.cat([ados, ados.new_zeros((1,) + ados.shape[1:])])
            own = ados[lo:hi]
            out = -1j * (H_t @ own - own @ H_t)
            out = out - damp.view((nd,) + ones + (1, 1)) * own
            g = padded[all_idx]                    # (nd, 2M, [B,] n, n)
            wl_, wr_ = (x.view((nd, -1) + ones + (1, 1)) for x in (wl, wr))
            out = out - 1j * (
                torch.einsum("kab, Nk...bc -> N...ac", Q2, wl_ * g)
                - torch.einsum("Nk...ab, kbc -> N...ac", wr_ * g, Q2))
            return out

        return rhs

    def _rhs_matmul(self, dtype, keys, plus_idx, minus_idx, Q, c, damp,
                    rows, nsrc):
        """Stacked-superoperator RHS (:func:`kernels.heom_rhs_dot`) on the
        gathered, occupation-weighted neighbour stack (destinations
        ``rows`` of a stack of ``nsrc`` ADOs)."""
        n = self.n
        V = n * n
        dev = self.device
        lo, hi = rows
        nd = hi - lo
        B0, Bk = kn.heom_superop_split(self._H_np, Q, c)
        B0 = kn.to_tensor(B0, dtype, dev)
        Bk = kn.to_tensor(Bk, dtype, dev)
        all_idx = self._neighbour_index(plus_idx, minus_idx, rows, nsrc)
        wocc = kn.to_tensor(kn.dest_rows(
            np.concatenate([np.ones_like(keys), keys], axis=1), rows, 0),
            dtype, dev)[:, :, None]

        def rhs(ados):
            # ados (nsrc, n, n) or a batch (nsrc, B, n, n)
            flat = ados.reshape(ados.shape[:-2] + (V,))
            padded = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
            g = padded[all_idx] * wocc.view(
                (nd, -1) + (1,) * (flat.dim() - 1))  # (nd, 2M, [B,] V)
            own = flat[lo:hi]
            return kn.heom_rhs_dot(B0, Bk, damp, own, g).reshape(
                (nd,) + tuple(ados.shape[1:]))

        return rhs

    # ------------------------------------------------------------ run
    def run(self, rho0, dt, nt, e_ops=None, nout=1, method="rk4",
            store_ados=False, mesh=None, kernel=None, checkpoint=None,
            checkpoint_every=10, resume=None, edip=None, pulse=None,
            t0=0.0) -> Result:
        """Propagate the hierarchy for ``nt`` steps of ``dt`` from
        ``rho0`` in the root ADO, recording ``e_ops`` and the root ADO (or
        every ADO, ``store_ados=True``) after each window of ``nout``
        steps. ``method`` is 'rk4' or 'euler'.

        ``edip``/``pulse`` drive the system: H(t) = H + E(t) μ with
        E(t) = ``pulse(t)``, any callable of a float that returns a float
        (evaluated on the host, at t0 + (window·nout + i)·dt and the RK4
        stage times, as the JAX package computes them from the step
        index). ``checkpoint`` (a path) saves the ADO stack every
        ``checkpoint_every`` windows and at the end, in the JAX package's
        npz format; ``resume`` (such a path) starts from the saved window,
        so a run resumed from it returns the rows from there on, with
        ``times`` counted from that window and not from ``t0``, as in the
        JAX package.

        ``mesh`` (or the solver's): the ADO axis is cut over the ranks of
        the mesh's first axis, in chunks of ceil(nado / d) (the last
        padded with ADOs that stay zero). Each right-hand side is one
        all-gather of the ADO stack and the chosen kernel on the rank's
        own destinations (``cuda``: one launch on their edges, so 4 per
        RK4 step, as unsharded). The whole stack is gathered again only at
        the output windows and checkpoints, so every rank returns the
        same whole :class:`Result` as the unsharded run; rank 0 writes the
        checkpoints.

        With spans on (:mod:`..core.diagnostics`) the call is span
        ``heom.run`` (attributes ``nt``, ``nout``, ``nado``, ``driven``),
        each window of ``nout`` steps ``heom.window``, its row of states
        and observables ``heom.observe``, and each host evaluation of
        ``pulse`` ``heom.field``."""
        mesh = self.mesh if mesh is None else check_mesh(mesh)
        if edip is not None and pulse is None:
            raise ValueError("edip given without pulse")
        with span("heom.run", nt=nt, nout=nout,
                  driven=int(edip is not None)) as attrs:
            return self._run(attrs, rho0, dt, nt, e_ops, nout, method,
                             store_ados, mesh, kernel, checkpoint,
                             checkpoint_every, resume, edip, pulse, t0)

    def _run(self, attrs, rho0, dt, nt, e_ops, nout, method, store_ados,
             mesh, kernel, checkpoint, checkpoint_every, resume, edip,
             pulse, t0):
        """:meth:`run`'s body; ``attrs`` are its span's."""
        if e_ops is None:
            e_ops = self.e_ops or []
        dev = self.device
        rho0 = (rho0.to(dev) if isinstance(rho0, torch.Tensor)
                else torch.as_tensor(np.asarray(rho0), device=dev))
        dtype = complex_dtype_for(rho0, self.H)
        n = self.n
        if mesh is None:
            rhs, nado = self.rhs_fn(dtype, kernel=kernel, edip=edip)
            local = full = lambda y: y      # noqa: E731
        else:
            from ..parallel.mesh import axis_group, gather_rows, local_range
            group, rank, d = axis_group(mesh)
            nado = enumerate_hierarchy(len(self._modes), self.lmax)[0].shape[0]
            chunk = local_range(nado, rank, d)[2]
            lo, hi, nsrc = rank * chunk, (rank + 1) * chunk, d * chunk
            rhs_own, _ = self.rhs_fn(dtype, kernel=kernel, edip=edip,
                                     rows=(lo, hi), nsrc=nsrc)

            def rhs(y, *E):
                return rhs_own(gather_rows(y, group, d), *E)

            def local(a):
                return torch.cat(
                    [a, a.new_zeros((nsrc - nado,) + a.shape[1:])])[lo:hi]

            def full(y):
                return gather_rows(y, group, d)[:nado]
        attrs["nado"] = nado

        if edip is None:
            def f(y, t):
                return rhs(y)
        else:
            field = (spanned("heom.field", pulse) if spans_enabled()
                     else pulse)

            def f(y, t):
                return rhs(y, float(field(t)))

        if method == "rk4":
            def step(y, t):
                k1 = f(y, t)
                k2 = f(y + k1 * (dt / 2), t + dt / 2)
                k3 = f(y + k2 * (dt / 2), t + dt / 2)
                k4 = f(y + k3 * dt, t + dt)
                return y + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        elif method == "euler":
            def step(y, t):
                return y + dt * f(y, t)
        else:
            raise ValueError(method)

        eops = (torch.stack([torch.as_tensor(_numpy(e)).to(dev, dtype)
                             for e in e_ops]) if e_ops else None)

        def obs_of(ados):
            # tr(E rho) = sum_ij E_ij rho_ji
            return torch.einsum("kij, ji -> k", eops, ados[0])

        start = 0
        if resume is not None:
            start, leaves, _ = load_checkpoint(resume)
            ados0 = leaves[0].to(dev, dtype)
        else:
            ados0 = torch.zeros((nado, n, n), dtype=dtype, device=dev)
            ados0[0] = rho0.to(dtype)
        nwin = nt // nout
        every = max(1, int(checkpoint_every))
        nrows = nwin - start + 1
        state_shape = (nado, n, n) if store_ados else (n, n)
        states = torch.empty((nrows,) + state_shape, dtype=dtype, device=dev)
        states[0] = ados0 if store_ados else ados0[0]
        obs = (torch.empty((nrows, len(e_ops)), dtype=dtype, device=dev)
               if e_ops else None)
        if obs is not None:
            obs[0] = obs_of(ados0)

        y = local(ados0)
        whole = ados0
        for w in range(start, nwin):
            with span("heom.window"):
                for i in range(nout):
                    y = step(y, t0 + (w * nout + i) * dt)
                row = w + 1 - start
                with span("heom.observe"):
                    whole = full(y)
                    states[row] = whole if store_ados else whole[0]
                    if obs is not None:
                        obs[row] = obs_of(whole)
                if checkpoint is not None and (row % every == 0
                                               or w + 1 == nwin):
                    self._save(mesh, checkpoint, w + 1, whole, dt, nout)

        times = (torch.arange(start, nwin + 1, dtype=torch.float64,
                              device=dev) * dt * nout)
        return Result(times=times, observables=obs, states=states,
                      rho0=rho0, rho=whole[0], ado=whole, dt=dt, nt=nt,
                      nout=nout)

    @staticmethod
    def _save(mesh, path, window, ados, dt, nout):
        """Checkpoint the whole ADO stack: by rank 0 of a sharded run,
        which the others wait for."""
        def write():
            save_checkpoint(path, window, [ados], dt=dt, nout=nout)
        if mesh is None:
            return write()
        from ..parallel.mesh import axis_group, rank0_write
        rank0_write(axis_group(mesh)[0], write)

    # ------------------------------------------------- correlation funcs
    def correlation_3op_1t(self, rho0, oplist, dt, nt, **kwargs):
        """<A B(t) C> by propagating C ρ0 A through the hierarchy
        (``kwargs`` go to :meth:`run`). Returns (nt // nout + 1,)."""
        dtype = complex_dtype_for(rho0, *oplist, self.H)
        rho0, a_op, b_op, c_op = [torch.as_tensor(_numpy(o)).to(
            self.device, dtype) for o in (rho0, *oplist)]
        res = self.run(c_op @ rho0 @ a_op, dt, nt, e_ops=[b_op], **kwargs)
        return res.observables[:, 0]

    def correlation_2op_1t(self, rho0, a_op, b_op, dt, nt, ados0=None,
                           **kwargs):
        """<A(t) B> through the full hierarchy (reference convention,
        pyqed/oqs.py:1193). Pass ``ados0=steady_state(full=True)`` for the
        exact equilibrium correlator: seeding only the ρ0 slice lets the
        higher ADOs re-equilibrate. Returns (nt+1,) at t = 0..nt dt."""
        eye = np.eye(self.n)
        if ados0 is None:
            return self.correlation_3op_1t(rho0, [eye, a_op, b_op], dt, nt,
                                           **kwargs)
        return self.correlation_3op_2t(rho0, [eye, a_op, b_op], dt=dt,
                                       nt=1, ntau=nt + 1, ados0=ados0,
                                       **kwargs)[0]

    def liouvillian_dense(self, dtype=None, kernel="einsum"):
        """The full hierarchy Liouvillian as a dense (D, D) tensor, D =
        nado·n², column j the (linear) right-hand side of the j-th basis
        stack: D calls of it. Small hierarchies only."""
        dtype = dtype or torch.complex128
        rhs, nado = self.rhs_fn(dtype, kernel=kernel)
        n = self.n
        D = nado * n * n
        L = torch.empty((D, D), dtype=dtype, device=self.device)
        e = torch.zeros(D, dtype=dtype, device=self.device)
        for j in range(D):
            e[j] = 1
            L[:, j] = rhs(e.view(nado, n, n)).reshape(D)
            e[j] = 0
        return L

    def steady_state(self, kernel="einsum", full=False):
        """Exact HEOM steady state: the null vector of the dense hierarchy
        Liouvillian (host SVD), normalised by the trace of its ρ0 slice.
        Returns the Hermitian part of ρ0 (n, n), or with ``full=True`` the
        whole stationary (nado, n, n) stack, on the solver's device. Warns
        when the null space is degenerate. Small hierarchies only."""
        L = self.liouvillian_dense(kernel=kernel).cpu().numpy()
        _, s, Vh = np.linalg.svd(L)
        if s[-2] < 1e-10 * max(s[0], 1.0):
            warnings.warn(
                "HEOM stationary space is degenerate (e.g. pure "
                "dephasing: [H, Q] = 0 conserves every population); "
                "steady_state returns an arbitrary member.")
        n = self.n
        ados = Vh[-1].conj().reshape(-1, n, n)
        ados = ados / np.trace(ados[0])
        if not full:
            ados = (ados[0] + ados[0].conj().T) / 2
        return torch.as_tensor(ados, device=self.device)

    def propagator(self, dt, nt, kernel="einsum"):
        """Exact hierarchy propagators U(k dt) = e^{L k dt}, k = 0..nt, from
        one eig of the dense L on the device. Returns (nt+1, D, D), D =
        nado·n², to apply to a flattened ADO stack. Small hierarchies
        only."""
        L = self.liouvillian_dense(kernel=kernel)
        w, V = torch.linalg.eig(L)
        Vinv = torch.linalg.inv(V)
        ks = torch.arange(nt + 1, dtype=torch.float64, device=L.device)
        phases = torch.exp(w[None, :] * (ks[:, None] * dt))
        return (V[None] * phases[:, None, :]) @ Vinv

    def correlation_3op_2t(self, rho0, oplist, dt, nt, ntau, ados0=None,
                           **kwargs):
        """Two-time correlator <A(t) B(t+tau) C(t)> with both legs
        propagated by the hierarchy (RK4, ``kwargs['kernel']`` picks the
        right-hand side). ``ados0`` (nado, n, n) seeds the whole hierarchy
        (``steady_state(full=True)`` for exact equilibrium correlators),
        else ρ0 seeds its root. Returns (nt, ntau) complex128."""
        dtype = torch.complex128
        dev = self.device
        rhs, nado = self.rhs_fn(dtype, kernel=kwargs.get("kernel"))
        n = self.n
        a_op, b_op, c_op = [torch.as_tensor(_numpy(o)).to(dev, dtype)
                            for o in oplist]
        if ados0 is not None:
            y = torch.as_tensor(_numpy(ados0)).to(dev, dtype)
        else:
            y = torch.zeros((nado, n, n), dtype=dtype, device=dev)
            y[0] = torch.as_tensor(_numpy(rho0)).to(dev, dtype)
        step = rk4_step(rhs)
        corr = torch.empty((nt, ntau), dtype=dtype, device=dev)
        for i in range(nt):
            if i:
                y = step(y, 0.0, dt)
            z = c_op @ y @ a_op
            for k in range(ntau):
                if k:
                    z = step(z, 0.0, dt)
                corr[i, k] = torch.trace(b_op @ z[0])
        return corr

    def absorption(self, omegas, edip, dt=None, ntau=2000, kernel=None):
        """Linear absorption from the hierarchy, S(w) = 2 Re int_0^T dt
        e^{iwt} <mu(t) mu>_eq in the exact correlated equilibrium
        (``steady_state(full=True)``), with a soft window against
        truncation ringing. Without ``dt`` the step is the JAX package's:
        2π / (40 max|ω|), capped at 1.5 / (lmax max|Re ν| + 2 ‖H‖₂) for
        RK4 stability. Returns a (len(omegas),) real NumPy array."""
        ados_ss = self.steady_state(full=True)
        if dt is None:
            wmax = float(np.max(np.abs(np.asarray(omegas))))
            dt = 2.0 * np.pi / (wmax * 40.0) if wmax > 0 else 0.01
            numax = max((abs(complex(m[2]).real) for m in self._modes),
                        default=0.0)
            lam = self.lmax * numax + 2.0 * float(
                np.linalg.norm(self._H_np, ord=2))
            if lam > 0:
                dt = min(dt, 1.5 / lam)
        mu = np.asarray(_numpy(edip), dtype=complex)
        corr = self.correlation_2op_1t(None, mu, mu, dt=dt, nt=ntau - 1,
                                       ados0=ados_ss, kernel=kernel)
        corr = corr.cpu().numpy()
        t = np.arange(ntau) * dt
        w = np.asarray(omegas, dtype=float)
        win = np.exp(-(t / t[-1]) ** 2 * 4.0)
        ph = np.exp(1j * np.outer(w, t))
        return 2.0 * np.real(ph @ (corr * win)) * dt


class HEOMSolverDrude(HEOMSolver):
    """High-temperature Drude HEOM with the reference's constructor/run
    signature (reference: pyqed/oqs.py:1332,1361).

    ``run(rho0, dt, nt, temperature, cutoff, reorganization, nado)`` uses
    one exponential with the reference's high-T coefficient D0 =
    reorg·cutoff·(coth(cutoff/(2T)) − i) (pyqed/oqs.py:1843) and a
    terminator at level nado − 2; ``method='euler-seq'`` is the
    reference's own stepping (pyqed/oqs.py:1856-1873): sequential in-place
    Euler over the chain of i^n-rescaled ADOs, level k reading the level
    k − 1 already updated in the same step and the old level k + 1.
    """

    def __init__(self, H=None, c_ops=None, e_ops=None, device=None):
        super().__init__(H, bath=None, c_ops=c_ops, e_ops=e_ops,
                         device=device)

    def run(self, rho0, dt, nt, temperature, cutoff, reorganization, nado,
            method="rk4", e_ops=None, **kwargs):
        gamma = cutoff
        T = temperature
        D0 = reorganization * gamma * (1.0 / np.tanh(gamma / (2.0 * T)) - 1j)
        Q = self.c_ops[0]
        if method == "euler-seq":
            return self._run_reference_euler(rho0, dt, nt, D0, gamma, Q,
                                             nado, e_ops=e_ops)
        self.lmax = nado - 2
        self.set_bath([(Q, [D0], [gamma])])
        return super().run(rho0, dt, nt, method=method, e_ops=e_ops,
                           **kwargs)

    def _run_reference_euler(self, rho0, dt, nt, D0, gamma, Q, nado,
                             e_ops=None):
        """The sequential in-place Euler of the reference over a chain of
        ``nado`` ADOs (the last one a zero terminator); observables on the
        root after every step."""
        e_ops = e_ops or []
        dev = self.device
        rho0 = (rho0 if isinstance(rho0, torch.Tensor)
                else torch.as_tensor(np.asarray(rho0)))
        dtype = (torch.complex128 if rho0.dtype in (torch.complex128,
                                                    torch.float64)
                 else torch.complex64)
        H = self.H.to(dev, dtype)
        Q = torch.as_tensor(_numpy(Q)).to(dev, dtype)
        n = self.n
        a = [torch.zeros((n, n), dtype=dtype, device=dev)
             for _ in range(nado)]
        a[0] = rho0.to(dev, dtype)
        eops = (torch.stack([torch.as_tensor(_numpy(e)).to(dev, dtype)
                             for e in e_ops]) if e_ops else None)
        obs = (torch.empty((nt + 1, len(e_ops)), dtype=dtype, device=dev)
               if e_ops else None)
        if obs is not None:
            obs[0] = torch.einsum("kij, ji -> k", eops, a[0])
        dr, di = D0.real, D0.imag

        def comm(x, y):
            return x @ y - y @ x

        for s in range(nt):
            a[0] = a[0] - 1j * comm(H, a[0]) * dt - comm(Q, a[1]) * dt
            for k in range(1, nado - 1):
                up = comm(Q, a[k + 1])
                down = (dr * comm(Q, a[k - 1])
                        + 1j * di * (Q @ a[k - 1] + a[k - 1] @ Q))
                a[k] = a[k] + (-1j * comm(H, a[k]) - up - k * gamma * a[k]
                               + k * down) * dt
            if obs is not None:
                obs[s + 1] = torch.einsum("kij, ji -> k", eops, a[0])
        ados = torch.stack(a)
        return Result(times=torch.arange(nt + 1, dtype=torch.float64,
                                         device=dev) * dt,
                      observables=obs, rho=ados[0], ado=ados, dt=dt, nt=nt)


def solver_from_reference(H, modes, lmax, *, device, kernel=None,
                          c_ops=None):
    """A port solver on the same operators as a JAX ``HEOMSolver``: its
    host Hamiltonian (``_H_np``), its flattened ``_modes`` list of
    (Q, c, nu) and its ``lmax``. A JAX ``HEOMSolverDrude`` builds its bath
    in run(): pass its ``c_ops`` with ``modes=None`` for the port's
    :class:`HEOMSolverDrude`."""
    if modes is None:
        return HEOMSolverDrude(np.asarray(H), c_ops=[_numpy(q) for q in c_ops],
                               device=device)
    return HEOMSolver(np.asarray(H),
                      bath=[(np.asarray(Q), c, nu) for Q, c, nu in modes],
                      lmax=lmax, kernel=kernel, device=device)
