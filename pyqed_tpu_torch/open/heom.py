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
never synchronises with the host; observables are written on the device,
one row per window of ``nout`` steps.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..config import (complex_dtype_for, not_yet_ported, numpy_dtype_of,
                      resolve_device)
from ..core.result import Result
from ..ops import kernels as kn
from .bath import DrudeBath

KERNELS = ("einsum", "matmul", "levels", "rowcol", "cuda")


def _numpy(a):
    """A host copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


def _kernel_name(kernel):
    """Validate a kernel name; ``pallas`` is an alias of ``cuda``."""
    if kernel is None:
        return None
    if kernel == "pallas":
        return "cuda"
    if kernel.endswith("-fast"):
        raise not_yet_ported(f"kernel={kernel!r} (reduced precision)")
    if kernel not in KERNELS:
        raise ValueError(f"unknown HEOM kernel {kernel!r}; expected one of "
                         f"{KERNELS} or 'pallas'")
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
    kernel : right-hand side, one of ``einsum``, ``matmul``, ``levels``,
        ``rowcol`` (site-projector couplings only) or ``cuda`` (the
        hand-written coupling kernel; ``pallas`` is an alias). None picks
        ``cuda`` on a CUDA device and ``einsum`` on the CPU. Complex bath
        rates (underdamped or Prony baths) run through the kernel too: the
        damping is applied outside it, in full (the JAX package routes its
        level kernel to ``matmul`` there, a TPU limitation).
    device : where the hierarchy lives; the card (``cuda``) when None,
        which raises without one. Pass ``"cpu"`` to run on the CPU.
    """

    def __init__(self, H, bath=None, c_ops=None, e_ops=None, lmax: int = 4,
                 decomposition="matsubara", nexp: int = 1, kernel=None,
                 mesh=None, device=None):
        if mesh is not None:
            raise not_yet_ported("HEOMSolver(mesh=...)")
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

    def rhs_fn(self, dtype, kernel=None):
        """The hierarchy RHS ``ados (nado, n, n) -> d ados/dt`` and nado.

        ``dtype`` is torch.complex128 or torch.complex64; ``kernel`` as in
        the class docstring (None: the solver's kernel, else automatic)."""
        kernel = _kernel_name(kernel) or self.kernel
        keys, plus_idx, minus_idx, Q, c, nu = self._build(dtype)
        nado = keys.shape[0]
        dev = self.device
        H = self._H_np
        if kernel is None:
            kernel = "cuda" if dev.type == "cuda" else "einsum"
        args = (H, Q, c, nu, keys, plus_idx, minus_idx)
        if kernel == "cuda":
            return kn.heom_rhs_coupling_factory(*args, dtype=dtype,
                                                device=dev), nado
        if kernel == "levels":
            return kn.heom_rhs_levels_xla_factory(*args, dtype=dtype,
                                                  device=dev), nado
        if kernel == "rowcol":
            return kn.heom_rhs_rowcol_factory(*args, dtype=dtype,
                                              device=dev), nado
        damp = kn.damp_tensor(keys @ nu, dtype, dev)
        if kernel == "matmul":
            return self._rhs_matmul(dtype, keys, plus_idx, minus_idx, Q, c,
                                    damp), nado

        # einsum: one gather over [plus; minus] neighbours with complex
        # left/right weights
        n = self.n
        npdt = numpy_dtype_of(dtype)
        all_idx = torch.as_tensor(
            np.concatenate([plus_idx, minus_idx], axis=1), dtype=torch.long,
            device=dev)                                       # (N, 2M)
        Q2 = kn.to_tensor(np.concatenate([Q, Q]), dtype, dev)  # (2M, n, n)
        ones = np.ones(keys.shape, dtype=npdt)
        wl = kn.to_tensor(np.concatenate([ones, keys * c[None, :]], axis=1),
                          dtype, dev)[:, :, None, None]
        wr = kn.to_tensor(
            np.concatenate([ones, keys * np.conj(c)[None, :]], axis=1),
            dtype, dev)[:, :, None, None]
        H_t = kn.to_tensor(H, dtype, dev)

        def rhs(ados):
            padded = torch.cat([ados, ados.new_zeros((1, n, n))])
            out = -1j * (H_t @ ados - ados @ H_t)
            out = out - damp[:, None, None] * ados
            g = padded[all_idx]                       # (nado, 2M, n, n)
            out = out - 1j * (torch.einsum("kab, Nkbc -> Nac", Q2, wl * g)
                              - torch.einsum("Nkab, kbc -> Nac", wr * g, Q2))
            return out

        return rhs, nado

    def _rhs_matmul(self, dtype, keys, plus_idx, minus_idx, Q, c, damp):
        """Stacked-superoperator RHS (:func:`kernels.heom_rhs_dot`) on the
        gathered, occupation-weighted neighbour stack."""
        nado = keys.shape[0]
        n = self.n
        V = n * n
        dev = self.device
        B0, Bk = kn.heom_superop_split(self._H_np, Q, c)
        B0 = kn.to_tensor(B0, dtype, dev)
        Bk = kn.to_tensor(Bk, dtype, dev)
        all_idx = torch.as_tensor(
            np.concatenate([plus_idx, minus_idx], axis=1), dtype=torch.long,
            device=dev)
        wocc = kn.to_tensor(
            np.concatenate([np.ones_like(keys), keys], axis=1), dtype,
            dev)[:, :, None]

        def rhs(ados):
            flat = ados.reshape(nado, V)
            padded = torch.cat([flat, flat.new_zeros((1, V))])
            g = padded[all_idx] * wocc                 # (nado, 2M, V)
            return kn.heom_rhs_dot(B0, Bk, damp, flat, g).reshape(nado, n, n)

        return rhs

    # ------------------------------------------------------------ run
    def run(self, rho0, dt, nt, e_ops=None, nout=1, method="rk4",
            store_ados=False, mesh=None, kernel=None, checkpoint=None,
            resume=None, edip=None, pulse=None) -> Result:
        """Propagate the hierarchy for ``nt`` steps of ``dt`` from
        ``rho0`` in the root ADO, recording ``e_ops`` and the root ADO (or
        every ADO, ``store_ados=True``) after each window of ``nout``
        steps. ``method`` is 'rk4' or 'euler'. Driven, sharded and
        checkpointed runs are not yet ported and raise."""
        for name, val in (("mesh", mesh), ("checkpoint", checkpoint),
                          ("resume", resume), ("edip", edip),
                          ("pulse", pulse)):
            if val is not None:
                raise not_yet_ported(f"HEOMSolver.run({name}=...)")
        if e_ops is None:
            e_ops = self.e_ops or []
        dev = self.device
        rho0 = (rho0.to(dev) if isinstance(rho0, torch.Tensor)
                else torch.as_tensor(np.asarray(rho0), device=dev))
        dtype = complex_dtype_for(rho0, self.H)
        rhs, nado = self.rhs_fn(dtype, kernel=kernel)
        n = self.n

        if method == "rk4":
            def step(y):
                k1 = rhs(y)
                k2 = rhs(y + k1 * (dt / 2))
                k3 = rhs(y + k2 * (dt / 2))
                k4 = rhs(y + k3 * dt)
                return y + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        elif method == "euler":
            def step(y):
                return y + dt * rhs(y)
        else:
            raise ValueError(method)

        eops = (torch.stack([torch.as_tensor(_numpy(e)).to(dev, dtype)
                             for e in e_ops]) if e_ops else None)

        def obs_of(ados):
            # tr(E rho) = sum_ij E_ij rho_ji
            return torch.einsum("kij, ji -> k", eops, ados[0])

        nwin = nt // nout
        ados0 = torch.zeros((nado, n, n), dtype=dtype, device=dev)
        ados0[0] = rho0.to(dtype)
        state_shape = (nado, n, n) if store_ados else (n, n)
        states = torch.empty((nwin + 1,) + state_shape, dtype=dtype,
                             device=dev)
        states[0] = ados0 if store_ados else ados0[0]
        obs = (torch.empty((nwin + 1, len(e_ops)), dtype=dtype, device=dev)
               if e_ops else None)
        if obs is not None:
            obs[0] = obs_of(ados0)

        y = ados0
        for w in range(1, nwin + 1):
            for _ in range(nout):
                y = step(y)
            states[w] = y if store_ados else y[0]
            if obs is not None:
                obs[w] = obs_of(y)

        times = (torch.arange(nwin + 1, dtype=torch.float64, device=dev)
                 * dt * nout)
        return Result(times=times, observables=obs, states=states,
                      rho0=rho0, rho=y[0], ado=y, dt=dt, nt=nt, nout=nout)

    # ------------------------------------------- not yet ported (raise)
    def correlation_3op_1t(self, *args, **kwargs):
        raise not_yet_ported("HEOMSolver.correlation_3op_1t")

    def correlation_2op_1t(self, *args, **kwargs):
        raise not_yet_ported("HEOMSolver.correlation_2op_1t")

    def correlation_3op_2t(self, *args, **kwargs):
        raise not_yet_ported("HEOMSolver.correlation_3op_2t")

    def liouvillian_dense(self, *args, **kwargs):
        raise not_yet_ported("HEOMSolver.liouvillian_dense")

    def steady_state(self, *args, **kwargs):
        raise not_yet_ported("HEOMSolver.steady_state")

    def propagator(self, *args, **kwargs):
        raise not_yet_ported("HEOMSolver.propagator")

    def absorption(self, *args, **kwargs):
        raise not_yet_ported("HEOMSolver.absorption")


class HEOMSolverDrude(HEOMSolver):
    """High-temperature Drude HEOM with the pyqed reference's signature
    (``pyqed_tpu.open.heom.HEOMSolverDrude``): not yet ported."""

    def __init__(self, *args, **kwargs):
        raise not_yet_ported("HEOMSolverDrude")


def solver_from_reference(H, modes, lmax, *, device, kernel=None):
    """A port solver on the same operators as a JAX ``HEOMSolver``: its
    host Hamiltonian (``_H_np``), its flattened ``_modes`` list of
    (Q, c, nu) and its ``lmax``."""
    return HEOMSolver(np.asarray(H),
                      bath=[(np.asarray(Q), c, nu) for Q, c, nu in modes],
                      lmax=lmax, kernel=kernel, device=device)
