"""Local diabatic representation (LDR): exact nonadiabatic dynamics on a
DVR grid (PyTorch).

PyTorch counterpart of ``pyqed_tpu/grid/ldr.py`` (reference:
pyqed/ldr/ldr.py — ``LDRN:320`` (``buildK:420``, ``buildV:463``,
``short_time_propagator:525``, ``run:579``), ``LDR2:1111``,
``LDR2_Jacobi:1779``, ``build_ovlp:1479``; pyqed/ldr/nonherm.py:156).

Adiabatic surfaces V_a(R) on a direct-product DVR grid and the electronic
overlap A[m a, n b] = <phi_a(R_m)|phi_b(R_n)> = (S S†)[m a, n b] give the
short-time propagator

    U = e^{-i V dt/2} [ A ⊙ (⊗_d e^{-i T_d dt}) ] e^{-i V dt/2}.

Three ways to apply it, as in the JAX package:

- ``method='dense'``: the (ntot·ns)² matrix A ⊙ ⊗expK is built once and
  each step is one complex128 matrix-vector product (cuBLAS ZGEMV) and a
  phase. ``short_time_propagator_blocked`` builds the same matrix row
  block by row block into one preallocated tensor, never forming A;
- ``method='factored'`` (``'auto'`` when the electronic states are
  known): A = S S† is applied through its factor, nbasis scalar fields
  through per-dimension kinetic products, so the dense matrix never
  exists (the only way at 127×127 grids);
- diabatic dynamics (no states): the separable per-dimension products.

The step loop is a Python loop over windows of ``nout`` steps that never
reads the device; states are written into one preallocated tensor per
window and carry the trailing half-step potential phase, as in the JAX
package. The JAX package's TPU workarounds are not carried over:
``precision=`` is accepted and changes nothing (complex128 products on
the card are exact FP64, and TF32 stays off), the blocked build is a
plain loop instead of a ``lax.scan``, and ``make_split_stepper`` keeps its
real-plane interface on top of the complex128 factored step.
"""
from __future__ import annotations

import dataclasses
import string
from typing import Any, Optional

import numpy as np
import torch

from ..config import complex_dtype_for, resolve_device
from ..core.diagnostics import load_checkpoint, save_checkpoint
from ..core.result import Result
from ..parallel.mesh import check_mesh
from .dvr import HermiteDVR, SineDVR
from .spo import _host, _tensor


def _on(a, device, dtype=None):
    """:func:`~pyqed_tpu_torch.grid.spo._tensor` (an array is copied),
    converted to ``dtype`` where given."""
    return _tensor(a, device).to(dtype=dtype)


@dataclasses.dataclass
class ResultLDR(Result):
    """Result with the grid spacings (``dx``) and, after
    :meth:`get_population`, the electronic populations."""
    dx: Any = None
    population: Optional[torch.Tensor] = None

    def get_population(self, fname=None):
        """Electronic populations (nt, nstates) of the stored snapshots
        (reference: pyqed/ldr/ldr.py:6727), one einsum over the stack."""
        psis = self.states
        dvol = float(np.prod(self.dx)) if self.dx is not None else 1.0
        p = torch.einsum("t...a, t...a -> ta", psis.conj(), psis).real * dvol
        self.population = p
        if fname is not None:
            np.savez(fname, p.cpu().numpy())
        return p


class LDRN:
    """N-dimensional, multi-state LDR propagator
    (reference: pyqed/ldr/ldr.py:320).

    ``device``: the card when None (raises without one), ``"cpu"`` on
    request; the grids, surfaces, overlap factor and propagators live
    there. ``precision`` is accepted for the JAX signature and changes
    nothing. ``mesh``: a :class:`~torch.distributed.device_mesh.DeviceMesh`
    that :meth:`run` shards the state's rows over (None: unsharded).
    """

    def __init__(self, domains, levels, ndim=None, nstates=2, x0=None,
                 mass=None, dvr_type="sine", mesh=None, precision=None,
                 device=None):
        self.device = resolve_device(device)
        self.precision = precision
        self.mesh = check_mesh(mesh)
        if ndim is None:
            ndim = len(domains)
        assert len(domains) == len(levels) == ndim
        self.domains = domains
        self.mass = mass if mass is not None else [1.0] * ndim
        self.ndim = ndim
        self.nstates = nstates

        dvrs = []
        if dvr_type in ("sine", "sinc"):
            for d in range(ndim):
                dvrs.append(SineDVR(*domains[d], 2 ** levels[d] - 1,
                                    mass=self.mass[d], device=self.device))
        elif dvr_type == "gauss_hermite":
            assert x0 is not None
            for d in range(ndim):
                dvrs.append(HermiteDVR(levels[d], x0=x0[d],
                                       mass=self.mass[d],
                                       device=self.device))
        else:
            raise ValueError(f"DVR {dvr_type} is not supported.")

        self.dvr = dvrs
        self.x = [np.asarray(dvr.x) for dvr in dvrs]
        self.dx = [float(x[1] - x[0]) for x in self.x]
        self.nx = [len(x) for x in self.x]
        self.ntot = int(np.prod(self.nx))

        self._apes = None
        self.A = self.wf_overlap = None
        self._S = None       # (ntot, nbasis, ns) overlap factor (A = S S†)
        self._S_bra = None   # distinct bra factor (non-Hermitian A = L R)
        self._diabatic = False
        self.exp_K = None
        self.H = None
        self._U = None       # flattened short-time propagator
        self._exp_T_flat = None
        self._blocked_dt = None

    # --------------------------------------------------------------- inputs
    @property
    def apes(self):
        return self._apes

    @apes.setter
    def apes(self, v):
        v = _on(v, self.device)
        assert tuple(v.shape) == (*self.nx, self.nstates), \
            f"APES shape {tuple(v.shape)} != {(*self.nx, self.nstates)}"
        self._apes = v
        # new surfaces invalidate any cached (blocked) propagator
        self._blocked_dt = None
        self._U = self._exp_T_flat = None

    @property
    def v(self):
        return self._apes

    @v.setter
    def v(self, value):
        self.apes = value

    def set_apes(self, v):
        self.apes = v
        return self

    def build_ovlp(self, states=None):
        """Electronic overlap from the local electronic eigenvectors
        ``states`` (grid_shape + (nbasis, nstates), expanded in a common
        diabatic basis): A[m a, n b] = Σ_c states[m, c, a]* states[n, c, b]
        (reference: pyqed/ldr/ldr.py:1479). ``states=None`` means the
        identity overlap (diabatic dynamics), which is never materialised:
        run() then takes the separable path. Clears the cached
        propagator."""
        ns = self.nstates
        self._blocked_dt = None
        self._U = self._exp_T_flat = None
        if states is None:
            self.A = self._S = self._S_bra = None
            self._diabatic = True
            return None
        states = _on(states, self.device)
        S = states.reshape(self.ntot, states.shape[-2], ns)
        self._S = S
        self._S_bra = None    # Hermitian: bra = conj(ket)
        A = torch.einsum("mca, ncb -> manb", S.conj(), S)
        self.A = A.reshape(*self.nx, ns, *self.nx, ns)
        self._diabatic = False
        return self.A

    # ---------------------------------------------------------------- build
    def buildK(self, dt):
        """Per-dimension exact kinetic propagators
        (reference: pyqed/ldr/ldr.py:420)."""
        self.exp_K = [dvr.expT(dt) for dvr in self.dvr]
        self.K = [dvr.t() for dvr in self.dvr]
        return self.exp_K

    def buildV(self, dt):
        """(reference: pyqed/ldr/ldr.py:463)."""
        self.exp_V = torch.exp(-1j * dt * self._apes)
        self.exp_V_half = torch.exp(-1j * dt / 2 * self._apes)

    def gen_einsum_string(self, D):
        """'ab..x, ab..x kl..y, kl..y -> ab..x kl..y'
        (reference: pyqed/ldr/ldr.py:497)."""
        abc = string.ascii_lowercase
        s1 = abc[:D] + "x"
        s3 = abc[D:2 * D] + "y"
        s2 = s1 + s3
        return f"{s1}, {s2}, {s3} -> {s2}"

    def _cdtype(self):
        return complex_dtype_for(self._apes)

    def _factored_kernel(self, expKs, cdtype, S=None):
        """kin(p) applying (A ⊙ ⊗expK) through the overlap factor
        A = bra · S: the electronic index is contracted into nbasis scalar
        fields, each is kinetic-propagated by per-dimension products, then
        contracted back. ``p`` is (n,) or (n, B). ``S`` overrides the
        stored factor (its bra is then conj(S))."""
        if S is None:
            S, bra = self._S, self._S_bra
        else:
            bra = None
        Sf = _on(S, self.device, cdtype)
        Sfc = (Sf.conj() if bra is None else _on(bra, self.device, cdtype))
        SfcT = Sfc.transpose(1, 2).resolve_conj()      # (m, a, c)
        nx, D = tuple(self.nx), self.ndim
        ns, ntot = self.nstates, self.ntot
        nb = Sf.shape[1]

        def kin(p):
            vec = p.dim() == 1
            p2 = p[:, None] if vec else p
            B = p2.shape[1]
            phi = torch.bmm(Sf, p2.reshape(ntot, ns, B))     # (n, nb, B)
            phi = phi.reshape(nx + (nb * B,))
            for d in range(D):
                phi = torch.movedim(
                    torch.tensordot(expKs[d], phi, dims=([1], [d])), 0, d)
            out = torch.bmm(SfcT, phi.reshape(ntot, nb, B))
            out = out.reshape(ntot * ns, B)
            return out[:, 0] if vec else out

        return kin

    def _kin_sep(self, expKs):
        """kin(p): the separable (diabatic) per-dimension products."""
        nx, D, ns = tuple(self.nx), self.ndim, self.nstates

        def kin(p):
            p = p.reshape(nx + (ns,))
            for d in range(D):
                p = torch.movedim(
                    torch.tensordot(expKs[d], p, dims=([1], [d])), 0, d)
            return p.reshape(-1)

        return kin

    def short_time_propagator(self, dt):
        """U = expV_half (A ⊙ ⊗ expK) expV_half, flattened to a matrix
        (reference: pyqed/ldr/ldr.py:525); ``_exp_T_flat`` keeps
        A ⊙ ⊗ expK. A blocked build is returned from its cache for the
        same ``dt`` and rebuilt through the blocked path, with the states
        it retained, for another. Returns None for diabatic dynamics."""
        if self._U is not None and self._blocked_dt is not None:
            if complex(dt) == self._blocked_dt:
                return self._U
            return self.short_time_propagator_blocked(
                dt, self._blocked_states, block=self._blocked_block)
        if self._apes is None:
            raise ValueError("APES not provided. Set self.apes = ...")
        self.buildV(dt)
        self.buildK(dt)
        if self.A is None and not self._diabatic:
            self.build_ovlp()
        if self.A is None:
            self._U = self._exp_T_flat = None
            return None
        ns, ntot = self.nstates, self.ntot
        n = ntot * ns
        K2 = self.exp_K[0]
        for k in self.exp_K[1:]:
            K2 = torch.kron(K2, k)                     # (ntot, ntot)
        expT4 = self.A.reshape(ntot, ns, ntot, ns) * K2[:, None, :, None]
        vh = self.exp_V_half.reshape(ntot, ns)
        U4 = vh[:, :, None, None] * expT4
        U4.mul_(vh[None, None, :, :])
        self._U = U4.reshape(n, n)
        self._exp_T_flat = expT4.reshape(n, n)
        return self._U

    def short_time_propagator_blocked(self, dt, states, block=None):
        """The propagator of :meth:`short_time_propagator` (and
        ``_exp_T_flat``) built ``block`` grid points of rows at a time into
        one preallocated (n, n) tensor: each block multiplies a (block,
        nbasis, ns) slice of ``states`` against all of them, forms the
        matching rows of the kron kinetic factor from the digits of the
        row index, and is written in place, so the overlap A is never
        materialised on its own (peak memory: the two (n, n) results).

        states: grid_shape + (nbasis, nstates), as for :meth:`build_ovlp`.
        block: must divide ntot (default ``nx[-1]``, which always does).
        The result is cached for ``dt`` (see :meth:`short_time_propagator`)
        and the factor is exposed to run()'s factored path."""
        if states is None:
            raise ValueError("blocked build needs electronic states; "
                             "diabatic dynamics uses the separable path")
        if self._apes is None:
            raise ValueError("APES not provided. Set self.apes = ...")
        self.buildV(dt)
        self.buildK(dt)
        ns, ntot, D = self.nstates, self.ntot, self.ndim
        n = ntot * ns
        if block is None:
            block = self.nx[-1]
        if ntot % block:
            raise ValueError(f"block {block} must divide ntot {ntot}")
        dev = self.device
        states = _on(states, dev)
        S = states.reshape(ntot, states.shape[-2], ns)
        cdtype = complex_dtype_for(self._apes, S)
        expKs = [k.to(cdtype) for k in self.exp_K]
        strides = [int(np.prod(self.nx[d + 1:])) for d in range(D)]
        Sc = S.conj().to(cdtype)
        Sd = S.to(cdtype)
        self._U = self._exp_T_flat = None
        T = torch.empty((n, n), dtype=cdtype, device=dev)
        rows_idx = torch.arange(ntot, device=dev)
        for m0 in range(0, ntot, block):
            m = rows_idx[m0:m0 + block]
            rows = torch.ones((block, 1), dtype=cdtype, device=dev)
            for d in range(D):
                Kd = expKs[d][(m // strides[d]) % self.nx[d]]
                rows = (rows[:, :, None] * Kd[:, None, :]).reshape(block, -1)
            # A rows on the fly: A[b a, n β] = Σ_c S*[b,c,a] S[n,c,β]
            Ab = torch.einsum("bca, ncd -> band", Sc[m0:m0 + block], Sd)
            T[m0 * ns:(m0 + block) * ns] = (
                Ab * rows[:, None, :, None]).reshape(block * ns, n)
        vf = self.exp_V_half.reshape(n).to(cdtype)
        self._exp_T_flat = T
        U = T * vf[:, None]
        U.mul_(vf[None, :])
        self._U = U
        self._blocked_dt = complex(dt)
        self._blocked_states = S
        self._blocked_block = block
        self._S = S
        self._S_bra = None
        self._diabatic = False
        return self._U

    def buildH(self, dense=True):
        """LDR Hamiltonian H = diag(APES) + A ⊙ (Σ_d T_d), (n, n) on the
        device (reference: pyqed/ldr/ldr.py:552)."""
        if self.A is None and not self._diabatic:
            self.build_ovlp()
        if self.exp_K is None:
            self.K = [dvr.t() for dvr in self.dvr]
        dev = self.device
        Ksum = 0.0
        for d in range(self.ndim):
            M = None
            for dd in range(self.ndim):
                f = (self.K[d] if dd == d else torch.eye(
                    self.nx[dd], dtype=torch.float64, device=dev))
                M = f if M is None else torch.kron(M, f)
            Ksum = Ksum + M
        ns, ntot = self.nstates, self.ntot
        n = ntot * ns
        if self.A is None:
            H = torch.kron(Ksum, torch.eye(ns, dtype=Ksum.dtype, device=dev))
        else:
            H = (Ksum.to(self.A.dtype)[:, None, :, None]
                 * self.A.reshape(ntot, ns, ntot, ns)).reshape(n, n)
        v = self._apes.reshape(-1)
        H = H.to(torch.promote_types(H.dtype, v.dtype))
        H = H + torch.diag(v.to(H.dtype))
        self.H = H
        return H

    # ------------------------------------------------------------------ run
    def run(self, psi0, dt, nt, nout=1, t0=0.0, mesh=None, method="auto",
            checkpoint=None, checkpoint_every=10, resume=None) -> ResultLDR:
        """Propagate ``psi0`` (grid_shape + (nstates,)) for ``nt`` steps of
        ``dt``, storing the state after each window of ``nout`` steps
        (reference hot loop: pyqed/ldr/ldr.py:611-618).

        method: ``'factored'`` (``'auto'`` when electronic states are
        known: A applied through its factor, no dense matrix) or
        ``'dense'`` (one (n, n) matrix-vector product per step). Diabatic
        dynamics always takes the separable path. Stored states carry the
        trailing half-step potential phase, as in the JAX package.
        ``checkpoint=`` (a path) saves the state every
        ``checkpoint_every`` windows and at the end in the JAX package's
        npz format; ``resume=`` continues from such a file.

        ``mesh`` (or the solver's): the rows of the state vector (ntot·ns,
        grid-major) are cut over the mesh's first axis, in chunks of
        ceil(n / d). Dense: each rank holds its rows of ψ and of U, and a
        step is one all-gather of ψ and a local ZGEMV. Factored and
        separable: a step gathers ψ and applies the kinetic factor to the
        whole vector, keeping the rank's rows (they shard the state and
        the potential phases, not the kinetic work). The states are
        gathered at the output windows; every rank returns the whole
        result, and rank 0 writes the checkpoints."""
        mesh = self.mesh if mesh is None else check_mesh(mesh)
        if method not in ("auto", "dense", "factored"):
            raise ValueError(f"method {method!r}")
        psi0 = _on(psi0, self.device)
        assert tuple(psi0.shape) == (*self.nx, self.nstates)
        use_fact = self._S is not None and method in ("auto", "factored")
        if method == "factored" and self._S is None and not self._diabatic:
            raise ValueError("method='factored' needs build_ovlp(states) "
                             "(or the blocked build) first")
        if use_fact:
            if self._apes is None:
                raise ValueError("APES not provided. Set self.apes = ...")
            self.buildV(dt)
            self.buildK(dt)
            U = None
        else:
            self.short_time_propagator(dt)
            U = self._exp_T_flat
        cdtype = self._cdtype()
        expV = self.exp_V.reshape(-1).to(cdtype)
        expV2 = self.exp_V_half.reshape(-1).to(cdtype)
        expKs = [k.to(cdtype) for k in self.exp_K]
        if use_fact:
            kin = self._factored_kernel(expKs, cdtype)
        elif U is not None:
            U = U.to(cdtype)

            def kin(p):
                return torch.mv(U, p)
        else:
            kin = self._kin_sep(expKs)

        psi = expV2 * psi0.to(cdtype).reshape(-1)
        nwin = nt // nout
        start = 0
        if resume is not None:
            start, (psi_r,), meta = load_checkpoint(resume)
            for key, val in (("dt", dt), ("nout", nout)):
                saved = meta.get(key)
                if saved is not None and abs(float(saved) - val) > 1e-15:
                    raise ValueError(
                        f"resume {key}={val} != checkpointed {key}={saved}")
            if start > nwin:
                raise ValueError(
                    f"checkpoint already at window {start} > "
                    f"requested nt//nout = {nwin}")
            psi = psi_r.to(self.device, cdtype)

        nrun = nwin - start
        states = torch.empty((nrun, psi.shape[0]), dtype=cdtype,
                             device=self.device)
        every = max(1, int(checkpoint_every))
        whole = lambda p: p                 # noqa: E731
        write = save_checkpoint
        if mesh is not None:
            from ..parallel.mesh import (axis_group, gather_rows, local_range,
                                         rank0_write)
            group, rank, d = axis_group(mesh)
            n = psi.shape[0]
            lo, hi, _ = local_range(n, rank, d)
            expV = expV[lo:hi]

            def whole(p):
                return gather_rows(p, group, d, n=n)

            if U is not None and not use_fact:
                U_own = U[lo:hi]

                def kin(p):
                    return torch.mv(U_own, p)
            else:
                kin_all = kin

                def kin(p):
                    return kin_all(p)[lo:hi]

            def step_fn(p):
                return expV * kin(whole(p))

            def write(*a, **k):
                rank0_write(group, lambda: save_checkpoint(*a, **k))

            psi = psi[lo:hi]
        else:
            def step_fn(p):
                return expV * kin(p)
        for i in range(nrun):
            for _ in range(nout):
                psi = step_fn(psi)
            states[i] = whole(psi)
            if checkpoint is not None and ((i + 1) % every == 0
                                           or i + 1 == nrun):
                write(checkpoint, start + i + 1, [states[i]], dt=dt,
                      nout=nout)
        psi = states[nrun - 1] if nrun else whole(psi)
        r = ResultLDR(dx=self.dx, dt=dt, nt=nt, nout=nout, psi0=psi0)
        r.times = t0 + (start + torch.arange(
            1, nrun + 1, dtype=torch.float64, device=self.device)) * dt * nout
        r.states = states.reshape(nrun, *self.nx, self.nstates)
        r.psi = psi.reshape(*self.nx, self.nstates)
        return r

    # ------------------------------------------------- real-split stepper
    def make_split_stepper(self, dt, nsteps, dtype=None, apes=None,
                           states=None):
        """``run(pr, pi) -> (pr, pi)``: ``nsteps`` factored steps of ``dt``
        on a state given as real and imaginary (n, B) planes (arrays or
        tensors), with the same half-step offset as :meth:`run`'s stored
        states. ``dtype`` (torch.float64 by default, or torch.float32) is
        the planes' type; the steps run in the matching complex type.
        ``apes``/``states`` override the stored surfaces and factor; a
        factor with a nonzero imaginary part raises (use run()). The
        factors are those of run(): ``dvr.expT(dt)`` and the potential
        phases, built on the device in complex128."""
        if dtype is None:
            dtype = torch.float64
        cdtype = (torch.complex128 if dtype == torch.float64
                  else torch.complex64)
        ns, ntot = self.nstates, self.ntot
        n = ntot * ns
        if apes is None and self._apes is None:
            raise ValueError("APES not provided: pass apes= or set "
                             "self.apes first")
        if states is None and self._S is None:
            raise ValueError("overlap factor not built: pass states= "
                             "or call build_ovlp(states) first")
        S_h = (_host(self._S) if states is None
               else np.reshape(_host(states), (ntot, -1, ns)))
        if np.iscomplexobj(S_h) and np.abs(S_h.imag).max() > 0:
            raise NotImplementedError("complex overlap factors need the "
                                      "run() complex path")
        S_h = np.asarray(S_h.real, dtype=np.float64)
        dev = self.device
        v = _on(self._apes if apes is None else apes, dev,
                torch.float64).reshape(n, 1)
        expV = torch.exp(-1j * dt * v).to(cdtype)
        expVh = torch.exp(-0.5j * dt * v).to(cdtype)
        expKs = [dvr.expT(dt).to(cdtype) for dvr in self.dvr]
        kin = self._factored_kernel(expKs, cdtype, S=S_h)

        def run(pr0, pi0):
            p = torch.complex(_on(pr0, dev, dtype), _on(pi0, dev, dtype))
            p = expVh * p
            for _ in range(nsteps):
                p = expV * kin(p)
            return p.real.contiguous(), p.imag.contiguous()

        return run

    # ------------------------------------------------------ imaginary time
    def run_imag(self, psi0, dt, nt, nout=1) -> ResultLDR:
        """Imaginary-time relaxation exp(-H dt) with renormalisation every
        step (reference: pyqed/ldr/ldr.py:1989 ``LDR2_IT``): the real-time
        machinery at dt -> -i dt. ``energies`` holds -log(norm)/dt after
        each window, ``e_tot`` the last, ``psi`` the relaxed state."""
        psi0 = _on(psi0, self.device)
        assert tuple(psi0.shape) == (*self.nx, self.nstates)
        tau = -1j * dt
        use_fact = self._S is not None
        if use_fact:
            self.buildV(tau)
            self.buildK(tau)
            U = None
        else:
            self.short_time_propagator(tau)
            U = self._exp_T_flat
        cdtype = self._cdtype()
        expV = self.exp_V.reshape(-1).to(cdtype)
        expV2 = self.exp_V_half.reshape(-1).to(cdtype)
        expKs = [k.to(cdtype) for k in self.exp_K]
        sq = float(np.sqrt(np.prod(self.dx)))
        if use_fact:
            kin = self._factored_kernel(expKs, cdtype)
        elif U is not None:
            U = U.to(cdtype)

            def kin(p):
                return torch.mv(U, p)
        else:
            kin = self._kin_sep(expKs)

        psi = psi0.to(torch.complex128).reshape(-1)
        psi = psi / (torch.linalg.vector_norm(psi) * sq)
        psi = expV2 * psi.to(cdtype)
        nwin = nt // nout
        nrms = torch.ones(nwin, dtype=torch.float64, device=self.device)
        for w in range(nwin):
            for _ in range(nout):
                p = expV * kin(psi)
                nrm = torch.linalg.vector_norm(p) * sq
                psi = p / nrm
            nrms[w] = nrm
        energies = -torch.log(nrms) / dt
        r = ResultLDR(dx=self.dx, dt=dt, nt=nt, nout=nout)
        r.times = torch.arange(1, nwin + 1, dtype=torch.float64,
                               device=self.device) * dt * nout
        r.energies = energies
        r.e_tot = float(energies[-1])
        psi = psi / (torch.linalg.vector_norm(psi) * sq)
        r.psi = psi.reshape(*self.nx, self.nstates)
        return r

    # -------------------------------------------- Liouville-von Neumann
    def run_lvn(self, rho0, dt, nt, nout=1) -> ResultLDR:
        """Density-matrix propagation rho -> U rho U† per step, rho over
        the flattened (grid × state) composite (reference:
        pyqed/ldr/ldr.py:678 ``LDR2_LvN``). ``rho`` is the final and
        ``states`` the per-window density matrices."""
        n = self.ntot * self.nstates
        rho0 = _on(rho0, self.device).to(torch.complex128).reshape(n, n)
        if self._S is not None:
            # U applied on both sides through the factor:
            # U rho U† = (U (U rho)†)†
            self.buildV(dt)
            self.buildK(dt)
            cdtype = self._cdtype()
            kin = self._factored_kernel(
                [k.to(cdtype) for k in self.exp_K], cdtype)
            expVc = self.exp_V.reshape(-1, 1).to(cdtype)

            def step(x):
                y = expVc * kin(x)
                return (expVc * kin(y.mH)).mH.resolve_conj()
        else:
            self.short_time_propagator(dt)
            if self._U is None:
                Kfull = self.exp_K[0]
                for Kd in self.exp_K[1:]:
                    Kfull = torch.kron(Kfull, Kd)
                P = torch.kron(Kfull, torch.eye(self.nstates,
                                                dtype=Kfull.dtype,
                                                device=self.device))
            else:
                P = self._exp_T_flat
            U = self.exp_V.reshape(-1, 1) * P
            Uh = U.mH

            def step(x):
                return U @ x @ Uh

        nwin = nt // nout
        rho = rho0.to(torch.promote_types(rho0.dtype, self.exp_V.dtype))
        rhos = torch.empty((nwin, n, n), dtype=rho.dtype, device=self.device)
        for w in range(nwin):
            for _ in range(nout):
                rho = step(rho)
            rhos[w] = rho
        r = ResultLDR(dx=self.dx, dt=dt, nt=nt, nout=nout)
        r.times = torch.arange(1, nwin + 1, dtype=torch.float64,
                               device=self.device) * dt * nout
        r.rho = rho
        r.states = rhos
        return r

    # ----------------------------------------------------------- observables
    def rdm_el(self, psi):
        """Electronic reduced density matrix (reference:
        pyqed/ldr/ldr.py:640)."""
        psi = _on(psi, self.device)
        return (torch.einsum("...a, ...b -> ab", psi.conj(), psi)
                * float(np.prod(self.dx)))

    def population(self, psi):
        return torch.diagonal(self.rdm_el(psi)).real

    def rdm_nuc(self, psi):
        """Nuclear reduced density matrix rho(x, x') = Σ_a psi*(x, a)
        psi(x', a) (reference: pyqed/ldr/ldr.py:15798), shape nx + nx;
        dense, for small grids."""
        flat = _on(psi, self.device).reshape(-1, self.nstates)
        rho = (flat.conj() @ flat.T) * float(np.prod(self.dx))
        return rho.reshape(tuple(self.nx) * 2)

    def heom(self, bath, coupling, lmax=3, **kwargs):
        """A :class:`~pyqed_tpu_torch.open.heom.HEOMSolver` of the full
        vibronic Hamiltonian (``buildH`` first) coupled to ``bath``
        (reference: pyqed/ldr/ldr.py:18916 ``LDRN.HEOM``). ``coupling``: an
        (n, n) operator on the flattened (grid × states) space, or
        ``'population'`` for the projector on diabatic state 1. The solver
        runs on this LDR's device unless ``device=`` is given. Its
        superoperators are (n², n²): memory grows as n⁴."""
        from ..open.heom import HEOMSolver
        if self.H is None:
            raise ValueError("call buildH() first")
        ngrid = int(np.prod(self.nx))
        H = self.H.reshape(ngrid * self.nstates, -1).to(torch.complex128)
        if isinstance(coupling, str) and coupling == "population":
            proj = torch.zeros((self.nstates, self.nstates),
                               dtype=torch.float64)
            proj[1, 1] = 1.0
            coupling = torch.kron(torch.eye(ngrid, dtype=torch.float64), proj)
        if hasattr(bath, "set_bath_ops") and getattr(bath, "bath_ops",
                                                     None) is None:
            bath.set_bath_ops([_host(coupling).astype(complex)])
        kwargs.setdefault("device", self.device)
        return HEOMSolver(H, bath=bath, lmax=lmax, **kwargs)

    HEOM = heom


class LDR2(LDRN):
    """2D specialization (reference: pyqed/ldr/ldr.py:1111)."""

    def __init__(self, domains=None, levels=None, nstates=2, mass=None,
                 dvr_type="sine", x=None, y=None, device=None):
        if domains is None and x is not None:
            dx, dy = x[1] - x[0], y[1] - y[0]
            domains = [(x[0] - dx, x[-1] + dx), (y[0] - dy, y[-1] + dy)]
            levels = [int(np.log2(len(x) + 1)), int(np.log2(len(y) + 1))]
        super().__init__(domains, levels, ndim=2, nstates=nstates, mass=mass,
                         dvr_type=dvr_type, device=device)


class LDR2Jacobi(LDRN):
    """2D LDR in Jacobi coordinates (r, theta): K = p_r^2/(2 mu)
    + p_theta^2/(2 I(r)), factorised e^{-iK dt} ~ e^{-iK_r dt}
    e^{-iK_theta dt} with an r-dependent rotor propagator
    (reference: pyqed/ldr/ldr.py:1779 ``LDR2_Jacobi``; buildK at :1870).
    ``mass = (mu, I)`` with I a callable of r."""

    def __init__(self, domains, levels, nstates=2, mass=None,
                 dvr_type="sine", device=None):
        mu, inertia = mass
        super().__init__(domains, levels, ndim=2, nstates=nstates,
                         mass=[mu, 1.0], dvr_type=dvr_type, device=device)
        self._inertia = inertia

    def buildK(self, dt):
        """(reference: ldr.py:1870) — the per-r rotor propagators from the
        sine-DVR FBR spectrum, one (nx, ny, ny) tensor."""
        dvr_x = self.dvr[0]
        expTx = dvr_x.expT(dt)
        nx, ny = self.nx
        Iinv = 1.0 / np.asarray(self._inertia(np.asarray(self.x[0])))
        dvr_y = SineDVR(*self.domains[1], ny, mass=1.0, device=self.device)
        U = dvr_y._fbr2dvr_host()
        n_fbr = np.arange(1, ny + 1)
        phases = np.exp(-1j * np.outer(Iinv, n_fbr ** 2)
                        * (np.pi ** 2 / dvr_y.L ** 2) * dt / 2.0)
        expTy = np.einsum("ia, xi, ib -> xab", U.conj(), phases, U)
        self.exp_K = [expTx, _on(expTy, self.device)]
        self.K = [dvr_x.t(), dvr_y.t()]
        return self.exp_K

    def short_time_propagator(self, dt):
        if self._apes is None:
            raise ValueError("APES not provided. Set self.apes = ...")
        self.buildV(dt)
        self.buildK(dt)
        if self.A is None and not self._diabatic:
            self.build_ovlp()
        if self.A is None:
            self._U = self._exp_T_flat = None
            return None
        # U_T[i j a, k l b] = A[ija, klb] * expTx[i, k] * expTy[k, j, l]
        nx, ny = self.nx
        ns = self.nstates
        Tx, Ty = self.exp_K
        A6 = self.A.reshape(nx, ny, ns, nx, ny, ns)
        exp_T = (A6 * Tx[:, None, None, :, None, None]
                 * Ty.permute(1, 0, 2)[None, :, None, :, :, None])
        n = self.ntot * ns
        self._exp_T_flat = exp_T.reshape(n, n)
        self._U = self._exp_T_flat
        return self._U

    def _factored_kernel(self, expKs, cdtype, S=None):
        """The factored application with the r-batched rotor propagator
        expTy[k, j, l] (source r index k):
        tmp[k,j,c] = Σ_l expTy[k,j,l] phi[k,l,c];
        out[i,j,c] = Σ_k expTx[i,k] tmp[k,j,c]."""
        if S is None:
            S, bra = self._S, self._S_bra
        else:
            bra = None
        Sf = _on(S, self.device, cdtype)
        Sfc = (Sf.conj() if bra is None else _on(bra, self.device, cdtype))
        SfcT = Sfc.transpose(1, 2).resolve_conj()
        nx, ny = self.nx
        ns, ntot = self.nstates, self.ntot
        nb = Sf.shape[1]
        expTx = expKs[0].to(cdtype)
        expTy = expKs[1].to(cdtype)

        def kin(p):
            vec = p.dim() == 1
            p2 = p[:, None] if vec else p
            B = p2.shape[1]
            phi = torch.bmm(Sf, p2.reshape(ntot, ns, B))
            phi = phi.reshape(nx, ny, nb * B)
            tmp = torch.bmm(expTy, phi)                     # (k, j, c)
            out = torch.tensordot(expTx, tmp, dims=1)       # (i, j, c)
            res = torch.bmm(SfcT, out.reshape(ntot, nb, B))
            res = res.reshape(ntot * ns, B)
            return res[:, 0] if vec else res

        return kin

    def make_split_stepper(self, dt, nsteps, dtype=None, apes=None,
                           states=None):
        """Not available in Jacobi coordinates: the rotor propagator
        depends on r, which the per-dimension factors cannot hold
        (use run())."""
        raise NotImplementedError(
            "LDR2Jacobi.make_split_stepper: the r-dependent rotor "
            "propagator has no per-dimension factor; use run()")

    def run(self, psi0, dt, nt, nout=1, t0=0.0, mesh=None,
            method="auto") -> ResultLDR:
        """Nonadiabatic (A set): :meth:`LDRN.run` with the Jacobi factored
        kernel (or ``method='dense'``); diabatic: the factorised kinetic
        applied directly."""
        if self.A is not None:
            return super().run(psi0, dt, nt, nout=nout, t0=t0, mesh=mesh,
                               method=method)
        mesh = self.mesh if mesh is None else check_mesh(mesh)
        psi0 = _on(psi0, self.device)
        assert tuple(psi0.shape) == (*self.nx, self.nstates)
        self.buildV(dt)
        self.buildK(dt)
        cdtype = self._cdtype()
        expV = self.exp_V.to(cdtype)
        Ux, Uy = (k.to(cdtype) for k in self.exp_K)
        nwin = nt // nout
        psi = psi0.to(cdtype) * self.exp_V_half.to(cdtype)
        states = torch.empty((nwin,) + tuple(psi.shape), dtype=cdtype,
                             device=self.device)
        whole = lambda p: p                 # noqa: E731
        if mesh is not None:
            # x rows over the mesh: the rotor factor is local to a row, the
            # radial one mixes rows after one all-gather of the rotated rows
            from ..parallel.mesh import axis_group, gather_rows, local_range
            group, rank, d = axis_group(mesh)
            nx = psi.shape[0]
            lo, hi, _ = local_range(nx, rank, d)
            expV, Ux, Uy, psi = expV[lo:hi], Ux[lo:hi], Uy[lo:hi], psi[lo:hi]

            def whole(p):
                return gather_rows(p, group, d, n=nx)
        for w in range(nwin):
            for _ in range(nout):
                q = whole(torch.bmm(Uy, psi))               # x: (a,b)(b,s)
                psi = expV * torch.tensordot(Ux, q, dims=1)
            states[w] = whole(psi)
        psi = states[nwin - 1] if nwin else whole(psi)
        r = ResultLDR(dx=self.dx, dt=dt, nt=nt, nout=nout, psi0=psi0)
        r.times = t0 + torch.arange(1, nwin + 1, dtype=torch.float64,
                                    device=self.device) * dt * nout
        r.states = states
        r.psi = psi
        return r


class NonHermLDRN(LDRN):
    """Non-Hermitian LDR: exact nonadiabatic dynamics on complex diabatic
    potential matrices (resonances, absorbing states; reference:
    pyqed/ldr/nonherm.py:156 ``NonHermitianLDR2``).

    The local diagonalisation is a biorthogonal eig on the host at build
    time; the overlap A[m a, n b] = <L_a(R_m)|R_b(R_n)> takes the left
    eigenvectors on the bra side, so A is not Hermitian, and the complex
    surfaces make the propagation non-unitary. The wavepacket is
    propagated in the adiabatic (right-eigenvector) representation;
    ``to_diabatic``/``from_diabatic`` convert."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.right_eigenstates = None
        self.left_eigenstates = None
        self._vdia = None

    def set_diabatic(self, v):
        """v: (*nx, ns, ns) complex diabatic potential matrix field."""
        import scipy.linalg
        v = _host(v)
        assert v.shape == (*self.nx, self.nstates, self.nstates)
        ns = self.nstates
        vflat = v.reshape(-1, ns, ns)
        w = np.empty((vflat.shape[0], ns), dtype=complex)
        ur = np.empty((vflat.shape[0], ns, ns), dtype=complex)
        ul = np.empty_like(ur)   # rows = left eigvecs, ul @ ur = 1
        for m, vm in enumerate(vflat):
            wm, um = scipy.linalg.eig(vm)
            idx = np.argsort(wm.real)
            w[m] = wm[idx]
            ur[m] = um[:, idx]
            ul[m] = scipy.linalg.inv(ur[m])
        dev = self.device
        self._apes = _on(w.reshape(*self.nx, ns), dev)
        self._blocked_dt = None
        self._U = self._exp_T_flat = None
        self.right_eigenstates = _on(ur.reshape(*self.nx, ns, ns), dev)
        self.left_eigenstates = _on(ul.reshape(*self.nx, ns, ns), dev)
        self._vdia = _on(v, dev)
        return self

    def build_ovlp(self, states=None):
        """A[m a, n b] = (L(R_m) R(R_n))[a, b] (reference:
        pyqed/ldr/nonherm.py:464)."""
        if self.right_eigenstates is None:
            raise ValueError("call set_diabatic(v) first")
        ns = self.nstates
        L = self.left_eigenstates.reshape(self.ntot, ns, ns)
        R = self.right_eigenstates.reshape(self.ntot, ns, ns)
        A = torch.einsum("mac, ncb -> manb", L, R)
        self.A = A.reshape(*self.nx, ns, *self.nx, ns)
        # factors of A = bra · ket: ket[n,c,b] = R[n,c,b],
        # bra[m,c,a] = L[m,a,c]
        self._S = R
        self._S_bra = L.transpose(1, 2)
        self._diabatic = False
        self._blocked_dt = None
        self._U = self._exp_T_flat = None
        return self.A

    # ------------------------------------------------------ representation
    def from_diabatic(self, psi_dia):
        """psi_adi[..., a] = L[..., a, c] psi_dia[..., c]."""
        return torch.einsum("...ac, ...c -> ...a", self.left_eigenstates,
                            _on(psi_dia, self.device).to(torch.complex128))

    def to_diabatic(self, psi_adi):
        """psi_dia[..., c] = R[..., c, a] psi_adi[..., a]."""
        return torch.einsum("...ca, ...a -> ...c", self.right_eigenstates,
                            _on(psi_adi, self.device).to(torch.complex128))

    def rdm_el(self, psi):
        """Electronic RDM in the diabatic frame."""
        dia = self.to_diabatic(psi)
        axes = list(range(self.ndim))
        return (torch.tensordot(dia.conj(), dia, dims=(axes, axes))
                * float(np.prod(self.dx)))

    def norm(self, psi):
        """Decaying norm of the diabatic-frame wavepacket."""
        return float(torch.trace(self.rdm_el(psi)).real)


NonHermitianLDR2 = NonHermLDRN   # reference drop-in name
LDR2_Jacobi = LDR2Jacobi         # reference drop-in name


def ldr_from_reference(domains, levels, *, nstates=2, mass=None,
                       dvr_type="sine", x0=None, apes=None, states=None,
                       device):
    """The port's :class:`LDRN` for the same grid, masses, surfaces and
    electronic states as a JAX ``LDRN`` built from these NumPy arrays
    (the JAX package is not imported): ``apes`` grid_shape + (nstates,),
    ``states`` grid_shape + (nbasis, nstates) or None (diabatic)."""
    sol = LDRN(domains, levels, nstates=nstates, mass=mass,
               dvr_type=dvr_type, x0=x0, device=device)
    if apes is not None:
        sol.apes = _host(apes)
    sol.build_ovlp(None if states is None else _host(states))
    return sol
