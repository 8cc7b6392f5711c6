"""Distributed pencil / four-step FFT over a sharded grid axis.

Counterpart of ``pyqed_tpu/parallel/pencil_fft.py``. A rank holds its
slab of the grid, rows [r·n0/d, (r+1)·n0/d) of axis 0, and the transform
along that axis is done the classical distributed way, with explicit
``all_to_all_single`` transposes over the mesh axis' process group, so a
rank's memory and traffic stay O(N/d):

* **Pencil decomposition** (``fft_ndim >= 2``): FFT the local grid axes,
  transpose the slabs with one all-to-all so that axis 0 becomes local
  (axis 1 takes the sharding), FFT it, transpose back: two all-to-alls a
  forward transform.

* **Four-step / Bailey decomposition** (``fft_ndim == 1``): with
  N = d·m, view x as the (d, m) matrix A[n1, n2], rank p holding row p;
  transpose to columns (all-to-all), FFT the length-d axis, twiddle by
  exp(−2πi k1 n2 / N), transpose to rows (all-to-all), FFT the length-m
  axis, and block-transpose once more so each rank holds its contiguous
  chunk of the spectrum: three all-to-alls a forward transform.

The fused KEOs (:func:`make_keo_pencil`, :func:`make_keo_factors_pencil`)
apply the forward FFT, the k-space phase and the inverse FFT with the
phase in the transposed (N-D) or strided-k (1-D) layout, so the
re-transposes in between cancel: 2 all-to-alls a KEO application in N-D
and 4 in 1-D, as in the JAX package. The phase multiply of
:func:`make_keo_pencil` runs through the split-operator phase kernel
(``ops/kernels.py::spo_phase_multiply``, its plain version on the CPU) on
the rank's slab of expK.

Divisibility: the pencil needs ``n0 % d == 0`` and ``n1 % d == 0``
(N-D), the four-step ``n0 % d² == 0`` (1-D). Where the grid does not
divide, these functions raise with the shape: there is no gathering
fallback. They run at d = 1 too (their all-to-alls are then one-rank
calls), while :func:`pencil_supported` keeps the JAX package's answer,
False at d <= 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .mesh import all_to_all, axis_group

__all__ = ["pencil_supported", "fft_sharded", "ifft_sharded",
           "make_keo_pencil", "make_keo_factors_pencil"]


def pencil_supported(shape, ndev: int, fft_ndim: int) -> bool:
    """The JAX package's answer: can the pencil/four-step path run for
    this global grid shape on ``ndev`` devices (False at ndev <= 1)?"""
    if ndev <= 1 or shape[0] % ndev:
        return False
    if fft_ndim >= 2:
        return shape[1] % ndev == 0
    return (shape[0] // ndev) % ndev == 0


def _check_divides(shape, d, fft_ndim, what):
    """Raise where the global grid ``shape`` cannot run the pencil (N-D)
    or four-step (1-D) path on ``d`` ranks."""
    ok = shape[0] % d == 0 and (
        shape[1] % d == 0 if fft_ndim >= 2 else (shape[0] // d) % d == 0)
    if not ok:
        need = ("axis 0 and axis 1 divisible by d" if fft_ndim >= 2
                else "axis 0 divisible by d**2")
        raise ValueError(
            f"{what}: grid {tuple(shape)} does not divide over d = {d} "
            f"ranks (fft_ndim={fft_ndim} needs {need}); pad the grid or "
            "choose another mesh")


def _a2a(p, group, d, split, concat):
    """The JAX package's tiled all-to-all: cut local axis ``split`` into
    d chunks, send chunk j to rank j, and join the received chunks along
    ``concat`` in rank order (split, concat ∈ {0, 1})."""
    if split == 0 and concat == 0:
        return all_to_all(p.contiguous(), group)
    if split == 1 and concat == 0:
        s = p.shape
        x = p.reshape((s[0], d, s[1] // d) + s[2:]).movedim(1, 0)
        out = all_to_all(x.contiguous(), group)
        return out.reshape((d * s[0], s[1] // d) + s[2:])
    s = p.shape                                   # split 0, concat 1
    out = all_to_all(p.contiguous(), group)       # (d·m, n1/d, ...)
    out = out.reshape((d, s[0] // d) + s[1:]).movedim(0, 1)
    return out.reshape((s[0] // d, d * s[1]) + s[2:])


def _twiddle(d, m, rank, n0, sign, dtype, device):
    """exp(sign·2πi k1 n2 / n0) for k1 < d and this rank's n2 columns,
    (d, m/d)."""
    k1 = torch.arange(d, dtype=torch.float64, device=device)
    n2 = rank * (m // d) + torch.arange(m // d, dtype=torch.float64,
                                        device=device)
    return torch.exp((sign * 2j * math.pi / n0)
                     * (k1[:, None] * n2[None, :])).to(dtype)


def _four_step_fwd(p, group, d, rank, n0, reorder=True):
    """1-D four-step forward FFT along the sharded axis 0 of the local
    slab (m, *rest), m = n0/d. With ``reorder=False`` it stops in the
    strided-k layout (rank p holds X[p::d]), one all-to-all fewer."""
    m, rest = p.shape[0], tuple(p.shape[1:])
    ones = (1,) * len(rest)
    q = _a2a(p, group, d, 0, 0).reshape((d, m // d) + rest)
    q = torch.fft.fft(q, dim=0)
    q = q * _twiddle(d, m, rank, n0, -1, q.dtype, q.device).reshape(
        (d, m // d) + ones)
    q = _a2a(q.reshape((m,) + rest), group, d, 0, 0)
    q = torch.fft.fft(q, dim=0)
    if not reorder:
        return q
    q = _a2a(q, group, d, 0, 0).reshape((d, m // d) + rest)
    return q.movedim(0, 1).reshape((m,) + rest)


def _four_step_inv_from_strided(q, group, d, rank, n0):
    """From the strided-k layout back to the row layout, applying the
    inverse transform (1/N normalised)."""
    m, rest = q.shape[0], tuple(q.shape[1:])
    ones = (1,) * len(rest)
    q = torch.fft.ifft(q, dim=0)
    q = _a2a(q, group, d, 0, 0).reshape((d, m // d) + rest)
    q = q * _twiddle(d, m, rank, n0, +1, q.dtype, q.device).reshape(
        (d, m // d) + ones)
    q = torch.fft.ifft(q, dim=0)
    return _a2a(q.reshape((m,) + rest), group, d, 0, 0)


def _fwd_nd(p, group, d, fft_ndim):
    p = torch.fft.fftn(p, dim=tuple(range(1, fft_ndim)))
    p = _a2a(p, group, d, 1, 0)
    p = torch.fft.fft(p, dim=0)
    return _a2a(p, group, d, 0, 1)


def fft_sharded(x, mesh, axis_name=None, fft_ndim=1):
    """Distributed FFT over axes [0, fft_ndim) of the global array whose
    rows this rank holds: ``x`` is the local slab (n0/d, ...), and the
    result is the local slab of ``torch.fft.fftn`` over those axes
    (trailing axes ride along). All-to-alls only, never a gather; raises
    where the grid does not divide."""
    group, rank, d = axis_group(mesh, axis_name)
    shape = (x.shape[0] * d,) + tuple(x.shape[1:])
    _check_divides(shape, d, fft_ndim, "fft_sharded")
    if fft_ndim >= 2:
        return _fwd_nd(x, group, d, fft_ndim)
    return _four_step_fwd(x, group, d, rank, shape[0])


def ifft_sharded(x, mesh, axis_name=None, fft_ndim=1):
    """Inverse of :func:`fft_sharded` (1/N normalised), as
    conj(fft(conj(x))) / N with the same collectives."""
    d = axis_group(mesh, axis_name)[2]
    n = float(np.prod((x.shape[0] * d,) + tuple(x.shape[1:fft_ndim])))
    return torch.conj(fft_sharded(torch.conj(x).resolve_conj(), mesh,
                                  axis_name, fft_ndim)) / n


def make_keo_pencil(grid_shape, nstates, exp_K, mesh, axis_name=None,
                    kernel=True):
    """The fused sharded KEO psi -> IFFT(expK · FFT(psi)) on a rank's slab.

    ``exp_K`` is the k-space phase on the full grid (``grid_shape``), a
    complex tensor on the device the KEO runs on (the JAX package takes
    it as a (re, im) pair, a TPU workaround);
    psi is this rank's slab (n0/d,) + grid_shape[1:] + (nstates,). The
    rank keeps its slab of the phase in the layout it multiplies it in:
    the transposed one (N-D: all of axis 0, its n1/d columns of axis 1)
    or the strided-k one (1-D: k = rank, rank + d, ...). ``kernel``: the
    multiply runs through the phase kernel's wrapper
    (``spo_phase_multiply``), else as a broadcast product. Returns the
    callable; 2 all-to-alls an application in N-D, 4 in 1-D. Raises where
    the grid does not divide (at d = 1 it always does)."""
    from ..ops import kernels as kn
    group, rank, d = axis_group(mesh, axis_name)
    grid_shape = tuple(int(n) for n in grid_shape)
    fft_ndim = len(grid_shape)
    _check_divides(grid_shape + (nstates,), d, fft_ndim, "make_keo_pencil")
    n0 = grid_shape[0]
    K = torch.as_tensor(exp_K)
    if tuple(K.shape) != grid_shape:
        raise ValueError(f"make_keo_pencil: exp_K {tuple(K.shape)} is not "
                         f"the grid {grid_shape}")
    if fft_ndim >= 2:
        c = grid_shape[1] // d
        Kl = K[:, rank * c:(rank + 1) * c].contiguous()
    else:
        Kl = K[rank::d].contiguous()

    def phase(p):
        if kernel:
            return kn.spo_phase_multiply(Kl, p.contiguous())
        return p * Kl[..., None]

    if fft_ndim >= 2:
        inner = tuple(range(1, fft_ndim))

        def keo(p):
            p = torch.fft.fftn(p, dim=inner)
            p = _a2a(p, group, d, 1, 0)           # (n0, n1/d, ..., ns)
            p = torch.fft.fft(p, dim=0)
            p = phase(p)
            p = torch.fft.ifft(p, dim=0)
            p = _a2a(p, group, d, 0, 1)           # (n0/d, n1, ..., ns)
            # dense, states last, as the potential kernel takes it
            return torch.fft.ifftn(p, dim=inner).contiguous()
    else:
        def keo(p):
            q = _four_step_fwd(p, group, d, rank, n0, reorder=False)
            q = phase(q)
            return _four_step_inv_from_strided(q, group, d, rank, n0)

    return keo


def make_keo_factors_pencil(grid_shape, nstates, factors, mesh,
                            axis_name=None):
    """Fused sharded KEO for sequential per-axis FFT-diagonal factors, the
    Jacobi-coordinate SPO2/SPO3 kinetic propagators: each factor is
    psi -> ifft_axis(phase · fft_axis(psi)).

    ``factors``: ordered ``(axis, phase)``, the phase a complex tensor
    either of shape (grid_shape[axis],) or of the full
    ``grid_shape``. Axis-0 factors run as one all-to-all transpose pair
    each (axis 1 takes the sharding), and their phase must be axis-only;
    a full-rank phase of another axis is cut to the rank's rows. The
    multiplies are broadcast products, as in the unsharded solvers.
    Raises where the grid does not divide or a phase does not fit."""
    group, rank, d = axis_group(mesh, axis_name)
    grid_shape = tuple(int(n) for n in grid_shape)
    ndim = len(grid_shape)
    if ndim < 2:
        raise ValueError("make_keo_factors_pencil: needs a grid of 2 or more "
                         "axes (use make_keo_pencil in 1-D)")
    _check_divides(grid_shape, d, 2, "make_keo_factors_pencil")
    rows = grid_shape[0] // d
    plan = []
    for axis, ph in factors:
        ph = torch.as_tensor(ph)
        if ph.dim() == 1 and ph.shape[0] == grid_shape[axis]:
            shape = [1] * (ndim + 1)
            shape[axis] = ph.shape[0]
            ph = ph.reshape(shape)
        elif tuple(ph.shape) == grid_shape and axis != 0:
            ph = ph[rank * rows:(rank + 1) * rows][..., None]
        else:
            raise ValueError(
                f"make_keo_factors_pencil: phase {tuple(ph.shape)} of axis "
                f"{axis} is neither ({grid_shape[axis]},) nor the grid "
                f"{grid_shape}" + (" (an axis-0 phase must be axis-only)"
                                   if axis == 0 else ""))
        plan.append((axis, ph.contiguous()))

    def keo(p):
        for axis, ph in plan:
            if axis == 0:
                p = _a2a(p, group, d, 1, 0)
                p = torch.fft.ifft(torch.fft.fft(p, dim=0) * ph, dim=0)
                p = _a2a(p, group, d, 0, 1)
            else:
                p = torch.fft.ifft(torch.fft.fft(p, dim=axis) * ph, dim=axis)
        return p.contiguous()

    return keo
