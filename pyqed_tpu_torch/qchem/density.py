"""Real-space (transition) charge and current densities on grids.

PyTorch counterpart of ``pyqed_tpu/qchem/density.py`` (reference:
pyqed/qchem/current_density.py — ``eval_rho_tcurdens:81``,
``eval_rho_tchgdens:88``, ``eval_nabla_ao:72``, ``CreateCube:62``,
``WriteCube:67``; there the AO values come from pyscf ``eval_gto``).
The AO values and gradients are evaluated on the device from the port's
own contracted-Cartesian-GTO basis (:func:`.dft.ao_values`,
:func:`.dft.ao_values_grad`), batched over grid points, and every
contraction runs there.

Given a (possibly complex) AO transition density matrix gamma:

    rho_T(r)  = sum_pq gamma_pq phi_p(r) phi_q(r)
    j_T(r)    = (1/2i) sum_pq gamma_pq [phi_p grad phi_q - (grad phi_p) phi_q]

(real gamma -> purely real rho_T and j_T = Im-part contraction).

The device of a call is that of the density matrix or coefficients when
they are tensors (the mean field's, so the molecule's), else ``device``
(the card when None).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .dft import ao_values, ao_values_grad


def _device(x, device):
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _on(x, dev, dtype=None):
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=dev)
    if dtype is not None:
        return t.to(dtype)
    return t if t.is_complex() else t.to(torch.float64)


def _pts(pts, dev):
    return torch.as_tensor(np.asarray(pts, dtype=float)
                           if not isinstance(pts, torch.Tensor) else pts,
                           dtype=torch.float64, device=dev)


def ao_gradients(bfs, pts, device=None):
    """Analytic gradient of contracted Cartesian GTOs on points:
    (P, nao, 3) on ``pts``' device (or ``device``). d/dx [x^l e^{-a r^2}]
    = l x^{l-1} e^{-a r^2} - 2 a x^{l+1} e^{-a r^2} per primitive."""
    return ao_values_grad(bfs, _pts(pts, _device(pts, device)))[1]


def charge_density(bfs, dm, pts, device=None):
    """rho(r) = sum_pq D_pq phi_p(r) phi_q(r) on points -> (P,)."""
    dev = _device(dm, device)
    g = _on(dm, dev)
    ao = ao_values(bfs, _pts(pts, dev)).to(g.dtype)
    return torch.einsum("pq, ip, iq -> i", g, ao, ao)


transition_charge_density = charge_density


def transition_current_density(bfs, tdm, pts, device=None):
    """j_T(r) = (1/2i) sum_pq gamma_pq [phi_p grad phi_q
    - (grad phi_p) phi_q] -> (P, 3), complex
    (reference: pyqed/qchem/current_density.py:81)."""
    dev = _device(tdm, device)
    ao, grad = ao_values_grad(bfs, _pts(pts, dev))
    g = _on(tdm, dev, torch.complex128)
    ao, grad = ao.to(g.dtype), grad.to(g.dtype)
    t1 = torch.einsum("pq, ip, iqx -> ix", g, ao, grad)
    t2 = torch.einsum("pq, ipx, iq -> ix", g, grad, ao)
    return (t1 - t2) / 2j


def current_density_wavefunction(bfs, coeff, pts, device=None):
    """Probability current of a (complex) one-electron orbital
    psi = sum_p c_p phi_p:  j = Im[psi* grad psi] -> (P, 3)."""
    dev = _device(coeff, device)
    ao, grad = ao_values_grad(bfs, _pts(pts, dev))
    c = _on(coeff, dev, torch.complex128)
    psi = ao.to(c.dtype) @ c
    dpsi = torch.einsum("ipx, p -> ix", grad.to(c.dtype), c)
    return torch.imag(torch.conj(psi)[:, None] * dpsi)


def cube_grid(atoms, nx=40, ny=40, nz=40, margin=4.0):
    """Uniform cube-file grid box around the molecule
    (reference: pyqed/qchem/current_density.py:62 ``CreateCube``).
    Returns (pts (P,3), origin, axes (3,3), shape) as NumPy."""
    coords = np.asarray([np.asarray(a[1], dtype=float) for a in atoms])
    lo = coords.min(axis=0) - margin
    hi = coords.max(axis=0) + margin
    xs = [np.linspace(lo[k], hi[k], n) for k, n in
          zip(range(3), (nx, ny, nz))]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    axes = np.diag([(hi[k] - lo[k]) / (n - 1)
                    for k, n in zip(range(3), (nx, ny, nz))])
    return pts, lo, axes, (nx, ny, nz)


def _write(fname, atoms, values, origin, axes, shape):
    from ..utils.io import write_cube
    from ..units import au2angstrom
    cell = axes * (np.asarray(shape) - 1)[:, None]
    # qchem coordinates are bohr; write_cube takes angstrom
    atoms_ang = [(a[0], np.asarray(a[1], dtype=float) * au2angstrom)
                 for a in atoms]
    with open(fname, "w") as f:
        write_cube(f, atoms_ang, cell * au2angstrom, data=values,
                   origin=origin * au2angstrom)


def write_density_cube(fname, atoms, bfs, dm, nx=40, ny=40, nz=40,
                       margin=4.0, device=None):
    """Evaluate rho on a cube grid (on the device) and write a Gaussian
    cube file (reference: pyqed/qchem/current_density.py:67
    ``WriteCube``). Returns rho (nx, ny, nz) as NumPy."""
    pts, origin, axes, shape = cube_grid(atoms, nx, ny, nz, margin)
    rho = charge_density(bfs, dm, pts, device).cpu().numpy().reshape(shape)
    _write(fname, atoms, rho, origin, axes, shape)
    return rho


def ao_on_grid(mol, pts):
    """AO values (P, nao) on arbitrary points, in the SAME basis as
    ``mol.intor()`` (contracts through the pure-spherical transform when
    ``mol.spherical``), computed on ``mol.device``; NumPy."""
    ao = ao_values(mol.bfs, _pts(pts, mol.device))
    C = getattr(mol, "csph", None)
    if C is not None:
        ao = ao @ torch.as_tensor(C, device=ao.device).T
    return ao.cpu().numpy()


def write_mo_cube(fname, mol, mo, nx=40, ny=40, nz=40, margin=4.0):
    """Write one molecular orbital phi(r) = sum_p mo[p] chi_p(r) as a
    Gaussian cube file (reference: pyqed/qchem/mol.py:1544 ``view_mo``,
    a pyscf-cubegen wrapper). mo: (nao,) MO coefficient column (e.g.
    ``mf.mo_coeff[:, i]``). Returns phi (nx, ny, nz) as NumPy."""
    pts, origin, axes, shape = cube_grid(mol.atoms, nx, ny, nz, margin)
    mo = mo.detach().cpu().numpy() if isinstance(mo, torch.Tensor) \
        else np.asarray(mo)
    phi = (ao_on_grid(mol, pts) @ mo).reshape(shape)
    _write(fname, mol.atoms, phi, origin, axes, shape)
    return phi
