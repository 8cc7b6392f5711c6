"""Volumetric/cube file I/O.

PyTorch counterpart of ``pyqed_tpu/utils/io.py`` (reference:
pyqed/io/cube.py — ``write_cube:27``). Host NumPy and text: a tensor
given as ``data`` is read to the host first.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..units import au2angstrom

_BOHR = au2angstrom  # angstrom per bohr


def write_cube(file_obj, atoms: Sequence, cell, data=None, origin=None,
               comment=None):
    """Write a Gaussian cube file (reference: pyqed/io/cube.py:27).

    atoms: list of (Z or symbol, (x, y, z) in angstrom);
    cell: (3, 3) lattice vectors in angstrom spanning the data volume;
    data: (nx, ny, nz) volumetric array.
    """
    from ..qchem.basis import ATOMIC_NUMBER
    close = False
    if isinstance(file_obj, str):
        file_obj = open(file_obj, "w")
        close = True
    try:
        if data is None:
            data = np.ones((2, 2, 2))
        if hasattr(data, "detach"):
            data = data.detach().cpu().numpy()
        data = np.asarray(data)
        if np.iscomplexobj(data):
            data = np.abs(data)
        if comment is None:
            comment = "Cube file written by pyqed_tpu"
        file_obj.write(comment.strip())
        file_obj.write("\nOUTER LOOP: X, MIDDLE LOOP: Y, INNER LOOP: Z\n")
        origin = (np.zeros(3) if origin is None
                  else np.asarray(origin) / _BOHR)
        file_obj.write("{:5d}{:12.6f}{:12.6f}{:12.6f}\n".format(
            len(atoms), *origin))
        cell = np.asarray(cell, dtype=float)
        for i in range(3):
            n = data.shape[i]
            d = cell[i] / n / _BOHR
            file_obj.write("{:5d}{:12.6f}{:12.6f}{:12.6f}\n".format(n, *d))
        for (z, xyz) in atoms:
            Z = z if isinstance(z, int) else ATOMIC_NUMBER[z]
            x, y, zc = np.asarray(xyz) / _BOHR
            file_obj.write("{:5d}{:12.6f}{:12.6f}{:12.6f}{:12.6f}\n".format(
                Z, 0.0, x, y, zc))
        flat = data.reshape(-1)
        for i in range(0, len(flat), 6):
            file_obj.write(" ".join("{:13.5e}".format(v)
                                    for v in flat[i:i + 6]) + "\n")
    finally:
        if close:
            file_obj.close()


def read_cube(file_obj):
    """Read a cube file written by :func:`write_cube`.

    Returns (atoms [(Z, xyz angstrom)], cell, data, origin)."""
    close = False
    if isinstance(file_obj, str):
        file_obj = open(file_obj)
        close = True
    try:
        file_obj.readline()
        file_obj.readline()
        parts = file_obj.readline().split()
        natm = int(parts[0])
        origin = np.array([float(p) for p in parts[1:4]]) * _BOHR
        ns, cell = [], []
        for i in range(3):
            parts = file_obj.readline().split()
            n = int(parts[0])
            ns.append(n)
            cell.append(np.array([float(p) for p in parts[1:4]]) * n * _BOHR)
        atoms = []
        for _ in range(natm):
            parts = file_obj.readline().split()
            atoms.append((int(parts[0]),
                          np.array([float(p) for p in parts[2:5]]) * _BOHR))
        data = np.fromstring(" ".join(file_obj.read().split()), sep=" ")
        data = data.reshape(ns)
        return atoms, np.asarray(cell), data, origin
    finally:
        if close:
            file_obj.close()
