"""ctypes bridge to the native C++ walker engine (DMC and QSATS).

Counterpart of ``pyqed_tpu/qmc/engine.py``. The source,
``qmc/native/qmc_engine.cpp``, is a copy of the JAX package's; it is built
at first use with ``g++ -O3 -march=native -fopenmp -shared -fPIC`` into
the git-ignored ``pyqed_tpu_torch/build/`` (:mod:`pyqed_tpu_torch._native`),
never beside the source, and a failed build raises with the compiler's
output (the JAX package retries without OpenMP). The port never loads
the JAX package's library.

The functions keep the JAX package's signatures and return NumPy. With
the same flags and ``OMP_NUM_THREADS`` they return the same numbers as
the JAX package's engine: ``dmc_run`` seeds one generator per OpenMP
thread, so its result depends on the thread count.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from .. import _native

SRC = Path(__file__).resolve().parent / "native" / "qmc_engine.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

POTENTIALS = {"harmonic": 0, "morse": 1, "quartic": 2}


def library_path() -> Path:
    """Where the engine's library lives once built."""
    return _native.library_path(SRC, CXX_FLAGS)


def build(force=False) -> Path:
    """Compile the engine with g++ unless a library of the same hash
    exists (``force`` rebuilds it); raise when the compiler fails."""
    if force:
        library_path().unlink(missing_ok=True)
    return _native.build(SRC, CXX_FLAGS,
                         "the QMC engine of pyqed_tpu_torch.qmc")


@functools.lru_cache(maxsize=None)
def _lib():
    handle = ctypes.CDLL(str(build()))
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    handle.dmc_run.restype = ctypes.c_double
    handle.dmc_run.argtypes = [
        f64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_uint64, f64,
    ]
    handle.qsats_eloc.restype = None
    handle.qsats_eloc.argtypes = [
        f64, ctypes.c_int, ctypes.c_int, i32, f64, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, f64, f64,
    ]
    handle.qsats_vmc.restype = ctypes.c_double
    handle.qsats_vmc.argtypes = [
        f64, ctypes.c_int, i32, f64, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_uint64, f64,
    ]
    handle.engine_version.restype = ctypes.c_int
    handle.engine_version.argtypes = []
    return handle


def _stencil(ipairs, vpvec):
    ipairs = np.ascontiguousarray(ipairs, np.int32)
    vpvec = np.ascontiguousarray(vpvec, np.float64)
    if ipairs.ndim != 2 or ipairs.shape[1] != 2 or vpvec.shape != (
            ipairs.shape[0], 3):
        raise ValueError(f"ipairs (P, 2) and vpvec (P, 3) expected, got "
                         f"{ipairs.shape} and {vpvec.shape}")
    return ipairs, vpvec


def qsats_eloc_native(q, ipairs, vpvec, a, b, mass):
    """C++ local energies for configurations q (nw, natoms, 3).
    Returns (tloc, vloc) arrays (nw,) [hartree]."""
    lib = _lib()
    q = np.ascontiguousarray(q, np.float64)
    if q.ndim == 2:
        q = q[None]
    nw, natoms, _ = q.shape
    ipairs, vpvec = _stencil(ipairs, vpvec)
    if ipairs.size and ipairs.max() >= natoms:
        raise ValueError("ipairs index an atom beyond q's natoms")
    t = np.zeros(nw)
    v = np.zeros(nw)
    lib.qsats_eloc(q, nw, natoms, ipairs, vpvec, ipairs.shape[0],
                   a, b, mass, t, v)
    return t, v


def qsats_vmc_native(q0, ipairs, vpvec, a, b, mass, nsweeps=2000,
                     nequil=500, step=0.35, seed=1234):
    """C++ single-chain all-atom Metropolis VMC. Returns
    (energy per atom [K], e_trace, final config)."""
    lib = _lib()
    q = np.ascontiguousarray(q0, np.float64).copy()
    natoms = q.shape[0]
    ipairs, vpvec = _stencil(ipairs, vpvec)
    if ipairs.size and ipairs.max() >= natoms:
        raise ValueError("ipairs index an atom beyond q0's natoms")
    e_trace = np.zeros(nsweeps)
    E = lib.qsats_vmc(q.reshape(-1), natoms, ipairs, vpvec,
                      ipairs.shape[0], a, b, mass, nsweeps, nequil,
                      step, seed, e_trace)
    return E, e_trace, q


def dmc_native(potential="harmonic", ndim=1, nwalkers=4096, nsteps=2000,
               nequil=500, dt=0.01, mass=1.0, p0=0.0, p1=0.0, eref0=0.5,
               seed=12345, walkers0=None):
    """Run the C++ DMC engine. Returns (E, e_trace, final walkers)."""
    lib = _lib()
    pot_id = POTENTIALS[potential]
    if walkers0 is None:
        rng = np.random.default_rng(seed)
        walkers = rng.normal(size=(nwalkers, ndim)) * 0.5
    else:
        walkers = np.array(walkers0, dtype=np.float64, copy=True)
        nwalkers, ndim = walkers.shape
    walkers = np.ascontiguousarray(walkers, dtype=np.float64)
    e_trace = np.zeros(nsteps, dtype=np.float64)
    E = lib.dmc_run(walkers, nwalkers, ndim, nsteps, nequil, dt, mass,
                    pot_id, p0, p1, eref0, seed, e_trace)
    return E, e_trace, walkers
