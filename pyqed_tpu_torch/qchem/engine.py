"""ctypes bridge to the native C++ McMurchie-Davidson ERI engine.

The source, ``qchem/native/eri_engine.cpp``, is a copy of the JAX
package's (OpenMP over shell pairs, 8-fold symmetry). The port's
derivative ERIs come from its own ``qchem/native/eri_deriv.cpp``: the same
recursions and the same tensor as the engine's ``eri_deriv_native``, with
one Hermite Coulomb table per primitive quartet of each unique (8-fold)
quartet instead of one per ordered bra pair, axis and ket pair. At first use each is built with
``g++ -O3 -fopenmp -shared -fPIC`` into the git-ignored
``pyqed_tpu_torch/build/``, under a file name that carries a hash of the
source and the flags (as ``ops/_cuda_lib.py`` names its CUDA libraries),
so an edited source is rebuilt and nothing is written beside the source.

A failed build raises: there is no silent fallback to the Python
recursion of :mod:`.basis`, which runs only when a caller asks for it
with ``native=False``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "native" / "eri_engine.cpp"
DERIV_SRC = _HERE / "native" / "eri_deriv.cpp"
BUILD = _HERE.parent / "build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")


def library_path(src: Path = None, flags=None) -> Path:
    """Where the library built from ``src`` (default :data:`SRC`) with
    ``flags`` (default :data:`CXX_FLAGS`) lives."""
    src = SRC if src is None else Path(src)
    flags = CXX_FLAGS if flags is None else tuple(flags)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: Path = None, flags=None) -> Path:
    """Compile ``src`` (default :data:`SRC`) unless a library of the same
    hash exists; raise with the compiler's output when it fails."""
    src = SRC if src is None else Path(src)
    flags = CXX_FLAGS if flags is None else tuple(flags)
    so = library_path(src, flags)
    if so.is_file():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the ERI engine of "
                           "pyqed_tpu_torch.qchem is compiled at first use")
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *flags, str(src), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, so)           # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load(src, names):
    """Build ``src`` and declare its functions ``names``, each taking the
    packed basis (:func:`_pack`) and the output array."""
    handle = ctypes.CDLL(str(build(src)))
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for name in names:
        fn = getattr(handle, name)
        fn.restype = None
        fn.argtypes = [f64, i32, i32, f64, f64, ctypes.c_int, f64]
    return handle


@functools.lru_cache(maxsize=None)
def _lib():
    return _load(SRC, ("eri_tensor_native", "eri_deriv_native"))


@functools.lru_cache(maxsize=None)
def _deriv_lib():
    return _load(DERIV_SRC, ("eri_deriv_pairs_native",))


def _pack(bfs):
    nbf = len(bfs)
    centers = np.ascontiguousarray(
        np.array([g.center for g in bfs]), np.float64)
    lmn = np.ascontiguousarray(np.array([g.lmn for g in bfs]), np.int32)
    prim_off = np.zeros(nbf + 1, np.int32)
    exps, cn = [], []
    for k, g in enumerate(bfs):
        prim_off[k + 1] = prim_off[k] + len(g.exps)
        exps.append(np.asarray(g.exps, float))
        cn.append(np.asarray(g.coefs, float) * np.asarray(g.norms, float))
    return (centers, lmn, prim_off,
            np.ascontiguousarray(np.concatenate(exps), np.float64),
            np.ascontiguousarray(np.concatenate(cn), np.float64), nbf)


def eri_tensor_native(bfs):
    """Full (nao, nao, nao, nao) ERI tensor from the C++ engine."""
    centers, lmn, prim_off, exps, cn, nbf = _pack(bfs)
    out = np.zeros((nbf, nbf, nbf, nbf), np.float64)
    _lib().eri_tensor_native(centers, lmn, prim_off, exps, cn, nbf,
                             out.reshape(-1))
    return out


def eri_deriv_native(bfs):
    """d(ij|kl)/d(center_i)_x, derivative on the FIRST index:
    (3, nao, nao, nao, nao) from the C++ engine."""
    centers, lmn, prim_off, exps, cn, nbf = _pack(bfs)
    out = np.zeros((3, nbf, nbf, nbf, nbf), np.float64)
    _lib().eri_deriv_native(centers, lmn, prim_off, exps, cn, nbf,
                            out.reshape(-1))
    return out


def eri_deriv_pairs(bfs):
    """The tensor of :func:`eri_deriv_native`, (3, nao, nao, nao, nao),
    from ``native/eri_deriv.cpp``: one Hermite Coulomb table per primitive
    quartet of each unique (8-fold) quartet gives the derivatives on all
    four centres along all three axes."""
    centers, lmn, prim_off, exps, cn, nbf = _pack(bfs)
    out = np.empty((3, nbf, nbf, nbf, nbf), np.float64)
    _deriv_lib().eri_deriv_pairs_native(centers, lmn, prim_off, exps, cn,
                                        nbf, out.reshape(-1))
    return out


def available() -> bool:
    """True when the engine builds and loads (the error is not hidden
    from the integral functions, which raise it)."""
    try:
        _lib()
        _deriv_lib()
        return True
    except (RuntimeError, OSError):
        return False
