"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``pyqed_tpu_torch/build/`` and loaded with :mod:`ctypes`; nothing
is built when a module is imported. The library's file name carries a
hash of the source, of the headers it includes from its directory and of
the flags (:func:`source_digest`), so an edited source or header is
rebuilt and an unchanged one is reused. ``nvcc`` is looked up in ``$CUDA_HOME/bin``,
then on ``PATH``, then in ``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SPO = (_P, _P, _P, _L, _I, _L, _L, _P)
# exported C functions of each source: name -> argtypes (restype is int,
# the cudaError_t of the launch)
SIGNATURES = {
    "heom_coupling": {
        "heom_coupling_c128": (_P,) * 5,
        "heom_coupling_c64": (_P,) * 5,
        "heom_coupling_batched_c128": (_P,) * 5,
        "heom_coupling_batched_c64": (_P,) * 5,
    },
    "spo": {
        "spo_phase_c128": _SPO,
        "spo_phase_c64": _SPO,
        "spo_potential_c128": _SPO,
        "spo_potential_c64": _SPO,
    },
    "liouvillian": {
        "liouvillian_commutator_c128": (_P, _P, _P, _I, _P),
        "liouvillian_commutator_c64": (_P, _P, _P, _I, _P),
    },
}


class CouplingPlanArgs(ctypes.Structure):
    """``PlanArgs`` of ``csrc/heom_coupling.cu``, field for field."""
    _fields_ = [("w", _P), ("plan", _P), ("partial", _P), ("nd", _I),
                ("ntiles", _I), ("nedges", _I), ("V", _I), ("B", _I)]


class CouplingBatchArgs(ctypes.Structure):
    """``BatchArgs`` of ``csrc/heom_coupling.cu``, field for field."""
    _fields_ = [("nbr", _P), ("w", _P), ("nd", _I), ("nj", _I), ("V", _I),
                ("B", _I)]


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    log: str           # nvcc's output, including the -Xptxas -v report
    seconds: float     # compile time; 0.0 when a cached build was loaded


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels of pyqed_tpu_torch "
                       "are compiled at first use and need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(src: Path) -> list[Path]:
    """The files that ``src`` includes with ``#include "..."`` from beside
    it, and theirs in turn, each once, in the order first met."""
    found, todo = [], [src]
    while todo:
        cur = todo.pop(0)
        for name in _INCLUDE.findall(cur.read_bytes()):
            path = cur.parent / name.decode()
            if path.is_file() and path not in found:
                found.append(path)
                todo.append(path)
    return found


def source_digest(src: Path, flags=NVCC_FLAGS) -> str:
    """Hash of a source, the local headers it includes and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for path in local_includes(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if needed and load it (once per process)."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(src)
    so = BUILD / f"lib{name}-{digest}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.is_file():
        nvcc = nvcc_path()
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            seconds = time.perf_counter() - t0
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)       # atomic: concurrent builders agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    log = log_path.read_text() if log_path.is_file() else ""
    return Built(lib=lib, path=so, log=log, seconds=seconds)
