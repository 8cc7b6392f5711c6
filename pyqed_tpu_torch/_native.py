"""Build route of the port's host C++ engines.

A source is compiled with ``g++`` at first use into the git-ignored
``pyqed_tpu_torch/build/``, under a file name that carries a hash of the
source and the flags (as ``ops/_cuda_lib.py`` names its CUDA libraries),
so an edited source is rebuilt and nothing is written beside the source.
With ``-march=native`` the hash also covers the host's CPU model, so a
library built for one machine is not loaded on another. A failed build
raises with the compiler's output: there is no silent retry with other
flags.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD = Path(__file__).resolve().parent / "build"


def _cpu_model() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"model name", b"flags")):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library_path(src, flags) -> Path:
    """Where the library built from ``src`` with ``flags`` lives."""
    src = Path(src)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_cpu_model())
    return BUILD / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(src, flags, what="a host engine of pyqed_tpu_torch") -> Path:
    """Compile ``src`` with ``g++ flags`` unless a library of the same hash
    exists; raise with the compiler's output when it fails."""
    src = Path(src)
    flags = tuple(flags)
    so = library_path(src, flags)
    if so.is_file():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {what} is compiled at first use")
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *flags, str(src), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, so)           # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so
