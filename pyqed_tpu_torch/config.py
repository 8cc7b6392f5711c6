"""dtype and device helpers for pyqed_tpu_torch.

PyTorch counterpart of ``pyqed_tpu/config.py``. torch runs complex128 on
both the CPU and CUDA, so there is no global precision switch: solvers
follow the dtype of their inputs. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

_DOUBLE = (torch.float64, torch.complex128)
_SINGLE = (torch.float32, torch.complex64, torch.float16, torch.bfloat16)


def _dtype_of(a):
    if isinstance(a, torch.Tensor):
        return a.dtype
    if isinstance(a, (bool, int, float, complex)):
        return None                   # weakly typed, as in JAX
    dt = np.asarray(a).dtype
    if dt in (np.float64, np.complex128):
        return torch.float64
    if dt in (np.float32, np.complex64, np.float16):
        return torch.float32
    return None


def complex_dtype_for(*arrays) -> torch.dtype:
    """complex128 unless the given arrays are single precision: any
    double-precision input gives complex128, otherwise any
    single-precision input gives complex64 (``None`` entries and Python
    scalars do not count)."""
    dts = [_dtype_of(a) for a in arrays if a is not None]
    if any(d in _DOUBLE for d in dts):
        return torch.complex128
    if any(d in _SINGLE for d in dts):
        return torch.complex64
    return torch.complex128


def use_x64(enable: bool = True) -> None:
    """Accepted for the JAX package's surface and does nothing: torch
    runs float64 and complex128 on the CPU and CUDA alike, so precision
    follows the inputs (``enable=False`` does not switch to 32 bits)."""


def x64_enabled() -> bool:
    """Always True: float64/complex128 are always available in torch (the
    JAX package's switch, ``jax_enable_x64``, has no counterpart)."""
    return True


def default_real() -> torch.dtype:
    """The real dtype a constructor uses when none is given: float64, as
    the JAX package's ``default_real()`` under x64."""
    return torch.float64


def default_complex() -> torch.dtype:
    """The complex dtype a constructor uses when none is given:
    complex128, as the JAX package's ``default_complex()`` under x64."""
    return torch.complex128


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """float64 for complex128, float32 for complex64."""
    return torch.float64 if dtype == torch.complex128 else torch.float32


def numpy_dtype_of(dtype: torch.dtype):
    """The numpy dtype with the same layout as a torch complex dtype."""
    return np.complex128 if dtype == torch.complex128 else np.complex64


def not_yet_ported(what) -> NotImplementedError:
    """The error that a part of pyqed_tpu the port lacks raises."""
    return NotImplementedError(f"{what} is not yet ported to pyqed_tpu_torch")


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`, ``cuda`` (the card) when
    None. Asking for CUDA, explicitly or by default, without a usable card
    raises instead of falling back to the CPU; pass ``device="cpu"`` to
    run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is false")
    return dev
