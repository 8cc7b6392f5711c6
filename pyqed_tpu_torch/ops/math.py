"""Small math helpers (PyTorch).

Counterpart of ``pyqed_tpu/ops/math.py`` (reference: pyqed/phys.py —
``lorentzian:1084``, ``gaussian:1106``, ``coth:1181``, ``heaviside:1153``,
``fermi:1066``, ``sinc:806``, ``rect:603``, ``interval:606``,
``stepsize:610``, ``fftfreq:613``, ``morse:447``). The Gauss-Hermite
helpers of the JAX module live in its ``ops/quadrature.py`` and wait for
a caller in the port.

Elementwise functions take tensors and return tensors on the device of
their input; anything else is first made a CPU tensor of its NumPy
conversion (so Python floats and float64 arrays stay float64).
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x):
    """``x`` as a tensor: itself, or a CPU tensor of ``np.asarray(x)``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def lorentzian(x, width=1.0):
    """Normalized Lorentzian with HWHM ``width``
    (reference: pyqed/phys.py:1084)."""
    return 1.0 / np.pi * width / (width**2 + _t(x) ** 2)


def gaussian(x, sigma=1.0):
    """Normalized Gaussian (reference: pyqed/phys.py:1106)."""
    return (1.0 / sigma / np.sqrt(2.0 * np.pi)
            * torch.exp(-(_t(x) ** 2) / 2.0 / sigma**2))


def coth(x):
    return 1.0 / torch.tanh(_t(x))


def heaviside(x):
    """Step function with the value 0.5 at 0."""
    x = _t(x)
    return torch.heaviside(x, torch.full((), 0.5, dtype=x.dtype,
                                         device=x.device))


def fermi(E, Ef=0.0, T=1e-4):
    """Fermi-Dirac occupation (reference: pyqed/phys.py:1066)."""
    return 1.0 / (torch.exp((_t(E) - Ef) / T) + 1.0)


def sinc(x):
    """sin(x)/x (NOT the normalized sinc of torch and numpy;
    reference: pyqed/phys.py:806)."""
    return torch.sinc(_t(x) / np.pi)


def rect(x):
    """Rectangular window on [-1/2, 1/2] (reference: pyqed/phys.py:603)."""
    x = _t(x)
    return (x.abs() <= 0.5).to(torch.float64)


def interval(x):
    """Grid spacing of a uniform grid (reference: pyqed/phys.py:606)."""
    return x[1] - x[0]


stepsize = interval


def fftfreq(times):
    """Angular frequency grid conjugate to ``times``, ascending
    (reference: pyqed/phys.py:613); a float64 CPU tensor."""
    n = len(times)
    dt = float(times[1] - times[0])
    return torch.as_tensor(
        2.0 * np.pi * np.fft.fftshift(np.fft.fftfreq(n, d=dt)))


def morse(r, D, a, re):
    """Morse potential D(1-e^{-a(r-re)})^2 as a tensor
    (reference: pyqed/phys.py:447)."""
    return D * (1.0 - torch.exp(-a * (_t(r) - re))) ** 2


def pdf_normal(x, mu=0.0, sigma=1.0):
    return (1.0 / (sigma * np.sqrt(2 * np.pi))
            * torch.exp(-0.5 * ((_t(x) - mu) / sigma) ** 2))


def discretize(a=0.0, b=1.0, l=4, endpoints=True):
    """Dyadic discretization of [a, b] with 2^l points
    (reference: pyqed/phys.py:158); a float64 CPU tensor."""
    n = 2**l
    if endpoints:
        return torch.as_tensor(np.linspace(a, b, n))
    x, dx = np.linspace(a, b, n, endpoint=False, retstep=True)
    return torch.as_tensor(x + dx / 2)


def cartesian_product(arrays):
    """All coordinate tuples of a tensor-product grid, one row each, the
    last axis fastest (reference: pyqed/phys.py:129); float64."""
    axes = [_t(a).to(torch.float64) for a in arrays]
    grids = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grids, dim=-1).reshape(-1, len(axes))


def is_positive_def(A):
    """Whether the Cholesky factorization of A succeeds."""
    return bool(torch.linalg.cholesky_ex(_t(A)).info.eq(0).all())


def meshgrid(*args):
    """ij-indexed meshgrid (reference: pyqed/phys.py meshgrid — "fix the
    indexing of the Numpy meshgrid")."""
    return torch.meshgrid(*[_t(a) for a in args], indexing="ij")


def cartesian(*args):
    """Cartesian product as a list of lists (reference: pyqed/phys.py)."""
    ans = [[]]
    for arg in args:
        ans = [x + [y] for x in ans for y in arg]
    return ans


def logarithmic_discretize(n, base=2.0):
    """Logarithmic discretization points Lambda^-k, k = 0..n, of (0, 1]
    in descending order (reference: pyqed/phys.py; used by NRG)."""
    return float(base) ** (-torch.arange(n + 1, dtype=torch.float64))


def polar2cartesian(r, theta):
    """(r, theta) -> (x, y) (reference: pyqed/phys.py)."""
    r, theta = _t(r), _t(theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def cartesian2polar(x, y):
    """(x, y) -> (r, theta) (reference: pyqed/phys.py)."""
    x, y = _t(x), _t(y)
    return torch.sqrt(x ** 2 + y ** 2), torch.atan2(y, x)


def nlargest(a, n=1, with_index=False):
    """Largest n elements (optionally with indices), descending
    (reference: pyqed/phys.py — heapq there; one stable argsort here, so
    ties come out last index first, as in the JAX package)."""
    a = _t(a)
    idx = torch.argsort(a, stable=True).flip(0)[:n]
    if with_index:
        return a[idx], idx
    return a[idx]


def get_index(array, value):
    """Index of the element closest to `value` (reference: pyqed/phys.py)."""
    return int(torch.argmin(torch.abs(_t(array) - value)))


_POLARIZATIONS = {
    "x": np.array([1.0, 0.0, 0.0]),
    "y": np.array([0.0, 1.0, 0.0]),
    "z": np.array([0.0, 0.0, 1.0]),
    "lcp": np.array([1.0, 1j, 0.0]) / np.sqrt(2),
    "rcp": np.array([1.0, -1j, 0.0]) / np.sqrt(2),
}


def polarization_vector(pol="x"):
    """Unit polarization vector: 'x', 'y', 'z', 'lcp', 'rcp'
    (reference: pyqed/phys.py — x/y/lcp/rcp there)."""
    try:
        return torch.as_tensor(_POLARIZATIONS[pol])
    except KeyError:
        raise ValueError(f"unknown polarization {pol!r}") from None


def rotate(angle):
    """2D rotation matrix (reference: pyqed/phys.py rotate — which
    returns the invalid ``np.array()`` there; made real)."""
    angle = _t(angle)
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def polar(x, y):
    """(rho, phi) from cartesian (reference: pyqed/mol.py:1296)."""
    return cartesian2polar(x, y)


def square_barrier(x, width, height):
    """Rectangular barrier of given width/height starting at x=0
    (reference: pyqed/wpd.py:1965)."""
    x = _t(x)
    return height * (heaviside(x) - heaviside(x - width))
