"""Nonequilibrium Green's functions (PyTorch): Keldysh-contour Green
functions and Kadanoff-Baym marches, equilibrium contour components,
G0W0 and GW-BSE, real-time TDHF, equilibrium and nonequilibrium DMFT and
electron-phonon self-energies — the counterpart of ``pyqed_tpu.negf``.
Every solver computes on its device (the card when None)."""
from .keldysh import (
    NEGF, green_from_H_const, green_from_H, hartree, fock_exchange,
    second_born, KBSolver, volterra_int, fermi, bose,
)
from .gw import G0W0, g0w0, rpa_modes
from .kb2t import KBSolver2T
from .contour import (
    ContourGF, green_equilibrium, green_equilibrium_H, semicircle_dos,
    DOS, volterra_intdiff,
)
from .gwbse import GWBSE
from .rt_tdhf import RTTDHF
from .dmft import DMFT, NoneqDMFT, NoneqDMFTThermal
from . import eph
