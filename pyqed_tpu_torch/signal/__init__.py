"""Nonlinear spectroscopy signals (PyTorch): the sum-over-states module
``sos`` and the time-domain 2DES module ``tdes``, with the names of
``pyqed_tpu.signal``. ``field2des`` and ``pump_probe`` are not yet
ported."""
from .sos import (
    absorption, linear_absorption, TPA, TPA2D, TPA2D_time_order,
    ESA, GSB, SE, _photon_echo, photon_echo, photon_echo_t3,
    DQC_R1, DQC_R2, etpa, etpa_amplitude, vacuum_efield, cars, mcd,
    polarizability,
)
from . import tdes
