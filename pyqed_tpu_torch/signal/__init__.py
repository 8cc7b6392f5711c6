"""Nonlinear spectroscopy signals (PyTorch): the sum-over-states module
``sos``, the time-domain 2DES module ``tdes`` and pump-probe with the
third-order responses (``pump_probe``), with the names of
``pyqed_tpu.signal``, and the explicit-field phase-cycled 2DES of
``field2des``."""
from .sos import (
    absorption, linear_absorption, TPA, TPA2D, TPA2D_time_order,
    ESA, GSB, SE, _photon_echo, photon_echo, photon_echo_t3,
    DQC_R1, DQC_R2, etpa, etpa_amplitude, vacuum_efield, cars, mcd,
    polarizability,
)
from . import tdes
from .field2des import field_2des_rephasing, rephasing_spectrum
from .pump_probe import (TransientAbsorption, chi1, chi3,
                         response1_freq, response2_freq,
                         response3_freq, response4_freq,
                         susceptibility, response1_fd, response2_fd,
                         response3_fd, response4_fd)
