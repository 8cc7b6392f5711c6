"""Utilities (PyTorch), with the names of ``pyqed_tpu.utils``: quantum
information (``qip``), colored noise, non-Hermitian eigenproblems, the
Wigner-Ville distribution and Wigner sampling, and cube-file I/O. The
plotting module ``style`` is not yet ported (ROADMAP.md queue 1, with
``beam/``)."""
from .qip import (
    reduce_dm, vn_entropy, mutual_info, purity, concurrence, tracedist,
    hilbert_dist, fidelity, hadamard,
)
from .noise import cnoise, autocorrelation
from .wigner import wigner, spectrogram, wvd, wigner_sample_harmonic
from .nonherm import eig as nonherm_eig, diabatic_to_adiabatic
from .io import write_cube, read_cube
