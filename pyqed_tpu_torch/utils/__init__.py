"""Utilities (PyTorch): the Wigner-Ville distribution and Wigner
sampling of ``pyqed_tpu.utils.wigner`` and the cube-file I/O of
``pyqed_tpu.utils.io``. The other modules of ``pyqed_tpu.utils`` are not
yet ported."""
from .wigner import wigner, spectrogram, wvd, wigner_sample_harmonic
from .io import write_cube, read_cube
