"""Optics (PyTorch), with the names of ``pyqed_tpu.beam``: scalar and
vector diffraction of X, XY, XZ and XYZ fields (angular spectrum,
Rayleigh-Sommerfeld, split-step BPM, WPM, PWD), masks and sources,
refractive-index scenes, Jones calculus and Stokes analysis, Bluestein
zoom transforms, transfer-matrix photonics and dyadic Green's functions,
the host analysis of ``optics``/``fieldz``, and drawing (matplotlib is
imported only when something is drawn). No TPU kernel lies on this
layer: its FFTs run on cuFFT through ``torch.fft``."""
from .beam import (
    ScalarFieldX, ScalarFieldXY, ScalarFieldXZ, ScalarFieldXYZ,
    Scalar_field_X, Scalar_field_XY, Scalar_field_XZ, Scalar_field_XYZ,
    VectorFieldXY, VectorFieldXYZ,
    plane_wave, gauss_beam, slit, double_slit, circular_aperture, lens,
)
from .vector import (
    VectorMaskXY, VectorSourceXY, Vector_mask_XY, Vector_source_XY,
    polarizer_linear, quarter_waveplate, half_waveplate, retarder,
    polarization_states, polarization_ellipse,
)
from .photonic import (
    transfer_matrix, rt_coefficients, transmittance_spectrum,
    quasinormal_modes, Multilayer, propagation, interface,
    dyadic_G0, dyadic_Gs_interface, dyadic_Gs_slab, dyadic_G_slab,
    ChiralMultilayer, purcell_factor, helmholtz_g0,
)
from .zoom import czt, zoom_dft, zoom_dft2, fraunhofer_zoom
from . import fieldutils
from .fieldz import ScalarFieldZ
from . import optics
from .beam import draw_several_fields
from . import masks
from . import scenes
from . import masks_x
from . import drawing
from .drawing import (draw, video, slices, prepare_drawing,
                      normalize_draw, field_view)
