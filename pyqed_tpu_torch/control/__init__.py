"""Optimal control and differentiable parameter fitting (PyTorch), the
names of ``pyqed_tpu.control``: ``GRAPE``, ``OpenGRAPE`` and ``CRAB``
(pulses by ``torch.autograd`` through batched matrix exponentials),
``Krotov`` (closed-form sequential updates) and ``fit`` (a gradient loop
over any loss built from the port's solvers, e.g. a Lindblad rate
through ``LindbladSolver``, whose commutator kernel has a backward)."""
from .grape import GRAPE, OpenGRAPE, CRAB, amplitude_penalty, smoothness_penalty
from .krotov import Krotov
from .fit import fit, fit_exponential_decay
