"""pyqed_tpu_torch — the PyTorch/CUDA port of pyqed_tpu.

Ported so far:

- the HEOM main path (``HEOMSolver``, ``DrudeBath``, the ``FMO`` model,
  ``Result``, ``units``), with the HEOM coupling as a hand-written CUDA
  kernel for Hopper (``ops/kernels.py``, ``csrc/heom_coupling.cu``);
- the split-operator wavepacket path (``SPO``, ``SPO2``, ``SPO3``,
  ``SPON``, ``SPO2NH``, ``ResultSPO``, ``gwp``), with the kinetic phase
  multiply and the potential apply as hand-written CUDA kernels
  (``csrc/spo.cu``).

Entry points run on the card (``device=None`` means ``cuda`` and raises
without one) unless the caller passes ``device="cpu"``. The package
imports torch, NumPy and SciPy, never JAX or ``pyqed_tpu``.
"""

__version__ = "0.1.0"

from . import units
from .core.result import Result, load_result
from .models.named import FMO
from .open.bath import DrudeBath
from .open.heom import HEOMSolver, solver_from_reference
from .grid import SPO, SPO2, SPO3, SPON, SPO2NH, ResultSPO
from .ops.wavepacket import gwp
