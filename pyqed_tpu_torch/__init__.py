"""pyqed_tpu_torch — the PyTorch/CUDA port of pyqed_tpu.

Ported so far:

- the HEOM main path (``HEOMSolver``, ``DrudeBath``, the ``FMO`` model,
  ``Result``, ``units``), with the HEOM coupling as a hand-written CUDA
  kernel for Hopper (``ops/kernels.py``, ``csrc/heom_coupling.cu``);
- the split-operator wavepacket path (``SPO``, ``SPO2``, ``SPO3``,
  ``SPON``, ``SPO2NH``, ``ResultSPO``, ``gwp``), with the kinetic phase
  multiply and the potential apply as hand-written CUDA kernels
  (``csrc/spo.cu``);
- the Lindblad/Redfield path (``LindbladSolver``, ``LiouvilleSolver``,
  ``RedfieldSolver``, ``redfield_tensor``, ``FMO.redfield``) with the
  operator algebra it stands on (``ops/linalg``, ``ops/operators``,
  ``ops/superoperator``, ``ops/expm``, ``core/dynamics``), and the
  Liouvillian commutator −i(H_eff ρ − ρ H_eff†) as a hand-written CUDA
  kernel (``csrc/liouvillian.cu``);
- the 2DES slice: ``Mol`` (``models/mol``), the sum-over-states
  photon-echo maps and the other signals of ``signal/sos`` (with the
  t2-batched and the low-rank factored photon-echo cubes), the
  time-domain 2DES of ``signal/tdes``, the rest of ``ops/math``, and the
  DEOM solver (``DEOMSolver``, ``DEOMBath``) with its resolvent response
  maps by host eig or by batched GMRES on the device. No TPU kernel lies
  on this path: it runs on cuBLAS and cuFFT;
- the driven-dynamics slice: the rest of ``HEOMSolver`` (the drive
  ``run(edip=, pulse=)`` through the coupling kernel, checkpoints, the
  dense Liouvillian, steady state and propagator, the correlation
  functions, ``absorption``) and ``HEOMSolverDrude``; laser pulses and
  biphotons (``models/pulse``), ``SESolver`` and the dynamics of ``Mol``,
  the cavity polariton (``models/cavity``) and Floquet theory
  (``floquet``);
- the LDR slice: the DVR family (``grid/dvr``), exact nonadiabatic
  dynamics in the local diabatic representation (``LDRN``, ``LDR2``,
  ``LDR2Jacobi``, ``NonHermLDRN``: dense, row-blocked and factored
  propagation, imaginary time, Liouville-von Neumann, HEOM), flux-side
  rates (``grid/rate``) and tensor trains (``tn/ttals``); the rest of
  ``models/named`` (oscillators, spin chains, Frenkel excitons, the
  displaced oscillator, Franck-Condon factors); and the rest of ``open``:
  TCL2, quantum jumps (``MCWFSolver``, ``mcsolve``), NRG, the
  quantum-regression correlations and the ``OQS`` front door. No TPU
  kernel lies on the LDR path (cuBLAS products); ``OQS.lindblad``,
  ``OQS.heom`` and ``LDRN.heom`` run the commutator and coupling kernels.

- the nonadiabatic-dynamics slice: trajectory methods (``FSSH`` with
  the Tully models, ``Ehrenfest``), adiabatic-representation wavepackets
  (``NAMD``, the ADT), the vibronic and conical-intersection models
  (pyrazine, Jahn-Teller, spin-vibronic, triazine, Shin-Metiu in 1D and
  2D, pyrrole, phenol, LVC), grid polaritons and vibrational strong
  coupling (``models/polariton_grid``), pump-probe and the third-order
  responses (``signal/pump_probe``), and Wigner sampling (``utils``).
  The SPO runs of the models go through the split-operator kernels
  (more than 4 states: their generic branch); the rest is plain torch.

- the rest of ``grid``, ``models`` and ``signal``: Gaussian-basis
  wavepackets (``WPD``, ``WPDN``, ``ThawedGaussian``), nonadiabatic
  Gaussian DVRs (``NAWPD``), variational moving Gaussians (``VMCG``),
  quantum trajectories (``QT``, ``NAQT``, ``QTF``), sparse grids and
  interpolation (``grid/smolyak``), NuSol and the Davidson eigensolvers
  (``ops/davidson``), Lippmann-Schwinger scattering, lattice models
  (``models/lattice``) and the explicit-field phase-cycled 2DES
  (``signal/field2des``), which propagates its whole phase × t1 batch as
  one hierarchy state: with ``kernel='cuda'`` one launch of the HEOM
  coupling kernel per right-hand side covers the batch.

- tensor networks and optimal control: ``tn`` (MPS/MPO, two-site DMRG,
  TEBD, TDVP, autoMPO, the ab initio MPOs, TT-LDR and ``VibronicMPS``)
  and ``control`` (GRAPE, OpenGRAPE,
  CRAB, Krotov, ``fit``). No TPU kernel lies on tn/; ``control`` runs
  ``torch.autograd`` through the solvers, and the commutator kernel's
  wrapper carries a backward (one more launch of the same kernel).

- Gaussian-basis quantum chemistry (``qchem``): integrals on the host
  (NumPy, and the C++ ERI engine built at first use), RHF/UHF, MP2,
  CI/CASSCF, CCSD(T), EOM-CCSD, TDA/TDHF, RKS/UKS on Becke grids,
  analytic gradients, the Hessian, localisation and RXS, on the
  molecule's device; ``tn.DMRGQC`` runs on its integrals. No TPU kernel
  lies on qchem/: it runs on cuBLAS and cuSOLVER.

- the rest of quantum chemistry and the Green's functions: analytic
  excited-state and correlated forces and relaxed dipoles
  (``qchem.tdgrad``: ``torch.func`` through the orbital functional, one
  Z-vector solve, the derivative ERIs contracted per AO), DVR electronic
  structure, densities and cube files, spin-orbit integrals, qubit
  Hamiltonians, ab initio LVC models (``LVCBuilder``), the two-electron and 3D
  Shin-Metiu models, and ``negf`` (Keldysh and equilibrium contour Green's
  functions, Kadanoff-Baym marches with second-Born and GW self-energies,
  DMFT in and out of equilibrium, G0W0, GW-BSE, real-time TDHF,
  electron-phonon spectra). No TPU kernel lies on them.

- the sampling family: ``qmc`` (DMC/VMC, PIMC and BosonPIMC, QSATS, Sobol
  integration, the C++ walker engine), ``md`` (Lennard-Jones MD and Monte
  Carlo, RPMD) and ``ml`` (MLP fits); ``ops.fft``, ``ops.ode``,
  ``ops.jointdiag``, ``ops.quadrature``; ``utils.qip``, ``noise`` and
  ``nonherm``; the rest of ``core.diagnostics``; ``units.AtomicUnits``.
  Every sampler takes its random draws as arguments (``run`` draws them
  from a seeded ``torch.Generator`` on the device) and runs its step as a
  CUDA graph on the card (``core.dynamics.GraphScan``). No TPU kernel lies
  on them.

The package surface mirrors ``pyqed_tpu``'s for every ported module
(``tests/test_torch_surface.py``); ``use_x64``/``x64_enabled`` are
accepted and change nothing, since torch always has float64.

Entry points run on the card (``device=None`` means ``cuda`` and raises
without one) unless the caller passes ``device="cpu"``. The package
imports torch, NumPy and SciPy, never JAX or ``pyqed_tpu``.
"""

__version__ = "0.1.0"

from . import units
from .units import *  # noqa: F401,F403 — constants namespace, as in pyqed_tpu
from .config import use_x64, x64_enabled, default_complex, default_real
from .ops import *  # noqa: F401,F403 — the ported names of pyqed_tpu.ops
from .core.result import Result, load_result
from .models.named import (FMO, Frenkel, Frenkel2, Frenkel2s, Frenkel2_s,
                           HarmonicOscillator, Morse, TFIM, HeisenbergModel,
                           DHO, franck_condon, franck_condon_analytic)
from .models.mol import (Mol, SESolver, mls, tdse, quantum_dynamics,
                         driven_dynamics)
from .models.pulse import (
    Pulse, GaussianPulse, ChirpedPulse, Biphoton, intensity_to_field,
    Analyser, schmidt_decompose, schmidt_number, hom_schmidt,
    field_to_intensity, fwhm_to_std, std_to_fwhm,
)
from .models.cavity import Cavity, Composite, Polariton, QRM
from .open.bath import DrudeBath, OhmicBath
from .open.heom import HEOMSolver, HEOMSolverDrude, solver_from_reference
from .grid import SPO, SPO2, SPO3, SPON, SPO2NH, ResultSPO, LDRN
from .grid import (FSSH, Ehrenfest, NAMD, tully_i, tully_ii, tully_iii,
                   diabatic_to_adiabatic_1d, adt_1d, adt_angle, ADT)
from .models.lvc import LVC, Mode
from .models.vibronic import (Pyrazine, JahnTeller, ShinMetiu,
                              SpinVibronic, VibronicAdiabatic)
from .models.polariton_grid import GridMol, VibronicPolariton, VSC, TDH
from .models.shinmetiu2d import ShinMetiu2D
from . import utils
from .grid import SincDVR, SineDVR, HermiteDVR, ExponentialDVR, ChebDVR
from .ops.wavepacket import gwp
from .ops.davidson import davidson, block_davidson
from .open.lindblad import (LindbladSolver, LiouvilleSolver, Lindblad_solver,
                            driven_dissipative_dynamics, absorption_eseries)
from .open.redfield import RedfieldSolver, redfield_tensor
from .open.deom import DEOMSolver, DEOMBath
from .open.oqs import OQS
from .open.mcwf import MCWFSolver, mcsolve
from . import signal
from . import floquet
from . import tn
from . import control
from . import qchem
from . import negf
from . import qmc
from . import md
from . import ml
from .ops.linalg import sort_eig as sort   # reference: pyqed/phys.py:554
from .ops.operators import (
    lowering, raising, multi_spin, norm2, is_positive_def, direct_product,
    jacobi_anger, propagator, propagator_H_const,
)
from .ops.expm import chebyshev_expm_multiply
