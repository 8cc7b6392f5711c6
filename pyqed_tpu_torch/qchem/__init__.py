"""Gaussian-basis quantum chemistry (PyTorch).

Counterpart of ``pyqed_tpu/qchem``: integrals (host NumPy, with the C++
McMurchie-Davidson ERI engine built at first use into
``pyqed_tpu_torch/build/``), RHF/UHF, MP2, CI/CASSCF, CCSD(T), EOM-CCSD,
TDA/TDHF, RKS/UKS on Becke grids, analytic gradients, the numerical
Hessian, localisation and core excitations (RXS). ``Molecule(...,
device=None)`` puts the integrals on the card (``device="cpu"`` to run on
the CPU), and every method computes on its molecule's device.

Not yet ported (ROADMAP queue 1 item 1): ``tdgrad``, ``vibronic``, ``dvr``,
``density``, ``soc`` and ``qubit``.
"""
from .mol import Molecule, molecule_from_reference
from .scf import RHF, UHF, scf_from_reference
from .ci import FCI, CISD, CASCI, slater_condon, spinorb_ints
from .mp import MP2, UMP2
from .cc import CCSD
from .eom import EOMCCSD
from .tdscf import TDA, TDHF, CIS, UCIS
from .dft import RKS, UKS, becke_grid, lda_exc_vxc
from .grad import (Grad, GeometryOptimizer, optimize_geometry, scan_pes,
                   rhf_gradient, scf_gradient, tda_gradient_fd,
                   excited_state_energy, ExcitedGeometryOptimizer)
from . import basis
from .rxs import RXS, get_ab_ras, core_excitation
from .ci_overlap import (cross_overlap_ao, mo_cross_overlap, ci_overlap,
                         wavefunction_overlap, nonadiabatic_coupling)
from .scf import get_hcore_mo, get_eri_mo
from .geometry import (read_xyz, grad_nuc, quasi_angular_momentum,
                       eckart_frame, zmatrix_to_cartesian)
from .lo import (boys, pipek_mezey, iao, ibo, vec_lowdin,
                 mulliken_charges, iao_charges, find_homo_lumo,
                 orbital_centers)
from .cphf import polarizability_cphf, polarizability_dynamic
