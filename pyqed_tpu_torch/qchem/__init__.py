"""Gaussian-basis quantum chemistry (PyTorch).

Counterpart of ``pyqed_tpu/qchem``: integrals (host NumPy, with the C++
McMurchie-Davidson ERI engine built at first use into
``pyqed_tpu_torch/build/``), RHF/UHF, MP2, CI/CASSCF, CCSD(T), EOM-CCSD,
TDA/TDHF, RKS/UKS on Becke grids, analytic gradients, the numerical
Hessian, localisation and core excitations (RXS); analytic excited-state
and correlated forces and relaxed dipoles (``tdgrad``: CIS/TDA, TDHF,
TDDFT/TDA, MP2, UCIS, UMP2, CCSD), real-space DVR electronic structure
(``dvr``), charge and current densities and cube files (``density``),
spin-orbit integrals (``soc``), qubit Hamiltonians (``qubit``) and ab
initio LVC models (``vibronic``). ``Molecule(..., device=None)`` puts the
integrals on the card (``device="cpu"`` to run on the CPU), and every
method computes on its molecule's device.
"""
from .mol import Molecule, molecule_from_reference
from .scf import RHF, UHF, scf_from_reference
from .ci import FCI, CISD, CASCI, slater_condon, spinorb_ints
from .mp import MP2, UMP2
from .cc import CCSD
from .eom import EOMCCSD
from .cc import ccsd_from_reference
from .tdscf import TDA, TDHF, CIS, UCIS, tdscf_from_reference
from .dft import RKS, UKS, becke_grid, lda_exc_vxc
from .soc import soc_integrals, soc_matrix, soc_mo
from .grad import (Grad, GeometryOptimizer, optimize_geometry, scan_pes,
                   rhf_gradient, scf_gradient, tda_gradient_fd,
                   excited_state_energy, ExcitedGeometryOptimizer)
from .tdgrad import (cis_gradient, tda_gradient, mp2_gradient,
                     mp2_dipole, response_gradient, ResponseEngine,
                     ccsd_gradient, tdhf_gradient, tddft_tda_gradient,
                     ump2_gradient, ump2_dipole, ucis_gradient, ccsd_dipole,
                     cis_dipole, tdhf_dipole, ucis_dipole, tddft_tda_dipole)
from .vibronic import LVCBuilder, LVC_DFT
from . import basis
from .dvr import (MoleculeDVR, RHF1D, RHF2D, RKS1D, CASCIDVR,
                  soft_coulomb, exact_2e)
from .rxs import RXS, get_ab_ras, core_excitation
from .density import (ao_gradients, charge_density,
                      transition_charge_density,
                      transition_current_density,
                      current_density_wavefunction, cube_grid,
                      write_density_cube)
from .ci_overlap import (cross_overlap_ao, mo_cross_overlap, ci_overlap,
                         wavefunction_overlap, nonadiabatic_coupling)
from .scf import get_hcore_mo, get_eri_mo
from .geometry import (read_xyz, grad_nuc, quasi_angular_momentum,
                       eckart_frame, zmatrix_to_cartesian)
from .lo import (boys, pipek_mezey, iao, ibo, vec_lowdin,
                 mulliken_charges, iao_charges, find_homo_lumo,
                 orbital_centers)
from .cphf import polarizability_cphf, polarizability_dynamic
