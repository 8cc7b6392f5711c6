from .bath import DrudeBath, OhmicBath, Env, pade_poles_bose, bose, \
    bath_correlation_from_spectral_density, prony_decomposition
from .heom import (HEOMSolver, HEOMSolverDrude, enumerate_hierarchy,
                   neighbor_maps, solver_from_reference)
from .lindblad import (LindbladSolver, LiouvilleSolver, Lindblad_solver,
                       driven_dissipative_dynamics, absorption_eseries)
from .redfield import RedfieldSolver, redfield_tensor
from .deom import DEOMSolver, DEOMBath, Bath
from .nrg import NRG, SBM
from .tcl import TCL2Solver
from .mcwf import MCWFSolver, mcsolve
from .correlation import correlation_3p_1t, correlation_4p_2t, g2_coherence
from .oqs import OQS
