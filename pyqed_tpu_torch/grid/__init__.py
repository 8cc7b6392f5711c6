from .spo import (SPO, SPO2, SPO3, SPON, SPO2NH, ResultSPO, ResultSPO2,
                  spo_from_reference)
from .dvr import (
    SincDVR, SineDVR, HermiteDVR, ExponentialDVR, DVRN, DVR2, kinetic,
    BesselDVR, LaguerreDVR, ChebyshevDVR, LegendreDVR, ChebDVR,
)
from .ldr import LDRN, LDR2, ResultLDR, ldr_from_reference
from .rate import RateFluxSide, flux_operator
from .ldr import LDR2Jacobi, NonHermLDRN
from .ehrenfest import Ehrenfest
from .fssh import FSSH, tully_i, tully_ii, tully_iii
from .adt import adt_1d, adt_angle, ADT
from .namd import NAMD, diabatic_to_adiabatic_1d
from .scattering import LippmannSchwingerSolver, LippmannSchwinger2DSolver
from .qtraj import QT, QTF, NAQT, lqf, ResultQT
from .gwp import (GWP, WPD, overlap_real, kinetic_real, moment_real,
                  GWPBasis, WPDN, WPD2, ThawedGaussian)
from .smolyak import (SparseGrid, AdaptiveSparseGrid, SparseInterpolator,
                      SGCT_LDR, combination_technique)
from .nawpd import NAWPD, NAWPD2
from .vmcg import VMCG, GWPMatrixElements
from .nusol import NuSol, cheb_D2
