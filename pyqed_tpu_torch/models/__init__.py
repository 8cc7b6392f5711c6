from .named import (
    HarmonicOscillator, Morse, Frenkel, Frenkel2, Frenkel2s, Frenkel2_s,
    TFIM, HeisenbergModel,
    franck_condon, FranckCondon, franck_condon_analytic, DHO, FMO,
)
from .mol import Mol, SESolver, mls, tdse
from .pulse import (
    Pulse, GaussianPulse, ChirpedPulse, Biphoton, intensity_to_field,
    std_to_fwhm, jsa, jta, rdm, hom,
)
from .cavity import Cavity, Composite, Polariton, QRM
from .lvc import LVC, Mode, multimode
from .vibronic import (Pyrazine, JahnTeller, ShinMetiu, ShinMetiuInField,
                       Pyrazine4, Triazine, SpinVibronic, VibronicAdiabatic)
from .polariton_grid import GridMol, VibronicPolariton, VSC, TDH
from .polariton_grid import GridMol2, VibronicPolariton2, berry_curvature_field
from .shinmetiu2e import ShinMetiu2e1d, ShinMetiu3d
from .shinmetiu2d import (ShinMetiu2D, ShinMetiu2DMagnetic,
                          ShinMetiu2DElectric, ShinMetiu2,
                          ShinMetiu2InMagneticField,
                          ShinMetiu2InElectricField)
from .phenol import Phenol
from .pyrrole import Pyrrole, PyrroleCation
from .lattice import FermiHubbard, BoseHubbard, jordan_wigner_ops
