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
