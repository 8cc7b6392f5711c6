from .named import FMO
from .mol import Mol, SESolver, mls
