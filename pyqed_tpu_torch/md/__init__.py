"""Molecular dynamics (PyTorch): the Lennard-Jones liquid (MD, Monte
Carlo, minimisation) and ring-polymer MD, with the names of
``pyqed_tpu.md``."""
from .md import LJMD, lj_forces, fcc_lattice
from .rpmd import RPMD, kubo_harmonic_xx

# the reference's drop-in names: LJMD carries run/minimize/monte_carlo/rdf
MolecularDynamics = LJMD
MonteCarlo = LJMD
MinimizeEnergy = LJMD
Measurements = LJMD
