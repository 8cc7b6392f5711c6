"""Quantum Monte Carlo (PyTorch): DMC/VMC, PIMC and BosonPIMC, QSATS,
Sobol integration and the C++ walker engine, with the names of
``pyqed_tpu.qmc``."""
from .dmc import DMC, VMC
from .engine import dmc_native, build as build_native_engine
from .pimc import PIMC
from .pimc import BosonPIMC
from .qsats import (QSATS, hfdbhe, fcc_lattice, hcp_lattice, build_pairs)
from .engine import qsats_eloc_native, qsats_vmc_native
