"""Named model systems (PyTorch): the FMO exciton model.

PyTorch counterpart of ``FMO`` in ``pyqed_tpu/models/named.py`` (its
``heom`` and ``redfield`` solvers); the other named models are not yet
ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..units import au2fs, au2k, au2wavenumber


class FMO:
    """Fenna-Matthews-Olson 7-site exciton model.

    Single-excitation Hamiltonian of one FMO monomer from Adolphs &
    Renger, Biophys. J. 91, 2778 (2006), as used by Ishizaki & Fleming,
    PNAS 106, 17255 (2009); site energies and couplings in cm^-1, stored
    in atomic units with the mean site energy removed (a global phase).

    Each site couples to an independent Drude-Lorentz bath through its
    projector |j><j| (reorganization ``reorg_cm`` = 35 cm^-1, bath
    correlation time ``tau_c_fs`` = 50 fs). Operators are complex128 CPU
    tensors; :meth:`heom` places the hierarchy on ``device``.
    """

    # cm^-1, Adolphs-Renger table 4 (trimer) / Ishizaki-Fleming Fig. 2
    H_CM = np.array([
        [12410.0,  -87.7,    5.5,   -5.9,    6.7,  -13.7,   -9.9],
        [-87.7,   12530.0,  30.8,    8.2,    0.7,   11.8,    4.3],
        [5.5,      30.8,  12210.0, -53.5,   -2.2,   -9.6,    6.0],
        [-5.9,      8.2,   -53.5, 12320.0, -70.7,  -17.0,  -63.3],
        [6.7,       0.7,    -2.2,  -70.7, 12480.0,  81.1,   -1.3],
        [-13.7,    11.8,    -9.6,  -17.0,   81.1, 12630.0,  39.7],
        [-9.9,      4.3,     6.0,  -63.3,   -1.3,   39.7, 12440.0],
    ])

    def __init__(self, reorg_cm=35.0, tau_c_fs=50.0):
        self.nsites = 7
        Hcm = self.H_CM.copy()
        np.fill_diagonal(Hcm, np.diag(Hcm) - np.mean(np.diag(Hcm)))
        self.H = torch.as_tensor((Hcm / au2wavenumber).astype(complex))
        self.reorg = reorg_cm / au2wavenumber
        self.cutoff = 1.0 / (tau_c_fs / au2fs)      # gamma = 1/tau_c [au]

    def site_projectors(self):
        return [torch.as_tensor(np.diag(np.eye(self.nsites)[j]).astype(complex))
                for j in range(self.nsites)]

    def _bath(self, temperature):
        from ..open.bath import DrudeBath
        b = DrudeBath(temperature=temperature / au2k, cutoff=self.cutoff,
                      reorg=self.reorg)
        b.set_bath_ops(self.site_projectors())
        return b

    def heom(self, temperature=300.0, lmax=3, nexp=1,
             decomposition="matsubara", device=None, **kw):
        """HEOMSolver with an independent Drude bath per site
        (temperature in Kelvin; nexp Matsubara/Pade terms per site on top
        of the Drude pole), its hierarchy on ``device``: the card when
        None (raises without one), ``"cpu"`` on request."""
        from ..open.heom import HEOMSolver
        return HEOMSolver(self.H, bath=self._bath(temperature), lmax=lmax,
                          decomposition=decomposition, nexp=nexp,
                          device=device, **kw)

    def redfield(self, temperature=300.0, nexp=30, device=None):
        """RedfieldSolver with the SAME exponential bath modes as
        :meth:`heom` (spectra built from the converged Matsubara series,
        so a weak-coupling comparison isolates the method, not the
        decomposition), on ``device``: the card when None (raises
        without one), ``"cpu"`` on request."""
        from ..open.redfield import RedfieldSolver
        Gamma = self._bath(temperature).redfield_spectrum(nexp=nexp)
        return RedfieldSolver(self.H, c_ops=self.site_projectors(),
                              spectra=[Gamma] * self.nsites, device=device)

    def initial_state(self, site=0):
        rho0 = np.zeros((self.nsites, self.nsites), dtype=complex)
        rho0[site, site] = 1.0
        return torch.as_tensor(rho0)
