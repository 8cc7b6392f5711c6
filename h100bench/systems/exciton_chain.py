"""A Frenkel exciton chain: a ground state |0> and n_sites sites with
nearest-neighbour couplings, site energies drawn per job, one Drude bath
per site through its projector, and the dipole mu = sum_k |0><k| + h.c.

``plain`` builds the operators for the reference and the counts;
``program`` hands the same Hamiltonian and the bath parameters (as
``DrudeBath`` objects, so the program makes its own decomposition) to
``pyqed_tpu_torch.HEOMSolver``."""
from __future__ import annotations

import numpy as np

from reference.bath import drude_pade


def operators(cfg, job):
    """(H, projectors, mu, rho0) as NumPy arrays; H holds the job's
    ``site_energies`` (the configuration's mean without a job)."""
    ns = cfg["n_sites"]
    n = ns + 1
    E = (np.asarray(job["site_energies"]) if job is not None
         else np.full(ns, cfg["site_energy_mean"]))
    H = np.zeros((n, n))
    H[np.arange(1, n), np.arange(1, n)] = E
    H[np.arange(1, n - 1), np.arange(2, n)] = cfg["coupling"]
    H[np.arange(2, n), np.arange(1, n - 1)] = cfg["coupling"]
    proj = [np.diag(np.eye(n)[1 + s]) for s in range(ns)]
    mu = np.zeros((n, n))
    mu[0, 1:] = mu[1:, 0] = 1.0
    rho0 = np.zeros((n, n))
    rho0[0, 0] = 1.0
    return H, proj, mu, rho0


def plain(cfg, job=None):
    H, proj, mu, rho0 = operators(cfg, job)
    c, nu = drude_pade(cfg["reorg"], cfg["cutoff"], cfg["temperature"],
                       cfg["nexp"])
    modes = [(Q, ck, nuk) for Q in proj for ck, nuk in zip(c, nu)]
    return {"H": H.astype(complex), "modes": modes, "lmax": cfg["lmax"],
            "mu": mu, "rho0": rho0}


def program(cfg, job, device, dtype):
    """The measured solver of the job's chain."""
    import torch

    from pyqed_tpu_torch import DrudeBath, HEOMSolver
    H, proj, _, _ = operators(cfg, job)
    bath = [(Q, DrudeBath(temperature=cfg["temperature"],
                          cutoff=cfg["cutoff"], reorg=cfg["reorg"]))
            for Q in proj]
    return HEOMSolver(torch.as_tensor(H).to(dtype), bath=bath,
                      lmax=cfg["lmax"], decomposition=cfg["decomposition"],
                      nexp=cfg["nexp"], kernel=cfg["kernel"], device=device)
