"""The FMO 7-site exciton model with one Drude bath per site.

``plain`` builds the operators from the configuration file (the
published Hamiltonian in cm^-1, the bath in cm^-1, fs and K) for the
reference and the counts; ``program`` builds the measured solver through
``pyqed_tpu_torch.models.named.FMO().heom``, which holds its own copy of
the Hamiltonian."""
from __future__ import annotations

import numpy as np

from reference.bath import drude_pade


def units(cfg):
    u = cfg["units"]
    return u["cm_per_au"], u["fs_per_au"], u["K_per_au"]


def plain(cfg, job=None):
    """H (n, n) in au, modes [(Q, c, nu)], lmax, and the site
    projectors as e_ops."""
    cm, fs, K = units(cfg)
    H = np.array(cfg["hamiltonian_cm"], dtype=float)
    np.fill_diagonal(H, np.diag(H) - np.mean(np.diag(H)))
    n = H.shape[0]
    c, nu = drude_pade(cfg["reorg_cm"] / cm, 1.0 / (cfg["tau_c_fs"] / fs),
                       cfg["temperature_K"] / K, cfg["nexp"])
    proj = [np.diag(np.eye(n)[s]).astype(complex) for s in range(n)]
    modes = [(Q, ck, nuk) for Q in proj for ck, nuk in zip(c, nu)]
    return {"H": (H / cm).astype(complex), "modes": modes,
            "lmax": cfg["lmax"], "e_ops": proj}


def program(cfg, job, device, dtype):
    """(solver, e_ops) of the measured program in ``dtype``."""
    import torch

    from pyqed_tpu_torch.models.named import FMO
    m = FMO(reorg_cm=cfg["reorg_cm"], tau_c_fs=cfg["tau_c_fs"])
    m.H = m.H.to(dtype)
    sol = m.heom(temperature=cfg["temperature_K"], lmax=cfg["lmax"],
                 nexp=cfg["nexp"], decomposition=cfg["decomposition"],
                 kernel=cfg["kernel"], device=device)
    return sol, [p.to(torch.complex128) for p in m.site_projectors()]
