"""Population trajectories through ``HEOMSolver.run``, one job each.

A job starts from rho0 = |psi><psi| of its drawn ``psi`` and records the
configuration's observables (the system's ``e_ops``) after every window
of ``nout`` RK4 steps; with a ``drive`` in the traffic the system runs
under H + E(t) X, X = |i><j| + |j><i| of the drive's two ``sites`` and E
a Gaussian pulse (cos carrier), evaluated by the program on the host at
every RK4 stage. The check propagates the jobs it is given again with
the plain reference and compares every recorded observable."""
from __future__ import annotations

import math

import numpy as np
import torch

from harness import registry
from reference.heom import PlainHEOM

NAME = "obs_gap"


def drive_of(cfg, traffic):
    """(X (n, n), pulse parameters in au) of the traffic's drive, or
    None."""
    d = traffic.get("drive")
    if not d:
        return None
    u = cfg["units"]
    cm, fs = u["cm_per_au"], u["fs_per_au"]
    X = np.zeros((cfg["n_sites"],) * 2)
    i, j = d["sites"]
    X[i, j] = X[j, i] = 1.0
    return X, {"amplitude": d["amplitude_cm"] / cm, "tau": d["width_fs"] / fs,
               "tc": d["center_fs"] / fs, "omega": d["carrier_cm"] / cm}


def gaussian(p):
    """E(t) = A exp(-(t - tc)^2 / (2 tau^2)) cos(omega (t - tc))."""
    def E(t):
        u = t - p["tc"]
        return (p["amplitude"] * math.exp(-u * u / (2 * p["tau"] ** 2))
                * math.cos(p["omega"] * u))
    return E


class Driver:
    def __init__(self, cfg, traffic, device, dtype):
        self.cfg, self.traffic = cfg, traffic
        self.device, self.dtype = device, dtype
        self.system = registry.module("systems", cfg["system"])
        self.drive = drive_of(cfg, traffic)
        self.extra = {}
        if self.drive is not None:
            from pyqed_tpu_torch import GaussianPulse
            X, p = self.drive
            pulse = GaussianPulse(omegac=p["omega"], tau=p["tau"], tc=p["tc"],
                                  amplitude=p["amplitude"])
            self.extra = {"edip": X, "pulse": pulse.efield}

    def steps(self, job):
        return self.traffic["nt"]

    def work(self, job):
        """What ``counts/`` takes for one of the job's steps."""
        return {"model": self.system.plain(self.cfg, job), "batch": 1,
                "itemsize": 16 if self.dtype == torch.complex128 else 8,
                "mu": None if self.drive is None else self.drive[0]}

    def _run(self, job, nt):
        sol, e_ops = self.system.program(self.cfg, job, self.device,
                                         self.dtype)
        psi = np.asarray(job["psi"])
        rho0 = torch.as_tensor(np.outer(psi, psi.conj())).to(self.dtype)
        res = sol.run(rho0, dt=self.cfg["dt_au"], nt=nt,
                      nout=self.traffic["nout"], e_ops=e_ops, **self.extra)
        return res.observables.cpu()

    def warm_up(self, job):
        """One window of the cell's own shapes."""
        self._run(job, self.traffic["nout"])

    def run(self, job):
        """The job's observables, (nt // nout + 1, K), on the host."""
        return self._run(job, self.traffic["nt"])

    def counters(self):
        from pyqed_tpu_torch.ops import kernels as kn
        return {"coupling_launches": kn.heom_coupling.launches,
                "coupling_batched_launches":
                    kn.heom_coupling.batched_launches}

    def check(self, jobs, outs, rng, device):
        """{"obs_gap": the largest |program - reference| over every
        recorded observable of the given jobs}."""
        gap = 0.0
        for job, res in zip(jobs, outs):
            model = self.system.plain(self.cfg, job)
            heom = PlainHEOM(model["H"], model["modes"], model["lmax"],
                             dtype=torch.complex128, device=device)
            psi = np.asarray(job["psi"])
            kw = {}
            if self.drive is not None:
                kw = {"mu": self.drive[0], "efield": gaussian(self.drive[1])}
            ref = heom.trajectory(np.outer(psi, psi.conj()),
                                  self.cfg["dt_au"], self.traffic["nt"],
                                  self.traffic["nout"], model["e_ops"], **kw)
            out = res.to(torch.complex128)
            if out.shape != ref.shape or not torch.isfinite(out).all():
                return {NAME: math.inf}
            gap = max(gap, (out - ref.cpu()).abs().max().item())
        return {NAME: gap}
