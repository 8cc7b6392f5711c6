"""Explicit-field phase-cycled rephasing 2DES maps through
``pyqed_tpu_torch.signal.field_2des_rephasing``, one map per job.

A job is one static-disorder realisation of the system (its drawn
``site_energies``): the N1 x N2 phase pairs of every delay t1 run as one
(nado, B, n, n) batch. The check recomputes sampled rows P3[t1, :] of
the maps it is given with the plain reference: the first and the last
delay and random others, each row from its N1 x N2 phase pairs."""
from __future__ import annotations

import math

import numpy as np
import torch

from harness import registry
from reference.field2des import rephasing_rows, schedule
from reference.heom import PlainHEOM

NAME = "p3_gap"
NUMPY = {torch.complex128: np.complex128, torch.complex64: np.complex64}


class Driver:
    def __init__(self, cfg, traffic, device, dtype):
        self.cfg, self.traffic = cfg, traffic
        self.device, self.dtype = device, dtype
        self.system = registry.module("systems", cfg["system"])
        self.t1s = traffic["t1_step"] * np.arange(traffic["n_t1"])

    def pulses(self):
        t = self.traffic
        return dict(t2=t["t2"], nt3=t["nt3"], dt=t["dt"],
                    width=t["pulse_width"], amps=tuple(t["amplitudes"]),
                    omega=t["omega"], n_phase=tuple(t["n_phase"]))

    def steps(self, job):
        p = self.pulses()
        return schedule(self.t1s, p["t2"], p["nt3"], p["dt"], p["width"])[3]

    def work(self, job):
        """What ``counts/`` takes for one of the job's steps: the whole
        batch, the dipole, and the recorded polarization spread over the
        steps."""
        p = self.pulses()
        model = self.system.plain(self.cfg, job)
        B = int(np.prod(p["n_phase"])) * len(self.t1s)
        itemsize = 16 if self.dtype == torch.complex128 else 8
        return {"model": model, "batch": B, "itemsize": itemsize,
                "mu": model["mu"],
                "extra_bytes": itemsize * B * p["nt3"] / self.steps(job)}

    def _run(self, job, t1s, **short):
        from pyqed_tpu_torch.signal.field2des import field_2des_rephasing
        p = {**self.pulses(), **short}
        sol = self.system.program(self.cfg, job, self.device, self.dtype)
        _, _, mu, rho0 = self.system.operators(self.cfg, job)
        npdt = NUMPY[self.dtype]
        P3, _, _ = field_2des_rephasing(
            sol, rho0.astype(npdt), mu.astype(npdt), t1s, t2=p["t2"],
            nt3=p["nt3"], dt=p["dt"], pulse_width=p["width"],
            e_amps=p["amps"], omega_c=p["omega"], pad=p.get("pad"),
            n_phase=p["n_phase"], kernel=self.cfg["kernel"])
        return P3

    def warm_up(self, job):
        """Four RK4 steps of the cell's own batch (B = N1 x N2 x n_t1):
        the delays, t2 and the pads cut to 0 or one step, two detection
        samples."""
        dt = self.traffic["dt"]
        self._run(job, np.zeros_like(self.t1s), t2=0.0, nt3=2, pad=dt)

    def run(self, job):
        """The job's map P3 (n_t1, nt3), on the host."""
        return self._run(job, self.t1s).cpu()

    def counters(self):
        from pyqed_tpu_torch.ops import kernels as kn
        return {"coupling_launches": kn.heom_coupling.launches,
                "coupling_batched_launches":
                    kn.heom_coupling.batched_launches}

    def check(self, jobs, outs, rng, device):
        """{"p3_gap": the largest |program - reference| over the sampled
        rows of the given maps, over the largest |reference| there}."""
        n1 = len(self.t1s)
        want = max(2, min(n1, int(self.traffic["check_rows"])))
        middle = rng.choice(np.arange(1, n1 - 1), size=want - 2,
                            replace=False).tolist() if n1 > 2 else []
        rows = sorted({0, n1 - 1, *middle})
        gap = 0.0
        for job, res in zip(jobs, outs):
            model = self.system.plain(self.cfg, job)
            heom = PlainHEOM(model["H"], model["modes"], model["lmax"],
                             dtype=torch.complex128, device=device)
            ref = rephasing_rows(heom, model["rho0"], model["mu"], self.t1s,
                                 rows, **self.pulses()).cpu()
            out = res.to(torch.complex128)
            if out.shape[0] != n1 or not torch.isfinite(out).all():
                return {NAME: math.inf}
            gap = max(gap, ((out[rows] - ref).abs().max()
                            / ref.abs().max()).item())
        return {NAME: gap}
