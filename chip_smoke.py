#!/usr/bin/env python3
"""GPU smoke run of pyqed_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is
nonzero:

1. environment: the card's name and power limit (nvidia-smi), TF32 off;
2. build: compiles csrc/heom_coupling.cu, csrc/spo.cu and
   csrc/liouvillian.cu with nvcc, one process each, started together,
   prints their -Xptxas -v reports, and counts the DMMA (FP64 tensor-core)
   instructions in the SASS (cuobjdump) of the commutator library and of
   the HEOM coupling library (its destination-major batched kernel),
   which must not be zero;
3. kernel parity, each CUDA kernel against its plain PyTorch version,
   complex128 (rel <= 1e-12) and complex64 (rel <= 1e-5):
   - the HEOM coupling at the FMO flagship shape (680 ADOs, V = 49, nj =
     28), at the n = 8 exciton-chain shape (680 ADOs, V = 64) and on the
     FMO nexp=2 hierarchy (2,024 ADOs, nj = 42); on the first two also
     with a batch of B = 1, 2, 7, 33 and 256 hierarchies (F (nado, B, V),
     one launch for the batch), through both designs, edge-major and
     destination-major, at every B (the latter allocates no partials
     buffer);
   - the SPO phase multiply and potential apply at the 256^3 x 2-state
     chip shape (states-first, the layout of the FFT on the main path)
     and at a ragged 37 x 41 x 29 x 3-state shape in both layouts, and
     with 10 states (the generic branch) on the ragged shape and on
     1,024- and 2^20-point 1-D grids, and with 200 states (rows read
     from device memory, too long to stage) on 333 points, in both
     layouts;
   - the Liouvillian commutator at n = 16, 37, 1000 and 1024 (and 2048
     at complex128) on random non-Hermitian H_eff and rho;
4. main paths, each driven with every launch count set to 0 just before
   and read just after:
   - HEOM: FMO().heom(..., device='cuda').run(...) for 4000 steps of
     10 au (968 fs) at complex128 through the kernel (launch count
     4 x nt, trace error and agreement with the plain einsum run
     <= 1e-10, first window against a CPU run), then the nexp=2
     hierarchy (2,024 ADOs), then an underdamped two-level bath (complex
     rates) through the kernel (launch count 4 x nt) against
     kernel='matmul' (<= 1e-10);
   - SPO: SPO3 on a 256^3 grid with 2 states (the two-state coupled
     harmonic model of bench.py's _spo3_model), run(dt=0.004, nt=200,
     nout=20) at complex128 through the kernels (launch counts 2 x nt
     and nt, norm drift <= 1e-10, agreement with kernel='xla' <= 1e-12);
     the first 10 steps at 64^3 against a NumPy complex128 Strang loop
     (<= 1e-10); the 1-D Morse model of examples/spo_morse.py (512
     points) through the kernels and through kernel='dft' (<= 1e-10);
   - Lindblad, config #2 (bench.py's vibronic dimer, n = 16):
     LindbladSolver.run for 4000 RK4 steps of 0.002 through the
     commutator kernel (launch count 4 x Nt, trace drift <= 1e-12,
     window by window against method='propagator' <= 1e-10 and against
     SciPy's expm of the dense Liouvillian <= 1e-8), then
     method='propagator' for the bench's 400,000 steps (trace drift);
   - Lindblad at chip scale (the same builder at nvib = 512, n = 1024):
     200 steps through the kernel (launch count 4 x Nt) and with
     kernel='matmul' (rel <= 1e-12 on rho and the observables, trace
     drift <= 1e-10);
   - Redfield: FMO().redfield() on the card against the same run on the
     CPU (<= 1e-10);
   - 2DES (BASELINE config #4; no hand-written kernel lies on this path,
     so every launch count must stay 0): the photon-echo cube of
     bench.py's excitonic dimer at 256 t2 x 512 x 512 complex128 (1.07
     GB) through photon_echo_t2series and photon_echo_t2series_factored
     (rel <= 1e-12 between them, finite; its first and last t2 maps at
     full width and each builder at 8 x 64^2 against the CPU, rel <=
     1e-12); tdes.twodes at t1 = t3 = 512 x 0.5, 64 t2 (R and S,
     268 MB each; against the CPU at 64 x 8 x 64, rel <= 1e-12);
   - DEOM at the FMO flagship hierarchy (680 ADOs, N = 33,320): run() for
     4000 RK4 steps of 10 au against HEOMSolver.run with the coupling
     kernel (rho_0(t) <= 1e-8, trace error <= 1e-10); the GMRES response
     map (correlation_4op_3t_gmres, 16 x 16 grid of 50-600 cm^-1, T = 2
     fs) with every solve's true relative residual <= 1e-8, and GMRES
     against the host-eig map at FMO lmax = 1 and at the spin-boson of
     tests/test_deom.py (rel <= 1e-6);
   - driven HEOM at the FMO flagship: run(edip=X, pulse=GaussianPulse)
     for 4000 RK4 steps of 10 au through the kernel, X = |1><2| + |2><1|
     (launch count 4 x nt, trace error and agreement with the driven
     einsum run <= 1e-10, first window against the CPU <= 1e-10, a
     zero-amplitude drive against the undriven run <= 1e-14, a run
     checkpointed every 7 windows against the single run <= 1e-12);
     HEOM absorption at FMO lmax = 1 (the dense Liouvillian, its host
     SVD, 999 RK4 steps through the kernel; card vs CPU <= 1e-10) and
     correlation_2op_1t at the flagship (1000 steps, kernel vs einsum
     <= 1e-10);
   - config #5 (bench.py's _polariton_system, n = 20, complex128; no
     hand-written kernel lies on this path, so every launch count must
     stay 0): SESolver.run under H + E0 cos(w t) mu at 4 of 512 drive
     frequencies for 2000 steps (card vs CPU <= 1e-10), the 512-column
     scan as one batched RK4 for 10,000 steps (its columns against those
     runs at step 2000 <= 1e-12), Floquet quasienergies at 8 frequencies
     (card vs CPU <= 1e-10);
   - LDR (bench.py's flagship method; no hand-written kernel lies on it,
     so every launch count stays 0 outside LDRN.heom): bench.py's
     _ldr_model at level 5 (31^2 grid x 2 states, n = 1,922),
     run(method='dense') against run(method='factored') over 400 steps
     (<= 1e-10), both over 30 steps against a NumPy complex128 copy of
     bench.py's _ldr_f64_truth (<= 1e-8, the project gate), the first
     window against the CPU (<= 1e-10), run_imag against the CPU; level 6
     (n = 7,938) through the row-blocked build, 200 dense steps against
     the factored path (<= 1e-10); level 7 (n = 32,258) factored only,
     400 steps (norm); run_lvn at level 4, NonadiabaticRate on a 1-D
     Eckart LDR (card vs CPU <= 1e-10) and LDRN.heom on a 1-D level-4
     LDR (n = 30) through the coupling kernel (launch count 4 x nt,
     against kernel='einsum' <= 1e-10); with run() steps/s, build
     seconds, device time per step by kernel and peak memory per level
     (the level-6 dense step against its HBM bound);
   - open/ through OQS: OQS.lindblad on config #2's dimer (launch count
     4 x Nt, equal to LindbladSolver), OQS.heom on a spin-boson at lmax 4
     (launch count 4 x nt, against kernel='einsum'), OQS.tcl2 card vs
     CPU, mcsolve with 2,000 trajectories card vs CPU on the same draws
     (<= 1e-10) and against LindbladSolver within 5 standard errors,
     correlation_4p_2t and NRG energies card vs CPU (<= 1e-10);
   - nonadiabatic dynamics (``phase_nonadiabatic``): FSSH on Tully I
     (examples/fssh_tully.py's setup, 20,000 trajectories x 4,000 steps
     of 2 au) against the exact 512-point SPO wavepacket (through the
     SPO kernels, launch counts 2 x nt and nt; populations within 0.02),
     its energy through hops (<= 1e-4), the first 256 trajectories on
     the CPU with the same draws (x, p, |c|^2 <= 1e-10, active
     identical), one EDC ensemble; FSSH on Pyrazine's 3 states (the eager
     batched-eigh step) card vs CPU; Ehrenfest on the same ensemble (energy
     drift, card vs CPU); NAMD against diabatic SPO at 2,048 points
     (populations <= 2e-4, norm <= 1e-4, card vs CPU); Pyrazine.spo() on
     256^2 x 3 (2,000 steps, norm drift <= 1e-10), SpinVibronic.spo() on
     128^2 x 4, VSC (ncav = 10) and VibronicPolariton (2 x 5) on 1,024
     points through the generic SPO branch; ShinMetiu2D.pes (31^2, 64
     positions), LVC and pump-probe (64 delays), card vs CPU <= 1e-10;
     launch counts 0 outside the SPO runs;
   - the explicit-field 2DES (``phase_field2des``): field_2des_rephasing
     through kernel='cuda' on the n = 8 chain (680 ADOs, V = 64) with 4 x 4
     phases x 16 t1 delays = 256 propagations as one batched hierarchy,
     701 RK4 steps (launch count exactly 4 x 701: one launch per
     right-hand side for the whole batch, every one by the
     destination-major kernel; profiled by kernel; peak memory), the same
     run with E3 = 0 (phase cycling cancels it, <= 1e-10 of max|P3|),
     kernel='cuda' against 'einsum' on the card at B = 32 (<= 1e-10), and
     examples/field_2des.py's two-level system card vs CPU (<= 1e-10) with
     its rephasing peak on (-w0, -w0);
   - the rest of grid/ and models/lattice (``phase_grid_rest``), each card
     vs CPU on the same inputs: WPDN (400 Gaussians, nquad 24; eigenvalues
     and 1,000 steps), ThawedGaussian on a Morse potential (10,000 steps
     as CUDA graphs; the CPU over the first 200), NAWPD and VMCG (64
     Gaussians) on examples/vmcg_avoided_crossing.py's model (VMCG also
     against its split-operator reference at 1e-5), QT, QTF and NAQT
     with 100,000 trajectories (NAQT also against SPO), SGCT_LDR at q = 8,
     the 4-D level-6 sparse interpolator, VibrationalDVR3D at 48^3 (6
     eigenpairs by block Davidson), Lippmann-Schwinger at 2,000 points x
     128 k, Fermi-Hubbard at L = 6 (half filling), Rice-Mele bands and
     the surface Green's function; every launch count stays 0;
   - tensor networks (``phase_tn``; no kernel lies on tn/, every launch
     count stays 0): two-site DMRG on the critical TFIM at L = 100,
     chi_max 128, 3 sweeps (rel 7.5e-12 of the free-fermion energy at
     the second; 5 converge to 1e-10), against the free-fermion ground
     energy (rel <= 1e-8), with bond updates/s, host synchronisations
     per bond (sync debug mode), device busy share and peak memory; DMRG
     at L = 20 (chi 32) card vs CPU from the same tensors (energies and
     Schmidt values <= 1e-10); one-site TDVP of the L = 100 ground state
     quenched to h = 2 (energy conserved <= 1e-10; 2 steps, at 5.5 s a
     step) and TDVP2 at chi 64 (drift printed); TDVP at L = 20 card vs
     CPU over 2 steps (the state and <sx_i> <= 1e-10); TEBD at L = 20
     against the same gates on the dense state (<= 1e-8);
     Pyrazine4().spectral_dynamics() at its defaults but 30 steps (60
     there), card vs CPU over the first 20 (<= 1e-8), and at chi 64,
     exact for the
     3 x 8^4 chain, its start padded to chi 64, 20 steps against SciPy's
     expm_multiply of the sparse LVC Hamiltonian from the same
     noise-padded state (<= 1e-8); TT-LDR on
     examples/ttldr_vibronic.py's model at level 5 (31^2 x 2) at full
     ranks against the dense LDRN propagation (<= 1e-8) and at the
     example's ranks (error printed);
   - optimal control (``phase_control``): examples/optimal_control_grape.py's
     three problems with the example's asserts (GRAPE state transfer and
     NOT gate, OpenGRAPE against decay, the Lindblad rate fit through
     the commutator kernel's backward, 100 iterations, 150 in the
     example), loss histories card vs CPU (<= 1e-8; over the first 20 %
     of each problem's iterations, the fit over its first 10),
     OpenGRAPE on config #2's dimer (n = 16, Liouville 256^2, 100
     slices; card vs CPU over 2 iterations), the n = 16 rate fit's
     gradient through kernel='cuda' against kernel='matmul' (<= 1e-10)
     with launches exactly 4 x Nt forward and 4 x Nt - 1 backward, and
     the commutator's backward against the plain version's autograd at
     n = 16, 1024 and 2048 (c128 <= 1e-12, c64 <= 1e-5);
   - quantum chemistry (``phase_qchem``): benzene (D6h) RHF/6-31G*
     (102 AOs; the host integrals: the C++ ERI engine and the
     derivative-ERI builder built with g++, SCF, MP2, TDA and TDHF with 6
     singlet roots, the analytic gradient, the CPHF polarizability,
     Mulliken/IAO charges, Boys orbitals), RKS/B3LYP on the default
     Becke grid (282,240 points) and its analytic gradient, each against
     the port on the host's CPU (SCF energies <= 1e-10, densities and
     orbital energies <= 1e-8, post-SCF methods from the card's orbitals
     <= 1e-10, gradients <= 1e-9, summed oscillator strengths of
     degenerate sets <= 1e-8); CCSD/6-31G (132 spin orbitals):
     converged to 1e-10 and equal to MP2 at the MP2 amplitudes
     (<= 1e-10), seconds an iteration and busy share; water CCSD and (T)
     (6-31G**), EOM-CCSD, FCI, CASCI and CASSCF (STO-3G) card vs CPU;
     examples/qchem_water.py's pipeline, a GeometryOptimizer run, the
     STO-3G Hessian card vs CPU and DMRGQC on H4 against FCI (<= 1e-8);
     no kernel launches; benzene's molecules and mean fields go on to the
     next phase (its ERI and dERI are built once);
   - the rest of qchem/ and models/shinmetiu2e (``phase_qchem_rest``):
     benzene RHF/6-31G* analytic CIS and TDHF forces at the lowest
     non-degenerate singlet and the CIS relaxed dipole (card vs CPU <=
     1e-9; forces summed over the atoms <= 1e-8; the six C and the six H
     radial components equal <= 1e-8; seconds of the Lagrangian, the
     CPHF Jacobian, the Z solve and the fused dERI contraction), MP2
     forces and dipole in 6-31G (<= 1e-9), G0W0 and GW-BSE (an RPA
     problem of 1,701 x 1,701; <= 1e-10), charge_density on a 40^3 cube
     (<= 1e-10 rel) and on 3.11M Becke points (42 electrons <= 1e-6), the
     SOC matrix in the MO basis (<= 1e-12); at the JAX tests' molecules
     (<= 1e-9 unless noted): examples/excited_state_forces.py with its
     asserts, TDDFT/TDA (SVWN), UCIS and UMP2 forces,
     ExcitedGeometryOptimizer's analytic default against the
     central-difference Jacobian (end energy 1e-7, bond 1e-3),
     examples/ab_initio_lvc.py's LVCBuilder path with its asserts (card
     vs CPU 1e-8), water's qubit Hamiltonian in a (4, 4) space under JW
     and BK (lowest penalised eigenvalue = CASCI <= 1e-10), RHF1D, RKS1D,
     CASCIDVR and ElectronDVR3D at 27^3 and 13^3 (<= 1e-10),
     ShinMetiu2e1d.pes at nx = 64 over 64 proton positions (4,096^2
     eigvalsh each; <= 1e-10 and the exchange symmetries equal at the
     CPU's position) and ShinMetiu3d at 17^3 (<= 1e-10); peak memory; no
     kernel launches;
   - negf/ (``phase_negf``): examples/noneq_dmft_quench.py at its
     parameters with its asserts, KBSolver2T with second Born and GW on
     tests/test_kb_gw.py's dimer, equilibrium DMFT at beta = 16 for the
     metal and the insulator, RTTDHF.absorption on H2/6-31G (nt = 6,000;
     peak at TDHF's within 0.01) and the Holstein spectral function, all
     card vs CPU (<= 1e-10 rel); rows per second of the KB march and its
     busy share, RT-TDHF steps/s; no kernel launches;
   - qmc/, md/ and ml/ (``phase_qmc``): QSATS at full width (solid He-4
     on hcp (3, 3, 5), 180 atoms, 6,120 directed pairs, 512 walkers,
     per-atom sweeps, exchange_prob 0.2, 200 sweeps) against the port's
     C++ engine and torch.func autodiff (<= 1e-10), the card against the
     CPU on the same draws over 5 sweeps (<= 1e-10, acceptance decisions
     identical) and its energy against 48 C++ chains on the same schedule
     (the example's 8 K/atom); DMC (65,536 walkers, 2,000 steps) against
     1.5 and dmc_native; PIMC (2,048 x 64 beads) and three harmonic bosons in
     BosonPIMC against the exact energy of their discretised path
     integral; RPMD's Kubo TCF and PILE thermalisation; LJMD with 2,048
     atoms (NVE spread, 20,000 Monte Carlo moves); an MLP fit card vs
     CPU; statistical gates at 5 standard errors; sweeps/s, walker-steps/s,
     device time and busy share of the graphed steps, host calls per sweep
     eager and graphed, peak memory; no kernel launches;
5. timing, for the record (CUDA events over eager calls after warm-up,
   in turns: plain, kernel, library, kernel, plain): kernel, plain
   version and one-call PyTorch yardstick per call (the HEOM coupling
   also as host enqueue per call and as device time of 50 calls replayed
   from a CUDA graph, which leaves the host out); run() steps/s for every
   right-hand side
   (HEOM, 500 - 40 steps), for cuda and xla (SPO 256^3), and for cuda, matmul and
   propagator (Lindblad n = 16) and cuda and matmul (n = 1024); SPO
   build() seconds, torch.profiler breakdowns of the flagship HEOM RK4
   step, of the 256^3 Strang step and of the n = 1024 Lindblad RK4 step,
   and peak device memory; for the 2DES slice, both cube builders end to
   end (ms, maps/s), the factored assembly against its bound, the tdes
   cube, DEOM run() steps/s beside HEOM's at the same hierarchy, and
   torch.profiler breakdowns of the cube builders and the DEOM RK4 step;
   HEOM run() steps/s driven and undriven in turns, the host time of one
   right-hand side driven and undriven by aten op, the device profile of
   HEOMSolver.run's own step driven and undriven, and SESolver.run()
   steps/s at config #5.

Timing also covers the generic SPO potential branch at 2^20 x 10,
1,024 x 10 and 4,096 x 200 against torch.matmul and its bound, the
nonadiabatic runs' steps/s, aten ops and device time per step and busy
share, and the batched HEOM coupling at the field-2DES shape (B = 256)
against its plain version and its bound, with both designs at B = 1, 2,
7, 16, 32 and 256 (complex128 and complex64), which sets the batch from
which the wrapper takes the destination-major kernel; and the
commutator's backward (the kernel on -H_eff^dag and the cotangent) at
n = 1024 against the plain backward and two ZGEMMs (its kernels entry
``liouvillian_commutator_backward``).

The line before the last is a JSON summary of the kernels (the generic
SPO branch as ``spo_potential_generic``, timed at the main path's
1,024 x 10 with its 2^20-point times beside; the batched coupling as
``heom_coupling_batched``), with the 2DES, DEOM, driven-HEOM, polariton,
LDR, open, nonadiabatic, field-2DES, grid, tn, control, qchem, qchem_rest,
negf and qmc gates and times under "slices" (each phase's seconds under "phase_s", also logged
as it ends);
the last line
is {"ok": true, "device": {...}}. Without a CUDA device it raises before
printing any result.

    python3 chip_smoke.py --ab PARENT [PAIRS]

compares the HEOM main path of the package in another checkout PARENT
(for example the parent commit, unpacked with ``git archive <commit>
pyqed_tpu_torch | tar -x -C build/parent``) with this one's in one
process: run() steps/s in PAIRS alternating pairs (12 by default), the
right-hand side's time per call, and the coupling per call, unbatched
at the flagship and batched at the field-2DES shape (chain8, B = 256)
(:func:`ab_main`).
"""
import glob
import json
import math
import os
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(temperature=300.0, lmax=3, nexp=1, decomposition="pade")
DT = 10.0          # au
NT = 4000          # 4000 x 10 au = 967.6 fs
NOUT = 40
DEVICE = "cuda"

SPO_N = 256        # the chip-scale grid of bench.py's bench_spo3_tpu
SPO_NS = 2
SPO_DT = 0.004
SPO_NT = 200
SPO_NOUT = 20
RAGGED = (37, 41, 29)
MORSE_NT = 10000   # examples/spo_morse.py: 10000 steps of 0.02

LB_NVIB = 8        # config #2 as bench.py builds it: n = 2 * 8 = 16
LB_DT = 0.002
LB_NT = 4000
LB_NOUT = 50
LB_BENCH_NT = 400000   # bench.py's bench_lindblad_tpu: 400,000 steps
LB_BIG_NVIB = 512  # chip scale: n = 1024
LB_BIG_NT = 200
LB_BIG_NOUT = 20
COMM_SIZES = (16, 37, 1000, 1024)
COMM_C128_ONLY = (2048,)
COMM_TIME_SIZES = (1024, 2048)

PE_NW = 512        # bench.py bench_2des_tpu: 512 x 512 (omega1, omega3)
PE_NT2 = 256       # x 256 t2 delays over [0, 30]
PE_CHECK = (64, 8)            # card vs CPU: 64^2 x 8 t2
DIMER_IDX = dict(g_idx=[0], e_idx=[1, 2], f_idx=[3])
TD_NT = 512        # tdes: t1 = t3 = 512 points of dt = 0.5
TD_DT = 0.5
TD_NT2 = 64        # x 64 t2 over [0, 30]
TD_CHECK = (64, 8)            # card vs CPU: 64 x 8 x 64
RESOLVENT_NW = 16
RESOLVENT_CM = (50.0, 600.0)  # omega_x grid, cm^-1; omega_y = -omega_x
RESOLVENT_T_FS = 2.0
RESOLVENT_NT_T = 40           # RK4 steps of e^{Delta T}
GMRES_TOL = 1e-8

# H100 SXM data sheet: HBM3 bytes/s; flop/s of FP64 (tensor cores) and of
# FP32 (outside them), both 67e12
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12


def log(msg):
    print(msg, flush=True)


def bound_ms(nbytes, flops):
    """The least time for the work: bytes at the HBM rate or flops at the
    peak rate, whichever is larger (ms, and which)."""
    t_b = nbytes / PEAK_BYTES
    t_f = flops / PEAK_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def kernel_wrappers():
    from pyqed_tpu_torch.ops import kernels as kn
    return {"heom_coupling": kn.heom_coupling,
            "spo_phase": kn.spo_phase_multiply,
            "spo_potential": kn.spo_potential_apply,
            "liouvillian_commutator": kn.liouvillian_commutator}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0
    kernel_wrappers()["heom_coupling"].batched_launches = 0
    kernel_wrappers()["liouvillian_commutator"].backward_launches = 0


def batched_launches():
    """The destination-major coupling kernel's launches (a part of
    heom_coupling's, not in :func:`read_counts`)."""
    return kernel_wrappers()["heom_coupling"].batched_launches


def read_counts():
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


# ------------------------------------------------------------------ 1
def phase_environment():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off")
    return card


# ------------------------------------------------------------------ 2
def phase_build():
    from pyqed_tpu_torch.ops import _cuda_lib
    names = list(_cuda_lib.SIGNATURES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_cuda_lib.load, names))
    log(f"[build] {len(names)} sources in {time.perf_counter() - t0:.1f} s "
        "wall, nvcc in parallel")
    for b in built:
        log(f"[build] {b.path.name}: nvcc {b.seconds:.1f} s")
        for line in b.log.splitlines():
            if line.strip():
                log(f"[build] {line.strip()}")
    for name, what in (("liouvillian", "the complex128 commutator"),
                       ("heom_coupling", "the batched complex128 coupling "
                        "(destination-major)")):
        lib = built[names.index(name)].path
        ops = re.findall(r"\bDMMA[.\w]*", sass_of(lib))
        log(f"[build] {lib.name}: {len(ops)} DMMA instructions in its SASS "
            f"({', '.join(sorted(set(ops)))}): {what} runs on the FP64 "
            "tensor cores")
        if not ops:
            raise AssertionError(f"no DMMA instruction in {lib}")


def sass_of(path):
    """cuobjdump -sass of a library, with cuobjdump from the CUDA toolkit
    or from the triton package."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        cands += glob.glob(os.path.join(os.path.dirname(triton.__file__),
                                        "backends", "nvidia", "bin",
                                        "cuobjdump"))
    except ImportError:
        pass
    tool = next((c for c in cands if os.path.isfile(c)), None)
    if tool is None:
        raise RuntimeError("cuobjdump not found in the CUDA toolkit or triton")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


# ------------------------------------------------------------------ 3
def chain_solver():
    """The n = 8 exciton chain (ground + 7 sites) with per-site Drude
    baths, Pade-decomposed to 2 terms per site: M = 14, lmax = 3."""
    from pyqed_tpu_torch import DrudeBath, HEOMSolver
    rng = np.random.default_rng(0)
    nsite = 7
    n = nsite + 1
    H = np.zeros((n, n))
    E = 1.0 + 0.1 * rng.standard_normal(nsite)
    for i in range(nsite):
        H[1 + i, 1 + i] = E[i]
    for i in range(nsite - 1):
        H[1 + i, 2 + i] = H[2 + i, 1 + i] = 0.05
    c, nu = DrudeBath(temperature=0.25, cutoff=0.25, reorg=0.02).pade(1)
    bath = []
    for site in range(nsite):
        Q = np.zeros((n, n))
        Q[1 + site, 1 + site] = 1.0
        bath.append((Q, c, nu))
    return HEOMSolver(H, bath=bath, lmax=3, device=DEVICE)


def coupling_operands(sol, dtype):
    """Kernel operands of a solver's hierarchy, with F from a numpy seed."""
    from pyqed_tpu_torch.ops import kernels as kn
    keys, plus_idx, minus_idx, Q, c, _ = sol._build(dtype)
    _, OpT, nbr, w = kn.heom_coupling_operands(sol._H_np, Q, c, keys,
                                               plus_idx, minus_idx)
    rng = np.random.default_rng(SEED)
    nado, V = keys.shape[0], OpT.shape[-1]
    F = rng.standard_normal((nado, V)) + 1j * rng.standard_normal((nado, V))
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    return (torch.as_tensor(F, dtype=dtype, device=DEVICE),
            torch.as_tensor(nbr, device=DEVICE),
            torch.as_tensor(w, dtype=rdt, device=DEVICE),
            torch.as_tensor(OpT, dtype=dtype, device=DEVICE))


def coupling_bound(F, nbr, w, OpT):
    """Bytes (each operand read once, out written once) and flops (one
    V x V complex row product per existing hierarchy edge and batch row)
    of one call; F is (nado, V) or (nado, B, V)."""
    V = F.shape[-1]
    batch = F.numel() // (F.shape[0] * V)
    nbytes = sum(t.numel() * t.element_size() for t in (F, nbr, w, OpT, F))
    edges = int((nbr >= 0).sum().item())
    return bound_ms(nbytes, 8 * V * V * edges * batch)


def batched_operands(sol, dtype, B):
    """The kernel operands of a solver's hierarchy with a batch of B
    hierarchies, F (nado, B, V) from a numpy seed."""
    _, nbr, w, OpT = coupling_operands(sol, dtype)
    rng = np.random.default_rng(SEED + B)
    shape = (nbr.shape[0], B, OpT.shape[-1])
    F = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(F, dtype=dtype, device=DEVICE), nbr, w, OpT


def check_close(label, out, ref, tol):
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    log(f"[parity] {label}: max abs err {err:.3e}, rel {rel:.3e} "
        f"(tol {tol:g})")
    if not (np.isfinite(rel) and rel <= tol):
        raise AssertionError(f"kernel disagrees with plain version at "
                             f"{label}: rel {rel:.3e}")
    return err


def phase_parity(shapes):
    """The coupling kernel against its plain version on every hierarchy,
    unbatched, and with a batch of B hierarchies (F (nado, B, V)) at
    each B of PARITY_BATCHES on the flagship and chain shapes, through
    both designs (the wrapper picks one by B; the destination-major one
    keeps no partials buffer)."""
    from pyqed_tpu_torch.ops import kernels as kn
    errs = {}
    for name, sol in shapes.items():
        for dtype, tol in ((torch.complex128, 1e-12), (torch.complex64, 1e-5)):
            F, nbr, w, OpT = coupling_operands(sol, dtype)
            out = kn.heom_coupling(F, nbr, w, OpT)
            ref = kn.heom_coupling_ref(F, nbr, w, OpT)
            errs[(name, dtype)] = check_close(
                f"heom_coupling {name} nado={F.shape[0]} V={F.shape[1]} "
                f"nj={OpT.shape[0]} {str(dtype)[6:]}", out, ref, tol)
            if name not in ("fmo", "chain8"):
                continue
            for B in PARITY_BATCHES:
                F, nbr, w, OpT = batched_operands(sol, dtype, B)
                plan = kn.heom_coupling_plan(nbr, w)
                ref = kn.heom_coupling_ref(F, nbr, w, OpT)
                for batched in (False, True):
                    out = kn._coupling_launch(F, OpT, plan, batched)
                    design = ("destination-major" if batched
                              else "edge-major")
                    errs[(name, dtype, B, batched)] = check_close(
                        f"heom_coupling batched {name} nado={F.shape[0]} "
                        f"B={B} V={F.shape[-1]} {str(dtype)[6:]} {design}",
                        out, ref, tol)
                partial = plan.launch_args[(F.shape[-1], B, True)][3]
                if partial is not None:
                    raise AssertionError("the destination-major launch "
                                         "keeps a partials buffer")
                # the wrapper takes the design its threshold names
                reset_counts()
                out = kn.heom_coupling(F, nbr, w, OpT, plan=plan)
                if batched_launches() != int(kn.coupling_batched(F)):
                    raise AssertionError(f"heom_coupling at B = {B} took the "
                                         "other design")
                errs[(name, dtype, B)] = check_close(
                    f"heom_coupling batched {name} B={B} {str(dtype)[6:]} "
                    "through the wrapper", out, ref, tol)
                del out, ref, F
    return errs


def spo_inputs(kind, shape, ns, dtype, states_first, seed=SEED):
    """Operator and state of one SPO kernel drawn on the card from a seeded
    generator (up to 2^20 x 10 x 10 entries: drawn on the host they took
    most of the parity phase); states_first gives psi the layout a batched
    FFT returns."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32

    def rand(*sh):
        return torch.randn(sh, generator=gen, dtype=rdt, device=DEVICE)

    def crand(*sh):
        return torch.complex(rand(*sh), rand(*sh))

    psi = (crand(ns, *shape).movedim(0, -1) if states_first
           else crand(*shape, ns))
    if kind == "phase":
        theta = rand(*shape)
        op = torch.polar(torch.ones_like(theta), theta)
    else:
        op = crand(*shape, ns, ns)
    return op, psi


SPO_FNS = {"phase": ("spo_phase_multiply", "spo_phase_multiply_ref"),
           "potential": ("spo_potential_apply", "spo_potential_apply_ref")}


def spo_bound(kind, npts, ns, dtype):
    """Bytes and flops of one SPO kernel call (each operand read once,
    the output written once)."""
    c = 16 if dtype == torch.complex128 else 8
    if kind == "phase":
        return bound_ms(npts * (2 * ns * c + c), 6 * ns * npts)
    return bound_ms(npts * (ns * ns * c + 2 * ns * c), 8 * ns * ns * npts)


def phase_spo_parity():
    from pyqed_tpu_torch.ops import kernels as kn
    errs = {}
    full = (SPO_N,) * 3
    for kind, (wrap, ref) in SPO_FNS.items():
        for dtype, tol in ((torch.complex128, 1e-12), (torch.complex64, 1e-5)):
            cases = ([(full, SPO_NS, True)]
                     + [(shape, ns, sf) for shape, ns in
                        ((RAGGED, 3), (RAGGED, NS10), ((POL_NX,), NS10),
                         ((NS10_N,), NS10), ((NS_WIDE_N,), NS_WIDE))
                        for sf in (False, True)])
            for shape, ns, sf in cases:
                op, psi = spo_inputs(kind, shape, ns, dtype, sf)
                out = getattr(kn, wrap)(op, psi)
                if out.is_cuda and out.stride() != psi.stride():
                    raise AssertionError(f"{wrap}: output strides "
                                         f"{out.stride()} != {psi.stride()}")
                label = (f"spo_{kind} {'x'.join(map(str, shape))} x {ns} "
                         f"{'states-first' if sf else 'states-last'} "
                         f"{str(dtype)[6:]}")
                errs[(kind, shape, sf, dtype)] = check_close(
                    label, out, getattr(kn, ref)(op, psi), tol)
                del op, psi, out
    return errs


# ------------------------------------------------------------------ 4
def checked_run(m, sol, nt, label):
    """Run through the default (kernel) path, counting launches, then the
    plain einsum path on the same card; check both."""
    from pyqed_tpu_torch.units import au2fs
    rho0, e_ops = m.initial_state(0), m.site_projectors()
    reset_counts()
    t0 = time.perf_counter()
    res = sol.run(rho0, dt=DT, nt=nt, nout=NOUT, e_ops=e_ops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["heom_coupling"]
    nwin = nt // NOUT
    obs = res.observables
    if tuple(obs.shape) != (nwin + 1, m.nsites) or not bool(
            torch.isfinite(torch.view_as_real(obs)).all()):
        raise AssertionError(f"{label}: bad observables {tuple(obs.shape)}")
    pops = obs.real
    trace_err = (pops.sum(dim=1) - 1.0).abs().max().item()
    res_e = sol.run(rho0, dt=DT, nt=nt, nout=NOUT, e_ops=e_ops,
                    kernel="einsum")
    diff = max((obs - res_e.observables).abs().max().item(),
               (res.ado - res_e.ado).abs().max().item())
    p = pops[-1].cpu().numpy()
    log(f"[main] {label}: nado={res.ado.shape[0]} nt={nt} "
        f"({nt * DT * au2fs:.1f} fs) in {wall:.2f} s, kernel launches "
        f"{counts} (expected heom_coupling {4 * nt}), trace err "
        f"{trace_err:.2e}, |kernel - einsum| {diff:.2e}, final populations "
        + " ".join(f"{x:.4f}" for x in p))
    if counts != {"heom_coupling": 4 * nt, "spo_phase": 0,
                  "spo_potential": 0, "liouvillian_commutator": 0}:
        raise AssertionError(f"{label}: launches {counts}, expected "
                             f"heom_coupling {4 * nt} and no other")
    if batched_launches() != 0:
        raise AssertionError(f"{label}: the unbatched run launched the "
                             "destination-major kernel")
    if not trace_err <= 1e-10:
        raise AssertionError(f"{label}: trace error {trace_err:.3e}")
    if not diff <= 1e-10:
        raise AssertionError(f"{label}: kernel and einsum runs differ by "
                             f"{diff:.3e}")
    return res, launches


def phase_main():
    from pyqed_tpu_torch import FMO
    m = FMO()
    sol = m.heom(**FLAGSHIP, device=DEVICE)
    res, launches = checked_run(m, sol, NT, "FMO flagship nexp=1")
    # the first window against the same run on the CPU
    cpu = m.heom(**FLAGSHIP, device="cpu").run(
        m.initial_state(0), dt=DT, nt=NOUT, nout=NOUT,
        e_ops=m.site_projectors())
    d = (res.observables[:2].cpu() - cpu.observables).abs().max().item()
    log(f"[main] first window vs CPU einsum run: max |diff| {d:.2e}")
    if not d <= 1e-12:
        raise AssertionError(f"card and CPU runs differ by {d:.3e}")
    sol2 = m.heom(**dict(FLAGSHIP, nexp=2), device=DEVICE)
    checked_run(m, sol2, 400, "FMO nexp=2")
    phase_underdamped()
    return launches


def phase_underdamped(nt=2000, dt=0.05, nout=100):
    """A two-level system under an underdamped bath (complex rates, as
    tests/test_torch_heom.py's test_complex_rates_match_jax_einsum) through
    the coupling kernel, against kernel='matmul' on the same card."""
    from pyqed_tpu_torch import HEOMSolver
    H = np.diag([0.0, 1.0])
    Q = np.array([[0.0, 1.0], [1.0, 0.0]])
    bath = [(Q, [0.05 + 0.02j, 0.05 - 0.02j], [0.3 + 0.5j, 0.3 - 0.5j])]
    sol = HEOMSolver(H, bath=bath, lmax=4, device=DEVICE)
    rho0 = np.diag([0.0, 1.0])
    kw = dict(dt=dt, nt=nt, nout=nout, e_ops=[np.diag([0.0, 1.0])])
    torch.cuda.synchronize()
    reset_counts()
    res = sol.run(rho0, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    res_m = sol.run(rho0, kernel="matmul", **kw)
    diff = max((res.observables - res_m.observables).abs().max().item(),
               (res.ado - res_m.ado).abs().max().item())
    finite = bool(torch.isfinite(torch.view_as_real(res.ado)).all())
    p1 = res.observables[-1, 0].real.item()
    log(f"[main] underdamped two-level bath (complex rates) lmax=4 "
        f"nado={res.ado.shape[0]} nt={nt}: kernel launches {counts} "
        f"(expected heom_coupling {4 * nt}), |cuda - matmul| {diff:.2e} "
        f"(tol 1e-10), final excited population {p1:.6f}")
    if counts != {"heom_coupling": 4 * nt, "spo_phase": 0, "spo_potential": 0,
                  "liouvillian_commutator": 0}:
        raise AssertionError(f"underdamped bath: launches {counts}")
    if not (finite and diff <= 1e-10):
        raise AssertionError(f"underdamped bath: cuda and matmul differ by "
                             f"{diff:.3e}")


def spo3_model(n, span=7.0):
    """3D two-state coupled-harmonic diabatic model on an n^3 grid, as
    bench.py's _spo3_model builds it: surfaces v1, v2, coupling c,
    kinetic k^2/2 and the ground-state packet displaced to x = -1."""
    x = np.linspace(-span, span, n, endpoint=False)
    dx = x[1] - x[0]
    shape3 = (n, n, n)
    X = x[:, None, None]
    Y = x[None, :, None]
    Z = x[None, None, :]
    R2 = np.broadcast_to(X ** 2 + Y ** 2 + Z ** 2, shape3)
    v1 = 0.5 * R2
    v2 = 0.5 * (np.broadcast_to((X - 1.0) ** 2 + Y ** 2 + Z ** 2,
                                shape3)) + 1.0
    c = 0.2 * np.exp(-0.5 * R2)
    k = 2 * np.pi * np.fft.fftfreq(n, dx)
    k2 = (k[:, None, None] ** 2 + k[None, :, None] ** 2
          + k[None, None, :] ** 2) / 2.0
    psi0 = np.exp(-((X + 1.0) ** 2 + Y ** 2 + Z ** 2) / 2.0)
    psi0 = np.broadcast_to(psi0, shape3).copy()
    psi0 /= np.sqrt(np.sum(psi0 ** 2) * dx ** 3)
    return x, v1, v2, c, k2, psi0


def spo3_phase_ops(v1, v2, c, k2, dt):
    """Closed-form 2x2 Hermitian potential half-step propagator
    exp(-i V dt/2) = e^{-i m dt/2}[cos(r dt/2) I - i sin(r dt/2)/r
    (d sz + c sx)], m = (v1+v2)/2, d = (v1-v2)/2, and expK."""
    m = 0.5 * (v1 + v2)
    d = 0.5 * (v1 - v2)
    r = np.sqrt(d * d + c * c)
    r_safe = np.where(r == 0, 1.0, r)
    th = dt / 2.0
    cosr = np.cos(r * th)
    sinc = np.sin(r * th) / r_safe
    ph = np.exp(-1j * m * th)
    u00 = ph * (cosr - 1j * sinc * d)
    u01 = ph * (-1j * sinc * c)
    u11 = ph * (cosr + 1j * sinc * d)
    return u00, u01, u11, np.exp(-1j * k2 * dt)


def spo3_solver(n, kernel=None):
    """The port's SPO3 on the card for the n^3 model, and psi0 in
    state 0."""
    from pyqed_tpu_torch import SPO3
    x, v1, v2, c, _, g = spo3_model(n)
    sol = SPO3(x, x, x, masses=[1.0, 1.0, 1.0], nstates=SPO_NS,
               kernel=kernel, device=DEVICE)
    sol.set_DPES([v1, v2], [[(0, 1), c]])
    psi0 = torch.zeros((n, n, n, SPO_NS), dtype=torch.complex128,
                       device=DEVICE)
    psi0[..., 0] = torch.as_tensor(g, device=DEVICE)
    return sol, psi0


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def phase_spo_main():
    """The 256^3 SPO3 run through the kernels, checked; returns the
    launch counts of that run and the solver for the timing phase."""
    torch.cuda.reset_peak_memory_stats()
    sol, psi0 = spo3_solver(SPO_N)
    kw = dict(dt=SPO_DT, nt=SPO_NT, nout=SPO_NOUT, return_states=False)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = sol.run(psi0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    nwin = SPO_NT // SPO_NOUT
    pops = res.population
    if (tuple(pops.shape) != (nwin + 1, SPO_NS)
            or tuple(res.psi.shape) != (SPO_N,) * 3 + (SPO_NS,)
            or not bool(torch.isfinite(torch.view_as_real(res.psi)).all())
            or not bool(torch.isfinite(torch.view_as_real(res.rho_el)).all())):
        raise AssertionError("SPO3: bad result shapes or non-finite values")
    norms = pops.sum(dim=1)
    drift = (norms - norms[0]).abs().max().item()
    sol.kernel = "xla"
    res_x = sol.run(psi0, **kw)
    sol.kernel = None
    d_psi = rel(res.psi, res_x.psi)
    d_rho = rel(res.rho_el, res_x.rho_el)
    p = pops[-1].cpu().numpy()
    log(f"[main] SPO3 {SPO_N}^3 x {SPO_NS} complex128 nt={SPO_NT} in "
        f"{wall:.2f} s (build included), kernel launches {counts} "
        f"(expected spo_potential {2 * SPO_NT}, spo_phase {SPO_NT}), "
        f"norm drift {drift:.2e}, |cuda - xla| rel psi {d_psi:.2e} "
        f"rho_el {d_rho:.2e}, final populations {p[0]:.6f} {p[1]:.6f}")
    if counts != {"heom_coupling": 0, "spo_phase": SPO_NT,
                  "spo_potential": 2 * SPO_NT, "liouvillian_commutator": 0}:
        raise AssertionError(f"SPO3: launches {counts}")
    if not drift <= 1e-10:
        raise AssertionError(f"SPO3: norm drift {drift:.3e}")
    if not (d_psi <= 1e-12 and d_rho <= 1e-12):
        raise AssertionError(f"SPO3: cuda and xla runs differ: psi "
                             f"{d_psi:.3e}, rho_el {d_rho:.3e}")
    if not p[1] > 1e-6:
        raise AssertionError("SPO3: no population transfer")
    log(f"[main] SPO3 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, sol, psi0


def phase_spo_numpy_check(n=64, steps=10):
    """The first steps at n^3 against a NumPy complex128 Strang loop with
    the closed-form 2x2 propagator (as bench.py's parity gate)."""
    sol, psi0 = spo3_solver(n)
    res = sol.run(psi0, dt=SPO_DT, nt=steps, nout=steps,
                  return_states=False)
    _, v1, v2, c, k2, g = spo3_model(n)
    u00, u01, u11, expK = spo3_phase_ops(v1, v2, c, k2, SPO_DT)
    p = np.zeros((n, n, n, 2), np.complex128)
    p[..., 0] = g

    def vhalf(p):
        q = np.empty_like(p)
        q[..., 0] = u00 * p[..., 0] + u01 * p[..., 1]
        q[..., 1] = u01 * p[..., 0] + u11 * p[..., 1]
        return q

    for _ in range(steps):
        p = vhalf(p)
        p = np.fft.ifftn(np.fft.fftn(p, axes=(0, 1, 2)) * expK[..., None],
                         axes=(0, 1, 2))
        p = vhalf(p)
    dev = res.psi.cpu().numpy()
    err = float(np.max(np.abs(dev - p)) / np.max(np.abs(p)))
    log(f"[main] SPO3 {n}^3 first {steps} steps vs NumPy complex128 Strang "
        f"loop: rel {err:.2e} (tol 1e-10)")
    if not err <= 1e-10:
        raise AssertionError(f"SPO3 {n}^3 differs from NumPy: {err:.3e}")


def phase_morse():
    """examples/spo_morse.py on the card: kernels vs kernel='dft'."""
    from pyqed_tpu_torch import SPO, gwp
    x = np.linspace(-3, 12, 512, endpoint=False)
    D, a, m = 2.0, 0.5, 20.0
    psi0 = gwp(x, a=np.sqrt(2 * D * a * a * m), x0=0.3)
    out = {}
    for k in (None, "dft"):
        s = SPO(x, mass=m, kernel=k, device=DEVICE)
        s.set_potential(D * (1 - np.exp(-a * (x - 1.0))) ** 2)
        out[k] = s.run(psi0, dt=0.02, nt=MORSE_NT, nout=100)
    torch.cuda.synchronize()
    d = max((out[None].psi - out["dft"].psi).abs().max().item(),
            (out[None].population - out["dft"].population).abs().max().item())
    drift = abs(out[None].population[-1].sum().item() - 1.0)
    log(f"[main] Morse 512 points nt={MORSE_NT}: |kernels - dft| {d:.2e} "
        f"(tol 1e-10), norm drift {drift:.2e}")
    if not d <= 1e-10:
        raise AssertionError(f"Morse: kernel and dft runs differ by {d:.3e}")


# ------------------------------------------------ 4, the 2DES slice
def dimer_system():
    """The excitonic dimer of bench.py:382 (_dimer_system): g, e1, e2, f
    with transition dipoles and decay rates."""
    E = np.array([0.0, 1.0, 1.15, 2.1])
    dip = np.zeros((4, 4))
    dip[0, 1] = dip[1, 0] = 1.0
    dip[0, 2] = dip[2, 0] = 0.7
    dip[1, 3] = dip[3, 1] = 0.8
    dip[2, 3] = dip[3, 2] = 1.1
    gamma = np.array([0.0, 0.02, 0.025, 0.04])
    return E, dip, gamma


def dimer_mol():
    from pyqed_tpu_torch import Mol
    E, dip, gamma = dimer_system()
    m = Mol(np.diag(E), edip=dip)
    m.gamma = gamma
    return m


def pe_cube(builder, nw, nt2, device):
    """The photon-echo cube of the dimer, (nt2, nw, nw): pump = probe =
    linspace(0.7, 1.45, nw), t2 = linspace(0, 30, nt2), as bench.py's
    bench_2des_tpu builds it (complex128 here)."""
    from pyqed_tpu_torch.signal import sos
    w = np.linspace(0.7, 1.45, nw)
    t2s = np.linspace(0.0, 30.0, nt2)
    fn = {"series": sos.photon_echo_t2series,
          "factored": sos.photon_echo_t2series_factored}[builder]
    return fn(dimer_mol(), w, w, t2s, device=device, **DIMER_IDX)


def td_grids(nt, nt2):
    t = TD_DT * np.arange(nt)
    return t, np.linspace(0.0, 30.0, nt2), t


def finite(t):
    return bool(torch.isfinite(torch.view_as_real(t)).all())


def against_cpu(label, card, cpu, tol):
    d = rel(card, cpu.to(card.device))
    log(f"[2des] {label}: card vs CPU rel {d:.2e} (tol {tol:g})")
    if not d <= tol:
        raise AssertionError(f"{label}: card and CPU differ by rel {d:.3e}")
    return d


def phase_2des():
    """The photon-echo cube at the bench shape through both builders, with
    the launch counts read around it; the builders against each other on
    the card and against the CPU at a small shape."""
    out = {}
    nw, nt2 = PE_NW, PE_NT2
    for builder in ("series", "factored"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        S = pe_cube(builder, nw, nt2, DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        expect_only(counts, "heom_coupling", 0, f"photon echo {builder}")
        if tuple(S.shape) != (nt2, nw, nw) or S.dtype != torch.complex128 \
                or not finite(S):
            raise AssertionError(f"photon echo {builder}: {tuple(S.shape)} "
                                 f"{S.dtype}, finite {finite(S)}")
        out[builder] = S
        log(f"[2des] photon-echo cube {builder}: {nt2} x {nw} x {nw} "
            f"complex128 ({S.numel() * 16 / 1e9:.2f} GB) in {wall:.3f} s "
            f"(first call), launches {counts}, max |S| "
            f"{S.abs().max().item():.4e}")
    d_sf = rel(out["factored"], out["series"])
    log(f"[2des] factored vs series at {nt2} x {nw}^2: rel {d_sf:.2e} "
        "(tol 1e-12)")
    if not d_sf <= 1e-12:
        raise AssertionError(f"photon echo: builders differ by rel {d_sf:.3e}")
    # the first and last t2 maps at full width, on the CPU
    from pyqed_tpu_torch.signal import sos
    w = np.linspace(0.7, 1.45, nw)
    ends = [0, nt2 - 1]
    cpu = sos.photon_echo_t2series(dimer_mol(), w, w,
                                   np.linspace(0.0, 30.0, nt2)[ends],
                                   device="cpu", **DIMER_IDX)
    errs = {"factored_vs_series": d_sf,
            "series_ends_vs_cpu": against_cpu(
                f"photon-echo series t2 maps {ends} at {nw}^2",
                out["series"][ends], cpu, 1e-12)}
    del out
    cw, ct = PE_CHECK
    for builder in ("series", "factored"):
        errs[f"{builder}_vs_cpu"] = against_cpu(
            f"photon-echo {builder} {ct} x {cw}^2",
            pe_cube(builder, cw, ct, DEVICE), pe_cube(builder, cw, ct, "cpu"),
            1e-12)
    return errs


def phase_tdes():
    """Time-domain 2DES (R and its 2-D FFT S) of the dimer at 512 x 64 x
    512 with the launch counts read around it; against the CPU at
    64 x 8 x 64."""
    from pyqed_tpu_torch.signal import tdes
    t1, t2, t3 = td_grids(TD_NT, TD_NT2)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    R, S, w1, w3 = tdes.twodes(dimer_mol(), t1, t2, t3, device=DEVICE,
                               **DIMER_IDX)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_only(counts, "heom_coupling", 0, "tdes")
    shape = (TD_NT, TD_NT2, TD_NT)
    for name, x in (("R", R), ("S", S)):
        if tuple(x.shape) != shape or not finite(x):
            raise AssertionError(f"tdes {name}: {tuple(x.shape)}, finite "
                                 f"{finite(x)}")
    log(f"[2des] tdes.twodes {TD_NT} x {TD_NT2} x {TD_NT} (dt {TD_DT}): R "
        f"and S {R.numel() * 16 / 1e6:.0f} MB each, in {wall:.3f} s (first "
        f"call), launches {counts}, max |R| {R.abs().max().item():.4e}")
    del R, S
    cn, cn2 = TD_CHECK
    t1, t2, t3 = td_grids(cn, cn2)
    card = tdes.twodes(dimer_mol(), t1, t2, t3, device=DEVICE, **DIMER_IDX)
    cpu = tdes.twodes(dimer_mol(), t1, t2, t3, device="cpu", **DIMER_IDX)
    return {"R_vs_cpu": against_cpu(f"tdes R {cn} x {cn2} x {cn}", card[0],
                                    cpu[0], 1e-12),
            "S_vs_cpu": against_cpu(f"tdes S {cn} x {cn2} x {cn}", card[1],
                                    cpu[1], 1e-12)}


def fmo_deom(lmax):
    """The FMO flagship as a DEOM problem on the card: one Drude bath per
    site through its projector, with FMO().heom(**FLAGSHIP)'s
    temperature, cutoff, reorganisation and Pade decomposition."""
    from pyqed_tpu_torch import FMO, DEOMBath, DEOMSolver
    from pyqed_tpu_torch.units import au2k
    m = FMO()
    bath = DEOMBath.drude(temperature=FLAGSHIP["temperature"] / au2k,
                          cutoff=m.cutoff, reorg=m.reorg,
                          npsd=FLAGSHIP["nexp"], nmod=m.nsites,
                          decomposition=FLAGSHIP["decomposition"])
    Q = torch.stack(m.site_projectors())
    return m, DEOMSolver(system=m.H, bath=bath, coupling=Q, lmax=lmax,
                         device=DEVICE)


def phase_deom():
    """DEOM run() at the FMO flagship hierarchy (680 ADOs) for 4000 RK4
    steps of 10 au, against the port's HEOMSolver with the coupling kernel
    (the scaled and unscaled hierarchies give the same rho_0(t))."""
    m, sol = fmo_deom(FLAGSHIP["lmax"])
    rho0 = m.initial_state(0)
    kw = dict(dt=DT, nt=NT, nout=NOUT)
    res, counts, wall = counted_run(sol, rho0, "DEOM FMO",
                                    p1=m.site_projectors()[0], **kw)
    expect_only(counts, "heom_coupling", 0, "DEOM FMO")
    nado = res.ado.shape[0]
    heom = m.heom(**FLAGSHIP, kernel="cuda", device=DEVICE)
    ref, counts_h, wall_h = counted_run(heom, rho0, "HEOM FMO",
                                        e_ops=m.site_projectors(), **kw)
    expect_only(counts_h, "heom_coupling", 4 * NT, "HEOM FMO reference")
    d_rho = (res.states - ref.states).abs().max().item()
    d_p1 = (res.observables[:, 0] - ref.observables[:, 0]).abs().max().item()
    trace = torch.diagonal(res.states, dim1=-2, dim2=-1).sum(-1)
    trace_err = (trace - 1.0).abs().max().item()
    log(f"[deom] FMO lmax={FLAGSHIP['lmax']} nado={nado} N={nado * 49} "
        f"nt={NT} dt={DT} in {wall:.2f} s, launches {counts}; HEOM "
        f"kernel='cuda' in {wall_h:.2f} s (heom_coupling "
        f"{counts_h['heom_coupling']}); |rho_0 deom - heom| {d_rho:.2e}, "
        f"|p_1| {d_p1:.2e} (tol 1e-8), trace err {trace_err:.2e} (tol "
        f"1e-10), final p_1 {res.observables[-1, 0].real.item():.6f}")
    if nado != 680:
        raise AssertionError(f"DEOM FMO: {nado} ADOs, expected 680")
    if not max(d_rho, d_p1) <= 1e-8:
        raise AssertionError(f"DEOM and HEOM differ by {max(d_rho, d_p1):.3e}")
    if not trace_err <= 1e-10:
        raise AssertionError(f"DEOM trace error {trace_err:.3e}")
    return {"vs_heom": max(d_rho, d_p1), "trace_err": trace_err,
            "run_s": wall, "nado": nado}


def resolvent_problem(lmax):
    """The FMO hierarchy, the site operator X = |1><2| + |2><1| for all
    four actions ('llll'), rho0 = |1><1|, T = 2 fs, and the grid omega_x =
    linspace(50, 600, 16) cm^-1, omega_y = -omega_x: the one-exciton
    splittings, clear of omega = 0 (where -Delta is singular)."""
    from pyqed_tpu_torch.units import au2fs, au2wavenumber
    m, sol = fmo_deom(lmax)
    X = np.zeros((m.nsites, m.nsites))
    X[0, 1] = X[1, 0] = 1.0
    wx = np.linspace(*RESOLVENT_CM, RESOLVENT_NW) / au2wavenumber
    return sol, (X, X, X, X, m.initial_state(0), RESOLVENT_T_FS / au2fs,
                 wx, -wx)


def gmres_map(sol, args, nt_T, label):
    """One GMRES response map with the launch counts read around it;
    returns (S, seconds, stats), every solve's relative residual (the
    true one, through the right-hand side, after the solve) <= tol."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    S = sol.correlation_4op_3t_gmres(*args, tol=GMRES_TOL, nt_T=nt_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_only(read_counts(), "heom_coupling", 0, label)
    st = {k: v.cpu().numpy() for k, v in sol.gmres_stats.items()}
    worst = max(st["residual_x"].max(), st["residual_y"].max())
    if not (finite(S) and worst <= GMRES_TOL):
        raise AssertionError(f"{label}: finite {finite(S)}, worst relative "
                             f"residual {worst:.3e}")
    return S, wall, st, worst


def phase_resolvent():
    """The GMRES response map at the 680-ADO FMO hierarchy on a 16 x 16
    grid; the GMRES map against the host-eig map at FMO lmax = 1 and at
    the spin-boson of tests/test_deom.py."""
    from pyqed_tpu_torch import DEOMBath, DEOMSolver
    sol, args = resolvent_problem(FLAGSHIP["lmax"])
    S, wall, st, worst = gmres_map(sol, args, RESOLVENT_NT_T, "GMRES FMO")
    nado = sol.rhs_fn()[1]
    restarts = np.concatenate([st["restarts_y"], st["restarts_x"]])
    log(f"[deom] GMRES map FMO lmax={FLAGSHIP['lmax']} (nado={nado}, N="
        f"{nado * 49}) {RESOLVENT_NW} x {RESOLVENT_NW}, T "
        f"{RESOLVENT_T_FS} fs ({RESOLVENT_NT_T} RK4 steps): {wall:.2f} s, "
        f"restarts of 20 per solve y {st['restarts_y'].tolist()} x "
        f"{st['restarts_x'].tolist()} (mean {restarts.mean():.1f}), worst "
        f"relative residual {worst:.2e} (tol {GMRES_TOL:g}), max |S| "
        f"{S.abs().max().item():.4e}")
    out = {"map_s": wall, "mean_restarts": float(restarts.mean()),
           "max_restarts": int(restarts.max()), "worst_residual": worst}
    sol1, args1 = resolvent_problem(1)
    t0 = time.perf_counter()
    S_eig = sol1.correlation_4op_3t(*args1)
    torch.cuda.synchronize()
    t_eig = time.perf_counter() - t0
    S_gm, t_gm, _, _ = gmres_map(sol1, args1, RESOLVENT_NT_T, "GMRES lmax=1")
    d1 = rel(S_gm, S_eig)
    bath = DEOMBath.drude(temperature=1.0, cutoff=0.5, reorg=0.05, npsd=1)
    sb = DEOMSolver(system=np.array([[0.5, 0.1], [0.1, -0.5]]), bath=bath,
                    coupling=np.array([[[1.0, 0], [0, -1.0]]]), lmax=3,
                    device=DEVICE)
    dip = np.array([[0.0, 1.0], [1.0, 0.0]])
    sb_args = (dip, dip, dip, dip, np.diag([1.0, 0.0]), 2.0,
               np.linspace(0.6, 1.5, 4), np.linspace(-1.5, -0.6, 3))
    S_sb, _, _, _ = gmres_map(sb, sb_args, 400, "GMRES spin-boson")
    d2 = rel(S_sb, sb.correlation_4op_3t(*sb_args))
    log(f"[deom] GMRES vs host eig: FMO lmax=1 (N={sol1._nado * 49}, eig "
        f"{t_eig:.2f} s, GMRES {t_gm:.2f} s) rel {d1:.2e}; spin-boson lmax=3 "
        f"rel {d2:.2e} (tol 1e-6)")
    if not max(d1, d2) <= 1e-6:
        raise AssertionError(f"GMRES and eig maps differ by rel "
                             f"{max(d1, d2):.3e}")
    out.update({"gmres_vs_eig_fmo_lmax1": d1, "gmres_vs_eig_spin_boson": d2})
    return out


# ------------------------------------------------ driven-dynamics slice
DRIVE_CM = (200.0, 100.0)     # carrier and peak field (x |mu| = 1), cm^-1
DRIVE_FS = (50.0, 150.0)      # width and centre, fs
ABS_NW = 64                   # HEOM absorption on linspace(50, 600) cm^-1
ABS_NTAU = 1000
CORR_NT = 1000                # correlation_2op_1t at the flagship
POL_E0 = 0.05                 # config #5 as bench.py builds it (n = 20)
POL_DT = 0.002
POL_NW = 512                  # drive frequencies over [0.8, 1.2]
POL_SE_NT = 2000
POL_SE_NOUT = 100
POL_SCAN_NT = 10000
POL_SE_COLS = (0, 170, 341, 511)
POL_FLOQUET_COLS = tuple(range(0, POL_NW, POL_NW // 8))


def fmo_drive(amplitude_cm=DRIVE_CM[1]):
    """The drive of the driven flagship: the site operator X = |1><2| +
    |2><1| of the resolvent phase under a GaussianPulse of 200 cm^-1
    carrier, 50 fs width, centred at 150 fs, 100 cm^-1 peak field."""
    from pyqed_tpu_torch import GaussianPulse
    from pyqed_tpu_torch.units import au2fs, au2wavenumber
    X = np.zeros((7, 7))
    X[0, 1] = X[1, 0] = 1.0
    return X, GaussianPulse(omegac=DRIVE_CM[0] / au2wavenumber,
                            tau=DRIVE_FS[0] / au2fs, tc=DRIVE_FS[1] / au2fs,
                            amplitude=amplitude_cm / au2wavenumber)


def max_diff(a, b, fields=("observables", "ado")):
    return max((getattr(a, f) - getattr(b, f).to(getattr(a, f).device))
               .abs().max().item() for f in fields)


def phase_heom_driven():
    """Driven HEOM at the FMO flagship (680 ADOs, 4000 RK4 steps of 10 au)
    through the coupling kernel: launch count 4 x nt, against the driven
    einsum run on the card, trace error, the first window against the CPU,
    a zero-amplitude drive against the undriven run, and a run
    checkpointed every 7 windows against the single run."""
    from pyqed_tpu_torch import FMO
    from pyqed_tpu_torch.core.diagnostics import load_checkpoint
    m = FMO()
    sol = m.heom(**FLAGSHIP, device=DEVICE)
    X, pulse = fmo_drive()
    rho0 = m.initial_state(0)
    kw = dict(dt=DT, nt=NT, nout=NOUT, e_ops=m.site_projectors())
    drive = dict(edip=X, pulse=pulse.efield)
    res, counts, wall = counted_run(sol, rho0, "driven FMO", **drive, **kw)
    expect_only(counts, "heom_coupling", 4 * NT, "driven FMO")
    trace_err = (res.observables.real.sum(dim=1) - 1.0).abs().max().item()
    d_ein = max_diff(res, sol.run(rho0, kernel="einsum", **drive, **kw))
    cpu = m.heom(**FLAGSHIP, device="cpu").run(
        rho0, dt=DT, nt=NOUT, nout=NOUT, e_ops=m.site_projectors(), **drive)
    d_cpu = (res.observables[:2].cpu() - cpu.observables).abs().max().item()
    undriven = sol.run(rho0, **kw)
    zero = sol.run(rho0, edip=X, pulse=fmo_drive(0.0)[1].efield, **kw)
    d_zero = max_diff(zero, undriven)
    effect = (res.observables - undriven.observables).abs().max().item()
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build")
    os.makedirs(ck_dir, exist_ok=True)
    ck = os.path.join(ck_dir, "chip_smoke_heom_checkpoint.npz")
    chunked = sol.run(rho0, checkpoint=ck, checkpoint_every=7, **drive, **kw)
    step, (ados_ck,), _ = load_checkpoint(ck)
    os.remove(ck)
    d_ck = max(max_diff(chunked, res, ("observables", "ado", "states")),
               (ados_ck.to(DEVICE) - res.ado).abs().max().item())
    log(f"[driven] FMO flagship nado={res.ado.shape[0]} nt={NT} dt={DT}, "
        f"X = |1><2| + |2><1| under a GaussianPulse ({DRIVE_CM[0]:g} cm^-1, "
        f"{DRIVE_FS[0]:g} fs, at {DRIVE_FS[1]:g} fs, {DRIVE_CM[1]:g} cm^-1) "
        f"in {wall:.2f} s, launches {counts} (expected heom_coupling "
        f"{4 * NT}); trace err {trace_err:.2e} (tol 1e-10), |cuda - einsum| "
        f"{d_ein:.2e} (tol 1e-10), first window vs CPU {d_cpu:.2e} (tol "
        f"1e-10), amplitude 0 vs undriven {d_zero:.2e} (tol 1e-14), "
        f"checkpoint_every=7 (last at window {step}) vs single {d_ck:.2e} "
        f"(tol 1e-12); the drive moves the populations by up to "
        f"{effect:.3e}")
    for name, val, tol in (("trace error", trace_err, 1e-10),
                           ("cuda vs einsum", d_ein, 1e-10),
                           ("first window vs CPU", d_cpu, 1e-10),
                           ("amplitude 0 vs undriven", d_zero, 1e-14),
                           ("chunked vs single", d_ck, 1e-12)):
        if not val <= tol:
            raise AssertionError(f"driven FMO: {name} {val:.3e} > {tol:g}")
    if not effect > 1e-6 or step != NT // NOUT:
        raise AssertionError(f"driven FMO: the drive moved the populations "
                             f"by {effect:.3e}; last checkpoint {step}")
    return {"launches": counts["heom_coupling"], "trace_err": trace_err,
            "vs_einsum": d_ein, "vs_cpu": d_cpu, "zero_vs_undriven": d_zero,
            "chunked_vs_single": d_ck, "run_s": wall}


def phase_heom_correlations():
    """HEOM absorption at FMO lmax 1 (15 ADOs, D = 735; the steady state
    from the host SVD of the dense Liouvillian built on the card), card
    against CPU; correlation_2op_1t at the flagship through the kernel
    against einsum."""
    from pyqed_tpu_torch import FMO
    from pyqed_tpu_torch.units import au2wavenumber
    m = FMO()
    X, _ = fmo_drive()
    w = np.linspace(50.0, 600.0, ABS_NW) / au2wavenumber
    lmax1 = dict(FLAGSHIP, lmax=1)
    sol = m.heom(**lmax1, device=DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    S = sol.absorption(w, X, ntau=ABS_NTAU)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_only(counts, "heom_coupling", 4 * (ABS_NTAU - 1), "absorption")
    S_cpu = m.heom(**lmax1, device="cpu").absorption(w, X, ntau=ABS_NTAU)
    d_abs = float(np.max(np.abs(S - S_cpu)) / np.max(np.abs(S_cpu)))
    if not (np.all(np.isfinite(S)) and d_abs <= 1e-10):
        raise AssertionError(f"absorption: card vs CPU rel {d_abs:.3e}")
    fl = m.heom(**FLAGSHIP, device=DEVICE)
    rho0 = m.initial_state(0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    c = fl.correlation_2op_1t(rho0, X, X, DT, CORR_NT)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    counts_c = read_counts()
    expect_only(counts_c, "heom_coupling", 4 * CORR_NT, "correlation_2op_1t")
    d_c = rel(c, fl.correlation_2op_1t(rho0, X, X, DT, CORR_NT,
                                        kernel="einsum"))
    nado = sol.rhs_fn(torch.complex128, kernel="einsum")[1]
    log(f"[driven] HEOM absorption FMO lmax=1 (nado={nado}, D="
        f"{nado * 49}) on {ABS_NW} "
        f"frequencies, ntau={ABS_NTAU}: {wall:.2f} s, launches {counts}, "
        f"card vs CPU rel {d_abs:.2e} (tol 1e-10), peak at "
        f"{w[int(np.argmax(S))] * au2wavenumber:.1f} cm^-1; "
        f"correlation_2op_1t at the flagship {CORR_NT} steps in "
        f"{wall_c:.2f} s, launches {counts_c}, |cuda - einsum| rel "
        f"{d_c:.2e} (tol 1e-10)")
    if not (finite(c) and d_c <= 1e-10):
        raise AssertionError(f"correlation_2op_1t: cuda vs einsum {d_c:.3e}")
    return {"absorption_vs_cpu": d_abs, "absorption_s": wall,
            "absorption_launches": counts["heom_coupling"],
            "corr_vs_einsum": d_c, "corr_launches": counts_c["heom_coupling"]}


def polariton_system(nmol=2, ncav=5):
    """bench.py:698-726 (_polariton_system): nmol two-level molecules x a
    cavity of ncav levels, Jaynes-Cummings coupling; (H, mu), n = 20."""
    nm = 2 ** nmol
    n = nm * ncav
    H = np.zeros((n, n))
    wc, wm, g0 = 1.0, 1.0, 0.1
    for i in range(nm):
        nex = bin(i).count("1")
        for k in range(ncav):
            H[i * ncav + k, i * ncav + k] = wm * nex + wc * k
    # sigma^+ a + h.c. per molecule
    for m in range(nmol):
        for i in range(nm):
            if not (i >> m) & 1:
                j = i | (1 << m)
                for k in range(1, ncav):
                    a = i * ncav + k
                    b = j * ncav + (k - 1)
                    H[b, a] += g0 * np.sqrt(k)
                    H[a, b] += g0 * np.sqrt(k)
    mu = np.zeros((n, n))
    for m in range(nmol):
        for i in range(nm):
            if not (i >> m) & 1:
                j = i | (1 << m)
                for k in range(ncav):
                    mu[i * ncav + k, j * ncav + k] = 1.0
                    mu[j * ncav + k, i * ncav + k] = 1.0
    return H, mu


def polariton_scan(H, mu, omegas, nt, keep):
    """bench.py:729-751's drive-frequency scan on the card: one batched RK4
    of (n, n) @ (n, B) under H + E0 cos(w t) mu, built from the port's
    rk4_step_t, from the ground state. Returns P (n, B) after ``keep``
    steps and after ``nt``."""
    from pyqed_tpu_torch.core.dynamics import rk4_step_t
    dev = torch.device(DEVICE)
    Ht = torch.as_tensor(H, dtype=torch.complex128, device=dev)
    mt = torch.as_tensor(mu, dtype=torch.complex128, device=dev)
    w = torch.as_tensor(omegas, dtype=torch.float64, device=dev)

    def rhs(P, t):
        c = POL_E0 * torch.cos(w * t)
        return -1j * (Ht @ P + (mt @ P) * c[None, :])

    step = rk4_step_t(rhs)
    P = torch.zeros((H.shape[0], len(omegas)), dtype=torch.complex128,
                    device=dev)
    P[0] = 1.0
    t, kept = 0.0, None
    for k in range(nt):
        P = step(P, t, POL_DT)
        t = t + POL_DT
        if k + 1 == keep:
            kept = P.clone()
    return kept, P


def polariton_field(w):
    """E(t) for SESolver's H - E(t) mu that gives the scan's
    H + E0 cos(w t) mu: -E0 cos(w t), a float."""
    return lambda t: -POL_E0 * math.cos(w * t)


def phase_polariton():
    """Config #5 at the bench's shape (n = 20, complex128): SESolver.run
    under the drive at 4 of the 512 frequencies, card against CPU; the
    512-column scan for 20,000 steps, whose 4 columns equal those runs over
    the shared 2,000 steps; Floquet quasienergies at 8 frequencies, card
    against CPU. No hand-written kernel lies on this path: every launch
    count stays 0."""
    from pyqed_tpu_torch import SESolver
    from pyqed_tpu_torch.floquet import Floquet
    H, mu = polariton_system()
    n = H.shape[0]
    omegas = np.linspace(0.8, 1.2, POL_NW)
    psi0 = np.eye(n)[0].astype(complex)
    torch.cuda.synchronize()
    reset_counts()
    kw = dict(psi0=psi0, dt=POL_DT, Nt=POL_SE_NT, nout=POL_SE_NOUT,
              edip=mu)
    se, d_se = {}, 0.0
    for j in POL_SE_COLS:
        f = polariton_field(omegas[j])
        se[j] = SESolver(H, device=DEVICE).run(pulse=f, **kw)
        cpu = SESolver(H, device="cpu").run(pulse=f, **kw)
        d_se = max(d_se, (se[j].states.cpu() - cpu.states).abs().max().item())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept, P = polariton_scan(H, mu, omegas, POL_SCAN_NT, POL_SE_NT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d_scan = max((kept[:, j] - se[j].psi).abs().max().item()
                 for j in POL_SE_COLS)
    spec = 1.0 - P[0].abs() ** 2
    norm_err = (torch.linalg.norm(P, dim=0) - 1.0).abs().max().item()
    d_fl = 0.0
    for j in POL_FLOQUET_COLS:
        q = [Floquet(H, mu, omegas[j], POL_E0, device=d).quasienergies(
            first_bz=False) for d in (DEVICE, "cpu")]
        d_fl = max(d_fl, rel(q[0].cpu(), q[1]))
        folded = Floquet(H, mu, omegas[j], POL_E0,
                         device=DEVICE).quasienergies()
        if not (bool(torch.isfinite(folded).all())
                and folded.abs().max().item() <= omegas[j] / 2):
            raise AssertionError(f"Floquet at w={omegas[j]}: quasienergies "
                                 "outside the first zone")
    counts = read_counts()
    expect_only(counts, "heom_coupling", 0, "polariton")
    rate = POL_SCAN_NT * POL_NW / wall
    peak = omegas[int(torch.argmax(spec).item())]
    log(f"[polariton] config #5 n={n}: SESolver.run at w = "
        f"{', '.join(f'{omegas[j]:.4f}' for j in POL_SE_COLS)} for "
        f"{POL_SE_NT} steps of {POL_DT}, card vs CPU {d_se:.2e} (tol 1e-10); "
        f"the {POL_NW}-column scan, {POL_SCAN_NT} steps in {wall:.2f} s "
        f"({rate:.4g} trajectory-steps/s, first call), its columns vs "
        f"SESolver at step {POL_SE_NT} {d_scan:.2e} (tol 1e-12), norm drift "
        f"{norm_err:.2e}, ground-state depletion peaks at w = {peak:.4f}; "
        f"Floquet quasienergies (nt=31) at {len(POL_FLOQUET_COLS)} "
        f"frequencies card vs CPU rel {d_fl:.2e} (tol 1e-10); launches "
        f"{counts}")
    if not (d_se <= 1e-10 and d_scan <= 1e-12 and d_fl <= 1e-10
            and finite(P) and norm_err <= 1e-6):
        raise AssertionError(f"polariton: SESolver {d_se:.3e}, scan "
                             f"{d_scan:.3e}, Floquet {d_fl:.3e}, norm "
                             f"{norm_err:.3e}")
    return {"sesolver_vs_cpu": d_se, "scan_vs_sesolver": d_scan,
            "floquet_vs_cpu": d_fl, "scan_s": wall,
            "scan_trajectory_steps_per_s": rate, "norm_drift": norm_err}


def run_profile(sol, steps=40, **kw):
    """Device time per RK4 step of HEOMSolver.run itself at the flagship
    by kernel (:func:`profile_steps`): one run of ``steps`` steps in one
    window after a warm-up run, its set-up included (``kw`` go to run(),
    e.g. the drive)."""
    rho0 = np.diag([1.0] + [0.0] * (sol.n - 1))

    def advance():
        sol.run(rho0, dt=DT, nt=steps, nout=steps, kernel="cuda", **kw)

    advance()
    return profile_steps(advance, 1, per=steps)


def host_profile(fn, args, calls=200):
    """Host time per call of ``fn(*args)`` by aten op (torch.profiler, CPU
    events only; the profiler's own cost per op is included): (total self
    us per call, rows of (self us per call, ops per call, name), longest
    first)."""
    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    rows = sorted(((evt.self_cpu_time_total / calls, evt.count / calls,
                    evt.key) for evt in prof.key_averages()
                   if evt.self_cpu_time_total > 0), reverse=True)
    return sum(r[0] for r in rows), rows


def phase_driven_timing(card):
    """Times of the driven slice, recorded and not claimed: HEOM run()
    steps/s at the flagship driven and undriven in turns, the host time of
    one right-hand side (in all and by aten op), the device profile of
    run()'s step driven and undriven, and SESolver.run steps/s at config
    #5."""
    from pyqed_tpu_torch import FMO, SESolver
    m = FMO()
    sol = m.heom(**FLAGSHIP, device=DEVICE)
    X, pulse = fmo_drive()
    rates = {"undriven": [], "driven": []}
    for which in ("undriven", "driven", "driven", "undriven") * 2:
        kw = dict(edip=X, pulse=pulse.efield) if which == "driven" else {}
        rates[which].append(steps_per_s(m, sol, nt=TIME_NT, kernel="cuda",
                                        e_ops=m.site_projectors(), **kw))
    # host enqueue per right-hand side, and per field evaluation
    rhs, nado = sol.rhs_fn(torch.complex128)
    rhs_d, _ = sol.rhs_fn(torch.complex128, edip=X)
    y = torch.zeros((nado, sol.n, sol.n), dtype=torch.complex128,
                    device=DEVICE)
    host = {"undriven": [], "driven": []}
    for which in ("undriven", "driven", "driven", "undriven"):
        host[which].append(host_ms(rhs, (y,)) if which == "undriven"
                           else host_ms(rhs_d, (y, 1e-4)))
    t0 = time.perf_counter()
    for i in range(10000):
        float(pulse.efield(DT * i))
    field_us = (time.perf_counter() - t0) / 10000 * 1e6
    aten = {"undriven": host_profile(rhs, (y,)),
            "driven": host_profile(rhs_d, (y, 1e-4))}
    total, rows = run_profile(sol, edip=X, pulse=pulse.efield)
    total_u, rows_u = run_profile(sol)
    busy = total / 1e6 * max(rates["driven"])
    log(f"[time] run() FMO flagship complex128 kernel=cuda steps/s: driven "
        + ", ".join(f"{r:.0f}" for r in rates["driven"]) + "; undriven "
        + ", ".join(f"{r:.0f}" for r in rates["undriven"]) + f" ({card})")
    log(f"[time] host enqueue per right-hand side: driven "
        f"{us(host['driven'])} us, undriven {us(host['undriven'])} us; "
        f"GaussianPulse.efield of a float on the host {field_us:.2f} us "
        f"({card})")
    for which, (tot, arows) in aten.items():
        log(f"[time] host per {which} right-hand side by aten op, "
            f"torch.profiler CPU events over 200 calls: {tot:.1f} us in "
            f"aten ops ({card})")
        for us_, count, key in arows[:10]:
            log(f"[time]   {us_:8.2f} us per call, {count:4.1f} ops "
                f"{key[:80]}")
    log(f"[time] HEOMSolver.run() FMO flagship RK4 step, torch.profiler over "
        f"a 40-step run, set-up included: device {total:.1f} us per step "
        f"driven, {total_u:.1f} undriven; busy share against the fastest "
        f"driven run() {busy:.2f} ({card})")
    for label, rws in (("driven", rows), ("undriven", rows_u)):
        for us_, count, key in rws[:12]:
            log(f"[time]   {label} {us_:8.2f} us per step, {count:5.2f} "
                f"kernels {key[:80]}")
    H, mu = polariton_system()
    psi0 = np.eye(H.shape[0])[0].astype(complex)
    se = SESolver(H, device=DEVICE)
    f = polariton_field(1.0)
    se_rates = []
    for _ in range(2):
        walls = []
        for steps in (POL_SE_NOUT, POL_SE_NT):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            se.run(psi0=psi0, dt=POL_DT, Nt=steps, nout=POL_SE_NOUT,
                   pulse=f, edip=mu)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        se_rates.append((POL_SE_NT - POL_SE_NOUT) / (walls[1] - walls[0]))
    log(f"[time] SESolver.run() config #5 n={H.shape[0]} driven complex128: "
        + ", ".join(f"{r:.0f}" for r in se_rates) + f" steps/s ({card})")
    return {"driven_steps_per_s": max(rates["driven"]),
            "undriven_steps_per_s": max(rates["undriven"]),
            "driven_rhs_host_ms": min(host["driven"]),
            "undriven_rhs_host_ms": min(host["undriven"]),
            "field_host_us": field_us,
            "driven_rhs_aten_host_us": aten["driven"][0],
            "undriven_rhs_aten_host_us": aten["undriven"][0],
            "driven_step_device_us": total,
            "undriven_run_step_device_us": total_u,
            "sesolver_steps_per_s": max(se_rates)}


# ------------------------------------------------------------------ 5
def event_ms(fn, args, iters=200, warmup=20):
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def steps_per_s(m, sol, nt=2000, **kw):
    """run() steps/s of a solver of the FMO model ``m`` from the
    difference of an nt-step and a one-window run, so the setup of run()
    cancels (``kw`` go to run())."""
    rho0 = m.initial_state(0)
    walls = []
    for steps in (NOUT, nt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol.run(rho0, dt=DT, nt=steps, nout=NOUT, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (nt - NOUT) / (walls[1] - walls[0])


def graph_ms(fn, args, calls=50, reps=20):
    """Device time per call of ``fn(*args)``: ``calls`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events, so the
    host's enqueue time does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def profile_steps(advance, steps, per=None):
    """Device time of ``steps`` calls of ``advance()`` by kernel name
    (torch.profiler; only the device's own events, so time under an aten
    op is not counted twice), per ``per`` steps (``steps`` unless given):
    (total us per step, rows of (us per step, kernels per step, name),
    longest first)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            advance()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / (per or steps), evt.count / (per or steps),
                         evt.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows


def heom_profile(sol, steps=20):
    """Device time per flagship RK4 step by kernel (:func:`profile_steps`),
    with the right-hand side of HEOMSolver.run and its RK4 step."""
    from pyqed_tpu_torch.core.dynamics import rk4_step
    rhs, nado = sol.rhs_fn(torch.complex128)
    step = rk4_step(rhs)
    y = [torch.zeros((nado, sol.n, sol.n), dtype=torch.complex128,
                     device=DEVICE)]
    y[0][0, 0, 0] = 1.0

    def advance():
        y[0] = step(y[0], 0.0, DT)

    for _ in range(3):
        advance()
    return profile_steps(advance, steps)


def host_ms(fn, args, iters=300):
    """Host time per call of ``fn(*args)`` (its enqueue; the device may
    still be busy when it returns)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    t = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return t * 1e3


def us(xs, fmt=".1f"):
    return " / ".join(f"{x * 1e3:{fmt}}" for x in xs)


def coupling_timing(card, name, sol, dtype):
    """One shape and dtype of :func:`phase_timing`'s coupling times:
    (kernel ms, plain ms, bound), eager."""
    from pyqed_tpu_torch.ops import kernels as kn
    args = coupling_operands(sol, dtype)
    plan = kn.heom_coupling_plan(args[1], args[2])

    def kern(*a):
        return kn.heom_coupling(*a, plan=plan)

    fns = {"plain": kn.heom_coupling_ref, "kernel": kern}
    t = {k: dict(eager=[], host=[], graph=[]) for k in fns}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which]["eager"].append(event_ms(fns[which], args))
        t[which]["host"].append(host_ms(fns[which], args))
        t[which]["graph"].append(graph_ms(fns[which], args))
    b = coupling_bound(*args)
    log(f"[time] heom_coupling {name} {str(dtype)[6:]}: eager per call "
        f"(CUDA events) kernel {us(t['kernel']['eager'])} us, plain "
        f"{us(t['plain']['eager'])} us; host enqueue per call kernel "
        f"{us(t['kernel']['host'])} us, plain {us(t['plain']['host'])} us; "
        f"device per call (CUDA graph replay) kernel "
        f"{us(t['kernel']['graph'], '.2f')} us, plain "
        f"{us(t['plain']['graph'], '.2f')} us; bound {b[0] * 1e3:.2f} us "
        f"({b[1]}); {plan.tiles.shape[0]} tiles ({card})")
    return min(t["kernel"]["eager"]), min(t["plain"]["eager"]), b


TIME_NT = 500      # run() steps/s of every right-hand side: 500 - 40 steps


def phase_timing(card, shapes):
    """The HEOM coupling per call, kernel (with the plan the main path
    launches from) and plain version in turns: CUDA events over eager
    calls (the kernels line's ms and plain_ms, as since the port began),
    host enqueue per call, and device time of calls replayed from a CUDA
    graph, a separate reading without the host; then run() steps/s and
    the flagship step's profile."""
    from pyqed_tpu_torch import FMO
    times = {(name, dtype): coupling_timing(card, name, sol, dtype)
             for name, sol in shapes.items()
             for dtype in (torch.complex128, torch.complex64)}
    m = FMO()
    sol = m.heom(**FLAGSHIP, device=DEVICE)
    order = ["cuda", "einsum", "matmul", "levels", "rowcol"]
    rates = {k: [] for k in order}
    for k in order + order[::-1]:
        rates[k].append(steps_per_s(m, sol, nt=TIME_NT, kernel=k,
                                    e_ops=m.site_projectors()))
    for k in order:
        log(f"[time] run() FMO flagship complex128 kernel={k}: "
            + ", ".join(f"{r:.0f}" for r in rates[k])
            + f" steps/s ({card})")
    steps = 20
    total, rows = heom_profile(sol, steps)
    busy = total / 1e6 * max(rates["cuda"])
    log(f"[time] HEOM FMO flagship RK4 step, kernel=cuda, torch.profiler "
        f"over {steps} steps: device {total:.1f} us per step; busy share "
        f"against the fastest unprofiled run() {busy:.2f} ({card})")
    for us, count, key in rows[:12]:
        log(f"[time]   {us:8.2f} us per step, {count:4.1f} kernels "
            f"{key[:80]}")
    return times


def spo_library(kind):
    """One PyTorch call computing the kernel's function (the yardstick;
    the port never calls it)."""
    if kind == "phase":
        return lambda op, psi: psi * op[..., None]
    return lambda op, psi: torch.matmul(op, psi.unsqueeze(-1))


def phase_spo_kernel_timing(card):
    from pyqed_tpu_torch.ops import kernels as kn
    times = {}
    npts = SPO_N ** 3
    for dtype in (torch.complex128, torch.complex64):
        for kind, (wrap, ref) in SPO_FNS.items():
            op, psi = spo_inputs(kind, (SPO_N,) * 3, SPO_NS, dtype, True)
            args = (op, psi)
            kern, plain = getattr(kn, wrap), getattr(kn, ref)
            t = dict(plain=[], kernel=[], library=[])
            for which, fn in (("plain", plain), ("kernel", kern),
                              ("library", spo_library(kind)),
                              ("kernel", kern), ("plain", plain)):
                t[which].append(event_ms(fn, args, iters=20, warmup=3))
            b = spo_bound(kind, npts, SPO_NS, dtype)
            times[(kind, dtype)] = dict(
                ms=min(t["kernel"]), plain_ms=min(t["plain"]),
                library_ms=t["library"][0], bound=b)
            log(f"[time] spo_{kind} {SPO_N}^3 x {SPO_NS} {str(dtype)[6:]} "
                f"states-first: kernel "
                + " / ".join(f"{x:.3f}" for x in t["kernel"])
                + " ms, plain " + " / ".join(f"{x:.3f}" for x in t["plain"])
                + f" ms, library {t['library'][0]:.3f} ms, bound "
                f"{b[0]:.3f} ms ({b[1]}) ({card})")
            del op, psi, args
    return times


def spo_steps_per_s(sol, psi0, kernel, nt=100):
    """run() steps/s at 256^3 from the difference of an nt-step and a
    one-window run, so the setup of run() cancels; a first one-window run
    makes sure both reuse the factors of one build()."""
    sol.kernel = kernel
    sol.run(psi0, dt=SPO_DT, nt=SPO_NOUT, nout=SPO_NOUT, return_states=False)
    walls = []
    for steps in (SPO_NOUT, nt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol.run(psi0, dt=SPO_DT, nt=steps, nout=SPO_NOUT,
                return_states=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    sol.kernel = None
    return (nt - SPO_NOUT) / (walls[1] - walls[0])


def spo_profile(sol, psi0, steps=5):
    """Device time per Strang step by kernel name (:func:`profile_steps`)."""
    sol.build(SPO_DT)
    psi = [psi0]

    def advance():
        psi[0] = sol.step(psi[0])

    for _ in range(2):
        advance()
    return profile_steps(advance, steps)


def eigh_batch_probe(card):
    """One batched eigh of 2x2 blocks at the build's chunk size and at
    twice it: the reason grid/spo.py chunks (printed, not checked)."""
    from pyqed_tpu_torch.grid.spo import EIGH_CHUNK
    rng = np.random.default_rng(SEED)
    for b in (EIGH_CHUNK, 2 * EIGH_CHUNK):
        a = torch.as_tensor(rng.standard_normal((b, 2, 2)), device=DEVICE)
        a = a + a.transpose(-1, -2)
        try:
            torch.linalg.eigh(a)            # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.linalg.eigh(a)
            torch.cuda.synchronize()
            what = f"ok, {(time.perf_counter() - t0) * 1e3:.3f} ms"
        except torch.linalg.LinAlgError as e:
            what = f"fails: {str(e)[:60]}"
        log(f"[time] torch.linalg.eigh of {b} 2x2 blocks in one call: "
            f"{what} ({card})")


def phase_spo_timing(card, sol, psi0):
    times = phase_spo_kernel_timing(card)
    eigh_batch_probe(card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol.build(SPO_DT)
    torch.cuda.synchronize()
    log(f"[time] SPO3 {SPO_N}^3 x {SPO_NS} build() {time.perf_counter() - t0:.3f}"
        f" s (batched eigh of {SPO_N ** 3} 2x2 blocks, expV, expV/2, expK) "
        f"({card})")
    order = [None, "xla"]
    rates = {k: [] for k in order}
    for k in order + order[::-1]:
        rates[k].append(spo_steps_per_s(sol, psi0, k))
    for k in order:
        log(f"[time] run() SPO3 {SPO_N}^3 x {SPO_NS} complex128 "
            f"kernel={k or 'cuda'}: "
            + ", ".join(f"{r:.2f}" for r in rates[k])
            + f" steps/s ({card})")
    total, rows = spo_profile(sol, psi0)
    busy = total / 1e3 * max(rates[None]) / 1e3
    log(f"[time] SPO3 {SPO_N}^3 Strang step, kernel=cuda, torch.profiler: "
        f"device {total / 1e3:.3f} ms per step; busy share against the "
        f"fastest unprofiled run() {busy:.2f} ({card})")
    for us, count, key in rows[:12]:
        log(f"[time]   {us / 1e3:8.3f} ms  x{count:<4g} {key[:90]}")
    log(f"[time] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB ({card})")
    return times


# ------------------------------------------------------ Lindblad slice
def vibronic_dimer(nvib):
    """Config #2 as bench.py's _vibronic_dimer builds it: 2 electronic
    states x nvib vibrational levels (n = 2 nvib), one jump operator
    lowering the vibrational level in both states."""
    n = 2 * nvib
    w0, de, g = 0.2, 1.0, 0.15
    H = np.zeros((n, n))
    for s in range(2):
        for v in range(nvib):
            H[s * nvib + v, s * nvib + v] = s * de + w0 * v
    for v in range(nvib - 1):
        H[nvib + v, v + 1] = H[v + 1, nvib + v] = g
    c = np.zeros((n, n))
    for v in range(1, nvib):
        c[v - 1, v] = 0.1 * np.sqrt(v)
        c[nvib + v - 1, nvib + v] = 0.1 * np.sqrt(v)
    return H, c


def dimer_problem(nvib):
    """H, c, rho0 = |n/2><n/2| (bench.py) and the e_ops: every level
    population at n <= 64, the two electronic populations above."""
    H, c = vibronic_dimer(nvib)
    n = 2 * nvib
    rho0 = np.zeros((n, n))
    rho0[n // 2, n // 2] = 1.0
    if n <= 64:
        e_ops = [np.diag(np.eye(n)[k]) for k in range(n)]
    else:
        e_ops = [np.diag((np.arange(n) < nvib).astype(float)),
                 np.diag((np.arange(n) >= nvib).astype(float))]
    return H, c, rho0, e_ops


def commutator_inputs(n, dtype, seed=SEED):
    """Random non-Hermitian H_eff and rho on the card, from a numpy seed."""
    rng = np.random.default_rng(seed + n)
    rdt = np.float64 if dtype == torch.complex128 else np.float32

    def crand():
        re = torch.from_numpy(rng.standard_normal((n, n), dtype=rdt))
        im = torch.from_numpy(rng.standard_normal((n, n), dtype=rdt))
        return torch.complex(re, im).to(DEVICE)

    return crand(), crand()


def commutator_bound(n, dtype):
    """Bytes (H_eff and rho read once, out written once) and flops (two
    complex n^3 products, 8 real flops per complex MAC) of one call."""
    c = 16 if dtype == torch.complex128 else 8
    return bound_ms(3 * n * n * c, 16 * n ** 3)


def commutator_library(Heff, rho):
    """The yardstick (the port never calls it): two cuBLAS products."""
    return torch.matmul(Heff, rho) - torch.matmul(rho, Heff.mH)


def phase_lindblad_parity():
    from pyqed_tpu_torch.ops import kernels as kn
    errs = {}
    cases = [(n, dtype, tol) for n in COMM_SIZES
             for dtype, tol in ((torch.complex128, 1e-12),
                                (torch.complex64, 1e-5))]
    cases += [(n, torch.complex128, 1e-12) for n in COMM_C128_ONLY]
    for n, dtype, tol in cases:
        Heff, rho = commutator_inputs(n, dtype)
        out = kn.liouvillian_commutator(Heff, rho)
        errs[(n, dtype)] = check_close(
            f"liouvillian_commutator n={n} {str(dtype)[6:]}", out,
            kn.liouvillian_commutator_ref(Heff, rho), tol)
        del Heff, rho, out
    return errs


def np_liouvillian(H, cs):
    """Dense row-major Liouvillian in NumPy (as tests/test_open.py)."""
    n = H.shape[0]
    eye = np.eye(n)
    L = -1j * (np.kron(H, eye) - np.kron(eye, H.T))
    for c in cs:
        cd = c.conj().T
        L = L + np.kron(c, c.conj()) - 0.5 * (np.kron(cd @ c, eye)
                                              + np.kron(eye, (cd @ c).T))
    return L


def counted_run(sol, rho0, label, **kw):
    """sol.run(rho0, **kw) with every launch count set to 0 just before
    and read just after; returns (result, counts, wall seconds)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = sol.run(rho0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    obs = res.observables
    if not (bool(torch.isfinite(torch.view_as_real(obs)).all()) and bool(
            torch.isfinite(torch.view_as_real(res.rho)).all())):
        raise AssertionError(f"{label}: non-finite values")
    return res, counts, wall


def expect_only(counts, name, n, label):
    want = {k: 0 for k in counts}
    want[name] = n
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {name} "
                             f"{n} and no other")


def phase_lindblad_main():
    """Config #2 (n = 16) through the kernel, against the propagator
    method and SciPy's expm; the bench's 400,000 propagator steps; the
    n = 1024 run through the kernel and through kernel='matmul'. Returns
    the launch count of the n = 1024 kernel run."""
    import scipy.linalg
    from pyqed_tpu_torch import LindbladSolver
    H, c, rho0, e_ops = dimer_problem(LB_NVIB)
    n = H.shape[0]
    nwin = LB_NT // LB_NOUT
    sol = LindbladSolver(H, [c], device=DEVICE)
    kw = dict(dt=LB_DT, Nt=LB_NT, nout=LB_NOUT, e_ops=e_ops)
    res, counts, wall = counted_run(sol, rho0, "config #2", **kw)
    label = f"Lindblad config #2 n={n}"
    expect_only(counts, "liouvillian_commutator", 4 * LB_NT, label)
    obs = res.observables
    if tuple(obs.shape) != (nwin + 1, n):
        raise AssertionError(f"{label}: observables {tuple(obs.shape)}")
    drift = (obs.real.sum(dim=1) - 1.0).abs().max().item()
    prop = sol.run(rho0, method="propagator", **kw)
    d_prop = max((obs - prop.observables).abs().max().item(),
                 (res.rho - prop.rho).abs().max().item())
    # SciPy: exact exp(L dt nout) of the dense Liouvillian, window by window
    M = scipy.linalg.expm(np_liouvillian(H, [c]) * LB_DT * LB_NOUT)
    v = rho0.reshape(-1).astype(complex)
    exact = [np.diagonal(rho0).real]
    for _ in range(nwin):
        v = M @ v
        exact.append(np.diagonal(v.reshape(n, n)).real)
    d_exp = float(np.max(np.abs(obs.real.cpu().numpy() - np.array(exact))))
    p = obs[-1].real.cpu().numpy()
    log(f"[main] {label} Nt={LB_NT} dt={LB_DT} in {wall:.2f} s, kernel "
        f"launches {counts} (expected liouvillian_commutator {4 * LB_NT}), "
        f"trace drift {drift:.2e}, |rk4 - propagator| {d_prop:.2e}, "
        f"|rk4 - scipy expm| {d_exp:.2e}, final electronic populations "
        f"{p[:n // 2].sum():.6f} {p[n // 2:].sum():.6f}")
    if not drift <= 1e-12:
        raise AssertionError(f"{label}: trace drift {drift:.3e}")
    if not d_prop <= 1e-10:
        raise AssertionError(f"{label}: rk4 and propagator differ by "
                             f"{d_prop:.3e}")
    if not d_exp <= 1e-8:
        raise AssertionError(f"{label}: rk4 and expm differ by {d_exp:.3e}")

    long, counts, wall = counted_run(
        sol, rho0, "config #2 propagator", dt=LB_DT, Nt=LB_BENCH_NT,
        nout=LB_NOUT, e_ops=e_ops, method="propagator")
    expect_only(counts, "liouvillian_commutator", 0, "propagator")
    drift_l = (long.observables.real.sum(dim=1) - 1.0).abs().max().item()
    p = long.observables[-1].real.cpu().numpy()
    log(f"[main] {label} method='propagator' Nt={LB_BENCH_NT} "
        f"({LB_BENCH_NT // LB_NOUT} windows) in {wall:.2f} s, trace drift "
        f"{drift_l:.2e}, final electronic populations "
        f"{p[:n // 2].sum():.6f} {p[n // 2:].sum():.6f}")
    if not drift_l <= 1e-10:
        raise AssertionError(f"propagator: trace drift {drift_l:.3e}")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    H, c, rho0, e_ops = dimer_problem(LB_BIG_NVIB)
    n = H.shape[0]
    label = f"Lindblad chip scale n={n}"
    kw = dict(dt=LB_DT, Nt=LB_BIG_NT, nout=LB_BIG_NOUT, e_ops=e_ops)
    big = LindbladSolver(H, [c], device=DEVICE)
    res, counts, wall = counted_run(big, rho0, label, **kw)
    launches = counts["liouvillian_commutator"]
    expect_only(counts, "liouvillian_commutator", 4 * LB_BIG_NT, label)
    res_m, counts_m, wall_m = counted_run(
        LindbladSolver(H, [c], kernel="matmul", device=DEVICE), rho0,
        label + " matmul", **kw)
    expect_only(counts_m, "liouvillian_commutator", 0, label + " matmul")
    d_rho = rel(res.rho, res_m.rho)
    d_obs = rel(res.observables, res_m.observables)
    drift = max((res.observables.real.sum(dim=1) - 1.0).abs().max().item(),
                abs(torch.trace(res.rho).item() - 1.0))
    p = res.observables[-1].real.cpu().numpy()
    log(f"[main] {label} Nt={LB_BIG_NT} in {wall:.2f} s (kernel) and "
        f"{wall_m:.2f} s (matmul), kernel launches {counts} (expected "
        f"liouvillian_commutator {4 * LB_BIG_NT}), |cuda - matmul| rel rho "
        f"{d_rho:.2e} observables {d_obs:.2e}, trace drift {drift:.2e}, "
        f"final electronic populations {p[0]:.6f} {p[1]:.6f}")
    if not (d_rho <= 1e-12 and d_obs <= 1e-12):
        raise AssertionError(f"{label}: cuda and matmul runs differ: rho "
                             f"{d_rho:.3e}, observables {d_obs:.3e}")
    if not drift <= 1e-10:
        raise AssertionError(f"{label}: trace drift {drift:.3e}")
    log(f"[main] {label} peak device memory of the two runs "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
        "above what earlier phases hold")
    return launches


def phase_redfield():
    """FMO().redfield() on the card against the same run on the CPU."""
    from pyqed_tpu_torch import FMO
    m = FMO()
    kw = dict(dt=DT, Nt=2000, nout=NOUT, e_ops=m.site_projectors())
    res, counts, wall = counted_run(m.redfield(device=DEVICE),
                                    m.initial_state(0), "Redfield", **kw)
    expect_only(counts, "liouvillian_commutator", 0, "Redfield")
    cpu = m.redfield(device="cpu").run(m.initial_state(0), **kw)
    d = max((res.observables.cpu() - cpu.observables).abs().max().item(),
            (res.rho.cpu() - cpu.rho).abs().max().item())
    drift = (res.observables.real.sum(dim=1) - 1.0).abs().max().item()
    p = res.observables[-1].real.cpu().numpy()
    log(f"[main] Redfield FMO n=7 (R 49 x 49) Nt=2000 dt={DT} in {wall:.2f} "
        f"s, |card - cpu| {d:.2e} (tol 1e-10), trace drift {drift:.2e}, "
        f"final populations " + " ".join(f"{x:.4f}" for x in p))
    if not d <= 1e-10:
        raise AssertionError(f"Redfield: card and CPU differ by {d:.3e}")


def lindblad_steps_per_s(sol, rho0, e_ops, nout, short, long, **kw):
    """run() steps/s from the difference of a long and a short run, so
    the setup of run() cancels."""
    walls = []
    for steps in (short, long):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol.run(rho0, dt=LB_DT, Nt=steps, nout=nout, e_ops=e_ops, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (long - short) / (walls[1] - walls[0])


def lindblad_profile(nvib, steps=5):
    """Device time per RK4 step at chip scale by kernel name
    (:func:`profile_steps`)."""
    from pyqed_tpu_torch.core.dynamics import rk4_step
    from pyqed_tpu_torch.ops.kernels import liouvillian_matvec
    H, c, rho0, _ = dimer_problem(nvib)
    dev = torch.device(DEVICE)
    Ht = torch.as_tensor(H, dtype=torch.complex128, device=dev)
    ct = torch.as_tensor(c, dtype=torch.complex128, device=dev)
    step = rk4_step(liouvillian_matvec(Ht, [ct]))
    rho = [torch.as_tensor(rho0, dtype=torch.complex128, device=dev)]

    def advance():
        rho[0] = step(rho[0], 0.0, LB_DT)

    for _ in range(2):
        advance()
    return profile_steps(advance, steps)


def phase_lindblad_timing(card):
    from pyqed_tpu_torch import LindbladSolver
    from pyqed_tpu_torch.ops import kernels as kn
    times = {}
    for n in COMM_TIME_SIZES:
        for dtype in (torch.complex128, torch.complex64):
            args = commutator_inputs(n, dtype)
            kern = kn.liouvillian_commutator
            plain = kn.liouvillian_commutator_ref
            iters = 20 if n <= 1024 else 6
            t = dict(plain=[], kernel=[], library=[])
            for which, fn in (("plain", plain), ("kernel", kern),
                              ("library", commutator_library),
                              ("kernel", kern), ("plain", plain)):
                t[which].append(event_ms(fn, args, iters=iters, warmup=3))
            b = commutator_bound(n, dtype)
            times[(n, dtype)] = dict(
                ms=min(t["kernel"]), plain_ms=min(t["plain"]),
                library_ms=t["library"][0], bound=b)
            log(f"[time] liouvillian_commutator n={n} {str(dtype)[6:]}: "
                "kernel " + " / ".join(f"{x:.3f}" for x in t["kernel"])
                + " ms, plain " + " / ".join(f"{x:.3f}" for x in t["plain"])
                + f" ms, library {t['library'][0]:.3f} ms, bound "
                f"{b[0]:.3f} ms ({b[1]}); kernel at "
                f"{16 * n ** 3 / min(t['kernel']) / 1e9:.1f} TFLOP/s "
                f"({card})")
            del args
    # run() steps/s, in turns
    H, c, rho0, e_ops = dimer_problem(LB_NVIB)
    sols = {k: LindbladSolver(H, [c], kernel=k, device=DEVICE)
            for k in ("cuda", "matmul")}
    order = ["cuda", "matmul", "propagator"]
    rates = {k: [] for k in order}
    for k in order + order[::-1]:
        if k == "propagator":
            rates[k].append(lindblad_steps_per_s(
                sols["cuda"], rho0, e_ops, LB_NOUT, 20000, LB_BENCH_NT,
                method="propagator"))
        else:
            rates[k].append(lindblad_steps_per_s(
                sols[k], rho0, e_ops, LB_NOUT, 200, 2000))
    for k in order:
        log(f"[time] run() Lindblad config #2 n=16 complex128 "
            f"kernel/method={k}: " + ", ".join(f"{r:.0f}" for r in rates[k])
            + f" steps/s ({card})")
    H, c, rho0, e_ops = dimer_problem(LB_BIG_NVIB)
    sols = {k: LindbladSolver(H, [c], kernel=k, device=DEVICE)
            for k in ("cuda", "matmul")}
    rates = {k: [] for k in sols}
    for k in ["cuda", "matmul", "matmul", "cuda"]:
        rates[k].append(lindblad_steps_per_s(
            sols[k], rho0, e_ops, LB_BIG_NOUT, LB_BIG_NOUT, 100))
    for k in sols:
        log(f"[time] run() Lindblad n=1024 complex128 kernel={k}: "
            + ", ".join(f"{r:.2f}" for r in rates[k]) + f" steps/s ({card})")
    steps = 5
    total, rows = lindblad_profile(LB_BIG_NVIB, steps)
    busy = total / 1e3 * max(rates["cuda"]) / 1e3
    log(f"[time] Lindblad n=1024 RK4 step, kernel=cuda, torch.profiler over "
        f"{steps} steps: device {total / 1e3:.3f} ms per step; busy share "
        f"against the fastest unprofiled run() {busy:.2f} ({card})")
    for us, count, key in rows[:10]:
        log(f"[time]   {us / 1e3:8.3f} ms per step, {count:4.1f} kernels "
            f"{key[:80]}")
    log(f"[time] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB ({card})")
    return times


def wall_s(fn, reps=3):
    """Host seconds of fn() ending in a synchronise, for each of reps
    calls after one warm call."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def print_profile(label, total, rows, n=8):
    log(f"[time] {label}: {total / 1e3:.3f} ms of device time per call")
    for us_, count, key in rows[:n]:
        log(f"[time]   {us_ / 1e3:8.3f} ms, {count:5.1f} kernels {key[:80]}")


def phase_2des_timing(card):
    """Times of the 2DES slice, recorded and not claimed: both cube
    builders end to end (in turns) and the factored assembly alone
    against its bound, the tdes cube, DEOM run() steps/s beside HEOM's at
    the same hierarchy, and torch.profiler breakdowns of the cube builders
    and of one DEOM RK4 step."""
    from pyqed_tpu_torch.core.dynamics import rk4_step
    from pyqed_tpu_torch.signal import sos, tdes
    out = {}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = {"series": [], "factored": []}
    for builder in ("series", "factored", "factored", "series"):
        t[builder] += wall_s(lambda: pe_cube(builder, PE_NW, PE_NT2, DEVICE),
                             reps=2)
    for builder, ts in t.items():
        out[f"cube_{builder}_ms"] = min(ts) * 1e3
        out[f"cube_{builder}_maps_per_s"] = PE_NT2 / min(ts)
        log(f"[time] photon-echo cube {builder} {PE_NT2} x {PE_NW}^2 "
            f"complex128, end to end: " + " / ".join(f"{x * 1e3:.2f}"
                                                      for x in ts)
            + f" ms, {PE_NT2 / min(ts):.0f} maps/s ({card})")
    E, dip, gamma = dimer_system()
    w = np.linspace(0.7, 1.45, PE_NW)
    C, A, B = sos._photon_echo_factors(E, dip, gamma, w, w,
                                       np.linspace(0.0, 30.0, PE_NT2),
                                       device=DEVICE, **DIMER_IDX)

    def assemble(C, A, B):
        return (A.T[None, :, :] * C[:, None, :]) @ B

    ms = [event_ms(assemble, (C, A, B), iters=10, warmup=2) for _ in range(3)]
    nbytes = PE_NT2 * PE_NW * PE_NW * 16 + sum(
        x.numel() * 16 for x in (C, A, B))
    flops = 8 * PE_NT2 * PE_NW * PE_NW * C.shape[1]
    b_ms, b_by = bound_ms(nbytes, flops)
    out["assemble_ms"] = min(ms)
    out["assemble_bound_ms"] = b_ms
    log(f"[time] factored assembly (T, W1, K) x (K, W3), K = {C.shape[1]}: "
        + " / ".join(f"{x:.3f}" for x in ms) + f" ms (CUDA events), bound "
        f"{b_ms:.3f} ms ({b_by}: {nbytes / 1e9:.3f} GB), "
        f"{b_ms / min(ms):.2f} of it ({card})")
    del C, A, B
    for builder in ("factored", "series"):
        total, rows = profile_steps(
            lambda: pe_cube(builder, PE_NW, PE_NT2, DEVICE), 2)
        out[f"cube_{builder}_device_ms"] = total / 1e3
        print_profile(f"profile photon-echo cube {builder} (busy share "
                      f"against its fastest call "
                      f"{total / 1e3 / out[f'cube_{builder}_ms']:.2f})",
                      total, rows)

    t1, t2, t3 = td_grids(TD_NT, TD_NT2)

    def twodes():
        return tdes.twodes(dimer_mol(), t1, t2, t3, device=DEVICE,
                           **DIMER_IDX)

    ts = wall_s(twodes)
    out["tdes_ms"] = min(ts) * 1e3
    log(f"[time] tdes.twodes {TD_NT} x {TD_NT2} x {TD_NT} (R and S): "
        + " / ".join(f"{x * 1e3:.2f}" for x in ts) + f" ms ({card})")
    total, rows = profile_steps(twodes, 2)
    out["tdes_device_ms"] = total / 1e3
    print_profile(f"profile tdes.twodes (busy share against its fastest "
                  f"call {total / 1e3 / out['tdes_ms']:.2f})", total, rows)
    log(f"[time] 2DES peak device memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above "
        f"the {base / 2**30:.2f} GiB held before ({card})")

    m, sol = fmo_deom(FLAGSHIP["lmax"])
    heom = m.heom(**FLAGSHIP, device=DEVICE)
    rho0 = m.initial_state(0)
    rates = {"deom": [], "heom": []}
    for which in ("deom", "heom", "heom", "deom"):
        rates[which].append(
            steps_per_s(m, sol, nt=1000) if which == "deom" else
            steps_per_s(m, heom, nt=1000, kernel="cuda",
                        e_ops=m.site_projectors()))
    out["deom_steps_per_s"] = max(rates["deom"])
    out["heom_steps_per_s"] = max(rates["heom"])
    log(f"[time] run() FMO 680 ADOs complex128 steps/s: DEOM "
        + ", ".join(f"{r:.0f}" for r in rates["deom"]) + "; HEOM "
        "kernel='cuda' " + ", ".join(f"{r:.0f}" for r in rates["heom"])
        + f" ({card})")
    rhs, nado, n = sol.rhs_fn()
    step = rk4_step(rhs)
    y = [torch.zeros((nado, n, n), dtype=torch.complex128, device=DEVICE)]
    y[0][0] = rho0.to(DEVICE)

    def advance():
        y[0] = step(y[0], 0.0, DT)

    for _ in range(3):
        advance()
    total, rows = profile_steps(advance, 20)
    out["deom_step_device_ms"] = total / 1e3
    print_profile(f"profile DEOM RK4 step (busy share against the fastest "
                  f"run() {total / 1e6 * max(rates['deom']):.2f})", total,
                  rows)
    return out


# ------------------------------------------------------------ LDR slice
LDR_DT = 0.01                 # bench.py's bench_ldr_tpu
LDR_NT = 400
LDR_NOUT = 20
LDR_TRUTH_NT = 30             # bench.py's _ldr_factored_parity
LDR6_NT = 200
LDR_LEVELS = (5, 6, 7)        # 31^2, 63^2, 127^2 grids x 2 states
LDR_HEOM_NT = 200
LDR_TIME_NT = 2000            # the long run of the steps/s difference
LDR_PROF_NT = 40              # the run() profiled and timed by events


def ldr_model(level, device):
    """bench.py:840-859 (_ldr_model) on the port: a 2-D two-state
    avoided-crossing model (harmonic surface pair, a mixing angle
    0.3 exp(-(X^2 + Y^2)) as the overlap factor S), on a (2^level - 1)^2
    sine-DVR grid over [-4, 4]^2; psi0 a Gaussian on state 0 with unit
    2-norm."""
    from pyqed_tpu_torch.grid.ldr import LDRN
    sol = LDRN([(-4.0, 4.0), (-4.0, 4.0)], [level, level], nstates=2,
               device=device)
    X, Y = np.meshgrid(sol.x[0], sol.x[1], indexing="ij")
    apes = np.stack([0.5 * (X ** 2 + Y ** 2),
                     0.5 * (X ** 2 + Y ** 2) + 1.0], axis=-1)
    th = 0.3 * np.exp(-(X ** 2 + Y ** 2)).reshape(sol.ntot)
    S = np.zeros((sol.ntot, 2, 2))
    S[:, 0, 0] = np.cos(th)
    S[:, 1, 1] = np.cos(th)
    S[:, 0, 1] = -np.sin(th)
    S[:, 1, 0] = np.sin(th)
    psi0 = (np.exp(-(X ** 2 + Y ** 2))[..., None]
            * np.array([1.0, 0.0])).astype(complex)
    psi0 /= np.linalg.norm(psi0)
    sol.apes = apes
    return sol, S.reshape(*sol.nx, 2, 2), psi0


def ldr_f64_truth(level, nsteps, dt):
    """bench.py:1042-1088 (_ldr_f64_truth) in NumPy complex128: the dense
    A ⊙ (expKx ⊗ expKy) from the sine DVR's analytic FBR spectrum, nsteps
    of expV · (A ⊙ K) after the leading half-step, the state LDRN.run
    stores."""
    sol, S, psi0 = ldr_model(level, "cpu")
    ns, ntot = sol.nstates, sol.ntot
    n = ntot * ns
    S = S.reshape(ntot, 2, ns)
    expKs = []
    for dvr in sol.dvr:
        nn = np.asarray(dvr.n, dtype=np.float64)
        U = (np.sin(np.outer(nn, nn) * np.pi / (dvr.npts + 1))
             * np.sqrt(2.0 / (dvr.npts + 1)))
        ph = np.exp(-1j * dt / (2 * dvr.mass) * nn ** 2
                    * np.pi ** 2 / dvr.L ** 2)
        expKs.append(U.T @ (ph[:, None] * U))
    K = np.kron(expKs[0], expKs[1])
    A = np.einsum("mca, ncb -> manb", S, S)
    kin = (A * K[:, None, :, None]).reshape(n, n)
    apes = sol.apes.numpy()
    expVh = np.exp(-1j * (dt / 2) * apes).reshape(n)
    p = expVh * psi0.reshape(n)
    for _ in range(nsteps):
        p = expVh * expVh * (kin @ p)
    return p


def ldr_runs_per_s(sol, psi0, method, nt):
    """run() steps/s from the difference of an nt-step and a one-window
    run, so the setup of run() cancels."""
    walls = []
    for steps in (LDR_NOUT, nt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol.run(psi0, LDR_DT, steps, nout=LDR_NOUT, method=method)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (nt - LDR_NOUT) / (walls[1] - walls[0])


def ldr_record(card, level, sol, psi0, method, build_s, base, out):
    """Steps/s, device time per step by kernel and peak memory (above
    ``base``, the memory allocated when the level began) of one level and
    method, into ``out``."""
    rates = [ldr_runs_per_s(sol, psi0, method, LDR_TIME_NT)
             for _ in range(2)]

    def advance():
        sol.run(psi0, LDR_DT, LDR_PROF_NT, nout=LDR_PROF_NT, method=method)

    advance()
    # the device time of one run() of LDR_PROF_NT steps, its set-up
    # included, per step (the profiler can drop events: rows then count
    # fewer kernels per step than the step runs)
    total, rows = profile_steps(advance, 1, per=LDR_PROF_NT)
    # CUDA events over 20 such runs: the device time of a device-bound
    # step, the host's enqueue of a host-bound one
    ev_us = event_ms(advance, (), iters=20, warmup=2) * 1e3 / LDR_PROF_NT
    n = sol.ntot * sol.nstates
    key = f"level{level}_{method}"
    out[key] = {"n": n, "steps_per_s": max(rates),
                "step_device_us": total, "step_event_us": ev_us,
                "build_s": build_s,
                "busy": total / 1e6 * max(rates),
                "max_memory_gb":
                    (torch.cuda.max_memory_allocated() - base) / 1e9}
    log(f"[ldr] level {level} (n = {n}) {method}: run() "
        + ", ".join(f"{r:.0f}" for r in rates) + f" steps/s, build "
        f"{build_s:.3f} s, peak memory {out[key]['max_memory_gb']:.2f} GB "
        "above the level's start "
        f"({card})")
    print_profile(f"profile LDR level {level} {method} step (busy share "
                  f"{out[key]['busy']:.2f})", total, rows, n=5)
    log(f"[ldr] level {level} {method} step: {ev_us / 1e3:.4f} ms per step "
        f"by CUDA events over 20 run() calls of {LDR_PROF_NT} steps "
        f"({card})")
    if method == "dense":
        b_ms, b_by = bound_ms(16.0 * n * n + 48.0 * n, 8.0 * n * n)
        out[key]["bound_ms"] = b_ms
        log(f"[ldr] level {level} dense step: {ev_us / 1e3:.4f} ms by CUDA "
            f"events, {total / 1e3:.4f} ms of profiled device time, against "
            f"its {b_ms:.4f} ms bound ({b_by}: the (n, n) complex128 matrix "
            "read once)")


def gate(tag, label, val, tol):
    """Log ``val`` against ``tol`` under ``[tag]``; raise above it."""
    log(f"[{tag}] {label}: {val:.3e} (tol {tol:g})")
    if not val <= tol:
        raise AssertionError(f"{tag} {label}: {val:.3e} > {tol:g}")
    return val


def phase_ldr(card):
    """The LDR slice (bench.py's flagship method; no hand-written kernel
    lies on it, every launch count stays 0 until LDRN.heom, read before
    it): bench.py's model at level 5
    (31^2 x 2, n = 1,922) dense against factored over 400 steps, both
    against the NumPy truth over 30 steps (the 1e-8 project gate), the
    first window against the CPU; level 6 (n = 7,938) through the blocked
    build, 200 dense steps against the factored path; level 7 (n =
    32,258) factored only; run_imag (level 5) and run_lvn (level 4)
    against the CPU, NonadiabaticRate on a 1-D LDR against the CPU, and
    LDRN.heom through the coupling kernel (launches 4 x nt) against
    kernel='einsum'; with steps/s, build seconds, device time per step
    and peak memory per level."""
    l5, l6, l7 = LDR_LEVELS
    out = {"gates": {}, "timing": {}}
    gates, timing = out["gates"], out["timing"]
    reset_counts()
    # level 5: dense against factored, the truth, the CPU
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sol, S, psi0 = ldr_model(l5, DEVICE)
    sol.build_ovlp(S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol.short_time_propagator(LDR_DT)
    torch.cuda.synchronize()
    build5 = time.perf_counter() - t0
    rd = sol.run(psi0, LDR_DT, LDR_NT, nout=LDR_NOUT, method="dense")
    rf = sol.run(psi0, LDR_DT, LDR_NT, nout=LDR_NOUT, method="factored")
    gates["l5_dense_vs_factored"] = gate("ldr",
        f"level {l5} dense vs factored, {LDR_NT} steps", rel(rd.states,
                                                           rf.states), 1e-10)
    truth = torch.as_tensor(ldr_f64_truth(l5, LDR_TRUTH_NT, LDR_DT))
    for method in ("dense", "factored"):
        r = sol.run(psi0, LDR_DT, LDR_TRUTH_NT, nout=LDR_TRUTH_NT,
                    method=method)
        gates[f"l5_{method}_vs_truth"] = gate("ldr",
            f"level {l5} {method} vs NumPy truth, {LDR_TRUTH_NT} steps",
            rel(r.psi.reshape(-1).cpu(), truth), 1e-8)
    cpu, _, _ = ldr_model(l5, "cpu")
    cpu.build_ovlp(S)
    rc = cpu.run(psi0, LDR_DT, LDR_NOUT, nout=LDR_NOUT, method="dense")
    gates["l5_first_window_vs_cpu"] = gate("ldr",
        f"level {l5} first window, card vs CPU",
        rel(rd.states[0].cpu(), rc.states[0]), 1e-10)
    norm5 = (rd.psi.abs() ** 2).sum().item()
    gates["l5_norm"] = norm5
    log(f"[ldr] level {l5} norm after {LDR_NT} dense steps {norm5:.15f}")
    ldr_record(card, l5, sol, psi0, "dense", build5, base, timing)
    ldr_record(card, l5, sol, psi0, "factored", 0.0, base, timing)
    # imaginary time at level 5, card against CPU
    ri = sol.run_imag(psi0, LDR_DT, 100, nout=20)
    ci = cpu.run_imag(psi0, LDR_DT, 100, nout=20)
    gates["l5_imag_vs_cpu"] = gate("ldr",
        f"level {l5} run_imag card vs CPU (E = {ri.e_tot:.12f})",
        max(rel(ri.energies.cpu(), ci.energies), rel(ri.psi.cpu(), ci.psi)),
        1e-10)
    del sol, cpu, rd, rf, ri, ci
    # level 6: the blocked build, dense steps against the factored path
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sol, S, psi0 = ldr_model(l6, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol.short_time_propagator_blocked(LDR_DT, S)
    torch.cuda.synchronize()
    build6 = time.perf_counter() - t0
    rd = sol.run(psi0, LDR_DT, LDR6_NT, nout=LDR_NOUT, method="dense")
    rf = sol.run(psi0, LDR_DT, LDR6_NT, nout=LDR_NOUT, method="factored")
    gates["l6_dense_vs_factored"] = gate("ldr",
        f"level {l6} blocked dense vs factored, {LDR6_NT} steps",
        rel(rd.states, rf.states), 1e-10)
    gates["l6_norm"] = (rd.psi.abs() ** 2).sum().item()
    ldr_record(card, l6, sol, psi0, "dense", build6, base, timing)
    ldr_record(card, l6, sol, psi0, "factored", 0.0, base, timing)
    del sol, rd, rf
    # level 7: factored only
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sol, S, psi0 = ldr_model(l7, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol.build_ovlp(S)
    sol.buildV(LDR_DT)
    sol.buildK(LDR_DT)
    torch.cuda.synchronize()
    build7 = time.perf_counter() - t0
    r7 = sol.run(psi0, LDR_DT, LDR_NT, nout=LDR_NOUT, method="factored")
    norm7 = (r7.psi.abs() ** 2).sum().item()
    if not (finite(r7.states) and abs(norm7 - 1.0) <= 1e-10):
        raise AssertionError(f"LDR level {l7}: norm {norm7!r}")
    gates["l7_norm"] = norm7
    log(f"[ldr] level {l7} (n = {sol.ntot * 2}) norm after {LDR_NT} factored "
        f"steps {norm7:.15f}")
    ldr_record(card, l7, sol, psi0, "factored", build7, base, timing)
    del sol, r7
    torch.cuda.empty_cache()
    # Liouville-von Neumann at level 4 (15^2 x 2), card against CPU
    lv = {}
    for dev in (DEVICE, "cpu"):
        s4, S4, p4 = ldr_model(l5 - 1, dev)
        s4.build_ovlp(S4)
        v = p4.reshape(-1)
        lv[dev] = s4.run_lvn(np.outer(v, v.conj()), LDR_DT, 20, nout=10)
    gates["l4_lvn_vs_cpu"] = gate("ldr",
        f"level {l5 - 1} run_lvn card vs CPU",
        rel(lv[DEVICE].states.cpu(), lv["cpu"].states), 1e-10)
    counts = read_counts()
    out["launches_outside_heom"] = counts
    if any(counts.values()):
        raise AssertionError(f"LDR: kernel launches {counts} outside "
                             "LDRN.heom, expected none")
    gates.update(phase_ldr_rate_heom())
    return out


def ldr_1d(device):
    """A 1-D two-state LDR at level 4 (15 points, n = 30): displaced
    harmonic surfaces with a mixing angle, for the HEOM check."""
    from pyqed_tpu_torch.grid.ldr import LDRN
    sol = LDRN([(-4.0, 4.0)], [4], nstates=2, device=device)
    x = sol.x[0]
    sol.apes = np.stack([0.5 * x ** 2, 0.5 * (x - 1.0) ** 2 + 0.3], -1)
    th = 0.3 * np.tanh(x)
    sol.build_ovlp(np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                             np.stack([np.sin(th), np.cos(th)], -1)], -2))
    g = np.exp(-0.5 * (x + 0.5) ** 2)
    psi = np.stack([g, 0 * g], -1).astype(complex)
    psi /= np.sqrt((np.abs(psi) ** 2).sum() * sol.dx[0])
    return sol, psi


def ldr_eckart(device):
    """tests/test_dvr_ldr.py's Eckart barrier 0.003 / cosh^2(2x) (mass
    1836, level 4) as a two-state LDR: the second surface 0.002 higher, a
    mixing angle 0.2 tanh(x)."""
    from pyqed_tpu_torch.grid.ldr import LDRN
    sol = LDRN([(-3.0, 3.0)], [4], nstates=2, mass=[1836.0], device=device)
    x = sol.x[0]
    v = 0.003 / np.cosh(2 * x) ** 2
    sol.apes = np.stack([v, v + 0.002], -1)
    th = 0.2 * np.tanh(x)
    sol.build_ovlp(np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                             np.stack([np.sin(th), np.cos(th)], -1)], -2))
    return sol


def phase_ldr_rate_heom():
    """NonadiabaticRate on the two-state Eckart LDR and LDRN.heom on the
    1-D harmonic LDR, card against the CPU and kernel='cuda' against
    kernel='einsum'."""
    from pyqed_tpu_torch.grid.rate import NonadiabaticRate
    from pyqed_tpu_torch.open.bath import DrudeBath
    gates = {}
    k, c = {}, {}
    reset_counts()
    for dev in (DEVICE, "cpu"):
        k[dev], _, c[dev] = NonadiabaticRate(ldr_eckart(dev)).rate(
            1052.0, t_plateau=1500.0)
    expect_only(read_counts(), "heom_coupling", 0, "NonadiabaticRate")
    gates["rate_vs_cpu"] = gate("ldr",
        f"NonadiabaticRate (k = {k[DEVICE]:.12e}) card vs CPU",
        max(abs(k[DEVICE] - k["cpu"]) / abs(k["cpu"]),
            float(np.max(np.abs(c[DEVICE] - c["cpu"]))
                  / np.max(np.abs(c["cpu"])))), 1e-10)
    sol, psi = ldr_1d(DEVICE)
    sol.buildH()
    v = psi.reshape(-1) * np.sqrt(sol.dx[0])
    rho0 = np.outer(v, v.conj())
    P = [np.kron(np.eye(sol.ntot), np.diag(np.eye(2)[s])) for s in (0, 1)]
    runs = {}
    for kernel in ("cuda", "einsum"):
        heom = sol.heom(DrudeBath(temperature=0.5, cutoff=0.5, reorg=0.05),
                        coupling="population", lmax=2, nexp=1)
        reset_counts()
        t0 = time.perf_counter()
        runs[kernel] = heom.run(rho0, dt=0.01, nt=LDR_HEOM_NT, nout=20,
                                e_ops=P, kernel=kernel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        expect_only(counts, "heom_coupling",
                    4 * LDR_HEOM_NT if kernel == "cuda" else 0,
                    f"LDRN.heom kernel={kernel}")
        if kernel == "cuda":
            gates["heom_launches"] = counts["heom_coupling"]
            log(f"[ldr] LDRN.heom n = 30 (V = 900, {runs[kernel].ado.shape[0]}"
                f" ADOs) {LDR_HEOM_NT} steps in {wall:.2f} s, launches "
                f"{counts}")
    gates["heom_cuda_vs_einsum"] = gate("ldr",
        "LDRN.heom cuda vs einsum", max_diff(runs["cuda"], runs["einsum"]),
        1e-10)
    return gates


# ----------------------------------------------------------- open slice
MC_NTRAJ = 2000
MC_DT = 0.02
MC_NT = 2000
MC_NOUT = 100


def spin_boson():
    """H = sigma_x / 2, Q = sigma_z, a Drude bath at temperature 0.5,
    cutoff 0.5, reorganisation 0.05 (the DEOM drive of the verify notes),
    rho0 = |0><0|."""
    from pyqed_tpu_torch.open.bath import DrudeBath
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    sz = np.diag([1.0, -1.0])
    return (0.5 * sx, sz, DrudeBath(temperature=0.5, cutoff=0.5, reorg=0.05),
            np.diag([1.0, 0.0]).astype(complex))


def phase_open(card):
    """The rest of open/ through the OQS front door, on config #2's dimer
    (n = 16) and a spin-boson: OQS.lindblad through the commutator kernel
    (launches 4 x Nt, equal to LindbladSolver called directly), OQS.heom
    at lmax 4 through the coupling kernel (launches 4 x nt, against
    kernel='einsum'), OQS.tcl2 card against CPU, 2,000 quantum-jump
    trajectories card against CPU on the same draws and against
    LindbladSolver within 5 standard errors, correlation_4p_2t and NRG
    energies card against CPU."""
    from pyqed_tpu_torch import LindbladSolver, OQS, mcsolve
    from pyqed_tpu_torch.open.correlation import correlation_4p_2t
    from pyqed_tpu_torch.open.nrg import NRG, SBM
    out = {}
    H, c, rho0, e_ops = dimer_problem(LB_NVIB)
    kw = dict(dt=LB_DT, nt=LB_NT, nout=LB_NOUT, e_ops=e_ops)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = OQS(H, c_ops=[c], device=DEVICE).lindblad(rho0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_only(counts, "liouvillian_commutator", 4 * LB_NT, "OQS.lindblad")
    out["lindblad_launches"] = counts["liouvillian_commutator"]
    direct = LindbladSolver(H, [c], e_ops=e_ops, device=DEVICE).run(
        rho0, LB_DT, LB_NT, nout=LB_NOUT)
    out["lindblad_vs_direct"] = gate("open",
        f"OQS.lindblad n = 16, {LB_NT} steps in {wall:.2f} s, launches "
        f"{counts}; vs LindbladSolver", max_diff(res, direct,
                                                 ("observables", "rho")),
        1e-14)
    Hs, sz, bath, rs0 = spin_boson()
    sb = OQS(Hs, c_ops=[sz], device=DEVICE)
    hk = dict(dt=0.01, nt=1000, nout=50, bath=bath, lmax=4,
              e_ops=[np.diag([1.0, 0.0]), sz])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rh = sb.heom(rs0, **hk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_only(counts, "heom_coupling", 4 * hk["nt"], "OQS.heom")
    out["heom_launches"] = counts["heom_coupling"]
    out["heom_vs_einsum"] = gate("open",
        f"OQS.heom spin-boson lmax 4 ({rh.ado.shape[0]} ADOs), {hk['nt']} "
        f"steps in {wall:.2f} s, launches {counts}; vs kernel='einsum'",
        max_diff(rh, sb.heom(rs0, kernel="einsum", **hk)), 1e-10)
    tk = dict(dt=0.01, nt=2000, e_ops=[sz], bath=bath)
    rt = sb.tcl2(rs0, **tk)
    ct = OQS(Hs, c_ops=[sz], device="cpu").tcl2(rs0, **tk)
    out["tcl2_vs_cpu"] = gate("open",
        "OQS.tcl2 spin-boson 2000 steps, card vs CPU",
        max_diff(rt, ct, ("observables", "rho")), 1e-10)
    # quantum jumps on the dimer from |e=1, v=3> (decaying at once): the
    # same draws on the card and the CPU; the electronic populations and
    # the vibrational quantum number
    n, nvib = H.shape[0], LB_NVIB
    psi0 = np.eye(n)[nvib + 3].astype(complex)
    mc_ops = [np.diag((np.arange(n) < nvib).astype(float)),
              np.diag((np.arange(n) >= nvib).astype(float)),
              np.diag(np.arange(n) % nvib).astype(float)]
    mk = dict(c_ops=[c], e_ops=mc_ops, dt=MC_DT, nt=MC_NT, ntraj=MC_NTRAJ,
              nout=MC_NOUT, key=SEED)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = mcsolve(H, psi0, device=DEVICE, **mk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_only(read_counts(), "heom_coupling", 0, "mcsolve")
    mcc = mcsolve(H, psi0, device="cpu", **mk)
    out["mcwf_vs_cpu"] = gate("open",
        f"mcsolve n = 16, {MC_NTRAJ} trajectories x {MC_NT} steps in "
        f"{wall:.2f} s ({int(mc.njumps[-1].sum())} jumps), card vs CPU",
        max_diff(mc, mcc, ("observables", "njumps")), 1e-10)
    lb = LindbladSolver(H, [c], device=DEVICE).run(
        np.outer(psi0, psi0.conj()), MC_DT, MC_NT, nout=MC_NOUT,
        e_ops=mc_ops)
    z = ((mc.observables - lb.observables[1:]).real.abs()
         / mc.observables_std.real).max().item()
    out["mcwf_vs_lindblad_se"] = gate("open",
        "mcsolve vs LindbladSolver, largest deviation in standard errors", z,
        5.0)
    A = np.diag(np.arange(H.shape[0], dtype=float) / H.shape[0])
    cm = {}
    for dev in (DEVICE, "cpu"):
        cm[dev] = correlation_4p_2t(H, rho0, (A, c.T, c, A), c_ops=[c],
                                    dt=LB_DT, nt1=10, nt2=100, device=dev)
    out["corr4p2t_vs_cpu"] = gate("open",
        "correlation_4p_2t (10 x 100) card vs CPU",
        rel(cm[DEVICE].cpu(), cm["cpu"]), 1e-10)
    en = {}
    for dev in (DEVICE, "cpu"):
        nrg = NRG(SBM(0.1, 0.05).H, device=dev)
        nrg.run(N=10, nz=8, nkeep=64, alpha=0.1)
        en[dev] = nrg.energies
    out["nrg_vs_cpu"] = gate("open",
        "NRG energies (10 shells, nz 8, nkeep 64) card vs CPU",
        rel(en[DEVICE].cpu(), en["cpu"]), 1e-10)
    log(f"[open] walls above on {card}")
    return out


# -------------------------------------------------- nonadiabatic slice
NA_NTRAJ = 20000              # examples/fssh_tully.py's setup, 20,000 traj
NA_DT = 2.0
NA_NT = 4000
NA_NOUT = 400
NA_CPU_TRAJ = 256             # card vs CPU: the first 256 trajectories
NA_CPU_NT = 800               # over the first two windows (past x = 0)
NA_EDC_NT = 4000
NA_PYR_NTRAJ = 2000           # FSSH on Pyrazine's 3 states (eigh branch)
NA_PYR_NT = 200
NA_PYR_NOUT = 100
EH_NT = 2000                  # Ehrenfest on the same ensemble
EH_NOUT = 250
EH_CPU_NT = 500               # card vs CPU through the crossing (x ~ +2)
EXACT_N = 512                 # the exact SPO wavepacket of test_fssh.py
EXACT_DT = 1.0
EXACT_NT = 2600
NAMD_NX = 2048                # tests/test_namd_adiabatic.py's model
NAMD_DT = 0.25
NAMD_NT = 4000
NAMD_NOUT = 1000
PYR_N = 256                   # Pyrazine.spo() on 256 x 256 x 3
PYR_DT = 10.0
PYR_NT = 2000
PYR_NOUT = 200
SV_N = 128                    # SpinVibronic.spo() on 128 x 128 x 4
SV_NT = 200
POL_NX = 1024                 # VSC (ncav = 10), VibronicPolariton (2 x 5)
POL_NT = 1000
SM_NPTS = 31                  # ShinMetiu2D: 31 x 31 electron grid
SM_NR = 64                    # proton positions on the card
SM_CPU = 8                    # of them on the CPU
TA_NDELAY = 64
TA_NT = 2000
NS10 = 10                     # the generic (ns > 4) SPO potential branch
NS10_N = 1 << 20              # its timing grid: 2^20 points x 10 states
NS_WIDE = 200                 # rows too long to stage in shared memory
NS_WIDE_N = 333
NS_WIDE_TIME_N = 4096


def tully_ensemble(n, seed=SEED):
    """x ~ N(-8, 1), p ~ N(20, 1/2) (examples/fssh_tully.py)."""
    rng = np.random.default_rng(seed)
    return rng.normal(-8.0, 1.0, (n, 1)), rng.normal(20.0, 0.5, (n, 1))


def aten_ops(fn):
    """The aten operations one call of ``fn()`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def na_profile(card, label, advance, steps, rate):
    """Device time per step of ``advance()`` (torch.profiler) and the busy
    share at ``rate`` steps/s; logged, returned as a dict."""
    for _ in range(2):
        advance()
    total, rows = profile_steps(advance, steps)
    busy = total / 1e6 * rate
    log(f"[nonadiabatic] {label}: {rate:.1f} steps/s, device "
        f"{total:.1f} us per step, busy share {busy:.3f} ({card})")
    for us_, count, key in rows[:6]:
        log(f"[nonadiabatic]   {us_:9.2f} us  x{count:<5g} {key[:80]}")
    return dict(steps_per_s=rate, device_us_per_step=total, busy=busy)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exact_tully(card):
    """The exact wavepacket of tests/test_fssh.py on the card: 512 points,
    dt 1, 2600 Strang steps through the SPO kernels; adiabatic surface
    populations at the end."""
    from pyqed_tpu_torch import SPON, tully_i
    v = tully_i()
    x = np.linspace(-25, 35, EXACT_N, endpoint=False)
    V = torch.func.vmap(v)(torch.as_tensor(x[:, None])).numpy()
    spo = SPON([x], masses=[2000.0], nstates=2, device=DEVICE)
    spo.set_dpes(V)
    dx = x[1] - x[0]
    g = np.exp(-(x + 8.0) ** 2 / 4 + 20j * (x + 8.0))
    psi0 = np.zeros((EXACT_N, 2), complex)
    psi0[:, 0] = g / np.sqrt(np.sum(np.abs(g) ** 2) * dx)
    reset_counts()
    res, wall = timed(lambda: spo.run(psi0, dt=EXACT_DT, nt=EXACT_NT,
                                      nout=EXACT_NT, return_states=False))
    counts = read_counts()
    want = {"heom_coupling": 0, "spo_phase": EXACT_NT,
            "spo_potential": 2 * EXACT_NT, "liouvillian_commutator": 0}
    if counts != want:
        raise AssertionError(f"exact Tully SPO: launches {counts}")
    _, Us = np.linalg.eigh(V)
    psiT = res.psi.cpu().numpy()
    pop = np.sum(np.abs(np.einsum("xia, xi -> xa", Us, psiT)) ** 2,
                 axis=0) * dx
    log(f"[nonadiabatic] exact SPO Tully I ({EXACT_N} points, {EXACT_NT} "
        f"steps) in {wall:.2f} s, launches {counts}, adiabatic populations "
        f"{pop[0]:.4f} {pop[1]:.4f}")
    return pop, counts


def phase_fssh(card, out):
    from pyqed_tpu_torch import FSSH, tully_i
    pop_exact, counts_x = exact_tully(card)
    out["exact_spo_launches"] = counts_x
    x0, p0 = tully_ensemble(NA_NTRAJ)
    sol = FSSH(tully_i(), mass=2000.0, device=DEVICE)
    kw = dict(dt=NA_DT, nt=NA_NT, nout=NA_NOUT, key=SEED)
    sol.run(x0[:8], p0[:8], dt=NA_DT, nt=2, nout=1)      # torch.func warm-up
    reset_counts()
    res, wall = timed(lambda: sol.run(x0, p0, **kw))
    expect_only(read_counts(), "heom_coupling", 0, "FSSH")
    rate = NA_NT / wall
    pop, pop_wf = (res.population[-1].cpu().numpy(),
                   res.population_wf[-1].cpu().numpy())
    log(f"[nonadiabatic] FSSH Tully I {NA_NTRAJ} trajectories x {NA_NT} "
        f"steps in {wall:.2f} s ({rate:.1f} steps/s, "
        f"{NA_NTRAJ * rate:.3g} trajectory-steps/s): surface populations "
        f"{pop[0]:.4f} {pop[1]:.4f}, |c|^2 {pop_wf[0]:.4f} {pop_wf[1]:.4f}, "
        f"exact {pop_exact[0]:.4f} {pop_exact[1]:.4f} ({card})")
    out["fssh_vs_exact"] = gate("nonadiabatic",
        "FSSH surface populations vs exact SPO, max |diff|",
        float(np.abs(pop - pop_exact).max()), 0.02)
    out["fssh_wf_vs_exact"] = gate("nonadiabatic",
        "FSSH |c|^2 populations vs exact SPO, max |diff|",
        float(np.abs(pop_wf - pop_exact).max()), 0.02)
    e = res.energy
    out["fssh_energy_drift"] = gate("nonadiabatic",
        "FSSH energy drift through hops, max |E - E0|",
        (e - e[0:1]).abs().max().item(), 1e-4)
    out["fssh_norm"] = gate("nonadiabatic", "FSSH |c| norm error",
                            ((res.c.abs() ** 2).sum(-1) - 1).abs().max()
                            .item(), 1e-8)
    # the first trajectories on the CPU with the same draws
    m = NA_CPU_TRAJ
    cpu = FSSH(tully_i(), mass=2000.0, device="cpu")
    draws = cpu.draws(SEED, NA_NT, NA_NTRAJ)[:NA_CPU_NT, :m]
    rc = cpu.trajectories(cpu.initial_state(x0[:m], p0[:m]), draws, NA_DT,
                          NA_CPU_NT, NA_NOUT)
    w = NA_CPU_NT // NA_NOUT
    diff = max((getattr(res, f)[:w, :m].cpu() - getattr(rc, f)).abs().max()
               .item() for f in ("x", "p"))
    diff = max(diff, ((res.c[:w, :m].abs() ** 2).cpu()
                      - rc.c.abs() ** 2).abs().max().item())
    same = bool(torch.equal(res.active[:w, :m].cpu(), rc.active))
    nhop = int((rc.active[-1] != 0).sum())
    out["fssh_card_vs_cpu"] = gate("nonadiabatic",
        f"FSSH card vs CPU, {m} trajectories x {NA_CPU_NT} steps "
        f"({nhop} on the upper surface), x, p, |c|^2", diff, 1e-10)
    if not same:
        raise AssertionError("FSSH: active surfaces differ between card "
                             "and CPU")
    out["fssh_active_identical"] = same
    # one EDC ensemble
    edc = FSSH(tully_i(), mass=2000.0, decoherence="edc", device=DEVICE)
    re_, wall_e = timed(lambda: edc.run(x0, p0, dt=NA_DT, nt=NA_EDC_NT,
                                        nout=NA_NOUT, key=SEED))
    pe = re_.population[-1].cpu().numpy()
    log(f"[nonadiabatic] FSSH-EDC {NA_NTRAJ} x {NA_EDC_NT} steps in "
        f"{wall_e:.2f} s ({NA_EDC_NT / wall_e:.1f} steps/s): surface "
        f"populations {pe[0]:.4f} {pe[1]:.4f} ({card})")
    out["edc_vs_exact"] = gate("nonadiabatic",
        "FSSH-EDC surface populations vs exact SPO", float(
            np.abs(pe - pop_exact).max()), 0.1)
    out["edc_norm"] = gate("nonadiabatic", "FSSH-EDC |c| norm error",
                           ((re_.c.abs() ** 2).sum(-1) - 1).abs().max()
                           .item(), 1e-8)
    fssh_pyrazine(card, out)
    # ops and device time per step at full width
    state = [sol.initial_state(x0, p0)]
    r = torch.rand(NA_NTRAJ, dtype=torch.float64, device=DEVICE)
    out["fssh_ops_per_step"] = aten_ops(
        lambda: sol._step(state[0], r, NA_DT))

    def advance():
        state[0] = sol._step(state[0], r, NA_DT)

    out["fssh_timing"] = na_profile(card, f"FSSH step, {NA_NTRAJ} "
                                    f"trajectories, {out['fssh_ops_per_step']}"
                                    " aten ops per step", advance, 20, rate)


def fssh_pyrazine(card, out):
    """FSSH on Pyrazine's 3-state dpes (2 modes, S2 excitation): the
    batched-eigh step, which reads the host and so runs eagerly on the
    card; card vs CPU on the first trajectories with the same draws."""
    from pyqed_tpu_torch import FSSH, Pyrazine
    rng = np.random.default_rng(SEED)
    x0 = rng.normal(0.0, 0.7, (NA_PYR_NTRAJ, 2))
    p0 = rng.normal(0.0, 0.7, (NA_PYR_NTRAJ, 2))
    m = NA_CPU_TRAJ
    res = {}
    sols = {}
    for dev, n in ((DEVICE, NA_PYR_NTRAJ), ("cpu", m)):
        model = Pyrazine(device=dev)
        sols[dev] = sol = FSSH(lambda x: model.dpes(x[0], x[1]), mass=model.mass,
                   nstates=3, ndim=2, device=dev)
        draws = sol.draws(SEED, NA_PYR_NT, NA_PYR_NTRAJ)[:, :n]
        if dev == DEVICE:                     # torch.func warm-up
            sol.run(x0[:8], p0[:8], active0=2, dt=10.0, nt=2, nout=1)
        reset_counts()
        res[dev], wall = timed(lambda: sol.trajectories(
            sol.initial_state(x0[:n], p0[:n], active0=2), draws, 10.0,
            NA_PYR_NT, NA_PYR_NOUT))
        expect_only(read_counts(), "heom_coupling", 0, "FSSH Pyrazine")
        if dev == DEVICE:
            rate = NA_PYR_NT / wall
            log(f"[nonadiabatic] FSSH Pyrazine 3 states x 2 modes, "
                f"{n} trajectories x {NA_PYR_NT} steps (eager, batched "
                f"eigh) in {wall:.2f} s ({NA_PYR_NT / wall:.1f} steps/s), "
                "surface populations " + " ".join(
                    f"{v:.4f}" for v in res[dev].population[-1].tolist())
                + f" ({card})")
    rd, rc = res[DEVICE], res["cpu"]
    diff = max((getattr(rd, f)[:, :m].cpu() - getattr(rc, f)).abs().max()
               .item() for f in ("x", "p"))
    diff = max(diff, ((rd.c[:, :m].abs() ** 2).cpu()
                      - rc.c.abs() ** 2).abs().max().item())
    nhop = int((rc.active[-1] != 2).sum())
    out["fssh_pyrazine_card_vs_cpu"] = gate("nonadiabatic",
        f"FSSH Pyrazine card vs CPU, {m} trajectories x {NA_PYR_NT} steps "
        f"({nhop} hopped off S2), x, p, |c|^2", diff, 1e-10)
    if not torch.equal(rd.active[:, :m].cpu(), rc.active):
        raise AssertionError("FSSH Pyrazine: active surfaces differ "
                             "between card and CPU")
    out["fssh_pyrazine_norm"] = gate("nonadiabatic",
        "FSSH Pyrazine |c| norm error", ((rd.c.abs() ** 2).sum(-1) - 1)
        .abs().max().item(), 1e-8)
    sol = sols[DEVICE]
    state = [sol.initial_state(x0, p0, active0=2)]
    r = torch.rand(NA_PYR_NTRAJ, dtype=torch.float64, device=DEVICE)
    out["fssh_pyrazine_ops_per_step"] = aten_ops(
        lambda: sol._step(state[0], r, 10.0))

    def advance():
        state[0] = sol._step(state[0], r, 10.0)

    out["fssh_pyrazine_timing"] = na_profile(
        card, f"FSSH Pyrazine step (eager), {NA_PYR_NTRAJ} trajectories, "
        f"{out['fssh_pyrazine_ops_per_step']} aten ops per step", advance,
        10, rate)


def phase_ehrenfest(card, out):
    from pyqed_tpu_torch import Ehrenfest, tully_i
    x0, p0 = tully_ensemble(NA_NTRAJ)
    c0 = np.tile(np.array([1.0, 0.0], complex), (NA_NTRAJ, 1))
    sol = Ehrenfest(tully_i(), mass=2000.0, device=DEVICE)
    reset_counts()
    res, wall = timed(lambda: sol.run(x0, p0, c0, dt=NA_DT, nt=EH_NT,
                                      nout=EH_NOUT))
    expect_only(read_counts(), "heom_coupling", 0, "Ehrenfest")
    rate = EH_NT / wall
    pop = res.population[-1].mean(0).cpu().numpy()
    log(f"[nonadiabatic] Ehrenfest Tully I {NA_NTRAJ} x {EH_NT} steps in "
        f"{wall:.2f} s ({rate:.1f} steps/s), mean populations "
        f"{pop[0]:.4f} {pop[1]:.4f} ({card})")
    e = res.energy
    out["ehrenfest_energy_drift"] = gate("nonadiabatic",
        "Ehrenfest energy drift, max |E - E0|",
        (e - e[0:1]).abs().max().item(), 1e-5)
    m = NA_CPU_TRAJ
    rc = Ehrenfest(tully_i(), mass=2000.0, device="cpu").run(
        x0[:m], p0[:m], c0[:m], dt=NA_DT, nt=EH_CPU_NT, nout=EH_NOUT)
    w = EH_CPU_NT // EH_NOUT
    out["ehrenfest_card_vs_cpu"] = gate("nonadiabatic",
        f"Ehrenfest card vs CPU, {m} trajectories x {EH_CPU_NT} steps",
        max((getattr(res, f)[:w, :m].cpu() - getattr(rc, f)).abs().max()
            .item() for f in ("x", "p", "c")), 1e-10)
    state = [(torch.as_tensor(x0, device=DEVICE),
              torch.as_tensor(p0, device=DEVICE),
              torch.as_tensor(c0, device=DEVICE))]
    out["ehrenfest_ops_per_step"] = aten_ops(
        lambda: sol._step(state[0], NA_DT))

    def advance():
        state[0] = sol._step(state[0], NA_DT)

    out["ehrenfest_timing"] = na_profile(
        card, f"Ehrenfest RK4 step, {out['ehrenfest_ops_per_step']} aten ops",
        advance, 10, rate)


def namd_model(nx):
    """tests/test_namd_adiabatic.py's avoided crossing at the test's grid
    spacing 24/256: nx points on [-nx 12/256, nx 12/256) (the test's box
    at 2048 points would put k_max^2/2m dt at 9, past RK4's stability
    limit of 2.8)."""
    L = 12.0 * nx / 256
    x = np.linspace(-L, L, nx, endpoint=False)
    e1 = 0.01 * np.tanh(x / 2.0)
    c = 0.005 * np.exp(-(x ** 2) / 8.0)
    dpes = np.zeros((nx, 2, 2))
    dpes[:, 0, 0], dpes[:, 1, 1] = e1, -e1
    dpes[:, 0, 1] = dpes[:, 1, 0] = c
    ddpes = np.zeros((nx, 2, 2))
    ddpes[:, 0, 0] = 0.01 / 2.0 / np.cosh(x / 2.0) ** 2
    ddpes[:, 1, 1] = -ddpes[:, 0, 0]
    ddpes[:, 0, 1] = ddpes[:, 1, 0] = -x / 4.0 * c
    psi0 = np.zeros((nx, 2), complex)
    psi0[:, 0] = (1 / np.pi) ** 0.25 * np.exp(-(x + 5.0) ** 2 / 2
                                              + 12j * (x + 5.0))
    return x, dpes, ddpes, psi0


def phase_namd(card, out):
    from pyqed_tpu_torch import NAMD, SPO, diabatic_to_adiabatic_1d
    x, dpes, ddpes, psi0 = namd_model(NAMD_NX)
    dx = x[1] - x[0]
    v, U, nac = diabatic_to_adiabatic_1d(x, dpes, ddpes=ddpes)
    spo = SPO(x, mass=1000.0, nstates=2, device=DEVICE)
    spo.set_dpes(dpes)
    reset_counts()
    rs, wall_s = timed(lambda: spo.run(np.einsum("xab, xb -> xa", U, psi0),
                                       dt=NAMD_DT, nt=NAMD_NT, nout=NAMD_NT,
                                       return_states=False))
    counts = read_counts()
    if counts != {"heom_coupling": 0, "spo_phase": NAMD_NT,
                  "spo_potential": 2 * NAMD_NT, "liouvillian_commutator": 0}:
        raise AssertionError(f"NAMD reference SPO: launches {counts}")
    out["namd_spo_launches"] = counts
    psi_ad = np.einsum("xba, xb -> xa", U, rs.psi.cpu().numpy())
    pop_dia = np.sum(np.abs(psi_ad) ** 2, axis=0) * dx
    sol = NAMD(x, v, nac, mass=1000.0, order=2, device=DEVICE)
    reset_counts()
    rn, wall = timed(lambda: sol.run(psi0, dt=NAMD_DT, nt=NAMD_NT,
                                     nout=NAMD_NOUT))
    expect_only(read_counts(), "heom_coupling", 0, "NAMD")
    rate = NAMD_NT / wall
    pop = sol.population(rn.psi).cpu().numpy()
    log(f"[nonadiabatic] NAMD order 2, nx = {NAMD_NX}, {NAMD_NT} RK4 steps "
        f"in {wall:.2f} s ({rate:.1f} steps/s); diabatic SPO {NAMD_NT} steps"
        f" in {wall_s:.2f} s, launches {counts}; populations "
        f"{pop[0]:.6f} {pop[1]:.6f} vs {pop_dia[0]:.6f} {pop_dia[1]:.6f} "
        f"({card})")
    if not pop_dia[1] > 0.1:
        raise AssertionError("NAMD: no population transfer in the SPO run")
    out["namd_vs_spo"] = gate("nonadiabatic",
        "NAMD vs diabatic SPO populations", float(np.abs(pop - pop_dia)
                                                  .max()), 2e-4)
    out["namd_norm"] = gate("nonadiabatic", "NAMD norm error",
                            abs(float(sol.norm(rn.psi)) - 1.0), 1e-4)
    rc = NAMD(x, v, nac, mass=1000.0, order=2, device="cpu").run(
        psi0, dt=NAMD_DT, nt=NAMD_NOUT, nout=NAMD_NOUT)
    out["namd_card_vs_cpu"] = gate("nonadiabatic",
        f"NAMD card vs CPU after {NAMD_NOUT} steps",
        rel(rn.states[1].cpu(), rc.states[1]), 1e-10)
    psi = [torch.as_tensor(psi0, device=DEVICE)]

    def advance():
        p = psi[0]
        k1 = sol.rhs(p)
        k2 = sol.rhs(p + 0.5 * NAMD_DT * k1)
        k3 = sol.rhs(p + 0.5 * NAMD_DT * k2)
        k4 = sol.rhs(p + NAMD_DT * k3)
        psi[0] = p + NAMD_DT / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    out["namd_timing"] = na_profile(card, "NAMD RK4 step", advance, 20, rate)


def spo_card_vs_cpu(label, make, psi0, nt, nout, dt, cpu_nt=None):
    """run() of make(device) on the card (launches counted) and of
    make('cpu') for the first ``cpu_nt`` steps; (card result, wall,
    counts, relative difference of the state after cpu_nt steps)."""
    sol = make(DEVICE)
    reset_counts()
    res, wall = timed(lambda: sol.run(psi0, dt=dt, nt=nt, nout=nout))
    counts = read_counts()
    want = {"heom_coupling": 0, "spo_phase": nt, "spo_potential": 2 * nt,
            "liouvillian_commutator": 0}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    cpu_nt = cpu_nt or nt
    rc = make("cpu").run(psi0, dt=dt, nt=cpu_nt, nout=nout)
    w = cpu_nt // nout
    d = rel(res.states[w].cpu(), rc.states[w])
    return sol, res, wall, counts, d


def phase_vibronic_spo(card, out):
    from pyqed_tpu_torch.models.polariton_grid import (GridMol, VSC,
                                                       VibronicPolariton)
    from pyqed_tpu_torch.models.cavity import Cavity
    from pyqed_tpu_torch.models.vibronic import Pyrazine, SpinVibronic
    x = np.linspace(-6.0, 6.0, PYR_N)
    y = np.linspace(-8.0, 6.0, PYR_N)
    X, Y = np.meshgrid(x, y, indexing="ij")
    psi0 = np.zeros((PYR_N, PYR_N, 3), complex)
    g = np.exp(-(X ** 2 + Y ** 2) / 2)
    psi0[..., 2] = g / np.sqrt((g ** 2).sum() * (x[1] - x[0]) * (y[1] - y[0]))
    sol, res, wall, counts, d = spo_card_vs_cpu(
        "Pyrazine", lambda dev: Pyrazine(x, y, device=dev).spo(), psi0,
        PYR_NT, PYR_NOUT, PYR_DT, cpu_nt=PYR_NOUT)
    norms = res.population.sum(1)
    pops = res.population[-1].cpu().numpy()
    rate = PYR_NT / wall
    log(f"[nonadiabatic] Pyrazine S2 excitation {PYR_N}^2 x 3, {PYR_NT} "
        f"steps of {PYR_DT} au in {wall:.2f} s ({rate:.1f} steps/s, build "
        f"included), launches {counts}, final populations "
        + " ".join(f"{p:.4f}" for p in pops) + f" ({card})")
    out["pyrazine_launches"] = counts
    out["pyrazine_norm_drift"] = gate("nonadiabatic",
        "Pyrazine norm drift", (norms - norms[0]).abs().max().item(), 1e-10)
    out["pyrazine_card_vs_cpu"] = gate("nonadiabatic",
        f"Pyrazine card vs CPU after {PYR_NOUT} steps", d, 1e-10)
    psi = [torch.as_tensor(psi0, device=DEVICE)]

    def advance():
        psi[0] = sol.step(psi[0])

    out["pyrazine_timing"] = na_profile(card, "Pyrazine Strang step",
                                        advance, 20, rate)
    xs = np.linspace(-5.0, 5.0, SV_N)
    Xs, Ys = np.meshgrid(xs, xs, indexing="ij")
    ps = np.zeros((SV_N, SV_N, 4), complex)
    gs = np.exp(-((Xs - 1.0) ** 2 + Ys ** 2) / 2)
    ps[..., 1] = gs / np.sqrt((gs ** 2).sum() * (xs[1] - xs[0]) ** 2)
    _, _, wall, counts, d = spo_card_vs_cpu(
        "SpinVibronic", lambda dev: SpinVibronic(device=dev).spo(xs, xs), ps,
        SV_NT, SV_NT // 4, 0.05)
    out["spin_vibronic_card_vs_cpu"] = gate("nonadiabatic",
        f"SpinVibronic {SV_N}^2 x 4 (complex expV), {SV_NT} steps in "
        f"{wall:.2f} s, launches {counts}; card vs CPU", d, 1e-10)
    # more than 4 states: the generic branch of the SPO potential kernel
    xp = np.linspace(-8.0, 8.0, POL_NX, endpoint=False)
    gp = np.exp(-(xp - 0.5) ** 2 / 2)
    gp = gp / np.sqrt((gp ** 2).sum() * (xp[1] - xp[0]))
    pv = np.zeros((POL_NX, 10), complex)
    pv[:, 0] = gp
    total = {"spo_phase": 0, "spo_potential": 0}
    _, _, wall, counts, d = spo_card_vs_cpu(
        "VSC", lambda dev: VSC(xp, 0.5 * xp ** 2, Cavity(1.0, 10), mass=1.0,
                               g=0.05, device=dev), pv, POL_NT, POL_NT // 4,
        0.01)
    out["vsc_card_vs_cpu"] = gate("nonadiabatic",
        f"VSC ncav = 10 on {POL_NX} points, {POL_NT} steps in {wall:.2f} s,"
        f" launches {counts}; card vs CPU", d, 1e-10)
    for k in total:
        total[k] += counts[k]
    vm = np.zeros((POL_NX, 2, 2))
    vm[:, 0, 0] = 0.5 * 0.2 * xp ** 2
    vm[:, 1, 1] = 0.5 * 0.2 * (xp - 1.0) ** 2 + 0.4
    vm[:, 0, 1] = vm[:, 1, 0] = 0.01 * np.exp(-xp ** 2)
    edip = np.array([[0.0, 1.0], [1.0, 0.0]])

    def vp(dev):
        m = VibronicPolariton(GridMol(xp, vm, edip, mass=20.0),
                              Cavity(0.4, 5), device=dev)
        m.dpes(0.05)
        return m

    _, _, wall, counts, d = spo_card_vs_cpu("VibronicPolariton", vp, pv,
                                            POL_NT, POL_NT // 4, 0.5)
    out["vibronic_polariton_card_vs_cpu"] = gate("nonadiabatic",
        f"VibronicPolariton 2 x 5 on {POL_NX} points, {POL_NT} steps in "
        f"{wall:.2f} s, launches {counts}; card vs CPU", d, 1e-10)
    for k in total:
        total[k] += counts[k]
    out["generic_branch_launches"] = total


def phase_na_models(card, out):
    from pyqed_tpu_torch.models.lvc import LVC, Mode
    from pyqed_tpu_torch.models.mol import Mol
    from pyqed_tpu_torch.models.pulse import GaussianPulse
    from pyqed_tpu_torch.models.shinmetiu2d import ShinMetiu2D
    from pyqed_tpu_torch.signal.pump_probe import TransientAbsorption
    rs = np.random.default_rng(SEED).uniform(-1.5, 1.5, (SM_NR, 2))
    E = {}
    for dev, n in ((DEVICE, SM_NR), ("cpu", SM_CPU)):
        m = ShinMetiu2D(nstates=3, device=dev)
        m.create_grid([(-6.0, 6.0), (-6.0, 6.0)], SM_NPTS)
        reset_counts()
        (E[dev], _), wall = timed(lambda: m.pes(rs[:n]))
        expect_only(read_counts(), "heom_coupling", 0, "ShinMetiu2D")
        if dev == DEVICE:
            log(f"[nonadiabatic] ShinMetiu2D.pes {SM_NPTS}^2 grid (n = "
                f"{SM_NPTS ** 2}), {SM_NR} proton positions in {wall:.2f} s "
                f"({card})")
    out["shinmetiu2d_card_vs_cpu"] = gate("nonadiabatic",
        f"ShinMetiu2D eigenvalues card vs CPU at {SM_CPU} positions",
        rel(E[DEVICE][:SM_CPU].cpu(), E["cpu"]), 1e-10)
    modes = [Mode(0.2, [((0, 1), 0.05), ((1, 1), 0.1)], 10),
             Mode(0.12, [((0, 0), -0.03), ((0, 1), 0.02)], 10)]
    lv = {}
    for dev in (DEVICE, "cpu"):
        m = LVC([0.0, 0.3], modes)
        reset_counts()
        lv[dev] = m.run(dt=0.05, nt=2000, nout=100, device=dev,
                        e_ops=[m.buildop(1)])
        expect_only(read_counts(), "heom_coupling", 0, "LVC")
    out["lvc_card_vs_cpu"] = gate("nonadiabatic",
        "LVC 2 x 10 x 10 run (2000 steps) card vs CPU",
        max_diff(lv[DEVICE], lv["cpu"], ("observables", "psi")), 1e-10)
    H = np.diag([0.0, 1.0, 1.9])
    mu = np.array([[0.0, 1.0, 0.2], [1.0, 0.0, 0.7], [0.2, 0.7, 0.0]])
    delays = np.linspace(0.0, 30.0, TA_NDELAY)
    S = {}
    for dev in (DEVICE, "cpu"):
        ta = TransientAbsorption(
            Mol(H, edip=mu), GaussianPulse(omegac=1.0, tau=2.0,
                                           amplitude=0.05),
            GaussianPulse(omegac=1.0, tau=2.0, amplitude=0.01), delays,
            device=dev)
        reset_counts()
        (_, S[dev]), wall = timed(lambda: ta.run(dt=0.05, nt=TA_NT))
        expect_only(read_counts(), "heom_coupling", 0, "pump-probe")
        if dev == DEVICE:
            log(f"[nonadiabatic] TransientAbsorption 3 levels, {TA_NDELAY} "
                f"delays x {TA_NT} RK4 steps in {wall:.2f} s ({card})")
    out["pump_probe_card_vs_cpu"] = gate("nonadiabatic",
        f"TransientAbsorption ({TA_NDELAY} delays) card vs CPU",
        rel(S[DEVICE].cpu(), S["cpu"]), 1e-10)


def phase_nonadiabatic(card):
    """The nonadiabatic-dynamics slice at full width (module constants
    NA_*, EH_*, NAMD_*, PYR_*, SV_*, POL_*, SM_*, TA_*): FSSH on Tully I
    with 20,000 trajectories against the exact SPO wavepacket (through
    the SPO kernels, launches 2 x nt and nt), its energy through hops,
    card vs CPU on 256 trajectories with the same draws, one EDC
    ensemble, FSSH on Pyrazine's 3 states card vs CPU; Ehrenfest on the
    same ensemble; NAMD against diabatic SPO
    at 2048 points; Pyrazine.spo() on 256^2 x 3 (2000 steps),
    SpinVibronic.spo() on 128^2 x 4, VSC (ncav = 10) and VibronicPolariton
    (2 x 5) on 1024 points through the generic SPO branch, card vs CPU;
    ShinMetiu2D.pes, LVC and pump-probe card vs CPU. Every launch count
    is 0 outside the SPO runs. Returns the gates and times."""
    out = {}
    t0 = time.perf_counter()
    phase_fssh(card, out)
    phase_ehrenfest(card, out)
    phase_namd(card, out)
    phase_vibronic_spo(card, out)
    phase_na_models(card, out)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[nonadiabatic] phase wall {out['wall_s']:.1f} s ({card})")
    return out


def phase_ns10_timing(card):
    """The generic (ns > 4) branch of the SPO potential kernel at
    2^20 points x 10 states, at the polariton runs' 1024 x 10 and, rows
    read from device memory, at 4096 x 200, against its plain version,
    torch.matmul and its HBM bound; keyed by (npts, ns)."""
    from pyqed_tpu_torch.ops import kernels as kn
    out = {}
    for npts, ns in ((NS10_N, NS10), (POL_NX, NS10),
                     (NS_WIDE_TIME_N, NS_WIDE)):
        op, psi = spo_inputs("potential", (npts,), ns, torch.complex128,
                             False)
        t = dict(plain=[], kernel=[], library=[])
        lib = spo_library("potential")
        for which, fn in (("plain", kn.spo_potential_apply_ref),
                          ("kernel", kn.spo_potential_apply),
                          ("library", lib),
                          ("kernel", kn.spo_potential_apply),
                          ("plain", kn.spo_potential_apply_ref)):
            t[which].append(event_ms(fn, (op, psi), iters=20, warmup=3))
        b = spo_bound("potential", npts, ns, torch.complex128)
        out[(npts, ns)] = dict(ms=min(t["kernel"]), plain_ms=min(t["plain"]),
                               library_ms=t["library"][0], bound=b)
        log(f"[time] spo_potential generic branch {npts} x {ns} "
            f"complex128 states-last: kernel "
            + " / ".join(f"{x:.4f}" for x in t["kernel"])
            + " ms, plain " + " / ".join(f"{x:.4f}" for x in t["plain"])
            + f" ms, torch.matmul {t['library'][0]:.4f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}), {b[0] / min(t['kernel']):.2f} of it "
            f"({card})")
        del op, psi
    return out


# ------------------------------------------------ field 2DES and grid
F2D_DT = 0.02                 # tests/test_field2des.py's pulses
F2D_WIDTH = 0.3
F2D_T2 = 0.5
F2D_DT1 = 0.4
F2D_NT1 = 16                  # t1s = 0.4 arange(16): B = 4 x 4 x 16 = 256
F2D_NT3 = 256
F2D_AMP = 0.05
F2D_OMEGA = 1.0
F2D_CHECK_NT1 = 2             # kernel='cuda' vs 'einsum' on the card, B = 32
F2D_TLS_NT1 = 24              # examples/field_2des.py: nt1 24, nt3 512
F2D_TLS_NT3 = 512
PARITY_BATCHES = (1, 2, 7, 33, 256)
F2D_DESIGN_BATCHES = (1, 2, 7, 16, 32, 256)   # both designs timed
F2D_TIME_B = 256              # the batched coupling's kernels entry


def f2des_chain():
    """chain_solver()'s n = 8 chain with mu = sum_k |0><k| + h.c. and the
    ground state: (solver, rho0, mu)."""
    sol = chain_solver()
    n = sol.n
    mu = np.zeros((n, n))
    mu[0, 1:] = mu[1:, 0] = 1.0
    rho0 = np.zeros((n, n))
    rho0[0, 0] = 1.0
    return sol, rho0, mu


def f2des_run(sol, rho0, mu, nt1, nt3=F2D_NT3, amps=(F2D_AMP,) * 3,
              kernel="cuda"):
    from pyqed_tpu_torch.signal.field2des import field_2des_rephasing
    return field_2des_rephasing(
        sol, rho0, mu, F2D_DT1 * np.arange(nt1), t2=F2D_T2, nt3=nt3,
        dt=F2D_DT, pulse_width=F2D_WIDTH, e_amps=amps, omega_c=F2D_OMEGA,
        kernel=kernel)


def f2des_nt_total(nt1, nt3):
    """The RK4 steps of one field_2des_rephasing run (its own horizon:
    4 sigma before the first pulse and after the third)."""
    pad = 4.0 * F2D_WIDTH
    t_det0 = pad + F2D_DT1 * (nt1 - 1) + F2D_T2 + pad
    return int(round(t_det0 / F2D_DT)) + nt3


def phase_field2des(card):
    """signal/field2des at full width on the n = 8 chain (680 ADOs, V =
    64; B = 4 x 4 phases x 16 t1 = 256, nt3 256): the coupling kernel
    launched once per right-hand side for the whole batch (4 x nt_total),
    the run profiled by kernel; the same run with E3 = 0 (phase cycling
    cancels it); kernel='cuda' against 'einsum' on the card at B = 32;
    examples/field_2des.py's two-level system card vs CPU, with its
    rephasing peak on (-w0, -w0)."""
    from pyqed_tpu_torch.signal.field2des import rephasing_spectrum
    out = {}
    sol, rho0, mu = f2des_chain()
    B = 16 * F2D_NT1
    nt_total = f2des_nt_total(F2D_NT1, F2D_NT3)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        P3, _, t3s = f2des_run(sol, rho0, mu, F2D_NT1)
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    counts = read_counts()
    expect_only(counts, "heom_coupling", 4 * nt_total, "field 2DES")
    dest_major = batched_launches()
    if dest_major != 4 * nt_total:
        raise AssertionError(f"field 2DES: {dest_major} launches of the "
                             f"destination-major kernel, expected "
                             f"{4 * nt_total}")
    peak_prof = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / nt_total, evt.count / nt_total, evt.key))
    rows.sort(reverse=True)
    dev_step = sum(r[0] for r in rows)
    if not finite(P3) or P3.abs().max().item() <= 1e-8:
        raise AssertionError("field 2DES: P3 not finite or empty")
    # the same run unprofiled, without the third pulse
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    reset_counts()
    (P30, _, _), wall = timed(lambda: f2des_run(
        sol, rho0, mu, F2D_NT1, amps=(F2D_AMP, F2D_AMP, 0.0)))
    expect_only(read_counts(), "heom_coupling", 4 * nt_total,
                "field 2DES E3 = 0")
    if batched_launches() != 4 * nt_total:
        raise AssertionError("field 2DES E3 = 0: not every launch was the "
                             "destination-major kernel's")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out["e3_zero_cancels"] = gate(
        "field2des", "E3 = 0 run, max|P3| over the full run's",
        (P30.abs().max() / P3.abs().max()).item(), 1e-10)
    busy = dev_step * nt_total / 1e6 / wall
    nado = sol._build(torch.complex128)[0].shape[0]
    log(f"[field2des] n = {sol.n} chain ({nado} ADOs, V = {sol.n ** 2}), "
        f"B = {B}, {nt_total} "
        f"RK4 steps: {wall:.2f} s per run unprofiled ({wall_prof:.2f} s "
        f"profiled), {1e3 * wall / nt_total:.2f} ms per step; peak memory "
        f"{peak:.3f} GiB unprofiled ({peak - base:.3f} GiB above the "
        f"{base:.3f} held before it; {peak_prof:.3f} GiB profiled); device "
        f"{dev_step / 1e3:.3f} ms per step, busy share {busy:.3f}; "
        f"launches {counts['heom_coupling']} = 4 x {nt_total}, all "
        f"destination-major ({card})")
    for us_, count, key in rows[:8]:
        log(f"[field2des]   {us_:9.1f} us per step, x{count:<5.2f} "
            f"{key[:80]}")
    out.update(B=B, nt_total=nt_total, launches=counts["heom_coupling"],
               dest_major_launches=dest_major,
               s_per_run=wall, ms_per_step=1e3 * wall / nt_total,
               device_ms_per_step=dev_step / 1e3, busy=busy,
               device_by_kernel_us_per_step={r[2][:60]: r[0]
                                             for r in rows[:8]},
               peak_gib=peak, peak_above_start_gib=peak - base,
               peak_profiled_gib=peak_prof)
    del P30
    # kernel='cuda' against 'einsum' on the card, B = 32
    P = {}
    for k in ("cuda", "einsum"):
        (P[k], _, _), w = timed(lambda: f2des_run(sol, rho0, mu,
                                                  F2D_CHECK_NT1, kernel=k))
        log(f"[field2des] B = {16 * F2D_CHECK_NT1} kernel={k}: {w:.2f} s "
            f"({card})")
    out["cuda_vs_einsum"] = gate(
        "field2des", f"B = {16 * F2D_CHECK_NT1} kernel='cuda' vs 'einsum' "
        "on the card", rel(P["cuda"], P["einsum"]), 1e-10)
    # examples/field_2des.py's two-level system, card vs CPU
    from pyqed_tpu_torch import DrudeBath, HEOMSolver
    sz = np.diag([1.0, -1.0])
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    tls = {}
    for dev in (DEVICE, "cpu"):
        bath = DrudeBath(temperature=0.5, cutoff=0.5, reorg=0.01)
        bath.set_bath_ops([sz])
        s = HEOMSolver((0.5 * F2D_OMEGA * sz).astype(complex), bath=bath,
                       lmax=1, decomposition="pade", nexp=1, device=dev)
        reset_counts()
        tls[dev], w = timed(lambda: f2des_run(
            s, np.diag([1.0, 0.0]), sx, F2D_TLS_NT1, nt3=F2D_TLS_NT3,
            kernel="einsum"))
        expect_only(read_counts(), "heom_coupling", 0, "field 2DES TLS")
        log(f"[field2des] examples/field_2des.py two-level system on "
            f"{dev}: {w:.2f} s")
    out["tls_card_vs_cpu"] = gate(
        "field2des", "examples/field_2des.py card vs CPU",
        rel(tls[DEVICE][0].cpu(), tls["cpu"][0]), 1e-10)
    w1, w3, S = rephasing_spectrum(*tls[DEVICE])
    i, j = np.unravel_index(int(S.abs().argmax()), tuple(S.shape))
    peak = (w1[i].item(), w3[j].item())
    ok = (abs(peak[0] + F2D_OMEGA) < 2 * (w1[1] - w1[0]).item()
          and abs(peak[1] + F2D_OMEGA) < 2 * (w3[1] - w3[0]).item())
    log(f"[field2des] TLS rephasing peak at ({peak[0]:+.3f}, "
        f"{peak[1]:+.3f}), expected (-{F2D_OMEGA}, -{F2D_OMEGA})")
    if not ok:
        raise AssertionError(f"field 2DES TLS peak at {peak}")
    out["tls_peak"] = peak
    return out


def batched_coupling_timing(card):
    """The batched coupling at the field-2DES shape (chain8, B =
    F2D_TIME_B, complex128) through the wrapper and its plain version by
    CUDA events in turns, with the bound and the rate; then both designs
    at each B of F2D_DESIGN_BATCHES, complex128 and complex64, in turns
    (edge-major, destination-major, destination-major, edge-major), from
    which COUPLING_BATCH_MIN was chosen."""
    from pyqed_tpu_torch.ops import kernels as kn
    sol = chain_solver()
    args = batched_operands(sol, torch.complex128, F2D_TIME_B)
    plan = kn.heom_coupling_plan(args[1], args[2])
    fns = {"plain": kn.heom_coupling_ref,
           "kernel": lambda *a: kn.heom_coupling(*a, plan=plan)}
    t = {k: [] for k in fns}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(event_ms(fns[which], args, iters=10, warmup=2))
    b = coupling_bound(*args)
    edges = int((args[1] >= 0).sum().item())
    flops = 8 * args[0].shape[-1] ** 2 * edges * F2D_TIME_B
    ms = min(t["kernel"])
    log(f"[time] heom_coupling batched chain8 B = {F2D_TIME_B} complex128: "
        "kernel " + " / ".join(f"{x:.4f}" for x in t["kernel"]) + " ms, "
        "plain " + " / ".join(f"{x:.3f}" for x in t["plain"]) + f" ms, "
        f"bound {b[0]:.3f} ms ({b[1]}), {b[0] / ms:.3f} of it; "
        f"{flops / ms / 1e9:.1f} TFLOP/s ({card})")
    del args
    by_batch = {}
    for dtype in (torch.complex128, torch.complex64):
        rows = by_batch[str(dtype)[6:]] = {}
        for B in F2D_DESIGN_BATCHES:
            F, nbr, w, OpT = batched_operands(sol, dtype, B)
            bplan = kn.heom_coupling_plan(nbr, w)
            tb = {False: [], True: []}
            for batched in (False, True, True, False):
                tb[batched].append(event_ms(
                    lambda: kn._coupling_launch(F, OpT, bplan, batched), (),
                    iters=10 if B > 64 else 50, warmup=3))
            rows[B] = {"edge_major_ms": min(tb[False]),
                       "dest_major_ms": min(tb[True])}
            log(f"[time] heom_coupling chain8 {str(dtype)[6:]} B = {B}: "
                f"edge-major {us(tb[False], '.1f')} us, destination-major "
                f"{us(tb[True], '.1f')} us ({card})")
            del F
        faster = [B for B, r in rows.items()
                  if r["dest_major_ms"] < r["edge_major_ms"]]
        log(f"[time] {str(dtype)[6:]}: destination-major faster at B = "
            f"{faster}; the wrapper takes it from B = "
            f"{kn.COUPLING_BATCH_MIN[dtype]}")
    return dict(ms=ms, plain_ms=min(t["plain"]), bound=b,
                tflops=flops / ms / 1e9, by_batch=by_batch)


GR_WPDN_N = 20                # WPDN: 20 x 20 Gaussians (400), nquad 24
GR_WPDN_A = 8.0
GR_WPDN_NQUAD = 24
GR_WPDN_NT = 1000
GR_TG_NT = 10000              # ThawedGaussian on a Morse potential
GR_TG_CPU_NT = 200            # card vs CPU over the first 200 steps
GR_NA_N = 64                  # NAWPD and VMCG: examples/vmcg_avoided_crossing.py
GR_NA_NT = 400
GR_VM_ALPHA = 16.0            # VMCG widths: 64 Gaussians on [-8, 8]
GR_VM_NT = 100
GR_VM_CPU_NT = 20
GR_QT_NTRAJ = 100000
GR_QTF_NT = 1000
GR_QTF_CPU_NT = 50            # card vs CPU over the first 50 steps
GR_NAQT_NT = 200
GR_NAQT_CPU_NT = 40
GR_SG_Q = 8                   # SGCT_LDR: tests/test_polariton2_sgct.py
GR_SI = (4, 6, 1000)          # SparseInterpolator: 4-D, level 6, 1,000 points
GR_DVR_N = 48                 # VibrationalDVR3D at 48^3 points
GR_DVR_NEIG = 6
GR_LS = (2000, 128, 4)        # Lippmann-Schwinger: points, k, k on the CPU
GR_FH_L = 6                   # FermiHubbard, half filling


def ac_potential(x):
    """examples/vmcg_avoided_crossing.py's two diabatic surfaces, in
    torch ops of a point x (1,)."""
    c = torch.full_like(x[0], 0.15)
    return torch.stack([torch.stack([0.5 * (x[0] + 1.0) ** 2, c]),
                        torch.stack([c, 0.5 * (x[0] - 1.0) ** 2 + 0.3])])


def ac_spo(nt, dt=0.01, n=256):
    """The example's split-operator reference on the card
    (kernel='xla', so no SPO kernel runs): final populations."""
    from pyqed_tpu_torch import SPON
    xg = np.linspace(-8, 8, n)
    v = np.zeros((n, 2, 2))
    v[:, 0, 0] = 0.5 * (xg + 1.0) ** 2
    v[:, 1, 1] = 0.5 * (xg - 1.0) ** 2 + 0.3
    v[:, 0, 1] = v[:, 1, 0] = 0.15
    spo = SPON([xg], masses=1.0, nstates=2, kernel="xla", device=DEVICE)
    spo.set_dpes(v)
    psi0 = np.zeros((n, 2), complex)
    psi0[:, 0] = np.exp(-0.5 * (xg + 1.0) ** 2)
    psi0 /= np.sqrt((np.abs(psi0) ** 2).sum() * (xg[1] - xg[0]))
    res = spo.run(psi0, dt=dt, nt=nt, nout=nt)
    return res.population[-1]


def grid_wavepackets(card, out):
    from pyqed_tpu_torch.grid.gwp import GWPBasis, ThawedGaussian, WPDN
    from pyqed_tpu_torch.grid.nawpd import NAWPD
    from pyqed_tpu_torch.grid.vmcg import VMCG
    # WPDN: 400 Gaussians on a 20 x 20 grid, an anharmonic 2-D potential
    centers = [np.linspace(-4.0, 4.0, GR_WPDN_N)] * 2
    pot = lambda x: 0.5 * (x[0] ** 2 + 1.3 * x[1] ** 2) + 0.05 * x[0] * x[1] ** 2
    r = {}
    for dev in (DEVICE, "cpu"):
        w = WPDN(GWPBasis.grid(centers, a=GR_WPDN_A, device=dev),
                 potential=pot, nquad=GR_WPDN_NQUAD)
        (E, C), t_build = timed(lambda: w.eigenstates())
        c0 = (C[:, 0] + 0.5 * C[:, 1]).cpu()      # the card's, on both
        if dev == DEVICE:
            c0_card = c0
        run, t_run = timed(lambda: w.run(c0_card, 0.01, GR_WPDN_NT,
                                         nout=10))
        r[dev] = (E, run)
        log(f"[grid] WPDN {GR_WPDN_N ** 2} Gaussians, nquad "
            f"{GR_WPDN_NQUAD} on {dev}: H and eigenstates {t_build:.2f} s, "
            f"{GR_WPDN_NT} steps {t_run:.2f} s")
    out["wpdn_E"] = gate("grid", "WPDN eigenvalues card vs CPU",
                         rel(r[DEVICE][0].cpu(), r["cpu"][0]), 1e-10)
    out["wpdn_run"] = gate("grid", "WPDN coefficients and <x> card vs CPU",
                           max(rel(a.cpu(), b) for a, b in
                               zip(r[DEVICE][1][1:], r["cpu"][1][1:])), 1e-10)
    # ThawedGaussian on a Morse potential (one CUDA graph per step)
    morse = lambda x: 0.2 * (1 - torch.exp(-x)) ** 2
    tg = ThawedGaussian(morse, mass=1.0, device=DEVICE)
    tg.run(0.3, 0.1, dt=0.01, nt=10)      # the first torch.func traces
    res, t_card = timed(lambda: tg.run(0.3, 0.1, dt=0.01, nt=GR_TG_NT,
                                       nout=GR_TG_CPU_NT))
    cpu = ThawedGaussian(morse, mass=1.0, device="cpu").run(
        0.3, 0.1, dt=0.01, nt=GR_TG_CPU_NT, nout=GR_TG_CPU_NT)
    log(f"[grid] ThawedGaussian Morse {GR_TG_NT} RK4 steps on the card in "
        f"{t_card:.2f} s ({GR_TG_NT / t_card:.0f} steps/s, CUDA graph)")
    out["thawed_card_vs_cpu"] = gate(
        "grid", f"ThawedGaussian first {GR_TG_CPU_NT} steps card vs CPU",
        max(rel(a[:1].cpu(), b) for a, b in zip(res[1:], cpu[1:])), 1e-10)
    # RK4's global error at dt = 0.01 over t = 100 (3.2e-6 on an H100)
    out["thawed_norm_drift"] = gate(
        "grid", f"ThawedGaussian norm drift over {GR_TG_NT} steps",
        (res[5].max() - res[5].min()).item() / res[5][0].item(), 1e-5)
    out["thawed_steps_per_s"] = GR_TG_NT / t_card
    # NAWPD on the example's model: 64 Gaussians with a dq^2 = 4
    xq = np.linspace(-6.0, 6.0, GR_NA_N)
    basis = [(q, 4.0 / (xq[1] - xq[0]) ** 2) for q in xq]
    V1 = lambda x: np.array([[0.5 * (x + 1) ** 2, 0.15],
                             [0.15, 0.5 * (x - 1) ** 2 + 0.3]])
    pops = {}
    for dev in (DEVICE, "cpu"):
        nw = NAWPD(basis, V1, device=dev)
        psi0 = nw.project(lambda x: np.exp(-0.5 * (x + 1) ** 2), state=0)
        res, t = timed(lambda: nw.run(psi0, 0.01, GR_NA_NT, nout=40))
        pops[dev] = torch.stack([torch.stack([nw.population(s),
                                              nw.population(s, "diabatic")])
                                 for s in res.states])
        log(f"[grid] NAWPD {GR_NA_N} Gaussians x 2 states, {GR_NA_NT} RK4 "
            f"steps on {dev} in {t:.2f} s")
    out["nawpd_card_vs_cpu"] = gate(
        "grid", "NAWPD populations card vs CPU (eigenvector phases differ)",
        rel(pops[DEVICE].cpu(), pops["cpu"]), 1e-10)
    # VMCG: 64 frozen Gaussians on Ehrenfest trajectories on the
    # example's model, against the CPU and the example's split-operator
    # reference. The example's own basis (unit widths on [-3.5, 2.5])
    # at N = 64 puts many overlap eigenvalues near the 1e-10 cut of the
    # regularized inverse, where LAPACK and cuSOLVER cut differently (the
    # card and the CPU parted by 9e-6 after 20 steps on an H100); with
    # widths 16 on [-8, 8] the smallest is 5e-4 of the largest. The
    # Gaussians far out carry amplitudes near 1e-12, whose ratio between
    # the states, and so whose Ehrenfest force, is rounding noise: the
    # check holds the populations and the amplitudes, not the centres
    qs = np.linspace(-8.0, 8.0, GR_NA_N)[:, None]
    ps = np.zeros((GR_NA_N, 1))
    al = np.full((GR_NA_N, 1), GR_VM_ALPHA + 0j)
    vm = {}
    for dev, nt in ((DEVICE, GR_VM_NT), ("cpu", GR_VM_CPU_NT)):
        sol = VMCG(ac_potential, mass=1.0, nstates=2, device=dev)
        C0 = sol.project(qs, ps, al, np.array([-1.0]), np.array([0.0]),
                         np.array([1.0 + 0j]), state=0)
        vm[dev], t = timed(lambda: sol.run(qs, ps, al, C0, 0.01, nt,
                                           nout=GR_VM_CPU_NT))
        log(f"[grid] VMCG N = {GR_NA_N}, {nt} RK4 steps on {dev} in "
            f"{t:.2f} s ({nt / t:.1f} steps/s, eager: eigh reads the host)")
    out["vmcg_card_vs_cpu"] = gate(
        "grid", f"VMCG populations and amplitudes after {GR_VM_CPU_NT} "
        "steps card vs CPU",
        max(rel(vm[DEVICE][k][1].cpu(), vm["cpu"][k][1])
            for k in ("populations", "C")), 1e-10)
    out["vmcg_vs_spo"] = gate(
        "grid", f"VMCG populations vs split operator after {GR_VM_NT} steps "
        "(the example's tolerance)",
        (vm[DEVICE]["populations"][-1] - ac_spo(GR_VM_NT)).abs().max().item(),
        1e-5)


def grid_trajectories(card, out):
    from pyqed_tpu_torch.grid import qtraj as tq
    N = GR_QT_NTRAJ
    # QT: a free Gaussian (tests/test_lattice_nrg_qt.py:91), one ensemble
    r = {}
    sig0 = 1.0 / np.sqrt(2.0)
    for dev in (DEVICE, "cpu"):
        qt = tq.QT(N, 1, mass=[1.0], device=dev)
        qt.sample(SEED, x0=[0.0], sigma=[sig0])
        qt.set_force(lambda x: torch.zeros_like(x))
        r[dev], t = timed(lambda: qt.run(dt=0.01, nt=200, nout=200))
        log(f"[grid] QT {N} trajectories, 200 steps on {dev} in {t:.2f} s")
    out["qt_card_vs_cpu"] = gate("grid", "QT x, xAve, energy card vs CPU",
                                 max(rel(getattr(r[DEVICE], k).cpu(),
                                         getattr(r["cpu"], k))
                                     for k in ("x", "xAve", "observables")),
                                 1e-10)
    var = r[DEVICE].x.var().item()
    exact = sig0 ** 2 + (2.0 / (2 * sig0)) ** 2
    out["qt_width"] = gate("grid", "QT width at t = 2 vs the free "
                           "Gaussian's, relative", abs(var / exact - 1), 0.02)
    # QTF: tests/test_qtf.py:73 (order 1, no friction) at N trajectories
    derivs = lambda x: (x ** 2 / 2.0, x)
    q = {}
    for dev, nt in ((DEVICE, GR_QTF_NT), ("cpu", GR_QTF_CPU_NT)):
        sol = tq.QTF(N, mass=1.0, order=1, friction=0.0, device=dev)
        ens = sol.sample(a0=0.5, x0=0.8)
        q[dev], t = timed(lambda: sol.run(*ens, derivs, dt=0.02, nt=nt,
                                          nout=50))
        log(f"[grid] QTF {N} trajectories, {nt} RK4 steps on {dev} in "
            f"{t:.2f} s")
    m = GR_QTF_CPU_NT // 50
    out["qtf_card_vs_cpu"] = gate(
        "grid", f"QTF energies over the first {GR_QTF_CPU_NT} steps card vs "
        "CPU", rel(q[DEVICE].observables[:m].cpu(), q["cpu"].observables),
        1e-10)
    E = q[DEVICE].observables[:, 3]
    out["qtf_energy"] = gate("grid", "QTF total energy ptp/mean (the test's "
                             "gate)", ((E.max() - E.min()) / E.mean()).item(),
                             1e-3)
    # NAQT: tests/test_polariton2_sgct.py:132, against the CPU and SPO
    def dpes1(x):
        c = torch.full_like(x[0], 0.15)
        return torch.stack([torch.stack([0.5 * x[0] ** 2, c]),
                            torch.stack([c, 0.5 * x[0] ** 2 + 1.0])])

    na = {}
    for dev, nt in ((DEVICE, GR_NAQT_NT), ("cpu", GR_NAQT_CPU_NT)):
        sol = tq.NAQT(N, 1, 2, dpes1, device=dev)
        x, p, c = sol.sample(a=[2.0], x0=[1.0], state=1)
        na[dev], t = timed(lambda: sol.run(x, p, c, dt=0.005, nt=nt,
                                           nout=40))
        log(f"[grid] NAQT {N} trajectories, {nt} steps on {dev} in "
            f"{t:.2f} s")
    m = GR_NAQT_CPU_NT // 40 + 1
    out["naqt_card_vs_cpu"] = gate(
        "grid", f"NAQT populations and <x> over the first {GR_NAQT_CPU_NT} "
        "steps card vs CPU",
        max(rel(getattr(na[DEVICE], k)[:m].cpu(), getattr(na["cpu"], k))
            for k in ("population", "xave")), 1e-10)
    from pyqed_tpu_torch import SPON
    xg = np.linspace(-8, 8, 192, endpoint=False)
    v = np.zeros((192, 2, 2))
    v[:, 0, 0] = 0.5 * xg ** 2
    v[:, 1, 1] = 0.5 * xg ** 2 + 1.0
    v[:, 0, 1] = v[:, 1, 0] = 0.15
    spo = SPON([xg], masses=[1.0], nstates=2, kernel="xla", device=DEVICE)
    spo.set_dpes(v)
    psi0 = np.zeros((192, 2), complex)
    psi0[:, 1] = np.exp(-(xg - 1.0) ** 2)
    psi0 /= np.sqrt(np.sum(np.abs(psi0) ** 2) * (xg[1] - xg[0]))
    pop = spo.run(psi0, dt=0.005, nt=GR_NAQT_NT, nout=40).population
    out["naqt_vs_spo"] = gate("grid", "NAQT populations vs SPO (exact "
                              "here; the test's gate)",
                              (na[DEVICE].population - pop).abs().max().item(),
                              1e-8)


def grid_sparse_and_eigen(card, out):
    from pyqed_tpu_torch.grid.nusol import VibrationalDVR3D
    from pyqed_tpu_torch.grid.scattering import LippmannSchwingerSolver
    from pyqed_tpu_torch.grid.smolyak import SGCT_LDR, SparseInterpolator

    # SGCT_LDR at q = 8 (tests/test_polariton2_sgct.py:84)
    def dpes(grids):
        X, Y = np.meshgrid(*grids, indexing="ij")
        return (0.5 * (X ** 2 + Y ** 2))[..., None, None]

    def psi0(grids):
        X, Y = np.meshgrid(*grids, indexing="ij")
        return np.exp(-((X - 1.0) ** 2 + Y ** 2) / 2)[..., None]

    sg = {}
    for dev in (DEVICE, "cpu"):
        sg[dev], t = timed(lambda: SGCT_LDR(
            [(-7, 7), (-7, 7)], q=GR_SG_Q, dpes_fn=dpes, psi0_fn=psi0,
            nstates=1, device=dev).run(dt=0.02, nt=60, nout=10))
        log(f"[grid] SGCT_LDR q = {GR_SG_Q} on {dev} in {t:.2f} s")
    out["sgct_card_vs_cpu"] = gate("grid", "SGCT_LDR <x>(t) card vs CPU",
                                   rel(sg[DEVICE][1].cpu(), sg["cpu"][1]),
                                   1e-10)
    t_, xavg = sg[DEVICE][0], sg[DEVICE][1]
    out["sgct_vs_cos"] = gate("grid", "SGCT_LDR <x>(t) vs cos t (the test's "
                              "gate)", (xavg - torch.cos(t_)).abs().max()
                              .item(), 1e-3)
    # SparseInterpolator, 4-D level 6
    d, level, nout = GR_SI
    pts = np.random.default_rng(SEED).random((nout, d))
    f = lambda X: np.exp(-np.sum((X - 0.4) ** 2, axis=1)) * np.cos(X[:, 0])
    si = {}
    for dev in (DEVICE, "cpu"):
        s = SparseInterpolator(level, d, "CC", tol=0.0, device=dev)
        si[dev], t = timed(lambda: s.fit(f, pts))
        log(f"[grid] SparseInterpolator {d}-D level {level}, "
            f"{sum(len(lv['Xn']) for lv in s.levels)} nodes, {nout} points "
            f"on {dev} in {t:.2f} s")
    out["sparse_interp_card_vs_cpu"] = gate(
        "grid", "SparseInterpolator card vs CPU",
        rel(si[DEVICE].cpu(), si["cpu"]), 1e-10)
    out["sparse_interp_error"] = float(
        np.abs(si[DEVICE].cpu().numpy() - f(pts)).max())
    log(f"[grid] SparseInterpolator max error against the function "
        f"{out['sparse_interp_error']:.2e}")
    # VibrationalDVR3D at 48^3 points, 6 eigenpairs
    pes = lambda X, Y, Z: (0.5 * (X ** 2 + 1.3 * Y ** 2 + 0.8 * Z ** 2)
                           + 0.05 * X * Y * Z)
    ev = {}
    for dev in (DEVICE, "cpu"):
        dv = VibrationalDVR3D(pes, [1.0, 1.0, 1.0], [(-6.0, 6.0)] * 3,
                              [GR_DVR_N] * 3, device=dev)
        ev[dev], t = timed(lambda: dv.run(neig=GR_DVR_NEIG, tol=1e-9))
        log(f"[grid] VibrationalDVR3D {GR_DVR_N}^3, {GR_DVR_NEIG} eigenpairs "
            f"on {dev} in {t:.2f} s: {ev[dev].cpu().numpy()}")
    out["dvr3d_card_vs_cpu"] = gate(
        "grid", "VibrationalDVR3D energies card vs CPU (Davidson tol 1e-9)",
        rel(ev[DEVICE].cpu(), ev["cpu"]), 1e-9)
    # Lippmann-Schwinger: 2,000 points x 128 k on the card, 4 k on the CPU
    n, nk, ncpu = GR_LS
    ks = np.linspace(0.5, 6.0, nk)
    V = lambda x: 2.0 * (np.abs(x) < 0.5)
    (psi, T), t = timed(lambda: LippmannSchwingerSolver(
        -8, 8, n - 1, V, device=DEVICE).run(ks))
    sel = np.arange(0, nk, nk // ncpu)
    psi_c, _ = LippmannSchwingerSolver(-8, 8, n - 1, V,
                                       device="cpu").run(ks[sel])
    log(f"[grid] LippmannSchwingerSolver {n} points x {nk} k on the card in "
        f"{t:.2f} s")
    out["lippmann_schwinger_card_vs_cpu"] = gate(
        "grid", f"LippmannSchwingerSolver psi at {ncpu} k card vs CPU",
        rel(psi[torch.as_tensor(sel, device=psi.device)].cpu(), psi_c),
        1e-10)


def grid_lattice(card, out):
    from pyqed_tpu_torch.models.lattice import (FermiHubbard, RiceMele,
                                                green_renormalization)
    fh = {}
    for dev in (DEVICE, "cpu"):
        m = FermiHubbard(1.0, 4.0, GR_FH_L, nelec=GR_FH_L, device=dev)
        fh[dev], t = timed(lambda: m.run(6))
        log(f"[grid] FermiHubbard L = {GR_FH_L} (dimension "
            f"{4 ** GR_FH_L}), half filling, on {dev} in {t:.2f} s: "
            f"{fh[dev].cpu().numpy()}")
    out["fermi_hubbard_card_vs_cpu"] = gate(
        "grid", "FermiHubbard lowest 6 half-filling energies card vs CPU",
        rel(fh[DEVICE].cpu(), fh["cpu"]), 1e-10)
    rm = {}
    for dev in (DEVICE, "cpu"):
        m = RiceMele(0.5, 1.0, nsites=200, device=dev)
        g = green_renormalization(np.array([[0.0, 0.5], [0.5, 0.0]]),
                                  np.array([[0.0, 0.0], [1.0, 0.0]]),
                                  energy=0.3, device=dev)
        rm[dev] = (m.run()[0], m.band_structure(), *g)
    out["rice_mele_card_vs_cpu"] = gate(
        "grid", "RiceMele bands and green_renormalization card vs CPU",
        max(rel(a.cpu(), b) for a, b in zip(rm[DEVICE], rm["cpu"])), 1e-10)


def phase_grid_rest(card):
    """The rest of grid/ and models/lattice at full width, each check
    card against CPU on the same inputs (sizes GR_*): WPDN, ThawedGaussian,
    NAWPD and VMCG (VMCG also against the split-operator reference),
    QT, QTF and NAQT with 100,000 trajectories, SGCT_LDR, the sparse
    interpolator, VibrationalDVR3D with block Davidson, Lippmann-Schwinger,
    Fermi-Hubbard, Rice-Mele and the Sancho-Rubio decimation. No
    hand-written kernel lies on this path: every launch count stays 0."""
    out = {}
    t0 = time.perf_counter()
    reset_counts()
    grid_wavepackets(card, out)
    grid_trajectories(card, out)
    grid_sparse_and_eigen(card, out)
    grid_lattice(card, out)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"grid phase: launches {counts}, expected none")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t0
    log(f"[grid] phase wall {out['wall_s']:.1f} s, launches {counts} "
        f"({card})")
    return out


# ---------------------------------------------------------------- tn/
TN_L = 100                    # DMRG at full width: critical TFIM, L = 100
TN_CHI = 128
TN_SWEEPS = 3                 # 3 of the 5 that converge to 1e-10 (rel
#                               7.5e-12 of the free-fermion energy at 2;
#                               the middle bond is at 114 after 2)
TN_PROBE_BONDS = 10           # bond updates timed, profiled and sync-counted
TN_CPU_L = 20                 # card vs CPU: DMRG, TDVP, TEBD at L = 20
TN_CPU_CHI = 32
TN_CPU_SWEEPS = 2
TN_TDVP_DT = 0.05
TN_TDVP_NT = 2                # the L = 100 quench to h = 2 (5.5 s a step)
TN_TDVP_CPU_NT = 2
TN_TDVP2_CHI = 64
TN_TDVP2_NT = 1
TN_TEBD_NT = 40
TN_PYR = dict(nb=8, nt=30, nout=10)   # Pyrazine4.spectral_dynamics' defaults
#                                       but nt (60 there)
TN_PYR_SHORT_NT = 20          # the CPU reference and the chi 64 exact check
TT_LEVEL = 5                  # examples/ttldr_vibronic.py's model, 31^2 x 2
TT_NT = 20
TT_DT = 0.02


def tfim_free_fermion_energy(L, J=1.0, h=1.0):
    """Exact ground energy of the open chain H = -J sum sz sz - h sum sx
    (the port's mpo_tfim) from free fermions: with Majoranas a_j, b_j the
    Hamiltonian is (i/2) sum M_mn g_m g_n, M real antisymmetric 2L x 2L
    (h on (a_j, b_j), J on (b_j, a_j+1)); E0 = -(1/2) sum |eig(iM)|."""
    M = np.zeros((2 * L, 2 * L))
    for j in range(L):
        M[2 * j, 2 * j + 1] = h
    for j in range(L - 1):
        M[2 * j + 1, 2 * j + 2] = J
    M = M - M.T
    return -0.5 * np.abs(np.linalg.eigvalsh(1j * M)).sum()


def mps_to(mps, device):
    """The same MPS tensors on another device."""
    from pyqed_tpu_torch import tn
    return tn.MPS([B.to(device) for B in mps.Bs],
                  [S.to(device) for S in mps.Ss])


def no_launches(label):
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"{label}: kernel launches {counts}, expected "
                             "none")


def sync_count(fn):
    """(fn(), the host synchronisations it made), counted by
    torch.cuda's sync debug mode (one warning per synchronising call)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_tn(card):
    """tn/ on the card: two-site DMRG on the critical TFIM at L = 100,
    chi 128, against the free-fermion energy (1e-8 relative); card vs CPU
    at L = 20 (energies and Schmidt values 1e-10); one-site TDVP of the
    L = 100 ground state quenched to h = 2 (energy conservation 1e-10) and
    TDVP2 at chi 64 (drift printed); TEBD at L = 20 against the same gates
    applied to the dense state (1e-8); Pyrazine4.spectral_dynamics card vs
    CPU (1e-8) and, at chi 64 (exact for the 3 x 8^4 chain), against
    SciPy's expm_multiply of the sparse LVC Hamiltonian from the same
    padded state (:func:`pyrazine_vs_exact`); TT-LDR at level 5 at full
    ranks against the dense LDRN propagation (1e-8) and at the example's
    ranks. No hand-written kernel lies on this path: every launch count
    stays 0."""
    from pyqed_tpu_torch import tn
    from pyqed_tpu_torch.models.vibronic import Pyrazine4
    out = {}
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    sz = np.diag([1.0, -1.0])
    # ---- DMRG at full width
    mpo = tn.mpo_tfim(TN_L, J=1.0, h=1.0, device=DEVICE)
    psi0 = tn.MPS.random(TN_L, chi=8, seed=SEED, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()          # read by no_launches until the phase ends
    solver = tn.DMRG(mpo, psi0, chi_max=TN_CHI)
    (energies, gs), wall = timed(lambda: solver.run(sweeps=TN_SWEEPS))
    no_launches("DMRG")
    e_exact = tfim_free_fermion_energy(TN_L)
    nb = 2 * (TN_L - 1) * len(energies)
    chis = gs.get_bond_dimensions()
    out["dmrg"] = dict(
        L=TN_L, chi_max=TN_CHI, sweeps=len(energies), energies=energies,
        exact=e_exact, wall_s=wall, bond_updates_per_s=nb / wall,
        max_chi=max(chis),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"[tn] DMRG TFIM L={TN_L} chi_max={TN_CHI}: {len(energies)} sweeps "
        f"in {wall:.2f} s, {nb / wall:.1f} bond updates/s, max bond "
        f"{max(chis)}, peak {out['dmrg']['peak_gib']:.2f} GiB; energies "
        + ", ".join(f"{e:.12f}" for e in energies) + f" ({card})")
    rel_e = abs(energies[-1] - e_exact) / abs(e_exact)
    if rel_e > 1e-8:
        log(f"[tn] chi_max={TN_CHI} reaches rel {rel_e:.3e} of the "
            "free-fermion energy, above the 1e-8 gate")
    out["dmrg"]["rel_err"] = gate("tn", f"DMRG L={TN_L} energy vs free "
                                  f"fermions {e_exact:.12f}", rel_e, 1e-8)
    # bond updates in the middle of the chain: wall, device time, syncs
    mid = range(TN_L // 2 - TN_PROBE_BONDS // 2,
                TN_L // 2 + TN_PROBE_BONDS // 2)

    def probe():
        for i in mid:
            solver.update_bond(i)

    probe()
    _, wall = timed(probe)
    total_us, rows = profile_steps(probe, 1, per=TN_PROBE_BONDS)
    _, syncs = sync_count(probe)
    torch.cuda.synchronize()
    per_bond = wall / TN_PROBE_BONDS
    out["dmrg"].update(
        bond_ms=per_bond * 1e3, device_ms_per_bond=total_us / 1e3,
        busy=total_us / 1e6 / per_bond,
        host_syncs_per_bond=syncs / TN_PROBE_BONDS)
    log(f"[tn] DMRG bond update at chi {chis[TN_L // 2]}: {per_bond * 1e3:.2f}"
        f" ms wall, {total_us / 1e3:.2f} ms device, busy share "
        f"{out['dmrg']['busy']:.3f}, host syncs per bond "
        f"{syncs / TN_PROBE_BONDS:.1f} ({card})")
    for us_, count, key in rows[:6]:
        log(f"[tn]   {us_:9.1f} us x{count:<6g} {key[:80]}")
    # ---- card vs CPU at L = 20
    mpo20 = {d: tn.mpo_tfim(TN_CPU_L, J=1.0, h=1.0, device=d)
             for d in (DEVICE, "cpu")}
    start = tn.MPS.random(TN_CPU_L, chi=8, seed=SEED, device="cpu")
    runs = {d: tn.two_site_dmrg(mpo20[d], mps_to(start, d),
                                chi_max=TN_CPU_CHI, sweeps=TN_CPU_SWEEPS)
            for d in (DEVICE, "cpu")}
    (ec, gc), (eh, gh) = runs[DEVICE], runs["cpu"]
    n = min(len(ec), len(eh))
    d_e = max(abs(a - b) / abs(b) for a, b in zip(ec[:n], eh[:n]))
    d_s = max((a[:min(len(a), len(b))].cpu()
               - b[:min(len(a), len(b))]).abs().max().item()
              for a, b in zip(gc.Ss[1:], gh.Ss[1:]))
    out["dmrg_l20_vs_cpu"] = [
        gate("tn", f"DMRG L={TN_CPU_L} chi {TN_CPU_CHI} energies card vs "
             "CPU", d_e, 1e-10),
        gate("tn", f"DMRG L={TN_CPU_L} Schmidt values card vs CPU", d_s,
             1e-10)]
    # ---- TDVP: the L = 100 ground state quenched to h = 2
    quench = tn.mpo_tfim(TN_L, J=1.0, h=2.0, device=DEVICE)
    td = tn.TDVP(quench, gs, krylov_dim=16)
    e0 = td.expect_mpo().real
    _, wall = timed(lambda: td.run(TN_TDVP_DT, TN_TDVP_NT))
    e1 = td.expect_mpo().real
    no_launches("TDVP")
    out["tdvp"] = dict(steps=TN_TDVP_NT, steps_per_s=TN_TDVP_NT / wall,
                       e0=e0, e1=e1)
    log(f"[tn] TDVP L={TN_L} quench h=1 -> 2, {TN_TDVP_NT} steps of "
        f"{TN_TDVP_DT}: {TN_TDVP_NT / wall:.2f} steps/s ({card})")
    out["tdvp"]["drift"] = gate("tn", "TDVP energy conservation (rel)",
                                abs(e1 - e0) / abs(e0), 1e-10)
    td2 = tn.TDVP2(quench, gs, chi_max=TN_TDVP2_CHI, krylov_dim=16)
    _, wall = timed(lambda: td2.run(TN_TDVP_DT, TN_TDVP2_NT))
    d2 = abs(td2.expect_mpo().real - e0) / abs(e0)
    out["tdvp2"] = dict(steps=TN_TDVP2_NT, steps_per_s=TN_TDVP2_NT / wall,
                        drift=d2, max_chi=max(M.shape[2] for M in td2.Ms))
    log(f"[tn] TDVP2 chi_max={TN_TDVP2_CHI}: {TN_TDVP2_NT} steps at "
        f"{TN_TDVP2_NT / wall:.3f} steps/s, energy drift (rel) {d2:.3e}, "
        f"max bond {out['tdvp2']['max_chi']} ({card})")
    # TDVP card vs CPU at L = 20 from the same tensors
    q20 = {d: tn.mpo_tfim(TN_CPU_L, J=1.0, h=2.0, device=d)
           for d in (DEVICE, "cpu")}
    # (the ground state's tiny Schmidt values leave QR gauges free, so the
    # states are compared, not their tensors)
    tds = {d: tn.TDVP(q20[d], mps_to(gh, d), krylov_dim=16).run(
        TN_TDVP_DT, TN_TDVP_CPU_NT) for d in (DEVICE, "cpu")}
    out["tdvp_l20_vs_cpu"] = [
        gate("tn", f"TDVP L={TN_CPU_L} {TN_TDVP_CPU_NT} steps: the state "
             "card vs CPU", (tds[DEVICE].to_mps().to_dense().cpu()
                             - tds["cpu"].to_mps().to_dense()).abs().max()
             .item(), 1e-10),
        gate("tn", f"TDVP L={TN_CPU_L} <sx_i> card vs CPU", np.abs(
            np.subtract(tds[DEVICE].expect_local([sx] * TN_CPU_L),
                        tds["cpu"].expect_local([sx] * TN_CPU_L))).max(),
             1e-10)]
    # ---- TEBD at L = 20 against the dense gate sequence
    bond = -np.kron(sz, sz) - 0.5 * (np.kron(sx, np.eye(2))
                                     + np.kron(np.eye(2), sx))
    prod = tn.MPS.from_product_state([[1.0, 0.0]] * TN_CPU_L, device=DEVICE)
    psi_t, wall = timed(lambda: tn.tebd(prod, bond, TN_TDVP_DT, TN_TEBD_NT,
                                        chi_max=TN_CPU_CHI * 4))
    no_launches("TEBD")
    w, V = np.linalg.eigh(bond)
    gates = {tau: torch.as_tensor((V * np.exp(-1j * w * tau)) @ V.conj().T,
                                  device=DEVICE)
             for tau in (TN_TDVP_DT, TN_TDVP_DT / 2)}
    psi = prod.to_dense()
    even, odd = range(0, TN_CPU_L - 1, 2), range(1, TN_CPU_L - 1, 2)
    for _ in range(TN_TEBD_NT):
        for sites, tau in ((even, TN_TDVP_DT / 2), (odd, TN_TDVP_DT),
                           (even, TN_TDVP_DT / 2)):
            for i in sites:
                psi = torch.einsum("ab, xbz -> xaz", gates[tau],
                                   psi.reshape(2 ** i, 4, -1)).reshape(-1)
    out["tebd"] = gate("tn", f"TEBD L={TN_CPU_L} {TN_TEBD_NT} steps "
                       f"({wall:.2f} s) vs the dense gate sequence",
                       (psi_t.to_dense() - psi).abs().max().item(), 1e-8)
    # ---- VibronicMPS: Pyrazine4.spectral_dynamics
    (_, p_c), wall = timed(lambda: Pyrazine4(device=DEVICE)
                           .spectral_dynamics(**TN_PYR))
    no_launches("Pyrazine4.spectral_dynamics")
    t0 = time.perf_counter()
    _, p_h = Pyrazine4(device="cpu").spectral_dynamics(
        **dict(TN_PYR, nt=TN_PYR_SHORT_NT))
    wall_cpu = time.perf_counter() - t0
    out["pyrazine"] = dict(card_s=wall, cpu_s=wall_cpu,
                           final_populations=p_c[-1].tolist())
    log(f"[tn] Pyrazine4.spectral_dynamics({TN_PYR}), chi 32: card "
        f"{wall:.2f} s, CPU {wall_cpu:.2f} s over the first "
        f"{TN_PYR_SHORT_NT} steps; final "
        f"populations {p_c[-1].tolist()} ({card})")
    # 1e-8, the project gate: at chi 32 the SVDs cut a spectrum whose
    # tail holds the 1e-8 noise that pad_noise seeds, and LAPACK and
    # cuSOLVER resolve those singular vectors differently at rounding
    out["pyrazine"]["vs_cpu"] = gate(
        "tn", f"Pyrazine4 populations card vs CPU, first {TN_PYR_SHORT_NT} "
        "steps", (p_c[:len(p_h)].cpu() - p_h).abs().max().item(), 1e-8)
    out["pyrazine"]["exact"] = pyrazine_vs_exact(card, p_c)
    # ---- TT-LDR at level 5
    out["ttldr"] = ttldr_vs_dense(card)
    no_launches("phase_tn")
    return out


def pyrazine_vs_exact(card, p_default):
    """Pyrazine4's VibronicMPS at chi 64 (exact for the 3 x 8^4 chain: the
    widest bond is 8^2), its start padded to chi 64 with 1e-8 noise
    (every bond at full rank, so two-site TDVP has no projection error),
    against SciPy's expm_multiply of the sparse 12,288-dimensional LVC
    Hamiltonian from the same padded state (<= 1e-8); and the defaults'
    run ``p_default`` (chi 32, start padded to chi 8) against the exact
    propagation of its own start (printed: the projection error of a
    rank-deficient start); both over the first TN_PYR_SHORT_NT steps."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    from pyqed_tpu_torch.models.vibronic import Pyrazine4
    from pyqed_tpu_torch.tn.vibronic import VibronicMPS, boson_ops
    from pyqed_tpu_torch.units import au2fs
    H_el, omegas, Vs = Pyrazine4(device=DEVICE).lvc()
    nb, nt, nout = TN_PYR["nb"], TN_PYR_SHORT_NT, TN_PYR["nout"]
    dt = 0.25 / au2fs
    vm = VibronicMPS(H_el, omegas, Vs, nb=nb, chi_max=TN_TDVP2_CHI,
                     device=DEVICE)
    (_, pops), wall = timed(lambda: vm.run(el_state=2, dt=dt, nt=nt,
                                           nout=nout, chi_pad=TN_TDVP2_CHI))
    a, ad, num = boson_ops(nb)
    x = sp.csr_matrix((a + ad) / np.sqrt(2.0))
    eye_b = sp.identity(nb, format="csr")

    def embed(el, k, op):
        out = sp.csr_matrix(el)
        for m in range(4):
            out = sp.kron(out, op if m == k else eye_b, format="csr")
        return out

    H = embed(H_el, -1, eye_b)
    for k in range(4):
        H = H + omegas[k] * embed(np.eye(3), k, sp.csr_matrix(num)) \
            + embed(Vs[k], k, x)

    def exact(chi_pad):
        psi = vm.initial_state(2).pad_noise(chi_pad, noise=1e-8).to_dense()
        psi = psi.cpu().numpy()
        pops = [(np.abs(psi.reshape(3, -1)) ** 2).sum(1)]
        for _ in range(nt // nout):
            psi = spl.expm_multiply(-1j * nout * dt * H, psi)
            pops.append((np.abs(psi.reshape(3, -1)) ** 2).sum(1))
        return np.array(pops)

    d_default = np.abs(p_default[:nt // nout + 1].cpu().numpy()
                       - exact(8)).max()
    log(f"[tn] VibronicMPS chi {TN_TDVP2_CHI}, start padded to chi "
        f"{TN_TDVP2_CHI}: {nt} steps in {wall:.2f} s; the defaults (chi 32, "
        f"start padded to chi 8) {d_default:.3e} from the exact propagation "
        f"of their start ({card})")
    return dict(default_vs_exact=d_default, wall_s=wall, vs_exact=gate(
        "tn", f"Pyrazine4 chi {TN_TDVP2_CHI} populations vs sparse "
        "expm_multiply from the same padded state",
        np.abs(pops.cpu().numpy() - exact(TN_TDVP2_CHI)).max(), 1e-8))


def ttldr_model(level, device):
    """examples/ttldr_vibronic.py's two coupled harmonic surfaces with
    rotating local states, on [-5, 5]^2 at ``level``."""
    from pyqed_tpu_torch import LDRN
    domains = [(-5.0, 5.0), (-5.0, 5.0)]
    ldr = LDRN(domains, [level, level], nstates=2, mass=[1.0, 1.0],
               device=device)
    X, Y = np.meshgrid(ldr.x[0], ldr.x[1], indexing="ij")
    v = np.stack([0.5 * (X ** 2 + Y ** 2),
                  0.5 * ((X - 1) ** 2 + Y ** 2) + 1.0], axis=-1)
    theta = 0.25 * np.arctan2(Y, X + 0.1)
    states = np.stack([np.stack([np.cos(theta), np.sin(theta)], -1),
                       np.stack([-np.sin(theta), np.cos(theta)], -1)], -2)
    psi0 = np.zeros((*X.shape, 2), complex)
    psi0[..., 0] = np.exp(-(X - 1.0) ** 2 - Y ** 2)
    psi0 /= np.linalg.norm(psi0)
    ldr.set_apes(v)
    return domains, ldr, v, states, psi0


def ttldr_vs_dense(card):
    """TT-LDR at level 5: full ranks against the dense LDRN propagation
    (1e-8, as tests/test_ttspo.py), the example's ranks printed."""
    from pyqed_tpu_torch import tn
    domains, ldr, v, states, psi0 = ttldr_model(TT_LEVEL, DEVICE)
    A = ldr.build_ovlp(states)
    U = ldr.short_time_propagator(TT_DT)
    psi = torch.as_tensor(psi0, device=DEVICE).reshape(-1)
    for _ in range(TT_NT):
        psi = U @ psi
    psi = psi.reshape(*ldr.nx, 2)
    n1 = ldr.nx[0]
    out = {}
    for label, ranks in (("full", dict(rank_state=2 * n1, rank_pes=2 * n1,
                                       rank_ovlp=4 * n1 * n1)),
                         ("example", dict(rank_state=24, rank_pes=24,
                                          rank_ovlp=96))):
        tt = tn.TT_LDR(domains, [TT_LEVEL] * 2, nstates=2, mass=[1.0, 1.0],
                       device=DEVICE)
        tt.set_apes(v)
        tt.set_ovlp(A)
        res, wall = timed(lambda: tt.run(psi0, TT_DT, TT_NT, **ranks))
        no_launches("TT_LDR")
        d = (tn.tt_to_dense(res["cores_list"][-1]) - psi).abs().max().item()
        out[label] = dict(ranks=ranks, err=d, wall_s=wall,
                          max_rank=max(G.shape[2]
                                       for G in res["cores_list"][-1]))
        log(f"[tn] TT_LDR level {TT_LEVEL} ({n1}^2 x 2) ranks {ranks}: "
            f"{TT_NT} steps in {wall:.2f} s, max state rank "
            f"{out[label]['max_rank']}, max|psi_TT - psi_dense| {d:.3e} "
            f"({card})")
    gate("tn", "TT_LDR full ranks vs dense LDRN", out["full"]["err"], 1e-8)
    return out


# ---------------------------------------------------------------- control
CTL_FIT_ITERS = 100           # examples/optimal_control_grape.py step 3
#                               (150 there; gamma is 8.8e-4 from 0.25 at 100)
CTL_FIT_CPU_ITERS = 10        # the rate fit's first iterations on the CPU
CTL_GRAPE_CPU_FRAC = 0.2      # the example's first 20 % on the CPU
CTL_OG_STEPS = 100            # OpenGRAPE on config #2's dimer, n = 16
CTL_OG_ITERS = 20
CTL_OG_CPU_ITERS = 2
CTL_LB_NT = 200               # the n = 16 rate fit through the kernel
CTL_LB_DT = 0.05
CTL_BWD_SIZES = (16, 1024, 2048)


def grape_examples(device, frac=1.0):
    """examples/optimal_control_grape.py's three problems on ``device``:
    (their numbers, the loss histories), the example's asserts applied;
    ``frac`` < 1 runs that share of each problem's iterations (a CPU
    reference window, no asserts)."""
    from pyqed_tpu_torch.control import GRAPE, OpenGRAPE
    sx = np.array([[0.0, 1.0], [1.0, 0.0]], complex)
    sy = np.array([[0.0, -1j], [1j, 0.0]])
    sz = np.diag([1.0, -1.0]).astype(complex)
    sm = np.array([[0.0, 1.0], [0.0, 0.0]], complex)
    hist, nums = {}, {}
    g = GRAPE(H0=0.5 * sz, Hc=[sx], dt=0.2, n_steps=40, device=device)
    _, hist["state"] = g.optimize_state_transfer(
        [1.0, 0.0], [0.0, 1.0], iters=int(300 * frac), learning_rate=0.08)
    g2 = GRAPE(H0=0.3 * sz, Hc=[sx, sy], dt=0.25, n_steps=30, device=device)
    _, hist["gate"] = g2.optimize_gate(sx, iters=int(400 * frac),
                                       learning_rate=0.08)
    og = OpenGRAPE(H0=0.5 * sz, Hc=[sx], dt=0.2, n_steps=30, c_ops=[0.3 * sm],
                   device=device)
    rho0 = np.diag([1.0, 0.0]).astype(complex)
    e1 = np.array([0.0, 1.0], complex)
    uo, hist["open"] = og.optimize(
        lambda u: 1.0 - og.fidelity_state(u, rho0, e1),
        1e-2 * np.ones((30, 1)), iters=int(250 * frac), learning_rate=0.08)
    nums["state"] = float(hist["state"][-1])
    nums["gate"] = float(hist["gate"][-1])
    nums["p_driven"] = float(og.fidelity_state(uo, rho0, e1))
    nums["p_free"] = float(og.fidelity_state(np.zeros((30, 1)), rho0, e1))
    if frac < 1.0:
        return nums, hist
    for k, ok in (("state", nums["state"] > 0.999),
                  ("gate", nums["gate"] > 0.999),
                  ("open", nums["p_driven"] > nums["p_free"] + 0.5)):
        if not ok:
            raise AssertionError(f"optimal_control_grape.py {k} on {device}: "
                                 f"{nums}")
    return nums, hist


def rate_fit(device, iters):
    """examples/optimal_control_grape.py step 3: recover gamma = 0.25 by
    backpropagating through LindbladSolver (kernel='cuda', the default)."""
    from pyqed_tpu_torch import LindbladSolver
    from pyqed_tpu_torch.control import fit
    sz = torch.as_tensor(np.diag([1.0, -1.0]).astype(complex), device=device)
    sm = torch.as_tensor(np.array([[0.0, 1.0], [0.0, 0.0]], complex),
                         device=device)
    proj1 = np.diag([0.0, 1.0]).astype(complex)

    def trace_of(gamma):
        sol = LindbladSolver(0.5 * sz, c_ops=[torch.sqrt(gamma) * sm],
                             device=device)
        res = sol.run(proj1, dt=0.05, Nt=120, e_ops=[proj1], nout=4)
        return res.observables[:, 0].real

    y = trace_of(torch.tensor(0.25, dtype=torch.float64, device=device))
    lg, losses = fit(lambda lg: torch.mean((trace_of(torch.exp(lg)) - y) ** 2),
                     np.log(0.05), iters=iters, learning_rate=0.1,
                     device=device)
    return float(torch.exp(lg)), losses


def dimer_trace(kernel, gamma):
    """The excited-state population of config #2's dimer over CTL_LB_NT
    steps, its jump operator scaled by sqrt(gamma / 0.01) (gamma = 0.01
    is bench.py's operator)."""
    from pyqed_tpu_torch import LindbladSolver
    H, c, rho0, _ = dimer_problem(LB_NVIB)
    n = H.shape[0]
    pe = np.diag((np.arange(n) >= n // 2).astype(float))
    c = torch.as_tensor(c / 0.1, dtype=torch.complex128, device=DEVICE)
    sol = LindbladSolver(H, [torch.sqrt(gamma) * c], kernel=kernel,
                         device=DEVICE)
    res = sol.run(rho0, dt=CTL_LB_DT, Nt=CTL_LB_NT, e_ops=[pe], nout=10)
    return res.observables[:, 0].real


def dimer_rate_grad(kernel, y, log_gamma):
    """The misfit of the dimer's trace at exp(log_gamma) against ``y`` and
    its derivative in log_gamma."""
    lg = torch.tensor(log_gamma, dtype=torch.float64, device=DEVICE,
                      requires_grad=True)
    loss = torch.mean((dimer_trace(kernel, torch.exp(lg)) - y) ** 2)
    (g,) = torch.autograd.grad(loss, lg)
    return loss.item(), g.item()


def phase_control(card):
    """control/ on the card: examples/optimal_control_grape.py's three
    problems (the example's asserts; loss histories card vs CPU 1e-8, the
    rate fit over its first iterations), OpenGRAPE state transfer on config
    #2's dimer (n = 16, Liouville 256 x 256, 100 slices; card vs CPU over
    the first iterations), the n = 16 rate fit through the commutator
    kernel (gradient vs kernel='matmul' 1e-10; launches 4 Nt forward and
    4 Nt - 1 backward per evaluation: the first right-hand side sees a
    constant rho0), and the kernel's backward against the plain version's
    autograd at n = 16, 1024, 2048 (c128 1e-12, c64 1e-5)."""
    from pyqed_tpu_torch.control import OpenGRAPE
    from pyqed_tpu_torch.ops import kernels as kn
    out = {}
    reset_counts()
    (nums, hist), wall = timed(lambda: grape_examples(DEVICE))
    no_launches("GRAPE examples")
    nums_h, hist_h = grape_examples("cpu", CTL_GRAPE_CPU_FRAC)
    out["grape_examples"] = dict(nums, card_s=wall)
    log(f"[control] optimal_control_grape.py on the card in {wall:.2f} s: "
        f"{nums} ({card})")
    out["grape_vs_cpu"] = gate("control", "GRAPE/OpenGRAPE loss histories "
                               "card vs CPU, first "
                               f"{CTL_GRAPE_CPU_FRAC:.0%} of the iterations",
                               max((hist[k][:len(hist_h[k])].cpu()
                                    - hist_h[k]).abs().max().item()
                                                  for k in hist), 1e-8)
    (gamma, losses), wall = timed(lambda: rate_fit(DEVICE, CTL_FIT_ITERS))
    out["rate_fit"] = dict(gamma=gamma, s=wall,
                           per_iter_ms=wall / CTL_FIT_ITERS * 1e3)
    log(f"[control] rate fit through LindbladSolver (n = 2), {CTL_FIT_ITERS} "
        "iterations "
        f"in {wall:.2f} s: gamma {gamma:.6f} (true 0.25) ({card})")
    if not abs(gamma - 0.25) < 5e-3:
        raise AssertionError(f"rate fit on the card: gamma {gamma}")
    _, losses_h = rate_fit("cpu", CTL_FIT_CPU_ITERS)
    out["rate_fit"]["vs_cpu"] = gate(
        "control", f"rate fit losses card vs CPU, first {CTL_FIT_CPU_ITERS}",
        (losses[:CTL_FIT_CPU_ITERS].cpu() - losses_h).abs().max().item()
        / losses_h.abs().max().item(), 1e-8)
    # ---- OpenGRAPE on config #2's dimer
    H, c, rho0, _ = dimer_problem(LB_NVIB)
    n = H.shape[0]
    nv = n // 2
    mu = np.zeros((n, n))
    mu[:nv, nv:] = mu[nv:, :nv] = np.eye(nv)
    pe = np.diag((np.arange(n) >= nv).astype(float))
    g0 = np.zeros((n, n))
    g0[0, 0] = 1.0
    runs = {}
    for dev, iters in ((DEVICE, CTL_OG_ITERS), ("cpu", CTL_OG_CPU_ITERS)):
        og = OpenGRAPE(H0=H, Hc=[0.1 * mu], dt=0.5, n_steps=CTL_OG_STEPS,
                       c_ops=[c], device=dev)
        runs[dev] = timed(lambda: og.optimize(
            lambda u: 1.0 - og.fidelity_state(u, g0, pe),
            np.full((CTL_OG_STEPS, 1), 0.5), iters=iters,
            learning_rate=0.2))
    (u, l), wall = runs[DEVICE]
    out["open_grape_dimer"] = dict(n=n, steps=CTL_OG_STEPS,
                                   iters=CTL_OG_ITERS,
                                   ms_per_iter=wall / CTL_OG_ITERS * 1e3,
                                   loss_first=l[0].item(),
                                   loss_last=l[-1].item())
    log(f"[control] OpenGRAPE dimer n={n} (Liouville {n * n}^2), "
        f"{CTL_OG_STEPS} slices: {CTL_OG_ITERS} iterations at "
        f"{wall / CTL_OG_ITERS * 1e3:.1f} ms; excited population "
        f"{1 - l[0].item():.4f} -> {1 - l[-1].item():.4f} ({card})")
    if not (torch.isfinite(l).all() and l[-1] < l[0]):
        raise AssertionError(f"OpenGRAPE dimer: losses {l.tolist()}")
    (_, l_h), _ = runs["cpu"]
    out["open_grape_dimer"]["vs_cpu"] = gate(
        "control", f"OpenGRAPE dimer losses card vs CPU, first "
        f"{CTL_OG_CPU_ITERS}", (l[:CTL_OG_CPU_ITERS].cpu() - l_h).abs().max()
        .item(), 1e-8)
    # ---- the n = 16 rate fit through the kernel: gradient and launches
    with torch.no_grad():
        y = dimer_trace("matmul", torch.tensor(0.01, dtype=torch.float64,
                                               device=DEVICE))
    reset_counts()
    (loss_k, grad_k), wall = timed(lambda: dimer_rate_grad(
        "cuda", y, np.log(0.02)))
    counts = read_counts()
    bwd = kn.liouvillian_commutator.backward_launches
    expect_only(counts, "liouvillian_commutator", 4 * CTL_LB_NT,
                "rate fit n = 16, forward")
    expect_only({"backward": bwd}, "backward", 4 * CTL_LB_NT - 1,
                "rate fit n = 16, backward")
    loss_m, grad_m = dimer_rate_grad("matmul", y, np.log(0.02))
    out["dimer_rate_fit"] = dict(
        loss=loss_k, grad=grad_k, forward_launches=counts[
            "liouvillian_commutator"], backward_launches=bwd, s=wall)
    log(f"[control] rate fit n=16 ({CTL_LB_NT} steps): loss {loss_k:.6e}, "
        f"d/dlog(gamma) {grad_k:.12e} (matmul {grad_m:.12e}); launches "
        f"{counts['liouvillian_commutator']} forward, {bwd} backward; "
        f"{wall:.2f} s ({card})")
    out["dimer_rate_fit"]["grad_vs_matmul"] = gate(
        "control", "rate fit n = 16 gradient cuda vs matmul (rel)",
        abs(grad_k - grad_m) / abs(grad_m), 1e-10)
    out["backward"] = commutator_backward_parity()
    return out


def commutator_backward_parity():
    """The commutator's backward (one launch of the kernel on -H_eff^dag)
    against the plain version's autograd, gradients in rho and in H_eff."""
    from pyqed_tpu_torch.ops import kernels as kn
    errs = {}
    for n in CTL_BWD_SIZES:
        for dtype, tol in ((torch.complex128, 1e-12),
                           (torch.complex64, 1e-5)):
            H, rho = commutator_inputs(n, dtype)
            g, _ = commutator_inputs(n, dtype, seed=SEED + 1)
            H.requires_grad_(True)
            rho.requires_grad_(True)
            reset_counts()
            got = torch.autograd.grad(kn.liouvillian_commutator(H, rho),
                                      (H, rho), g)
            if H.is_cuda and kn.liouvillian_commutator.backward_launches != 1:
                raise AssertionError("the backward did not launch the kernel")
            want = torch.autograd.grad(kn.liouvillian_commutator_ref(H, rho),
                                       (H, rho), g)
            for name, a, b in (("d/drho", got[1], want[1]),
                               ("d/dH", got[0], want[0])):
                errs[(n, dtype, name)] = check_close(
                    f"liouvillian_commutator backward {name} n={n} "
                    f"{str(dtype)[6:]}", a, b, tol)
            del H, rho, g, got, want
    return errs


def commutator_backward_timing(card, n=1024):
    """One backward call (the kernel on -H_eff^dag and g) against the plain
    version's backward for rho and two ZGEMMs, in turns."""
    from pyqed_tpu_torch.ops import kernels as kn
    H, g = commutator_inputs(n, torch.complex128)
    Hm = (-H.mH).contiguous()

    def kernel():
        return kn._commutator_launch(Hm, g)

    def plain():
        return 1j * (H.mH @ g - g @ H)

    t = dict(plain=[], kernel=[], library=[])
    for which, fn in (("plain", plain), ("kernel", kernel),
                      ("library", lambda: commutator_library(Hm, g)),
                      ("kernel", kernel), ("plain", plain)):
        t[which].append(event_ms(fn, (), iters=20, warmup=3))
    b = commutator_bound(n, torch.complex128)
    log(f"[time] liouvillian_commutator backward n={n} complex128: kernel "
        + " / ".join(f"{x:.3f}" for x in t["kernel"]) + " ms, plain "
        + " / ".join(f"{x:.3f}" for x in t["plain"]) + f" ms, two ZGEMMs "
        f"{t['library'][0]:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) ({card})")
    return dict(ms=min(t["kernel"]), plain_ms=min(t["plain"]),
                library_ms=t["library"][0], bound=b)


# ------------------------------------------------------------- qchem
QC_BASIS = "6-31g*"           # benzene RHF and RKS: 102 Cartesian AOs
QC_CC_BASIS = "6-31g"         # benzene CCSD: 66 AOs, 132 spin orbitals
QC_NROOTS = 6                 # TDA/TDHF singlet roots
QC_XC = "b3lyp"
QC_GRID = dict(n_rad=60, n_theta=14)   # RKS's default: 282,240 points
QC_WATER = [("O", (0.0, 0.0, 0.0)), ("H", (0.0, -1.43, 1.11)),
            ("H", (0.0, 1.43, 1.11))]  # examples/qchem_water.py
QC_WATER_CC_BASIS = "6-31g**"  # CCSD and (T), card vs CPU
QC_WATER_DET_BASIS = "sto-3g"  # EOM-CCSD, FCI, CASCI, CASSCF, the Hessian
QC_OPT_BASIS = "6-31g"         # GeometryOptimizer from the example's start
QC_H4 = [("H", (0.0, 0.0, 1.8 * i)) for i in range(4)]  # ab_initio_dmrg.py


def benzene():
    """D6h benzene in the xy plane: C at 2.634 bohr and H at 4.686 bohr
    from the centre."""
    ang = np.arange(6) * np.pi / 3
    return ([("C", (2.634 * np.cos(a), 2.634 * np.sin(a), 0.0)) for a in ang]
            + [("H", (4.686 * np.cos(a), 4.686 * np.sin(a), 0.0))
               for a in ang])


QC_MOLECULE = benzene


def qc_on_cpu(mf, cpu_mol, cls, **kw):
    """The card mean field's orbitals on the CPU twin: the CPU runs of the
    post-SCF methods start from the same orbitals as the card's."""
    from pyqed_tpu_torch.qchem import scf_from_reference

    def h(x):
        return (tuple(y.cpu().numpy() for y in x)
                if isinstance(x, (tuple, list)) else x.cpu().numpy())
    return scf_from_reference(cpu_mol, cls, mo_coeff=h(mf.mo_coeff),
                              mo_energy=h(mf.mo_energy), dm=h(mf.dm),
                              nocc=mf.nocc, e_tot=mf.e_tot,
                              converged=mf.converged, **kw)


def qc_abs(a, b):
    def h(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    return float(np.max(np.abs(h(a) - h(b))))


def degenerate_sums(e, f, n, tol=1e-5):
    """(energy, summed f) of each set of roots within ``tol`` of each
    other among the first ``n``; a set that may continue past the last
    computed root is dropped. Card and CPU ``eigh`` may rotate inside a
    degenerate set, the sums do not change."""
    e, f = np.asarray(e), np.asarray(f)
    out, start = [], 0
    for k in range(1, len(e) + 1):
        if k == len(e) or e[k] - e[k - 1] > tol:
            if k <= n and k < len(e):
                out.append((float(e[start:k].mean()), float(f[start:k].sum())))
            start = k
    return out


def qc_stage(out, name, fn, tag="qchem"):
    """Run one stage, record and print its seconds."""
    res, wall = timed(fn)
    out.setdefault("stage_s", {})[name] = wall
    log(f"[{tag}] {name}: {wall:.2f} s")
    return res


def phase_qchem(card):
    """qchem/ on the card at full width: benzene (D6h) RHF/6-31G* (102
    Cartesian AOs) — the host integrals and the C++ ERI engine (the ERI
    and the 2.6 GB dERI), SCF, MP2, TDA and TDHF (6 singlet roots), the
    analytic gradient, the CPHF
    polarizability, Mulliken/IAO charges and Boys localisation; RKS/B3LYP
    on the default Becke grid and its analytic gradient; CCSD/6-31G (132
    spin orbitals). Each result but CCSD is held against the port on the
    card host's CPU: the SCFs run on both, the post-SCF methods start on
    the CPU from the card's orbitals; degenerate sets are compared
    through invariants (energies, densities, summed oscillator strengths,
    forces). The CCSD gates: converged to 1e-10 and its energy at the MP2
    amplitudes equal to MP2's. Water holds CCSD, (T) (6-31G**), EOM-CCSD,
    FCI, CASCI and CASSCF (STO-3G) card vs CPU; then the examples' paths
    (qchem_water.py, a GeometryOptimizer run, the STO-3G Hessian and
    DMRGQC on H4 against FCI). The CPU runs take over the card
    molecule's host-built integrals (``Molecule.to``). Every gate's
    reading is kept under "gates".
    Returns (its results, benzene's molecules and mean fields for
    :func:`phase_qchem_rest`).
    No hand-written kernel lies on this path: every launch count stays
    0."""
    from pyqed_tpu_torch import qchem as qc
    from pyqed_tpu_torch.qchem import engine
    from pyqed_tpu_torch.qchem.ci import CASSCF
    from pyqed_tpu_torch.qchem.grad import (derivative_integrals, ks_gradient,
                                            rhf_gradient)
    from pyqed_tpu_torch.qchem.hessian import Hessian
    from pyqed_tpu_torch.tn import DMRGQC
    t_phase = time.perf_counter()
    out = {"card": card}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()          # read by no_launches when the phase ends
    out["gates"] = {}

    def qgate(label, val, tol):
        out["gates"][label] = gate("qchem", label, val, tol)

    qc_stage(out, "ERI engine build (g++)", engine.build)
    # ---------------------------------------------- benzene RHF/6-31G*
    mol = qc.Molecule(QC_MOLECULE(), basis=QC_BASIS, device=DEVICE)
    qc_stage(out, "benzene integrals (host) + copy", mol.intor)
    out["integrals_s"] = dict(mol.intor_seconds)
    log(f"[qchem] {QC_BASIS}: {mol.nao} AOs, {mol.nelec // 2} doubly "
        f"occupied; host integrals: one-electron "
        f"{mol.intor_seconds['one_electron']:.2f} s, ERI (C++ engine, "
        f"{os.cpu_count()} host cores) {mol.intor_seconds['eri']:.2f} s, "
        f"copy to the card {mol.intor_seconds['to_device']:.2f} s "
        f"({mol.nao ** 4 * 8 / 1e9:.2f} GB)")
    dE1 = qc_stage(out, "benzene derivative integrals (host; dERI by the "
                        "C++ engine) + copy",
                   lambda: derivative_integrals(mol))[3]
    out["eri_deriv_gb"] = dE1.numel() * 8 / 1e9
    del dE1
    cmol = mol.to("cpu")        # the host-built integrals, not rebuilt
    qc_stage(out, "RHF SCF (card, first: cuBLAS/cuSOLVER set-up)",
             lambda: qc.RHF(mol).run())
    mf = qc_stage(out, "RHF SCF (card)", lambda: qc.RHF(mol).run())
    qgate("RHF converged (0 = yes)", float(not mf.converged), 0.0)
    out["rhf"] = dict(e_tot=mf.e_tot, cycles=mf.cycles,
                      s_per_cycle=out["stage_s"]["RHF SCF (card)"]
                      / mf.cycles)
    log(f"[qchem] RHF E = {mf.e_tot:.10f} in {mf.cycles} cycles, "
        f"{out['rhf']['s_per_cycle'] * 1e3:.2f} ms a cycle ({card})")
    cmf = qc_stage(out, "RHF SCF (CPU)", lambda: qc.RHF(cmol).run())
    out["rhf"]["cpu_cycles"] = cmf.cycles
    qgate("RHF energy card vs CPU", abs(mf.e_tot - cmf.e_tot), 1e-10)
    qgate("RHF density card vs CPU", qc_abs(mf.dm, cmf.dm), 1e-8)
    qgate("RHF orbital energies card vs CPU",
          qc_abs(mf.mo_energy, cmf.mo_energy), 1e-8)
    ref = qc_on_cpu(mf, cmol, qc.RHF)          # the card's orbitals

    mp = qc_stage(out, "MP2 (card)", lambda: qc.MP2(mf).run())
    cmp_ = qc.MP2(ref).run()
    out["mp2"] = dict(e_corr=mp.e_corr)
    qgate("MP2 e_corr card vs CPU", abs(mp.e_corr - cmp_.e_corr),
          1e-10)
    nr = QC_NROOTS + 4
    td = qc.TDA(mf)
    e_tda = qc_stage(out, "TDA (card)", lambda: td.run(nr))
    e_tdhf = qc_stage(out, "TDHF (card)", lambda: qc.TDHF(mf).run(nr))
    ctd = qc.TDA(ref)
    qgate(f"TDA {QC_NROOTS} roots card vs CPU",
          qc_abs(e_tda[:QC_NROOTS], ctd.run(nr)[:QC_NROOTS]), 1e-10)
    qgate(f"TDHF {QC_NROOTS} roots card vs CPU",
          qc_abs(e_tdhf[:QC_NROOTS], qc.TDHF(ref).run(nr)[:QC_NROOTS]),
          1e-10)
    g_card = degenerate_sums(e_tda, td.oscillator_strength(), QC_NROOTS)
    g_cpu = degenerate_sums(ctd.e, ctd.oscillator_strength(), QC_NROOTS)
    qgate("TDA summed oscillator strengths per degenerate set "
          "card vs CPU", qc_abs([f for _, f in g_card],
                                [f for _, f in g_cpu]), 1e-8)
    out["tda"] = dict(e=e_tda[:QC_NROOTS].tolist(), sets=g_card,
                      tdhf=e_tdhf[:QC_NROOTS].tolist())
    log("[qchem] TDA singlets (eV, summed f): " + ", ".join(
        f"{e * 27.211386:.4f} ({f:.4f})" for e, f in g_card))
    alpha = qc_stage(out, "CPHF polarizability (card)",
                     lambda: qc.polarizability_cphf(mf))
    qgate("CPHF polarizability card vs CPU",
          qc_abs(alpha, qc.polarizability_cphf(ref)), 1e-8)
    out["cphf_alpha"] = np.diag(alpha).tolist()
    q_m = qc.mulliken_charges(mf)
    q_i = qc_stage(out, "IAO charges", lambda: qc.iao_charges(mf))
    qgate("Mulliken charges card vs CPU",
          qc_abs(q_m, qc.mulliken_charges(ref)), 1e-10)
    qgate("IAO charges card vs CPU", qc_abs(q_i, qc.iao_charges(ref)),
          1e-10)
    L = qc_stage(out, "Boys localisation (host Jacobi sweeps)",
                 lambda: qc.boys(mf))
    spread = qc.lo.orbital_spread(mf, L)
    qgate("Boys objective card vs CPU (relative)",
          abs(spread - qc.lo.orbital_spread(ref, qc.boys(ref))) / abs(spread),
          1e-8)
    out["charges"] = dict(mulliken_C=float(q_m[0]), iao_C=float(q_i[0]))
    del cmf, ctd
    # ---------------------------------------------------- RKS/B3LYP
    ks = qc_stage(out, f"RKS/{QC_XC} grid + AO values (card)",
                  lambda: qc.RKS(mol, xc=QC_XC, **QC_GRID))
    npts = int(ks.grid[1].shape[0])
    qc_stage(out, f"RKS/{QC_XC} SCF (card, first)", ks.run)
    qc_stage(out, f"RKS/{QC_XC} SCF (card)", ks.run)
    qgate("RKS converged (0 = yes)", float(not ks.converged), 0.0)
    out["rks"] = dict(e_tot=ks.e_tot, cycles=ks.cycles, points=npts,
                      s_per_cycle=out["stage_s"][f"RKS/{QC_XC} SCF (card)"]
                      / ks.cycles)
    log(f"[qchem] RKS/{QC_XC} E = {ks.e_tot:.10f} on {npts} points in "
        f"{ks.cycles} cycles, {out['rks']['s_per_cycle'] * 1e3:.2f} ms a "
        f"cycle; AO values {ks.ao.numel() * 8 / 1e9:.2f} GB, gradients "
        f"{ks.ao_grad.numel() * 8 / 1e9:.2f} GB ({card})")
    cks = qc_stage(out, f"RKS/{QC_XC} SCF (CPU)",
                   lambda: qc.RKS(cmol, xc=QC_XC, **QC_GRID).run())
    qgate("RKS energy card vs CPU", abs(ks.e_tot - cks.e_tot), 1e-10)
    qgate("RKS density card vs CPU", qc_abs(ks.dm, cks.dm), 1e-8)
    del cks
    # ------------------------------------------------ CCSD/6-31G
    mcc = qc.Molecule(QC_MOLECULE(), basis=QC_CC_BASIS, device=DEVICE)
    mfc = qc_stage(out, f"RHF/{QC_CC_BASIS} (integrals + SCF)",
                   lambda: qc.RHF(mcc).run())
    mp2c = qc.MP2(mfc).run()
    cc = qc.CCSD(mfc)
    f, g, o, v, d1, d2, no, nv = qc_stage(
        out, "CCSD set-up (MO transform, <pq||rs>)", cc._setup)
    log(f"[qchem] CCSD/{QC_CC_BASIS}: {f.shape[0]} spin orbitals, {no} "
        f"occupied; <pq||rs> {g.numel() * 8 / 1e9:.2f} GB, vvvv "
        f"{nv ** 4 * 8 / 1e9:.2f} GB")
    qc_stage(out, "CCSD iterations (card)", cc.run)
    qgate("CCSD converged (0 = yes)", float(not cc.converged), 0.0)
    qgate("CCSD energy at the MP2 amplitudes vs MP2",
          abs(cc.e_mp2 - mp2c.e_corr), 1e-10)
    it_s = out["stage_s"]["CCSD iterations (card)"] / cc.cycles
    t1, t2 = cc.t1, cc.t2

    def update():
        cc._update(t1, t2, f, g, o, v, d1, d2)

    update()
    _, wall = timed(update)
    dev_us, rows = profile_steps(update, 1)
    out["ccsd"] = dict(
        e_corr=cc.e_corr, cycles=cc.cycles, s_per_iteration=it_s,
        update_s=wall, device_s=dev_us / 1e6, busy=dev_us / 1e6 / wall)
    log(f"[qchem] CCSD E_corr = {cc.e_corr:.10f} in {cc.cycles} iterations,"
        f" {it_s * 1e3:.1f} ms an iteration (DIIS and the energy included);"
        f" one amplitude update {wall * 1e3:.1f} ms wall, "
        f"{dev_us / 1e3:.1f} ms device, busy share {out['ccsd']['busy']:.3f}"
        f" ({card})")
    for us_, count, key in rows[:6]:
        log(f"[qchem]   {us_:9.1f} us x{count:<4g} {key[:80]}")
    del cc, f, g, d1, d2, t1, t2, update
    torch.cuda.empty_cache()
    # ------------------------------------------ water card vs CPU
    wm = qc.Molecule(QC_WATER, basis=QC_WATER_CC_BASIS, device=DEVICE)
    wmf = wm.RHF().run()
    wref = qc_on_cpu(wmf, wm.to("cpu"), qc.RHF)
    wcc = qc_stage(out, f"water CCSD/{QC_WATER_CC_BASIS} (card)",
                   lambda: qc.CCSD(wmf).run())
    cwcc = qc.CCSD(wref).run()
    qgate("water CCSD card vs CPU", abs(wcc.e_corr - cwcc.e_corr),
          1e-10)
    e_t = qc_stage(out, "water (T) (card)", wcc.ccsd_t)
    qgate("water (T) card vs CPU", abs(e_t - cwcc.ccsd_t()), 1e-10)
    out["water"] = dict(ccsd=wcc.e_corr, t=e_t)
    sm = qc.Molecule(QC_WATER, basis=QC_WATER_DET_BASIS, device=DEVICE)
    smf = sm.RHF().run()
    sref = qc_on_cpu(smf, sm.to("cpu"), qc.RHF)
    scc, cscc = qc.CCSD(smf).run(), qc.CCSD(sref).run()
    e_eom = qc_stage(out, "water EOM-CCSD (determinant space)",
                     lambda: qc.EOMCCSD(scc).run(4))
    qgate("water EOM-CCSD card vs CPU",
          qc_abs(e_eom, qc.EOMCCSD(cscc).run(4)), 1e-10)
    e_fci = qc_stage(out, "water FCI (card eigh)",
                     lambda: qc.FCI(smf).run(2))
    qgate("water FCI card vs CPU", qc_abs(e_fci, qc.FCI(sref).run(2)),
          1e-10)
    qgate("water CASCI(4,4) card vs CPU",
          qc_abs(qc.CASCI(smf, 4, 4).run(), qc.CASCI(sref, 4, 4).run()), 1e-10)
    e_mc = qc_stage(out, "water CASSCF(2,2) (card)",
                    lambda: CASSCF(smf, 2, 2).run())
    qgate("water CASSCF card vs CPU", abs(e_mc - CASSCF(sref, 2, 2).run()),
          1e-10)
    out["water"].update(eom=np.asarray(e_eom).tolist(),
                        fci=float(e_fci[0]), casscf=e_mc)
    # ------------------------------------------------ the examples
    pm = qc.Molecule(QC_WATER, basis="6-31g", device=DEVICE)
    pmf = pm.RHF().run()
    cpm = pm.to("cpu")
    qgate("qchem_water.py RHF/6-31G card vs CPU",
          abs(pmf.e_tot - qc.RHF(cpm).run().e_tot), 1e-10)
    lda = qc_stage(out, "qchem_water.py LDA/STO-3G (card)",
                   lambda: qc.RKS(sm).run())
    qgate("qchem_water.py LDA card vs CPU",
          abs(lda.e_tot - qc.RKS(sm.to("cpu")).run().e_tot), 1e-10)
    pref = qc_on_cpu(pmf, cpm, qc.RHF)
    qgate("qchem_water.py TDA card vs CPU",
          qc_abs(qc.TDA(pmf).run(4), qc.TDA(pref).run(4)), 1e-10)
    w_k, _ = qc.RXS(pmf, occidx=[0]).core_excitation(nstates=3)
    w_c, _ = qc.RXS(pref, occidx=[0]).core_excitation(nstates=3)
    qgate("qchem_water.py O K-edge card vs CPU", qc_abs(w_k, w_c),
          1e-10)
    out["examples"] = dict(rhf_631g=pmf.e_tot, lda=lda.e_tot,
                           k_edge_ev=(np.asarray(w_k) * 27.211386).tolist())
    opt = qc_stage(out, f"GeometryOptimizer water/{QC_OPT_BASIS} (card)",
                   lambda: qc.GeometryOptimizer(
                       QC_WATER, basis=QC_OPT_BASIS, device=DEVICE).run())
    qgate("GeometryOptimizer converged (0 = yes)",
          float(not opt.converged), 0.0)
    out["examples"]["opt"] = dict(e_tot=opt.e_tot, steps=opt.niter)
    hs = qc_stage(out, "Hessian water/STO-3G (card)", lambda: Hessian(
        QC_WATER, basis=QC_WATER_DET_BASIS,
        device=DEVICE).vibrational_frequencies())
    hs_cpu = Hessian(QC_WATER, basis=QC_WATER_DET_BASIS,
                     device="cpu").vibrational_frequencies()
    qgate("Hessian frequencies card vs CPU (relative)",
          float(np.max(np.abs(hs - hs_cpu) / np.abs(hs_cpu))), 1e-6)
    out["examples"]["freqs_cm"] = np.asarray(hs).tolist()
    hm = qc.Molecule(QC_H4, basis="sto-3g", device=DEVICE)
    hmf = hm.RHF().run()
    dm = DMRGQC(hmf, D=32)
    e_dmrg = qc_stage(out, "DMRGQC H4/STO-3G (card)", dm.run)
    qgate("DMRGQC vs FCI", abs(e_dmrg - qc.FCI(hmf).run()[0]), 1e-8)
    out["examples"]["dmrgqc"] = e_dmrg
    # ------------------------------------------ the benzene gradients
    grad = qc_stage(out, "RHF analytic gradient (card)",
                    lambda: rhf_gradient(mf))
    qgate("RHF gradient card vs CPU", qc_abs(grad, rhf_gradient(ref)),
          1e-9)
    out["rhf"]["max_force"] = float(np.max(np.abs(grad)))
    kgrad = qc_stage(out, "RKS analytic gradient (card)",
                     lambda: ks_gradient(ks))
    kref = qc_on_cpu(ks, cmol, qc.RKS, xc=QC_XC, **QC_GRID)
    qgate("RKS gradient card vs CPU",
          qc_abs(kgrad, qc_stage(out, "RKS analytic gradient (CPU)",
                                 lambda: ks_gradient(kref))), 1e-9)
    out["rks"]["max_force"] = float(np.max(np.abs(kgrad)))
    # benzene's molecules and mean fields go on to phase_qchem_rest: its
    # integrals (ERI, dERI) are built once
    benzene_state = dict(mol=mol, mf=mf, ref=ref, mfc=mfc)
    del ks, kref, mol, mf, cmol, ref, mcc, mfc
    torch.cuda.empty_cache()
    no_launches("qchem")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[qchem] launch counts {read_counts()} (all 0); peak "
        f"{out['peak_gib']:.2f} GiB; phase {out['phase_s']:.1f} s ({card})")
    return out, benzene_state


# ------------------------------------------------- qchem, the rest
QR_CUBE = 40                  # charge_density on a 40^3 cube
QR_DENS_GRID = dict(n_rad=100, n_theta=36)   # its integral: 3.11M points
QR_LIH = [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 3.0))]
QR_OH = [("O", (0.0, 0.0, 0.0)), ("H", (0.0, 0.3, 1.83))]
QR_KS = dict(xc="svwn", n_rad=30, n_theta=8)   # tests/test_tdgrad.py's
QR_H2_DVR = [(1, [-1.0]), (1, [1.0])]
QR_SM_NX = 64                 # ShinMetiu2e1d: 64^2 = 4,096 grid points
QR_SM_NR = 64                 # proton positions on the card
QR_SM_CPU = 1                 # of them on the CPU
QR_SM3_NX = 17                # ShinMetiu3d: 17^3 grid


def lowest_nondegenerate(e, tol=1e-5):
    """1-based index of the lowest root that no other root lies within
    ``tol`` of."""
    e = np.asarray(e)
    for k in range(len(e) - 1):
        if (k == 0 or e[k] - e[k - 1] > tol) and e[k + 1] - e[k] > tol:
            return k + 1
    raise AssertionError(f"no non-degenerate root among {e}")


def d6h_spread(mol, g):
    """(radial spread of C, radial spread of H, largest tangential or z
    component) of forces ``g`` on D6h benzene in the xy plane."""
    out = []
    for sym in ("C", "H"):
        idx = [k for k, (s, _) in enumerate(mol.atoms) if s == sym]
        r = np.array([mol.atoms[k][1] for k in idx])
        rhat = r / np.linalg.norm(r, axis=1)[:, None]
        rad = np.sum(g[idx] * rhat, axis=1)
        out.append(float(rad.max() - rad.min()))
    rhat = np.array([x / np.linalg.norm(x) for _, x in mol.atoms])
    rest = g - np.sum(g * rhat, axis=1)[:, None] * rhat
    return out[0], out[1], float(np.max(np.abs(rest)))


def phase_qchem_rest(card, benzene):
    """The rest of qchem/ and models/shinmetiu2e on the card, holding every
    result against the port on the card host's CPU (the CPU runs start
    from the card's orbitals, excitation vectors and amplitudes, and take
    over the card molecules' integrals). Benzene from phase_qchem:
    analytic CIS and TDHF forces at the lowest non-degenerate singlet and
    the CIS relaxed dipole (RHF/6-31G*; card vs CPU <= 1e-9, forces
    summed over the atoms <= 1e-8, the six C and six H radial components
    equal <= 1e-8), MP2 forces and dipole (6-31G, the CCSD basis; <=
    1e-9), G0W0 and GW-BSE on the 1,701 x 1,701 RPA problem (<= 1e-10),
    charge_density on a 40^3 cube (<= 1e-10 rel) and its integral on a
    3.11M-point Becke grid (42 electrons <= 1e-6), the SOC matrix in the
    MO basis (<= 1e-12). The JAX tests' molecules: the path of
    examples/excited_state_forces.py with its asserts (LiH: CIS, TDHF,
    MP2, CCSD forces and dipoles), TDDFT/TDA (SVWN) forces, UCIS and UMP2
    forces of the OH radical (<= 1e-9), ExcitedGeometryOptimizer's
    analytic default against the central-difference Jacobian on LiH,
    examples/ab_initio_lvc.py's LVCBuilder path with its asserts, water's
    qubit Hamiltonian in a (4, 4) space under JW and BK (lowest penalised
    eigenvalue = CASCI <= 1e-10), RHF1D/RKS1D/CASCIDVR (<= 1e-10),
    ElectronDVR3D at 27^3 and 13^3, ShinMetiu2e1d.pes at nx = 64 over 64
    proton positions (4,096^2 eigvalsh each; CPU at one position, the
    exchange symmetries there equal) and ShinMetiu3d at 17^3. Stage
    seconds, the response engine's stages and peak memory are kept; no
    kernel launches."""
    from pyqed_tpu_torch import qchem as qc
    from pyqed_tpu_torch.qchem import tdgrad, density, soc, qubit, dvr
    from pyqed_tpu_torch.qchem.dft import becke_grid
    from pyqed_tpu_torch.qchem.grad import rhf_gradient
    from pyqed_tpu_torch.negf import G0W0, GWBSE
    from pyqed_tpu_torch.models import ShinMetiu2e1d, ShinMetiu3d
    t_phase = time.perf_counter()
    out = {"card": card, "gates": {}}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    def qgate(label, val, tol):
        out["gates"][label] = gate("qchem_rest", label, val, tol)

    def stage(name, fn):
        return qc_stage(out, name, fn, "qchem_rest")

    def twin(mf, cls, **kw):
        return qc_on_cpu(mf, mf.mol.to("cpu"), cls, **kw)

    def cpu_vectors(td, cmf):
        xy = (td.xy.cpu().numpy() if isinstance(td.xy, torch.Tensor)
              else [tuple(z.cpu().numpy() for z in p) for p in td.xy])
        return qc.tdscf_from_reference(cmf, type(td), e=td.e, xy=xy,
                                       singlet=getattr(td, "singlet", True))

    def grad_and_dipole(eng, mf, base):
        return (base + eng.nuclear_gradient(),
                tdgrad._field_dipole(eng, mf, (0.0, 0.0, 0.0),
                                     mf.dip_moment()))

    mol, mf, ref = benzene["mol"], benzene["mf"], benzene["ref"]
    # ---------------------------------- benzene RHF/6-31G* excited forces
    nr = QC_NROOTS + 4
    td, rp = qc.TDA(mf), qc.TDHF(mf)
    s_td = lowest_nondegenerate(td.run(nr))
    s_rp = lowest_nondegenerate(rp.run(nr))
    out["benzene"] = dict(cis_state=s_td, tdhf_state=s_rp)
    g0 = rhf_gradient(mf)
    eng = stage("CIS response engine (card)",
                lambda: tdgrad._cis_engine(td, s_td))
    g_e = stage("CIS fused dERI contraction (card)", eng.nuclear_gradient)
    out["benzene"]["engine_s"] = dict(eng.seconds)
    log(f"[qchem_rest] benzene CIS root {s_td}: Lagrangian "
        f"{eng.seconds['lagrangian']:.3f} s, CPHF Jacobian "
        f"{eng.seconds['cphf_jacobian']:.3f} s, Z solve "
        f"{eng.seconds['z_solve']:.3f} s, dERI contraction "
        f"{eng.seconds['contraction']:.3f} s ({card})")
    g_cis = stage("cis_gradient (card)",
                  lambda: tdgrad.cis_gradient(td, s_td))
    qgate("benzene cis_gradient vs its engine's parts",
          qc_abs(g_cis, g0 + g_e), 1e-12)
    mu_cis = stage("cis_dipole (card)", lambda: tdgrad.cis_dipole(td, s_td))
    g_rpa = stage("tdhf_gradient (card)",
                  lambda: tdgrad.tdhf_gradient(rp, s_rp))
    del eng
    g_ref = rhf_gradient(ref)
    c_cis = stage("CIS gradient and dipole (CPU, one engine)",
                  lambda: grad_and_dipole(tdgrad._cis_engine(
                      cpu_vectors(td, ref), s_td), ref, g_ref))
    c_rpa = stage("TDHF gradient (CPU)", lambda: g_ref + tdgrad._tdhf_engine(
        cpu_vectors(rp, ref), s_rp).nuclear_gradient())
    qgate("benzene cis_gradient card vs CPU", qc_abs(g_cis, c_cis[0]), 1e-9)
    qgate("benzene cis_dipole card vs CPU", qc_abs(mu_cis, c_cis[1]), 1e-9)
    qgate("benzene tdhf_gradient card vs CPU", qc_abs(g_rpa, c_rpa), 1e-9)
    for label, g in (("CIS", g_cis), ("TDHF", g_rpa)):
        qgate(f"benzene {label} forces summed over the atoms",
              float(np.max(np.abs(g.sum(axis=0)))), 1e-8)
        c_sp, h_sp, rest = d6h_spread(mol, g)
        qgate(f"benzene {label} C radial forces, max - min", c_sp, 1e-8)
        qgate(f"benzene {label} H radial forces, max - min", h_sp, 1e-8)
        out["benzene"][f"{label}_tangential_or_z"] = rest
    out["benzene"].update(cis_force_C=float(np.linalg.norm(g_cis[0])),
                          cis_dipole=np.asarray(mu_cis).tolist())
    # ---------------------------------- benzene MP2/6-31G forces and dipole
    mfc = benzene["mfc"]
    g_mp2 = stage("mp2_gradient 6-31G (card)",
                  lambda: tdgrad.mp2_gradient(mfc))
    mu_mp2 = stage("mp2_dipole 6-31G (card)", lambda: tdgrad.mp2_dipole(mfc))
    cref = twin(mfc, qc.RHF)
    omega, e2 = tdgrad._mp2_omega(cref)
    c_mp2 = stage("MP2 gradient and dipole 6-31G (CPU, one engine)",
                  lambda: grad_and_dipole(tdgrad.ResponseEngine(
                      cref, omega, check_value=e2), cref, rhf_gradient(cref)))
    qgate("benzene mp2_gradient card vs CPU", qc_abs(g_mp2, c_mp2[0]), 1e-9)
    qgate("benzene mp2_dipole card vs CPU", qc_abs(mu_mp2, c_mp2[1]), 1e-9)
    del cref, omega
    # ---------------------------------- benzene G0W0 and GW-BSE
    gw = stage("G0W0 (card)", lambda: G0W0(mf).run())
    bse = GWBSE(mf)
    e_bse = stage("GW-BSE (card)", bse.run)
    cbse = GWBSE(ref)
    stage("GW-BSE (CPU)", cbse.run)
    qgate("benzene G0W0 QP energies card vs CPU", qc_abs(gw, cbse.e_gw),
          1e-10)
    qgate("benzene BSE energies card vs CPU", qc_abs(np.sort(e_bse),
                                                      np.sort(cbse.e_bse)),
          1e-10)
    out["benzene"].update(ip_ev=float(-gw[mf.nocc - 1] * 27.211386),
                          bse_ev=float(np.sort(e_bse)[0] * 27.211386))
    del bse, cbse
    # ---------------------------------- densities and SOC
    pts = density.cube_grid(mol.atoms, QR_CUBE, QR_CUBE, QR_CUBE)[0]
    rho = stage("charge_density 40^3 (card)",
                lambda: density.charge_density(mol.bfs, mf.dm, pts))
    qgate("benzene charge density 40^3 card vs CPU (rel)",
          qc_abs(rho, density.charge_density(mol.bfs, ref.dm, pts))
          / float(rho.abs().max()), 1e-10)
    gpts, gw_ = becke_grid(mol.atoms, device=DEVICE, **QR_DENS_GRID)
    nel = stage(f"charge_density on {gpts.shape[0]} Becke points (card)",
                lambda: float(torch.sum(gw_ * density.charge_density(
                    mol.bfs, mf.dm, gpts))))
    qgate("benzene charge density integral vs 42 electrons",
          abs(nel - mol.nelec), 1e-6)
    del gpts, gw_, rho
    W = stage("SOC integrals (host)", lambda: soc.soc_integrals(
        mol.bfs, mol.atoms))
    h_so = stage("SOC matrix in the MO basis (card)",
                 lambda: 0.5j * soc.FINE_STRUCTURE ** 2 * soc.soc_mo(
                     W, mf.mo_coeff))
    qgate("benzene SOC matrix card vs CPU", qc_abs(
        h_so, 0.5j * soc.FINE_STRUCTURE ** 2 * soc.soc_mo(W, ref.mo_coeff)),
        1e-12)
    benzene.clear()
    del mol, mf, ref, mfc, td, rp
    torch.cuda.empty_cache()
    # ---------------------------------- examples/excited_state_forces.py
    lm = qc.Molecule(QR_LIH, basis="sto-3g", device=DEVICE)
    lmf = lm.RHF().run()
    ltd, lrp = qc.TDA(lmf), qc.TDHF(lmf)
    ltd.run(3)
    lrp.run(3)
    lcc = qc.CCSD(lmf).run()
    card_r = dict(CIS=tdgrad.cis_gradient(ltd, 1),
                  RPA=tdgrad.tdhf_gradient(lrp, 1),
                  MP2=tdgrad.mp2_gradient(lmf), CCSD=tdgrad.ccsd_gradient(lcc),
                  mu=tdgrad.mp2_dipole(lmf), mu_exc=tdgrad.cis_dipole(ltd, 1),
                  mu_cc=tdgrad.ccsd_dipole(lcc))
    if not card_r["mu_exc"][2] * card_r["mu"][2] < 0:
        raise AssertionError("excited_state_forces.py: the LiH A-state "
                             "dipole does not reverse")
    for name in ("CIS", "RPA", "MP2", "CCSD"):
        if not np.max(np.abs(card_r[name].sum(axis=0))) < 1e-8:
            raise AssertionError(f"excited_state_forces.py: {name} forces "
                                 "not translationally invariant")
    lref = twin(lmf, qc.RHF)
    lcc_c = qc.ccsd_from_reference(lref, t1=lcc.t1.cpu().numpy(),
                                   t2=lcc.t2.cpu().numpy(), e_corr=lcc.e_corr)
    cpu_r = dict(CIS=tdgrad.cis_gradient(cpu_vectors(ltd, lref), 1),
                 RPA=tdgrad.tdhf_gradient(cpu_vectors(lrp, lref), 1),
                 MP2=tdgrad.mp2_gradient(lref), CCSD=tdgrad.ccsd_gradient(lcc_c),
                 mu=tdgrad.mp2_dipole(lref),
                 mu_exc=tdgrad.cis_dipole(cpu_vectors(ltd, lref), 1),
                 mu_cc=tdgrad.ccsd_dipole(lcc_c))
    qgate("excited_state_forces.py gradients and dipoles card vs CPU",
          max(qc_abs(card_r[k], cpu_r[k]) for k in card_r), 1e-9)
    out["lih"] = dict(cis_fz=float(card_r["CIS"][1, 2]),
                      ccsd_fz=float(card_r["CCSD"][1, 2]),
                      mu_exc_z=float(card_r["mu_exc"][2]))
    # ---------------------------------- TDDFT, UCIS, UMP2
    kmf = lm.RKS(**QR_KS).run()
    ktd = qc.TDA(kmf)
    ktd.run(3)
    kref = qc_on_cpu(kmf, lm.to("cpu"), qc.RKS, **QR_KS)
    g_k = stage("tddft_tda_gradient LiH (card)",
                lambda: tdgrad.tddft_tda_gradient(ktd, 1))
    qgate("tddft_tda_gradient card vs CPU", qc_abs(
        g_k, tdgrad.tddft_tda_gradient(cpu_vectors(ktd, kref), 1)), 1e-9)
    om = qc.Molecule(QR_OH, spin=1, basis="sto-3g", device=DEVICE)
    umf = om.UHF().run()
    uc = qc.UCIS(umf)
    uc.run(3)
    g_u = (tdgrad.ucis_gradient(uc, 2), tdgrad.ump2_gradient(umf))
    uref = twin(umf, qc.UHF)
    qgate("OH ucis_gradient and ump2_gradient card vs CPU", max(
        qc_abs(g_u[0], tdgrad.ucis_gradient(cpu_vectors(uc, uref), 2)),
        qc_abs(g_u[1], tdgrad.ump2_gradient(uref))), 1e-9)
    # ---------------------------------- ExcitedGeometryOptimizer
    opt = stage("ExcitedGeometryOptimizer LiH, analytic default (card)",
                lambda: qc.ExcitedGeometryOptimizer(
                    QR_LIH, state=1, maxiter=30, device=DEVICE).run())
    opt_fd = stage("ExcitedGeometryOptimizer LiH, FD Jacobian (card)",
                   lambda: qc.ExcitedGeometryOptimizer(
                       QR_LIH, state=1, maxiter=30, analytic=False,
                       device=DEVICE).run())
    if not (opt.analytic and opt.converged and opt_fd.converged):
        raise AssertionError("ExcitedGeometryOptimizer did not converge")

    def bond(o):
        return float(np.linalg.norm(o.atoms_opt[1][1] - o.atoms_opt[0][1]))

    qgate("ExcitedGeometryOptimizer analytic vs FD: end energy",
          abs(opt.e_tot - opt_fd.e_tot), 1e-7)
    qgate("ExcitedGeometryOptimizer analytic vs FD: bond (bohr)",
          abs(bond(opt) - bond(opt_fd)), 1e-3)
    out["lih"]["excited_re"] = bond(opt)
    # ---------------------------------- examples/ab_initio_lvc.py
    g_opt = qc.GeometryOptimizer(QR_LIH, basis="sto-3g", gtol=1e-5,
                                 device=DEVICE).run()
    b = qc.LVCBuilder(g_opt.atoms_opt, nstates=3, dq=0.05, truncate=6,
                      device=DEVICE)
    lvc = stage("LVCBuilder LiH (card)", b.run)
    nvib = lvc.nvib
    psi0 = np.zeros(lvc.buildH().shape[0], complex)
    psi0[nvib] = 1.0
    res = lvc.run(psi0=psi0, dt=10.0, nt=400, nout=10, method="expm",
                  e_ops=[lvc.buildop(1)], device=DEVICE)
    pop1 = np.real(np.asarray(res.observables.cpu())[:, 0])
    if not np.max(np.abs(pop1 - 1.0)) < 1e-8:
        raise AssertionError(f"ab_initio_lvc.py: S1 population {pop1}")
    cb = qc.LVCBuilder(g_opt.atoms_opt, nstates=3, dq=0.05, truncate=6,
                       device="cpu")
    cb.run()
    qgate("LVCBuilder frequencies and kappa card vs CPU",
          max(qc_abs(b.omegas, cb.omegas), qc_abs(b.kappa, cb.kappa)), 1e-8)
    out["lih"]["lvc_cm"] = float(b.omegas[0] * 219474.63)
    # ---------------------------------- water's qubit Hamiltonian
    sm = qc.Molecule(QC_WATER, basis="sto-3g", device=DEVICE)
    smf = sm.RHF().run()
    e_cas = qc.CASCI(smf, 4, 4).run()[0]
    for enc in ("jw", "bk"):
        H = qubit.fix_nelec_penalty(qubit.qubitize(smf, 4, 4, enc), 8, 2, 2,
                                    encoding=enc)
        qgate(f"qubitize water (4, 4) {enc}: lowest eigenvalue vs CASCI",
              abs(float(torch.linalg.eigvalsh(H)[0]) - e_cas), 1e-10)
    # ---------------------------------- DVR electronic structure
    dm_c = dvr.MoleculeDVR(QR_H2_DVR, Rf=1.5, Re=1.0, device=DEVICE)
    dm_h = dvr.MoleculeDVR(QR_H2_DVR, Rf=1.5, Re=1.0, device="cpu")
    r1 = [dvr.RHF1D(m, domain=(-12, 12), nx=40) for m in (dm_c, dm_h)]
    e1 = [m.run() for m in r1]
    e2 = [dvr.RKS1D(m, domain=(-12, 12), nx=40).run() for m in (dm_c, dm_h)]
    e3 = [m.CASCI(ncas=6).run(2) for m in r1]
    qgate("RHF1D, RKS1D and CASCIDVR card vs CPU", max(
        abs(e1[0] - e1[1]), abs(e2[0] - e2[1]), qc_abs(e3[0], e3[1])), 1e-10)
    for n, soft, atoms in ((27, 0.3, [(1.0, (-1.0, 0, 0)), (1.0, (1.0, 0, 0))]),
                           (13, 0.5, [(1.0, (0, 0, 0))])):
        lim = 9 if n == 27 else 6
        e = [dvr.ElectronDVR3D(atoms, [(-lim, lim)] * 3, [n] * 3, soft=soft,
                               device=d).run(neig=2, tol=1e-9)
             for d in (DEVICE, "cpu")]
        qgate(f"ElectronDVR3D {n}^3 card vs CPU", qc_abs(e[0], e[1]), 1e-10)
    # ---------------------------------- Shin-Metiu models
    smc = ShinMetiu2e1d(device=DEVICE)
    smc.create_grid((-8.0, 8.0), QR_SM_NX)
    Rs = np.linspace(-2.5, 2.5, QR_SM_NR)
    pes = stage(f"ShinMetiu2e1d.pes {QR_SM_NX ** 2}^2 x {QR_SM_NR} (card)",
                lambda: smc.pes(Rs))
    smh = ShinMetiu2e1d(device="cpu")
    smh.create_grid((-8.0, 8.0), QR_SM_NX)
    qgate("ShinMetiu2e1d eigenvalues card vs CPU", qc_abs(
        pes[:QR_SM_CPU], smh.pes(Rs[:QR_SM_CPU])), 1e-10)
    sym = [m.exchange_symmetry(m.single_point(Rs[0])[1]) for m in (smc, smh)]
    qgate("ShinMetiu2e1d exchange symmetries card vs CPU",
          qc_abs(sym[0], sym[1]), 0.0)
    s3 = [ShinMetiu3d(device=d) for d in (DEVICE, "cpu")]
    for m in s3:
        m.create_grid([(-4.0, 4.0)] * 3, QR_SM3_NX)
    R3 = [np.array([0.3, 0.0, 0.0])]
    qgate(f"ShinMetiu3d {QR_SM3_NX}^3 card vs CPU",
          qc_abs(s3[0].pes(R3), s3[1].pes(R3)), 1e-10)
    out["shinmetiu"] = dict(pes_min=float(pes[:, 0].min()),
                            symmetries=sym[0].tolist())
    no_launches("qchem_rest")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[qchem_rest] launch counts {read_counts()} (all 0); peak "
        f"{out['peak_gib']:.2f} GiB; phase {out['phase_s']:.1f} s ({card})")
    return out


# ------------------------------------------------------------------ negf
NG_DIMER = np.array([[0.0, -1.0], [-1.0, 0.5]])   # tests/test_kb_gw.py
NG_QUENCH = dict(v=0.5, nt=48, dt=0.08, beta=8.0, ntau=64, solver="2b")
NG_RT_NT = 6000


def phase_negf(card):
    """negf/ on the card, every result against the port on the CPU:
    examples/noneq_dmft_quench.py at its parameters (U = 2, nt = 48, dt =
    0.08, beta = 8, ntau = 64, second Born, 12 iterations) with its
    asserts (<= 1e-10 rel); KBSolver2T with second Born and with GW on
    the dimer of tests/test_kb_gw.py (nt = 48; <= 1e-10 rel); equilibrium
    DMFT at beta = 16 for the metal (U = 0.5) and the Mott insulator (U =
    4) (<= 1e-10, and the metal's Z in (0.8, 1), A(0) above three times
    the insulator's); RTTDHF.absorption on H2/6-31G (nt = 6,000) with its
    peak at the TDHF excitation (0.01, tests/test_gwbse_dmft.py's
    tolerance) and its spectrum card vs CPU (<= 1e-10 rel); the Holstein
    spectral function (<= 1e-10 rel). Kept: rows per second of the KB
    march (a row updates every earlier column at once) and its device
    busy share (torch.profiler), RT-TDHF steps per second; no kernel
    launches."""
    from pyqed_tpu_torch import negf
    from pyqed_tpu_torch import qchem as qc
    from pyqed_tpu_torch.negf import eph
    from pyqed_tpu_torch.negf.kb2t import _march
    t_phase = time.perf_counter()
    out = {"card": card, "gates": {}}
    reset_counts()

    def ngate(label, val, tol):
        out["gates"][label] = gate("negf", label, val, tol)

    def rel_(a, b):
        return qc_abs(a, b) / float(np.max(np.abs(
            b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b))))

    # ---------------------------------- the thermal quench example
    runs = {}
    for d in (DEVICE, "cpu"):
        q = negf.NoneqDMFTThermal(2.0, device=d, **NG_QUENCH)
        _, wall = timed(lambda: q.run(niter=12, mix=0.6))
        runs[d] = (q, wall)
    q, wall = runs[DEVICE]
    docc, n = q.double_occupancy(), q.density()
    if not (abs(docc[0] - 0.25) < 5e-3 and docc.min() < 0.17
            and np.max(np.abs(n - 0.5)) < 2e-3):
        raise AssertionError(f"noneq_dmft_quench.py: d = {docc}, n = {n}")
    ngate("noneq_dmft_quench.py G^R, G^<, G^mix card vs CPU (rel)",
          max(rel_(a, b) for a, b in zip(q.G, runs["cpu"][0].G)), 1e-10)
    ngate("noneq_dmft_quench.py double occupancy and energies card vs CPU",
          max(qc_abs(docc, runs["cpu"][0].double_occupancy()),
              qc_abs(q.total_energy(), runs["cpu"][0].total_energy())), 1e-10)
    nmarch = 14                    # 12 iterations, the start and the end
    out["quench"] = dict(s=wall, cpu_s=runs["cpu"][1],
                         rows_per_s=nmarch * (q.nt - 1) / wall,
                         docc_min=float(docc.min()))
    log(f"[negf] noneq_dmft_quench.py: {wall:.2f} s on the card, "
        f"{runs['cpu'][1]:.2f} s on the CPU; d(0) {docc[0]:.4f} -> min "
        f"{docc.min():.4f} ({card})")
    # ---------------------------------- KBSolver2T, 2B and GW
    sols = {}
    for se in ("2B", "GW"):
        for d in (DEVICE, "cpu"):
            s = negf.KBSolver2T(lambda t: NG_DIMER, nt=48, dt=0.05,
                                beta=5.0, U=0.8, selfenergy=se, device=d)
            _, wall = timed(lambda: s.run(sc_iter=2))
            sols[se, d] = (s, wall)
        ngate(f"KBSolver2T {se} dimer G^R, G^< card vs CPU (rel)", max(
            rel_(sols[se, DEVICE][0].GR, sols[se, "cpu"][0].GR),
            rel_(sols[se, DEVICE][0].GL, sols[se, "cpu"][0].GL)), 1e-10)
    # the march alone: rows per second and busy share
    s = sols["2B", DEVICE][0]
    hs = torch.as_tensor(np.stack([NG_DIMER] * s.nt), device=DEVICE) \
        .to(torch.complex128)
    SR, SL = s.second_born(s.GR, s.GL)
    GR0 = torch.zeros_like(SR)
    GL0 = torch.zeros_like(SR)
    GR0[0, 0] = -1j * torch.eye(2, dtype=SR.dtype, device=DEVICE)
    GL0[0, 0] = s.GL[0, 0]

    def march():
        _march(hs, GR0, GL0, SR, SL, s.dt)

    march()
    _, wall = timed(march)
    dev_us, rows = profile_steps(march, 1)
    out["kb_march"] = dict(nt=s.nt, s=wall, rows_per_s=(s.nt - 1) / wall,
                           device_s=dev_us / 1e6, busy=dev_us / 1e6 / wall)
    log(f"[negf] KB march (nt = {s.nt}, n = 2, second Born): {wall * 1e3:.1f}"
        f" ms, {(s.nt - 1) / wall:.0f} rows/s, device {dev_us / 1e3:.1f} ms, "
        f"busy share {out['kb_march']['busy']:.3f} ({card})")
    for us_, count, key in rows[:5]:
        log(f"[negf]   {us_:9.1f} us x{count:<6g} {key[:80]}")
    # ---------------------------------- equilibrium DMFT
    dm = {}
    for U in (0.5, 4.0):
        for d in (DEVICE, "cpu"):
            dm[U, d] = negf.DMFT(U=U, t=0.5, beta=16, device=d)
            dm[U, d].run()
        ngate(f"DMFT U = {U} G(iw) card vs CPU (rel)",
              rel_(dm[U, DEVICE].G, dm[U, "cpu"].G), 1e-10)
    z = dm[0.5, DEVICE].quasiparticle_weight()
    if not (0.8 < z < 1.0 and -dm[0.5, DEVICE].G[0].imag
            > 3 * -dm[4.0, DEVICE].G[0].imag):
        raise AssertionError(f"DMFT metal/insulator: Z = {z}")
    out["dmft"] = dict(z_metal=float(z),
                       z_insulator=float(dm[4.0, DEVICE].quasiparticle_weight()))
    # ---------------------------------- RT-TDHF
    h2 = qc.Molecule([("H", (0, 0, 0)), ("H", (0, 0, 1.4))], basis="6-31g",
                     device=DEVICE)
    hmf = h2.RHF().run()
    rt = negf.RTTDHF(hmf)
    (freqs, S), wall = timed(lambda: rt.absorption(dt=0.05, nt=NG_RT_NT,
                                                   kick=1e-3))
    e_lr = qc.TDHF(hmf).run(nroots=1)[0]
    peak = float(freqs[np.argmax(np.abs(S))])
    ngate("RTTDHF absorption peak vs TDHF (Eh)", abs(peak - e_lr), 0.01)
    _, S_h = negf.RTTDHF(qc_on_cpu(hmf, h2.to("cpu"), qc.RHF)).absorption(
        dt=0.05, nt=NG_RT_NT, kick=1e-3)
    ngate("RTTDHF spectrum card vs CPU (rel)", rel_(S, S_h), 1e-10)
    out["rttdhf"] = dict(steps_per_s=NG_RT_NT / wall, peak=peak, tdhf=e_lr)
    log(f"[negf] RTTDHF H2/6-31G {NG_RT_NT} RK4 steps: {NG_RT_NT / wall:.0f}"
        f" steps/s, peak {peak:.4f} vs TDHF {e_lr:.4f} ({card})")
    # ---------------------------------- Holstein
    ws = np.linspace(-4.0, 2.0, 1201)
    A = [eph.spectral_function(ws, [0.0, 0.5], g=0.6, w0=0.5, eta=2e-2,
                               device=d) for d in (DEVICE, "cpu")]
    ngate("Holstein A(k, w) card vs CPU (rel)", rel_(A[0], A[1]), 1e-10)
    no_launches("negf")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[negf] launch counts {read_counts()} (all 0); phase "
        f"{out['phase_s']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------- qmc
QMC_DENSITY = 4.0 / 7.5 ** 3      # examples/qsats_solid_helium.py
QMC_QS_CELLS = (3, 3, 5)          # hcp: 180 atoms, 6,120 directed pairs
QMC_QS_SHAPE = (180, 6120)
QMC_QS_NW = 512
QMC_QS_SWEEPS = 200               # depth: cut these first
QMC_QS_EQUIL = 100                # the chains' schedule equals the walkers'
QMC_QS_CPU = (16, 5)              # card vs CPU: the first 16 walkers, 5 sweeps
QMC_QS_CHAINS = 48                # C++ chains (host threads), seeds 0..47
QMC_QS_CHAIN = dict(nsweeps=QMC_QS_SWEEPS, nequil=QMC_QS_EQUIL, step=0.5)
QMC_DMC = dict(nwalkers=65536, nsteps=2000, dt=0.01, eref=1.5, nequil=500)
QMC_DMC_NATIVE_NW = 8192
QMC_PIMC = dict(npaths=2048, nsweeps=1200, ntherm=500, step=0.5)
QMC_PIMC_SYS = dict(beta=2.0, nbeads=64)          # examples/pimc_harmonic.py
QMC_BOSON = dict(nreplicas=4096, nsweeps=1000, ntherm=500, step=0.4)
QMC_BOSON_SYS = dict(nparticles=3, beta=2.0, nbeads=32)
QMC_RPMD = dict(beta=8.0, nbeads=32, ntraj=4000)  # examples/rpmd_harmonic.py
QMC_RPMD_TCF = dict(dt=0.05, nt=200, nout=4)
QMC_RPMD_THERM = (256, 3000)
QMC_LJ = dict(ncell=8, density=0.8, temperature=1.0)   # 2,048 atoms
QMC_LJ_NT = (200, 400)            # thermostatted, then NVE steps
QMC_LJ_MC = 20000
QMC_MLP = dict(dims=(2, 64, 64, 1), npts=1024, epochs=200, lr=5e-3)
QMC_NSE = 5.0                     # statistical gates: standard errors


def block_se(trace, nblocks=20):
    """(mean, standard error) of a Monte Carlo trace from ``nblocks``
    block means."""
    x = trace.detach().cpu().numpy() if isinstance(trace, torch.Tensor) \
        else np.asarray(trace)
    b = np.array([c.mean() for c in np.array_split(x, nblocks)])
    return float(x.mean()), float(b.std(ddof=1) / np.sqrt(nblocks))


def harmonic_pimc_energy(nparticles, beta, nbeads, ndim=1, omega=1.0):
    """-d ln Z / d beta of N ideal bosons (N = 1: one particle) in a
    harmonic well under the primitive action of ``nbeads`` beads, the
    quantity the thermodynamic estimator samples without bias: Z_n =
    (1/n) sum_k z_k Z_{n-k}, z_k a ring of k * nbeads beads,
    prod_j (2 - 2 cos(2 pi j / P) + (tau omega)^2)^(-ndim/2)."""
    def lnZ(b):
        tau = b / nbeads
        z = [0.0] + [np.exp(-0.5 * ndim * np.sum(np.log(
            2.0 - 2.0 * np.cos(2.0 * np.pi * np.arange(k * nbeads)
                               / (k * nbeads)) + (tau * omega) ** 2)))
            for k in range(1, nparticles + 1)]
        Z = [1.0]
        for n in range(1, nparticles + 1):
            Z.append(sum(z[k] * Z[n - k] for k in range(1, n + 1)) / n)
        return np.log(Z[nparticles])
    h = 1e-5 * beta
    return -(lnZ(beta + h) - lnZ(beta - h)) / (2.0 * h)


def qmc_profile(fn, calls):
    """Per call of ``fn()``: device time (us) and device kernels
    (torch.profiler's CUDA events), and the host's CUDA runtime calls by
    name (kernel launches, graph launches, copies)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev_us, kernels, api = 0.0, 0.0, {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us_ = getattr(evt, "self_device_time_total", None)
            dev_us += evt.self_cuda_time_total if us_ is None else us_
            kernels += evt.count
        elif evt.key in ("cudaLaunchKernel", "cudaGraphLaunch",
                         "cudaMemcpyAsync", "cuLaunchKernel"):
            api[evt.key] = evt.count / calls
    return dev_us / calls, kernels / calls, api


def qmc_qsats(card, out, qgate, host):
    """QSATS at full width (hcp (3, 3, 5), 512 walkers, per-atom sweeps,
    exchange_prob 0.2) against the port's C++ engine, autodiff and the
    CPU; its rates, profile and peak memory."""
    from pyqed_tpu_torch.qmc import QSATS, hcp_lattice, qsats_eloc_native
    from pyqed_tpu_torch.core.dynamics import GraphScan
    sites, box = hcp_lattice(QMC_QS_CELLS, QMC_DENSITY)
    sol = QSATS(sites, box, a=0.06, b=5.0, device=DEVICE)
    P = sol.ipairs.shape[0]
    if (sol.natoms, P) != QMC_QS_SHAPE:
        raise AssertionError(f"hcp {QMC_QS_CELLS}: {sol.natoms} atoms, "
                             f"{P} pairs, expected {QMC_QS_SHAPE}")
    rng = np.random.default_rng(SEED)
    q = 0.3 * rng.normal(size=(4, sol.natoms, 3)) / np.sqrt(4 * sol.a)
    tl, vl = sol.local_energy(torch.as_tensor(q, device=DEVICE))
    tc, vc = qsats_eloc_native(q, sol.ipairs, sol.vpvec, sol.a, sol.b,
                               sol.mass)
    e_card = (tl + vl).cpu().numpy()
    qgate("QSATS batched local energy vs the C++ engine (rel)",
          float(np.max(np.abs(e_card - (tc + vc)) / np.abs(tc + vc))), 1e-10)
    x = torch.as_tensor(q[0], device=DEVICE).reshape(-1)
    lp = lambda y: sol.log_psi(y.reshape(-1, 3))             # noqa: E731
    g = torch.func.grad(lp)(x)
    t_ad = -0.5 / sol.mass * (torch.trace(torch.func.hessian(lp)(x))
                              + torch.sum(g * g))
    qgate("QSATS kinetic estimator vs torch.func autodiff of log_psi (rel)",
          abs(float(tl[0] - t_ad)) / abs(float(t_ad)), 1e-10)
    # card vs CPU on the same draws: 5 sweeps, 2 of them with exchanges
    ncpu, nsw = QMC_QS_CPU
    gen = torch.Generator().manual_seed(SEED)
    draws = sol.draws(gen, nsw, QMC_QS_NW, exchange=True)
    q0 = (0.3 * torch.randn((QMC_QS_NW, sol.natoms, 3), generator=gen,
                            dtype=torch.float64) / np.sqrt(4 * sol.a))
    flags = np.array([False, True, False, True, False])
    cpu = QSATS(sites, box, a=0.06, b=5.0, device="cpu")
    qc, qh = q0.to(DEVICE), q0[:ncpu]
    e_err, acc_same = 0.0, True
    for k in range(nsw):
        (qc, _), _, acc_c, _ = sol.sweeps(
            qc, [d[k:k + 1].to(DEVICE) for d in draws], flags[k:k + 1])
        qc = qc.clone()
        (qh, _), _, acc_h, _ = cpu.sweeps(
            qh, [d[k:k + 1, :ncpu] for d in draws], flags[k:k + 1])
        ec = sum(sol.local_energy(qc[:ncpu])).cpu()
        eh = sum(cpu.local_energy(qh))
        e_err = max(e_err, float(torch.max(torch.abs(ec - eh) / eh.abs())))
        # accepted moves per walker (the fractions' last bit follows how
        # each device divides)
        acc_same &= bool(torch.equal(
            torch.round(acc_c[:, :ncpu].cpu() * sol.natoms),
            torch.round(acc_h * sol.natoms)))
    qgate(f"QSATS card vs CPU, {nsw} sweeps on the same draws: local "
          f"energies of the first {ncpu} walkers (rel)", e_err, 1e-10)
    if not acc_same:
        raise AssertionError("QSATS card vs CPU: acceptance decisions differ")
    qgate("QSATS card vs CPU: final walkers (rel)",
          float(torch.max(torch.abs(qc[:ncpu].cpu() - qh))
                / torch.max(torch.abs(qh))), 1e-10)
    log(f"[qmc] QSATS card vs CPU: acceptance decisions of {ncpu} walkers x "
        f"{sol.natoms} atoms x {nsw} sweeps identical ({card})")
    # the full-width run, through the entry point
    torch.cuda.reset_peak_memory_stats()
    res, wall = timed(lambda: sol.run(SEED, nwalkers=QMC_QS_NW,
                                      nsweeps=QMC_QS_SWEEPS,
                                      nequil=QMC_QS_EQUIL, step=0.5,
                                      exchange_prob=0.2))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # 180 atoms relax from the tight start over hundreds of sweeps, so the
    # C++ chains (per-atom moves, no exchanges) are held to a run with the
    # same moves over the same sweeps from the same kind of start
    plain = sol.run(SEED + 1, nwalkers=QMC_QS_NW, nsweeps=QMC_QS_SWEEPS,
                    nequil=QMC_QS_EQUIL, step=0.5)
    chains = np.array([f.result()[0] for f in host["qsats"]])
    e_cpp = float(chains.mean())
    se_cpp = float(chains.std(ddof=1) / np.sqrt(len(chains)))
    log(f"[qmc] QSATS energies (K/atom): exchange_prob 0.2 "
        f"{res['energy']:.3f} +- {res['error']:.3f}, without exchanges "
        f"{plain['energy']:.3f} +- {plain['error']:.3f}, {len(chains)} C++ "
        f"chains {e_cpp:.3f} +- {se_cpp:.3f} ({card})")
    qgate(f"QSATS energy without exchanges vs {len(chains)} C++ chains on "
          "the same schedule, K/atom (the example's window 8.0)",
          abs(plain["energy"] - e_cpp), 8.0)
    # steady state: one sweep graphed and eager
    state = (torch.as_tensor(res["walkers"], device=DEVICE),)
    state = (state[0], sol.log_psi(state[0]))
    g1 = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    d1 = sol.draws(g1, 1, QMC_QS_NW)
    graphed = GraphScan(sol.sweep_fn(0.5, "peratom", False))
    eager = GraphScan(sol.sweep_fn(0.5, "peratom", False), graph=False)
    graphed(state, *d1)
    walls = wall_s(lambda: graphed(state, *d1), reps=5)
    g_us, g_k, g_api = qmc_profile(lambda: graphed(state, *d1), 3)
    e_us, e_k, e_api = qmc_profile(lambda: eager(state, *d1), 1)
    sweep_s = min(walls)
    out["qsats"] = dict(
        natoms=sol.natoms, pairs=P, walkers=QMC_QS_NW, sweeps=QMC_QS_SWEEPS,
        energy_K=res["energy"], error_K=res["error"], cpp_K=e_cpp,
        cpp_se_K=se_cpp, no_exchange_K=plain["energy"],
        acceptance=res["acceptance"],
        exchanges_accepted=res["exchange_acceptance"], run_s=wall,
        sweeps_per_s=QMC_QS_SWEEPS / wall,
        walker_sweeps_per_s=QMC_QS_SWEEPS * QMC_QS_NW / wall,
        graphed_sweep_ms=sweep_s * 1e3, device_us_per_sweep=g_us,
        busy=g_us / 1e6 / sweep_s, kernels_per_sweep=g_k,
        host_calls_graphed=g_api, host_calls_eager=e_api,
        eager_device_us=e_us, peak_gib=peak)
    log(f"[qmc] QSATS hcp {QMC_QS_CELLS}: {sol.natoms} atoms, {P} pairs, "
        f"{QMC_QS_NW} walkers, {QMC_QS_SWEEPS} per-atom sweeps in {wall:.2f} "
        f"s ({QMC_QS_SWEEPS / wall:.1f} sweeps/s, "
        f"{QMC_QS_SWEEPS * QMC_QS_NW / wall:.0f} walker-sweeps/s, graph "
        f"capture included); acceptance "
        f"{res['acceptance']:.3f}, {res['exchange_acceptance']:.3f} "
        f"exchanges accepted per walker; peak {peak:.2f} GiB ({card})")
    log(f"[qmc] QSATS sweep graphed {sweep_s * 1e3:.2f} ms wall, "
        f"{g_us / 1e3:.2f} ms device ({g_k:.0f} kernels), busy "
        f"{g_us / 1e6 / sweep_s:.3f}; host calls per sweep graphed {g_api}, "
        f"eager {e_api} ({e_us / 1e3:.2f} ms device) ({card})")


def qmc_dmc(card, out, qgate, host):
    from pyqed_tpu_torch.core.dynamics import GraphScan
    from pyqed_tpu_torch.qmc import DMC
    dmc = DMC(ndim=3, potential=lambda x: 0.5 * torch.sum(x ** 2))
    (E, tr, xf), wall = timed(lambda: dmc.run(SEED, device=DEVICE,
                                              **QMC_DMC))
    nw, ns = QMC_DMC["nwalkers"], QMC_DMC["nsteps"]
    # blocks of 150 steps, beyond the walkers' correlation time (1 / dt)
    e, se = block_se(tr[QMC_DMC["nequil"]:], 10)
    qgate("DMC 3-D harmonic E vs 1.5, in standard errors",
          abs(e - 1.5) / se, QMC_NSE)
    En, trn, _ = host["dmc"].result()
    en, sen = block_se(trn[QMC_DMC["nequil"]:], 10)
    qgate(f"DMC vs dmc_native at {QMC_DMC_NATIVE_NW} walkers, in standard "
          "errors", abs(e - en) / np.hypot(se, sen), QMC_NSE)
    scan = GraphScan(dmc.step_fn(QMC_DMC["dt"]))
    carry = (xf, torch.ones(nw, dtype=torch.float64, device=DEVICE),
             torch.tensor(1.5, dtype=torch.float64, device=DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    xi = torch.randn((50, nw, 3), generator=gen, device=DEVICE,
                     dtype=torch.float64)
    u = torch.rand((50,), generator=gen, device=DEVICE, dtype=torch.float64)
    carry, _ = scan(carry, xi, u)
    walls = wall_s(lambda: scan(carry, xi, u), reps=3)
    d_us, k, api = qmc_profile(lambda: scan(carry, xi[:10], u[:10]), 2)
    step_s = min(walls) / 50
    out["dmc"] = dict(E=e, se=se, native_E=en, native_se=sen, run_s=wall,
                      walker_steps_per_s=nw * ns / wall,
                      step_us=step_s * 1e6, device_us_per_step=d_us / 10,
                      kernels_per_step=k / 10, busy=d_us / 10 / 1e6 / step_s)
    log(f"[qmc] DMC 3-D harmonic, {nw} walkers x {ns} steps in {wall:.2f} s "
        f"({nw * ns / wall:.3e} walker-steps/s); E = {e:.5f} +- {se:.5f} "
        f"(dmc_native {en:.5f} +- {sen:.5f}); a graphed step {step_s * 1e6:.1f}"
        f" us wall, {d_us / 10:.1f} us device ({k / 10:.0f} kernels), busy "
        f"{d_us / 10 / 1e6 / step_s:.3f} ({card})")


def qmc_pimc(card, out, qgate):
    from pyqed_tpu_torch.qmc import BosonPIMC, PIMC
    pimc = PIMC(lambda q: 0.5 * torch.sum(q ** 2), **QMC_PIMC_SYS)
    (ev, et, acc, _), wall = timed(lambda: pimc.run(SEED, device=DEVICE,
                                                    **QMC_PIMC))
    e_th, se = block_se(pimc.trace_[1])
    e_vir, se_v = block_se(pimc.trace_[0])
    exact_m = harmonic_pimc_energy(1, QMC_PIMC_SYS["beta"],
                                   QMC_PIMC_SYS["nbeads"])
    exact = 0.5 / np.tanh(0.5 * QMC_PIMC_SYS["beta"])
    qgate(f"PIMC thermodynamic estimator vs the exact M = "
          f"{QMC_PIMC_SYS['nbeads']} energy, in standard errors",
          abs(e_th - exact_m) / se, QMC_NSE)
    qgate("PIMC virial estimator vs the exact thermal energy, in standard "
          "errors", abs(e_vir - exact) / se_v, QMC_NSE)
    nps = QMC_PIMC["npaths"] * (QMC_PIMC["nsweeps"] + QMC_PIMC["ntherm"])
    out["pimc"] = dict(E_thermo=e_th, se=se, E_virial=e_vir, se_virial=se_v,
                       exact=exact, exact_M=exact_m, acceptance=acc,
                       run_s=wall, path_sweeps_per_s=nps / wall)
    log(f"[qmc] PIMC harmonic (examples/pimc_harmonic.py): "
        f"{QMC_PIMC['npaths']} paths x {QMC_PIMC_SYS['nbeads']} beads, "
        f"{QMC_PIMC['ntherm']} + {QMC_PIMC['nsweeps']} sweeps in {wall:.2f} "
        f"s ({nps / wall:.3e} path-sweeps/s); thermo {e_th:.5f} +- {se:.5f} "
        f"(exact at M {exact_m:.5f}), virial {e_vir:.5f} +- {se_v:.5f} "
        f"(exact {exact:.5f}); acceptance {acc:.3f} ({card})")
    sysb = QMC_BOSON_SYS
    bos = BosonPIMC(lambda q: 0.5 * torch.sum(q ** 2), **sysb)
    (E, ab, ap, frac), wall = timed(lambda: bos.run(SEED, device=DEVICE,
                                                    **QMC_BOSON))
    eb, seb = block_se(bos.trace_[0], 10)
    exact_b = harmonic_pimc_energy(sysb["nparticles"], sysb["beta"],
                                   sysb["nbeads"])
    dist = sysb["nparticles"] * harmonic_pimc_energy(1, sysb["beta"],
                                                     sysb["nbeads"])
    qgate(f"BosonPIMC {sysb['nparticles']} bosons vs the exact M = "
          f"{sysb['nbeads']} energy, in standard errors",
          abs(eb - exact_b) / seb, QMC_NSE)
    out["boson_pimc"] = dict(E=eb, se=seb, exact_M=exact_b,
                             distinguishable_M=dist, acc_bead=ab,
                             acc_perm=ap, exchanged_fraction=frac, run_s=wall)
    log(f"[qmc] BosonPIMC {sysb['nparticles']} bosons, beta "
        f"{sysb['beta']}, {sysb['nbeads']} beads, {QMC_BOSON['nreplicas']} "
        f"replicas, {QMC_BOSON['ntherm']} + {QMC_BOSON['nsweeps']} sweeps in "
        f"{wall:.2f} s: E = {eb:.5f} +- {seb:.5f} (exact {exact_b:.5f}; "
        f"distinguishable {dist:.5f}); acceptance beads {ab:.3f}, "
        f"permutations {ap:.4f}, {frac:.3f} of replicas exchanged ({card})")


def qmc_md(card, out, qgate):
    from pyqed_tpu_torch.md import LJMD, RPMD, kubo_harmonic_xx, lj_forces
    c = QMC_RPMD
    rp = RPMD(lambda x: 0.5 * torch.sum(x ** 2), beta=c["beta"],
              nbeads=c["nbeads"], device=DEVICE)
    x0, p0 = rp.sample_harmonic(SEED, c["ntraj"], 1.0)
    exact = 0.5 / np.tanh(c["beta"] / 2)
    x2 = float(torch.mean(torch.sum(x0 ** 2, dim=-1)))
    qgate("RPMD thermal <x^2> vs 0.5 coth(4) (rel; the example's 0.05)",
          abs(x2 - exact) / exact, 0.05)
    (tt, C), wall = timed(lambda: rp.position_tcf(x0, p0, **QMC_RPMD_TCF))
    Cex = kubo_harmonic_xx(tt, 1.0, c["beta"])
    qgate("RPMD Kubo C_xx(t) vs kubo_harmonic_xx (of C(0); the example's "
          "0.03)", float(np.max(np.abs(C - Cex)) / Cex[0]), 0.03)
    nth, nst = QMC_RPMD_THERM
    z = torch.zeros((nth, c["nbeads"], 1), dtype=torch.float64, device=DEVICE)
    (xt, _), wall_t = timed(lambda: rp.thermalize(z, z, 2, dt=0.05,
                                                   nsteps=nst))
    x2t = float(torch.mean(torch.sum(xt ** 2, dim=-1)))
    qgate("T-RPMD (PILE) thermalized <x^2> (rel; the example's 0.15)",
          abs(x2t - exact) / exact, 0.15)
    out["rpmd"] = dict(x2=x2, x2_pile=x2t, tcf_s=wall, pile_s=wall_t,
                       traj_steps_per_s=c["ntraj"] * QMC_RPMD_TCF["nt"] / wall,
                       pile_steps_per_s=nst / wall_t)
    log(f"[qmc] RPMD (examples/rpmd_harmonic.py): TCF of {c['ntraj']} x "
        f"{c['nbeads']} beads, {QMC_RPMD_TCF['nt']} steps in {wall:.3f} s; "
        f"PILE {nth} trajectories x {nst} steps in {wall_t:.3f} s "
        f"({nst / wall_t:.0f} steps/s) ({card})")
    # ------------------------------------------- Lennard-Jones
    lj = LJMD(device=DEVICE, **QMC_LJ)
    nth, nve = QMC_LJ_NT
    run, wall = timed(lambda: lj.run(SEED, dt=0.005, nt=nth + nve,
                                     thermostat_steps=nth))
    etot = (run["U"] + 1.5 * lj.n * run["T"])[nth:].cpu().numpy()
    drift = float((etot.max() - etot.min()) / abs(etot.mean()))
    qgate(f"LJMD {lj.n} atoms: NVE total energy spread over {nve} steps "
          "(rel)", drift, 1e-3)
    mc, wall_mc = timed(lambda: lj.monte_carlo(SEED, nmoves=QMC_LJ_MC,
                                               delta=0.1, x0=run["x"]))
    U_fresh = float(lj_forces(mc["x"], lj.L, lj.rc)[0])
    qgate(f"LJ Monte Carlo: U after {QMC_LJ_MC} moves (sum of dU) vs a fresh "
          "total (rel)", abs(mc["U"] - U_fresh) / abs(U_fresh), 1e-9)
    if not 0.05 < mc["acceptance"] < 0.95:
        raise AssertionError(f"LJ Monte Carlo acceptance {mc['acceptance']}")
    out["ljmd"] = dict(natoms=lj.n, steps_per_s=(nth + nve) / wall,
                       nve_spread=drift, mc_moves_per_s=QMC_LJ_MC / wall_mc,
                       mc_acceptance=mc["acceptance"])
    log(f"[qmc] LJMD ncell {QMC_LJ['ncell']} ({lj.n} atoms): {nth + nve} "
        f"steps in {wall:.2f} s ({(nth + nve) / wall:.0f} steps/s), NVE "
        f"spread {drift:.2e}; {QMC_LJ_MC} MC moves in {wall_mc:.2f} s "
        f"({QMC_LJ_MC / wall_mc:.0f} moves/s), acceptance "
        f"{mc['acceptance']:.3f} ({card})")


def qmc_mlp(card, out, qgate):
    from pyqed_tpu_torch.ml import MLP, init_params, params_from_numpy
    c = QMC_MLP
    rng = np.random.default_rng(SEED)
    x = rng.uniform(-1.5, 1.5, size=(c["npts"], 2))
    y = np.sin(x[:, :1]) * np.cos(x[:, 1:])
    p0 = [tuple(a.numpy() for a in layer)
          for layer in init_params(SEED, c["dims"], device="cpu")]
    fits = {}
    for d in (DEVICE, "cpu"):
        m = MLP(c["dims"], device=d)
        m.params = params_from_numpy(p0, d)
        _, wall = timed(lambda: m.fit(x, y, lr=c["lr"], epochs=c["epochs"]))
        fits[d] = (m.loss_, wall)
    (lc, wc), (lh, wh) = fits[DEVICE], fits["cpu"]
    qgate(f"MLP {c['dims']} fit, {c['epochs']} Adam epochs: loss card vs CPU "
          "(rel)", abs(lc - lh) / lh, 1e-10)
    out["mlp"] = dict(loss=lc, card_s=wc, cpu_s=wh)
    log(f"[qmc] MLP {c['dims']} on {c['npts']} points: loss {lc:.6e} after "
        f"{c['epochs']} epochs, {wc:.2f} s on the card, {wh:.2f} s on the "
        f"CPU ({card})")


def phase_qmc(card):
    """qmc/, md/ and ml/ on the card (no TPU kernel lies on them, so every
    launch count stays 0): QSATS at full width (solid He-4 on hcp (3, 3,
    5), 180 atoms and 6,120 directed pairs at the example's density, a =
    0.06, b = 5.0, 512 walkers, per-atom sweeps with exchange_prob 0.2, 200
    sweeps of which 100 equilibrate): its batched local energy against
    the port's C++ engine and against torch.func autodiff of log_psi (<=
    1e-10 rel), the card against the CPU on the same draws over 5 sweeps
    (local energies <= 1e-10 rel, acceptance decisions identical), the
    energy within the example's 8 K/atom of 48 C++ chains relaxing over
    the same sweeps from the same kind of start (host threads beside the
    card's work); sweeps/s, a graphed sweep's device time and
    busy share, host calls per sweep eager and graphed, peak memory. DMC
    on the 3-D harmonic well (65,536 walkers, 2,000 steps of 0.01) within
    5 standard errors of 1.5 and of dmc_native at 8,192 walkers; PIMC
    (examples/pimc_harmonic.py: 2,048 paths x 64 beads, 1,200 sweeps) and
    three harmonic bosons in BosonPIMC within 5 standard errors of the
    exact energy of their discretised path integral; RPMD's Kubo TCF and
    PILE thermalisation (examples/rpmd_harmonic.py, its tolerances); LJMD
    with 2,048 atoms (NVE energy spread, 20,000 Monte Carlo moves whose
    summed dU equals a fresh total); an MLP fit, card vs CPU (<= 1e-10)."""
    from concurrent.futures import ThreadPoolExecutor
    from pyqed_tpu_torch.qmc import dmc_native, hcp_lattice, QSATS
    from pyqed_tpu_torch.qmc import build_native_engine, qsats_vmc_native
    t_phase = time.perf_counter()
    out = {"card": card, "gates": {}}
    reset_counts()

    def qgate(label, val, tol):
        out["gates"][label] = gate("qmc", label, val, tol)

    # the C++ references run on host threads (ctypes releases the GIL)
    # while the card works
    build_native_engine()
    sites, box = hcp_lattice(QMC_QS_CELLS, QMC_DENSITY)
    ref = QSATS(sites, box, a=0.06, b=5.0, device="cpu")
    rng = np.random.default_rng(SEED)
    pool = ThreadPoolExecutor(8)
    try:
        # first in the queue: the DMC stage, the first, waits for it
        host = {"dmc": pool.submit(
            dmc_native, "harmonic", ndim=3, nwalkers=QMC_DMC_NATIVE_NW,
            nsteps=QMC_DMC["nsteps"], nequil=QMC_DMC["nequil"],
            dt=QMC_DMC["dt"], eref0=QMC_DMC["eref"], seed=SEED)}
        host["qsats"] = [pool.submit(
            qsats_vmc_native, 0.3 * rng.normal(size=(ref.natoms, 3))
            / np.sqrt(4 * ref.a), ref.ipairs, ref.vpvec, ref.a, ref.b,
            ref.mass, seed=s, **QMC_QS_CHAIN) for s in range(QMC_QS_CHAINS)]
        stages = {}
        for name, fn, args in (("dmc", qmc_dmc, (host,)),
                               ("pimc", qmc_pimc, ()),
                               ("md", qmc_md, ()), ("mlp", qmc_mlp, ()),
                               ("qsats", qmc_qsats, (host,))):
            t0 = time.perf_counter()
            fn(card, out, qgate, *args)
            stages[name] = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True)
    out["stage_s"] = stages
    no_launches("qmc")
    out["launches"] = read_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[qmc] stages {', '.join(f'{k} {v:.1f} s' for k, v in stages.items())}"
        f"; launch counts {read_counts()} (all 0); phase "
        f"{out['phase_s']:.1f} s ({card})")
    return out


PHASE_S = {}


def clocked(fn, *args):
    """``fn(*args)``, its seconds logged and kept in :data:`PHASE_S`."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[fn.__name__] = time.perf_counter() - t0
    log(f"[phases] {fn.__name__}: {PHASE_S[fn.__name__]:.1f} s")
    return out


def main():
    t_start = time.perf_counter()
    card = phase_environment()
    import pyqed_tpu_torch  # noqa: F401  (fails outside the repository)
    from pyqed_tpu_torch.ops import kernels as kn
    clocked(phase_build)
    from pyqed_tpu_torch import FMO
    shapes = {"fmo": FMO().heom(**FLAGSHIP, device=DEVICE),
              "chain8": clocked(chain_solver),
              "nexp2": FMO().heom(**dict(FLAGSHIP, nexp=2), device=DEVICE)}
    errs = clocked(phase_parity, shapes)
    spo_errs = clocked(phase_spo_parity)
    lb_errs = clocked(phase_lindblad_parity)
    launches = clocked(phase_main)
    spo_counts, spo_sol, spo_psi0 = clocked(phase_spo_main)
    clocked(phase_spo_numpy_check)
    clocked(phase_morse)
    lb_launches = clocked(phase_lindblad_main)
    clocked(phase_redfield)
    slices = {"2des": {"photon_echo": clocked(phase_2des),
                       "tdes": clocked(phase_tdes)},
              "deom": {"run": clocked(phase_deom),
                       "resolvent": clocked(phase_resolvent)},
              "heom_driven": {"run": clocked(phase_heom_driven),
                              "correlations": clocked(
                                  phase_heom_correlations)},
              "polariton": clocked(phase_polariton),
              "ldr": clocked(phase_ldr, card),
              "open": clocked(phase_open, card),
              "nonadiabatic": clocked(phase_nonadiabatic, card),
              "field2des": clocked(phase_field2des, card),
              "grid": clocked(phase_grid_rest, card),
              "tn": clocked(phase_tn, card),
              "control": clocked(phase_control, card),
              "qchem": clocked(phase_qchem, card)}
    slices["qchem"], benzene = slices["qchem"]
    slices["qchem_rest"] = clocked(phase_qchem_rest, card, benzene)
    slices["negf"] = clocked(phase_negf, card)
    slices["qmc"] = clocked(phase_qmc, card)
    times = clocked(phase_timing, card, shapes)
    spo_times = clocked(phase_spo_timing, card, spo_sol, spo_psi0)
    del spo_sol, spo_psi0
    lb_times = clocked(phase_lindblad_timing, card)
    ns10_times = clocked(phase_ns10_timing, card)
    f2d_time = clocked(batched_coupling_timing, card)
    slices["timing"] = clocked(phase_2des_timing, card)
    slices["heom_driven"]["timing"] = clocked(phase_driven_timing, card)
    slices["card"] = card
    slices["phase_s"] = PHASE_S
    t_kern, t_plain, (b_ms, b_by) = times[("fmo", torch.complex128)]
    kernels = [{
        "name": "heom_coupling",
        "route": "cuda",
        "source": "pyqed_tpu_torch/csrc/heom_coupling.cu",
        "replaces": "pyqed_tpu/ops/pallas_kernels.py:681",
        "launches": launches,
        "max_abs_err": errs[("fmo", torch.complex128)],
        "ms": t_kern,
        "plain_ms": t_plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]
    for kind, replaces in (("phase", "pyqed_tpu/ops/pallas_kernels.py:267"),
                           ("potential",
                            "pyqed_tpu/ops/pallas_kernels.py:309")):
        t = spo_times[(kind, torch.complex128)]
        kernels.append({
            "name": f"spo_{kind}",
            "route": "cuda",
            "source": "pyqed_tpu_torch/csrc/spo.cu",
            "replaces": replaces,
            "launches": spo_counts[f"spo_{kind}"],
            "max_abs_err": spo_errs[(kind, (SPO_N,) * 3, True,
                                     torch.complex128)],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        })
    # timed at the main path's shape (the polariton runs' 1024 x 10);
    # the same at 2^20 points beside it
    t, big = ns10_times[(POL_NX, NS10)], ns10_times[(NS10_N, NS10)]
    kernels.append({
        "name": "spo_potential_generic",
        "route": "cuda",
        "source": "pyqed_tpu_torch/csrc/spo.cu",
        "replaces": "pyqed_tpu/ops/pallas_kernels.py:309",
        "launches": slices["nonadiabatic"]["generic_branch_launches"][
            "spo_potential"],
        "max_abs_err": spo_errs[("potential", (POL_NX,), False,
                                 torch.complex128)],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1],
        "library_ms": t["library_ms"],
        "shape": [POL_NX, NS10],
        "at_2^20_points": {
            "max_abs_err": spo_errs[("potential", (NS10_N,), False,
                                     torch.complex128)],
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound"][0], "library_ms": big["library_ms"]},
    })
    kernels.append({
        "name": "heom_coupling_batched",
        "route": "cuda",
        "source": "pyqed_tpu_torch/csrc/heom_coupling.cu",
        "replaces": "pyqed_tpu/ops/pallas_kernels.py:681",
        "launches": slices["field2des"]["dest_major_launches"],
        "max_abs_err": errs[("chain8", torch.complex128, F2D_TIME_B, True)],
        "ms": f2d_time["ms"],
        "plain_ms": f2d_time["plain_ms"],
        "bound_ms": f2d_time["bound"][0],
        "bound_by": f2d_time["bound"][1],
        "library_ms": None,
        "shape": {"hierarchy": "chain8", "nado": 680, "B": F2D_TIME_B,
                  "V": 64},
        "design": "destination-major, DMMA",
        "tflops": f2d_time["tflops"],
        "bound_share": f2d_time["bound"][0] / f2d_time["ms"],
        "batch_min": {str(k)[6:]: v
                      for k, v in kn.COUPLING_BATCH_MIN.items()},
        "ms_by_batch": f2d_time["by_batch"],
    })
    n_big = 2 * LB_BIG_NVIB
    t = lb_times[(n_big, torch.complex128)]
    kernels.append({
        "name": "liouvillian_commutator",
        "route": "cuda",
        "source": "pyqed_tpu_torch/csrc/liouvillian.cu",
        "replaces": "pyqed_tpu/ops/pallas_kernels.py:364",
        "launches": lb_launches,
        "max_abs_err": lb_errs[(n_big, torch.complex128)],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1],
        "library_ms": t["library_ms"],
    })
    t = commutator_backward_timing(card)
    kernels.append({
        "name": "liouvillian_commutator_backward",
        "route": "cuda",
        "source": "pyqed_tpu_torch/csrc/liouvillian.cu",
        "replaces": "pyqed_tpu/ops/pallas_kernels.py:364",
        "launches": slices["control"]["dimer_rate_fit"]["backward_launches"],
        "max_abs_err": slices["control"]["backward"][
            (1024, torch.complex128, "d/drho")],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1],
        "library_ms": t["library_ms"],
        "shape": [1024, 1024],
        "note": "the same kernel on -H_eff^dag and the cotangent: the "
                "gradient of the commutator with respect to rho",
    })
    slices["control"]["backward"] = {
        f"{n} {str(d)[6:]} {w}": e
        for (n, d, w), e in slices["control"]["backward"].items()}
    slices["script_s"] = time.perf_counter() - t_start
    log(f"[done] chip_smoke.py {slices['script_s']:.1f} s, the build "
        f"included ({card})")
    log(json.dumps({"kernels": kernels, "slices": slices}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------- A/B
def load_package(path, name):
    """The package at ``path`` imported under ``name``, beside this
    checkout's pyqed_tpu_torch (the package's own imports are relative)."""
    import importlib.util
    import sys
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def ab_main(parent_root, pairs):
    """The HEOM main path of another checkout's package (``parent_root``)
    against this checkout's, in one process: the FMO flagship's run()
    steps/s with kernel='cuda' in ``pairs`` alternating pairs, then its
    right-hand side per call (CUDA events over eager calls, and host
    enqueue) in turns; the verdict on run() compares this checkout's
    median with the other's range. Then this checkout's coupling times
    (:func:`coupling_timing`), and both checkouts' coupling wrappers in
    turns, unbatched at the flagship and batched at the field-2DES shape
    (chain8, B = F2D_TIME_B) (:func:`ab_coupling`)."""
    import importlib
    import statistics
    card = phase_environment()
    import pyqed_tpu_torch
    pkgs = {"parent": load_package(
                os.path.join(os.path.abspath(parent_root), "pyqed_tpu_torch"),
                "parent_pyqed_tpu_torch"),
            "change": pyqed_tpu_torch}
    with ThreadPoolExecutor(len(pkgs)) as pool:
        list(pool.map(lambda p: importlib.import_module(
            p.__name__ + ".ops._cuda_lib").load("heom_coupling"),
            pkgs.values()))
    runs = {k: (p.FMO(), p.FMO().heom(**FLAGSHIP, device=DEVICE))
            for k, p in pkgs.items()}
    for k in pkgs:
        steps_per_s(*runs[k], kernel="cuda",            # warm-up
                    e_ops=runs[k][0].site_projectors())
    rates = {k: [] for k in pkgs}
    for i in range(pairs):
        for k in (("parent", "change") if i % 2 == 0
                  else ("change", "parent")):
            rates[k].append(steps_per_s(
                *runs[k], kernel="cuda", e_ops=runs[k][0].site_projectors()))
    rng = np.random.default_rng(SEED)
    per_call = {k: dict(eager=[], host=[]) for k in pkgs}
    for i in range(4):
        for k in (("parent", "change") if i % 2 == 0
                  else ("change", "parent")):
            rhs, nado = runs[k][1].rhs_fn(torch.complex128)
            n = runs[k][1].n
            y = torch.as_tensor(rng.standard_normal((nado, n, n)) + 0j,
                                device=DEVICE)
            per_call[k]["eager"].append(event_ms(rhs, (y,)))
            per_call[k]["host"].append(host_ms(rhs, (y,)))
    for k in pkgs:
        log(f"[ab] {k}: run() FMO flagship cuda steps/s "
            + ", ".join(f"{r:.0f}" for r in rates[k])
            + f"; median {statistics.median(rates[k]):.0f}, range "
            f"{min(rates[k]):.0f}-{max(rates[k]):.0f}; right-hand side per "
            f"call eager {us(per_call[k]['eager'])} us, host "
            f"{us(per_call[k]['host'])} us ({card})")
    from pyqed_tpu_torch.ops.kernels import _raw_stream
    index = torch.cuda.current_device()
    reads = {"torch.cuda.current_stream().cuda_stream":
             lambda: torch.cuda.current_stream().cuda_stream,
             "the raw handle (ops/kernels.py::_raw_stream)":
             lambda: _raw_stream(index)}
    log("[ab] host time per read of the current stream's handle: "
        + "; ".join(f"{k} {us([host_ms(f, ()) for _ in range(3)], '.2f')} us"
                    for k, f in reads.items()) + f" ({card})")
    med, med_p = (statistics.median(rates[k]) for k in ("change", "parent"))
    lo, hi = min(rates["parent"]), max(rates["parent"])
    q = statistics.quantiles(rates["parent"], n=4)
    wins = sum(c > p for c, p in zip(rates["change"], rates["parent"]))
    if wins >= 0.9 * pairs and med - med_p > q[2] - q[0]:
        verdict = "faster"
    elif lo <= med <= hi:
        verdict = "unchanged (within the parent's range)"
    else:
        verdict = "a regression" if med < lo else "unresolved"
    log(f"[ab] run(): the change wins {wins} of {pairs} pairs; medians "
        f"{med:.0f} (change) and {med_p:.0f} (parent) steps/s, the "
        f"parent's range {lo:.0f}-{hi:.0f} and quartile spread "
        f"{q[2] - q[0]:.0f}: {verdict}")
    coupling_timing(card, "fmo", runs["change"][1], torch.complex128)
    ab_coupling(card, pkgs, "unbatched FMO flagship",
                coupling_operands(runs["change"][1], torch.complex128))
    ab_coupling(card, pkgs, f"batched chain8 B = {F2D_TIME_B}",
                batched_operands(chain_solver(), torch.complex128,
                                 F2D_TIME_B))


def ab_coupling(card, pkgs, label, args):
    """The coupling through each package's wrapper (with its own plan) on
    the same complex128 operands ``args`` (F, nbr, w, OpT), per call in
    turns: CUDA events over eager calls, and the host's enqueue; the
    outputs must agree."""
    import importlib
    calls, outs = {}, {}
    for k, p in pkgs.items():
        kmod = importlib.import_module(p.__name__ + ".ops.kernels")
        plan = kmod.heom_coupling_plan(args[1], args[2])
        calls[k] = (lambda kmod=kmod, plan=plan:
                    kmod.heom_coupling(*args, plan=plan))
        outs[k] = calls[k]()
    diff = rel(outs["change"], outs["parent"])
    del outs
    big = args[0].dim() == 3
    t = {k: dict(eager=[], host=[]) for k in pkgs}
    for i in range(4):
        for k in (("parent", "change") if i % 2 == 0
                  else ("change", "parent")):
            t[k]["eager"].append(event_ms(calls[k], (), iters=10 if big
                                          else 200, warmup=2 if big else 20))
            t[k]["host"].append(host_ms(calls[k], (), iters=10 if big
                                        else 300))
    b = coupling_bound(*args)
    log(f"[ab] coupling {label} complex128 per call, eager (CUDA events): "
        + "; ".join(f"{k} " + " / ".join(f"{x * 1e3:.2f}" for x in
                                         t[k]["eager"]) + " us"
                    for k in pkgs)
        + "; host enqueue: " + "; ".join(
            f"{k} " + " / ".join(f"{x * 1e3:.2f}" for x in t[k]["host"])
            + " us" for k in pkgs)
        + f"; the change {min(t['parent']['eager']) / min(t['change']['eager']):.2f}x"
        f" faster eager; bound {b[0] * 1e3:.2f} us ({b[1]}); outputs "
        f"differ by rel {diff:.2e} ({card})")
    if not diff <= 1e-12:
        raise AssertionError(f"the two checkouts' couplings ({label}) differ "
                             f"by {diff:.3e}")


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--ab"]:
        ab_main(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 12)
    else:
        main()
