// Native CPU walker engine for diffusion Monte Carlo and QSATS.
//
// A copy of pyqed_tpu's qmc/native/qmc_engine.cpp (the code is the same
// line for line, so both builds give the same numbers with the same flags
// and thread count): drift-diffusion walker updates, local-energy
// accumulation and population control by comb resampling, OpenMP-parallel
// over walkers. The device path with the same algorithm is
// pyqed_tpu_torch/qmc/dmc.py; ../engine.py builds this file with
//   g++ -O3 -march=native -fopenmp -shared -fPIC
// into pyqed_tpu_torch/build/ and binds it with ctypes.
//
// dmc_run seeds one generator per OpenMP thread, so its result depends on
// OMP_NUM_THREADS.
//
// Supported potentials (id): 0 = harmonic sum_i x_i^2/2,
// 1 = Morse D(1-e^{-a x})^2 with p0=D, p1=a, 2 = quartic x^4/4 + p0 x^2/2.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

double potential(int pot_id, const double* x, int ndim, double p0, double p1) {
  double v = 0.0;
  switch (pot_id) {
    case 0:
      for (int d = 0; d < ndim; ++d) v += 0.5 * x[d] * x[d];
      return v;
    case 1:
      for (int d = 0; d < ndim; ++d) {
        double u = 1.0 - std::exp(-p1 * x[d]);
        v += p0 * u * u;
      }
      return v;
    case 2:
      for (int d = 0; d < ndim; ++d)
        v += 0.25 * x[d] * x[d] * x[d] * x[d] + 0.5 * p0 * x[d] * x[d];
      return v;
    default:
      return 0.0;
  }
}

}  // namespace

extern "C" {

// Pure DMC (no importance sampling): diffuse + birth/death by comb
// resampling on branching weights. Returns the growth-estimator energy
// averaged over the last (nsteps - nequil) steps; e_trace (nsteps) and the
// final walker array are written in place.
double dmc_run(double* walkers,       // (nwalkers, ndim), in/out
               int nwalkers, int ndim,
               int nsteps, int nequil, double dt, double mass,
               int pot_id, double p0, double p1,
               double eref0, uint64_t seed,
               double* e_trace) {
  std::vector<double> xnew(static_cast<size_t>(nwalkers) * ndim);
  std::vector<double> w(nwalkers);
  std::vector<double> eloc(nwalkers);
  double eref = eref0;
  const double sigma = std::sqrt(dt / mass);

  std::mt19937_64 master(seed);

  for (int step = 0; step < nsteps; ++step) {
    const uint64_t step_seed = master();

#ifdef _OPENMP
#pragma omp parallel
#endif
    {
#ifdef _OPENMP
      const int tid = omp_get_thread_num();
#else
      const int tid = 0;
#endif
      std::mt19937_64 rng(step_seed + 0x9e3779b97f4a7c15ULL * (tid + 1));
      std::normal_distribution<double> gauss(0.0, 1.0);
#ifdef _OPENMP
#pragma omp for
#endif
      for (int i = 0; i < nwalkers; ++i) {
        const double* xi = walkers + static_cast<size_t>(i) * ndim;
        double* xo = xnew.data() + static_cast<size_t>(i) * ndim;
        double v_old = potential(pot_id, xi, ndim, p0, p1);
        for (int d = 0; d < ndim; ++d) xo[d] = xi[d] + sigma * gauss(rng);
        double v_new = potential(pot_id, xo, ndim, p0, p1);
        w[i] = std::exp(-dt * (0.5 * (v_old + v_new) - eref));
        eloc[i] = v_new;
      }
    }

    double W = 0.0, EW = 0.0;
    for (int i = 0; i < nwalkers; ++i) {
      W += w[i];
      EW += w[i] * eloc[i];
    }
    const double E_est = EW / W;
    e_trace[step] = E_est;
    eref = E_est - 0.5 * std::log(W / nwalkers) / dt;

    // systematic (comb) resampling — the branching step
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    const double u0 = uni(master);
    double cum = 0.0;
    int i_src = 0;
    double target = (u0) / nwalkers * W;
    std::vector<double> resampled(static_cast<size_t>(nwalkers) * ndim);
    cum = w[0];
    for (int j = 0; j < nwalkers; ++j) {
      target = (u0 + j) / nwalkers * W;
      while (cum < target && i_src < nwalkers - 1) {
        ++i_src;
        cum += w[i_src];
      }
      std::memcpy(resampled.data() + static_cast<size_t>(j) * ndim,
                  xnew.data() + static_cast<size_t>(i_src) * ndim,
                  sizeof(double) * ndim);
    }
    std::memcpy(walkers, resampled.data(),
                sizeof(double) * static_cast<size_t>(nwalkers) * ndim);
  }

  double E = 0.0;
  int count = 0;
  for (int step = nequil; step < nsteps; ++step) {
    E += e_trace[step];
    ++count;
  }
  return count > 0 ? E / count : e_trace[nsteps - 1];
}

}  // extern "C"

// ---------------------------------------------------------------------
// QSATS: pair-product VMC on a quantum solid (solid He), after the QSATS
// Fortran engine's eloc.f and child.f.
// Trial: ln psi = -a sum_i |q_i|^2 - 1/2 sum_{undirected pairs}(b/r)^5,
// q = displacements from lattice sites, r from the directed pair
// stencil (ipairs (P,2), vpvec (P,3) = min-image R_j - R_i).
// Pair potential: HFD-B(He) [Aziz et al., Mol. Phys. 61, 1487 (1987)].

namespace {

double hfdbhe_cpp(double r2) {
  const double astar = 1.8443101e5, alstar = 10.43329537,
               bestar = -2.27965105, d = 1.4826, c6 = 1.36745214,
               c8 = 0.42123807, c10 = 0.17473318, rm = 5.59926,
               eps = 10.948, hart = 315774.65;
  const double r = std::sqrt(r2), x = r / rm;
  const double vstar = astar * std::exp(-alstar * x + bestar * x * x);
  double vd = c6 / std::pow(x, 6) + c8 / std::pow(x, 8)
            + c10 / std::pow(x, 10);
  if (x < d) {
    const double t = d / x - 1.0;
    vd *= std::exp(-t * t);
  }
  return (vstar - vd) * eps / hart;
}

double qsats_logpsi(const double* q, int natoms, const int* ipairs,
                    const double* vpvec, int npairs, double a, double b) {
  double s = 0.0;
  for (int i = 0; i < 3 * natoms; ++i) s -= a * q[i] * q[i];
  for (int n = 0; n < npairs; ++n) {
    const int i = ipairs[2 * n], j = ipairs[2 * n + 1];
    double r2 = 0.0;
    for (int d = 0; d < 3; ++d) {
      const double dd = q[3 * j + d] - q[3 * i + d] + vpvec[3 * n + d];
      r2 += dd * dd;
    }
    const double br2 = b * b / r2;
    s -= 0.25 * br2 * br2 * std::sqrt(br2);  // directed double count
  }
  return s;
}

}  // namespace

extern "C" {

// Local energies for nw configurations q (nw, natoms, 3): writes
// t_out/v_out (nw,) [hartree]. Formulas = eloc.f:313 'local'.
void qsats_eloc(const double* q, int nw, int natoms, const int* ipairs,
                const double* vpvec, int npairs, double a, double b,
                double mass, double* t_out, double* v_out) {
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int w = 0; w < nw; ++w) {
    const double* qw = q + static_cast<size_t>(w) * natoms * 3;
    std::vector<double> dlng(3 * natoms), d2lng(3 * natoms);
    for (int i = 0; i < 3 * natoms; ++i) {
      dlng[i] = -2.0 * a * qw[i];
      d2lng[i] = -2.0 * a;
    }
    double vloc = 0.0;
    for (int n = 0; n < npairs; ++n) {
      const int i = ipairs[2 * n], j = ipairs[2 * n + 1];
      double dv[3], r2 = 0.0;
      for (int d = 0; d < 3; ++d) {
        dv[d] = qw[3 * j + d] - qw[3 * i + d] + vpvec[3 * n + d];
        r2 += dv[d] * dv[d];
      }
      const double br2 = b * b / r2;
      const double br5 = br2 * br2 * std::sqrt(br2);
      const double br52 = br5 / r2;
      for (int d = 0; d < 3; ++d) {
        dlng[3 * i + d] -= 2.5 * br52 * dv[d];
        d2lng[3 * i + d] += 2.5 * br52 * (1.0 - 7.0 * dv[d] * dv[d] / r2);
      }
      vloc += hfdbhe_cpp(r2);
    }
    double tloc = 0.0;
    for (int i = 0; i < 3 * natoms; ++i)
      tloc += d2lng[i] + dlng[i] * dlng[i];
    t_out[w] = -0.5 * tloc / mass;
    v_out[w] = 0.5 * vloc;
  }
}

// Per-atom Metropolis VMC — the reference child.f:398 move structure:
// each sweep attempts one Gaussian displacement per atom in turn.
// Returns mean energy per atom [K] over post-equilibration sweeps;
// e_trace (nsweeps) written in place.
double qsats_vmc(double* q, int natoms, const int* ipairs,
                 const double* vpvec, int npairs, double a, double b,
                 double mass, int nsweeps, int nequil, double step,
                 uint64_t seed, double* e_trace) {
  const double k_per_atom = 3.1668513e-6;  // hartree/K (eloc.f:257)
  if (nsweeps <= 0) return 0.0;
  std::mt19937_64 rng(seed);
  std::normal_distribution<double> gauss(0.0, 1.0);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  std::vector<double> prop(3 * natoms);
  double lp = qsats_logpsi(q, natoms, ipairs, vpvec, npairs, a, b);
  double esum = 0.0;
  int count = 0;
  for (int s = 0; s < nsweeps; ++s) {
    for (int at = 0; at < natoms; ++at) {
      std::memcpy(prop.data(), q, sizeof(double) * 3 * natoms);
      for (int d = 0; d < 3; ++d)
        prop[3 * at + d] += step * gauss(rng);
      const double lp_new =
          qsats_logpsi(prop.data(), natoms, ipairs, vpvec, npairs, a, b);
      if (std::log(uni(rng)) < 2.0 * (lp_new - lp)) {
        std::memcpy(q, prop.data(), sizeof(double) * 3 * natoms);
        lp = lp_new;
      }
    }
    double t, v;
    qsats_eloc(q, 1, natoms, ipairs, vpvec, npairs, a, b, mass, &t, &v);
    const double e = (t + v) / (k_per_atom * natoms);
    e_trace[s] = e;
    if (s >= nequil) {
      esum += e;
      ++count;
    }
  }
  return count > 0 ? esum / count : e_trace[nsweeps - 1];
}

int engine_version() { return 2; }

}  // extern "C"
