// Native two-electron-integral engine: McMurchie-Davidson ERIs over
// contracted Cartesian Gaussians of arbitrary angular momentum.
//
// A copy of pyqed_tpu/qchem/native/eri_engine.cpp whose code is unchanged
// (only this header comment differs), so both packages build the same
// tensors. Same recursions as the Python path of qchem/basis.py
// (``_eri_prim``, ``E_md``) — this engine exists for speed: C++/OpenMP over
// shell quartets with 8-fold permutational symmetry.
//
// Build (done automatically by qchem/engine.py, into pyqed_tpu_torch/build/):
//   g++ -O3 -fopenmp -shared -fPIC eri_engine.cpp -o liberi_engine-<hash>.so
//
// Basis layout (flattened contracted functions):
//   center (nbf, 3), lmn (nbf, 3) int32, prim_off (nbf+1) int32,
//   exps (nprim_tot), cn (nprim_tot)  [contraction coeff x prim norm]

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double PI = 3.14159265358979323846;

// Boys function F_0..F_nmax by downward recursion; the top order comes
// from the series (small T) or the asymptotic form (large T).
void boys_all(int nmax, double T, double* F) {
  if (T < 35.0) {
    // series for F_nmax: sum_k (2T)^k (2nmax-1)!! / (2nmax+2k+1)!! e^-T
    const double eT = std::exp(-T);
    double term = 1.0 / (2.0 * nmax + 1.0);
    double sum = term;
    for (int k = 1; k < 200; ++k) {
      term *= 2.0 * T / (2.0 * nmax + 2.0 * k + 1.0);
      sum += term;
      if (term < 1e-17 * sum) break;
    }
    F[nmax] = sum * eT;
    for (int n = nmax; n > 0; --n)
      F[n - 1] = (2.0 * T * F[n] + eT) / (2.0 * n - 1.0);
  } else {
    F[0] = 0.5 * std::sqrt(PI / T);
    const double eT = std::exp(-T);
    for (int n = 1; n <= nmax; ++n)
      F[n] = ((2.0 * n - 1.0) * F[n - 1] - eT) / (2.0 * T);
  }
}

// Hermite expansion coefficients E_t^{ij} for one Cartesian direction
// (same recursion as pyqed_tpu/qchem/basis.py::E_md). Table layout:
// E[i][j][t].
struct ETable {
  int imax, jmax;
  std::vector<double> v;
  ETable(int i, int j) : imax(i), jmax(j),
      v((i + 1) * (j + 1) * (i + j + 1), 0.0) {}
  inline double& at(int i, int j, int t) {
    return v[(i * (jmax + 1) + j) * (imax + jmax + 1) + t];
  }
};

void build_E(ETable& E, double Qx, double a, double b) {
  const double p = a + b, q = a * b / p;
  E.at(0, 0, 0) = std::exp(-q * Qx * Qx);
  for (int i = 1; i <= E.imax; ++i)
    for (int t = 0; t <= i; ++t) {
      double val = 0.0;
      if (t > 0) val += E.at(i - 1, 0, t - 1) / (2.0 * p);
      val += -q * Qx / a * E.at(i - 1, 0, t);
      if (t + 1 <= i - 1) val += (t + 1) * E.at(i - 1, 0, t + 1);
      E.at(i, 0, t) = val;
    }
  for (int j = 1; j <= E.jmax; ++j)
    for (int i = 0; i <= E.imax; ++i)
      for (int t = 0; t <= i + j; ++t) {
        double val = 0.0;
        if (t > 0) val += E.at(i, j - 1, t - 1) / (2.0 * p);
        val += q * Qx / b * E.at(i, j - 1, t);
        if (t + 1 <= i + j - 1) val += (t + 1) * E.at(i, j - 1, t + 1);
        E.at(i, j, t) = val;
      }
}

// Hermite Coulomb integrals R_{t,u,v} built bottom-up from Boys values.
struct RTable {
  int L;
  std::vector<double> v;   // layout [n][t][u][w] with t+u+w <= L-n kept dense
  RTable(int Lmax) : L(Lmax),
      v((Lmax + 1) * (Lmax + 1) * (Lmax + 1) * (Lmax + 1), 0.0) {}
  inline double& at(int n, int t, int u, int w) {
    return v[((n * (L + 1) + t) * (L + 1) + u) * (L + 1) + w];
  }
};

void build_R(RTable& R, int L, double p, double X, double Y, double Z) {
  const double T = p * (X * X + Y * Y + Z * Z);
  std::vector<double> F(L + 1);
  boys_all(L, T, F.data());
  double pw = 1.0;
  for (int n = 0; n <= L; ++n) {
    R.at(n, 0, 0, 0) = pw * F[n];
    pw *= -2.0 * p;
  }
  for (int total = 1; total <= L; ++total)
    for (int n = 0; n <= L - total; ++n)
      for (int t = 0; t <= total; ++t)
        for (int u = 0; u <= total - t; ++u) {
          int w = total - t - u;
          double val;
          if (t > 0) {
            val = X * R.at(n + 1, t - 1, u, w);
            if (t > 1) val += (t - 1) * R.at(n + 1, t - 2, u, w);
          } else if (u > 0) {
            val = Y * R.at(n + 1, t, u - 1, w);
            if (u > 1) val += (u - 1) * R.at(n + 1, t, u - 2, w);
          } else {
            val = Z * R.at(n + 1, t, u, w - 1);
            if (w > 1) val += (w - 1) * R.at(n + 1, t, u, w - 2);
          }
          R.at(n, t, u, w) = val;
        }
}

struct BF {
  const double* center;
  const int32_t* lmn;
  const double* exps;
  const double* cn;
  int nprim;
  int L() const { return lmn[0] + lmn[1] + lmn[2]; }
};

// Precomputed data for one primitive pair of a basis-function pair:
// Gaussian-product center, total exponent, weight, and the three
// direction E-coefficient vectors E_t^{l_i l_j} (only the top (i,j)
// row is ever contracted).
struct PrimPair {
  double p;        // a + b
  double P[3];     // product center
  double w;        // c_i n_i c_j n_j
  std::vector<double> Ex, Ey, Ez;   // lengths l1+l2+1, m1+m2+1, n1+n2+1
};

std::vector<PrimPair> make_pair(const BF& gi, const BF& gj) {
  const int l1 = gi.lmn[0], m1 = gi.lmn[1], n1 = gi.lmn[2];
  const int l2 = gj.lmn[0], m2 = gj.lmn[1], n2 = gj.lmn[2];
  std::vector<PrimPair> out;
  out.reserve(gi.nprim * gj.nprim);
  for (int pa = 0; pa < gi.nprim; ++pa)
    for (int pb = 0; pb < gj.nprim; ++pb) {
      const double a = gi.exps[pa], b = gj.exps[pb];
      PrimPair pp;
      pp.p = a + b;
      for (int d = 0; d < 3; ++d)
        pp.P[d] = (a * gi.center[d] + b * gj.center[d]) / pp.p;
      pp.w = gi.cn[pa] * gj.cn[pb];
      ETable E1(l1, l2), E2(m1, m2), E3(n1, n2);
      build_E(E1, gi.center[0] - gj.center[0], a, b);
      build_E(E2, gi.center[1] - gj.center[1], a, b);
      build_E(E3, gi.center[2] - gj.center[2], a, b);
      pp.Ex.resize(l1 + l2 + 1);
      pp.Ey.resize(m1 + m2 + 1);
      pp.Ez.resize(n1 + n2 + 1);
      for (int t = 0; t <= l1 + l2; ++t) pp.Ex[t] = E1.at(l1, l2, t);
      for (int t = 0; t <= m1 + m2; ++t) pp.Ey[t] = E2.at(m1, m2, t);
      for (int t = 0; t <= n1 + n2; ++t) pp.Ez[t] = E3.at(n1, n2, t);
      out.push_back(std::move(pp));
    }
  return out;
}

// contracted (ij|kl) from precomputed pair data
double eri_pairs(const std::vector<PrimPair>& bra,
                 const std::vector<PrimPair>& ket, int Ltot) {
  double total = 0.0;
  for (const auto& B : bra) {
    const int nt = int(B.Ex.size()), nu = int(B.Ey.size()),
              nw = int(B.Ez.size());
    for (const auto& K : ket) {
      const int mt = int(K.Ex.size()), mu = int(K.Ey.size()),
                mw = int(K.Ez.size());
      const double alpha = B.p * K.p / (B.p + K.p);
      RTable R(Ltot);
      build_R(R, Ltot, alpha, B.P[0] - K.P[0], B.P[1] - K.P[1],
              B.P[2] - K.P[2]);
      double val = 0.0;
      for (int t = 0; t < nt; ++t) {
        if (B.Ex[t] == 0.0) continue;
        for (int u = 0; u < nu; ++u) {
          if (B.Ey[u] == 0.0) continue;
          for (int w = 0; w < nw; ++w) {
            if (B.Ez[w] == 0.0) continue;
            double inner = 0.0;
            for (int tau = 0; tau < mt; ++tau) {
              if (K.Ex[tau] == 0.0) continue;
              for (int vv = 0; vv < mu; ++vv) {
                if (K.Ey[vv] == 0.0) continue;
                for (int ph = 0; ph < mw; ++ph) {
                  if (K.Ez[ph] == 0.0) continue;
                  const double sgn = ((tau + vv + ph) & 1) ? -1.0 : 1.0;
                  inner += K.Ex[tau] * K.Ey[vv] * K.Ez[ph] * sgn *
                           R.at(0, t + tau, u + vv, w + ph);
                }
              }
            }
            val += B.Ex[t] * B.Ey[u] * B.Ez[w] * inner;
          }
        }
      }
      total += B.w * K.w * val * 2.0 * std::pow(PI, 2.5) /
               (B.p * K.p * std::sqrt(B.p + K.p));
    }
  }
  return total;
}

// Bra pair with the FIRST function differentiated w.r.t. its center
// along `axis`: per primitive, the Hermite E vector of that direction
// becomes D_t = 2a E_t^{l1+1, l2} - l1 E_t^{l1-1, l2} (length +1).
std::vector<PrimPair> make_pair_dbra(const BF& gi, const BF& gj, int axis) {
  const int l1v[3] = {gi.lmn[0], gi.lmn[1], gi.lmn[2]};
  const int l2v[3] = {gj.lmn[0], gj.lmn[1], gj.lmn[2]};
  std::vector<PrimPair> out;
  out.reserve(gi.nprim * gj.nprim);
  for (int pa = 0; pa < gi.nprim; ++pa)
    for (int pb = 0; pb < gj.nprim; ++pb) {
      const double a = gi.exps[pa], b = gj.exps[pb];
      PrimPair pp;
      pp.p = a + b;
      for (int d = 0; d < 3; ++d)
        pp.P[d] = (a * gi.center[d] + b * gj.center[d]) / pp.p;
      pp.w = gi.cn[pa] * gj.cn[pb];
      std::vector<double>* dest[3] = {&pp.Ex, &pp.Ey, &pp.Ez};
      for (int d = 0; d < 3; ++d) {
        const int l1 = l1v[d], l2 = l2v[d];
        const double Q = gi.center[d] - gj.center[d];
        if (d == axis) {
          ETable E(l1 + 1, l2);
          build_E(E, Q, a, b);
          dest[d]->assign(l1 + l2 + 2, 0.0);
          for (int t = 0; t <= l1 + 1 + l2; ++t) {
            double v = 2.0 * a * E.at(l1 + 1, l2, t);
            if (l1 > 0 && t <= l1 - 1 + l2) v -= l1 * E.at(l1 - 1, l2, t);
            (*dest[d])[t] = v;
          }
        } else {
          ETable E(l1, l2);
          build_E(E, Q, a, b);
          dest[d]->assign(l1 + l2 + 1, 0.0);
          for (int t = 0; t <= l1 + l2; ++t) (*dest[d])[t] = E.at(l1, l2, t);
        }
      }
      out.push_back(std::move(pp));
    }
  return out;
}

}  // namespace

extern "C" {

// Derivative ERI tensor d(ij|kl)/d(center_i)_x on the FIRST index only:
// out is (3, nbf, nbf, nbf, nbf) C-contiguous float64. Remaining
// symmetry (kl <-> lk) exploited; assembly into atomic gradients
// happens in Python (qchem/grad.py::rhf_gradient).
void eri_deriv_native(const double* centers, const int32_t* lmn,
                      const int32_t* prim_off, const double* exps,
                      const double* cn, int nbf, double* out) {
  std::vector<BF> bfs(nbf);
  for (int i = 0; i < nbf; ++i)
    bfs[i] = BF{centers + 3 * i, lmn + 3 * i, exps + prim_off[i],
                cn + prim_off[i], prim_off[i + 1] - prim_off[i]};
  const int64_t npair = int64_t(nbf) * (nbf + 1) / 2;
  std::vector<std::pair<int, int>> pairs;
  pairs.reserve(npair);
  for (int k = 0; k < nbf; ++k)
    for (int l = 0; l <= k; ++l) pairs.push_back({k, l});
  std::vector<std::vector<PrimPair>> ket_data(npair);
  std::vector<int> ket_L(npair);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int64_t kl = 0; kl < npair; ++kl) {
    ket_data[kl] = make_pair(bfs[pairs[kl].first], bfs[pairs[kl].second]);
    ket_L[kl] = bfs[pairs[kl].first].L() + bfs[pairs[kl].second].L();
  }
  const int64_t N = nbf, N4 = N * N * N * N;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 2) collapse(2)
#endif
  for (int64_t ij = 0; ij < N * N; ++ij)
    for (int axis = 0; axis < 3; ++axis) {
      const int i = int(ij / N), j = int(ij % N);
      const auto bra = make_pair_dbra(bfs[i], bfs[j], axis);
      const int Lb = bfs[i].L() + 1 + bfs[j].L();
      double* o = out + axis * N4;
      for (int64_t kl = 0; kl < npair; ++kl) {
        const int k = pairs[kl].first, l = pairs[kl].second;
        const double v = eri_pairs(bra, ket_data[kl], Lb + ket_L[kl]);
        o[((i * N + j) * N + k) * N + l] = v;
        o[((i * N + j) * N + l) * N + k] = v;
      }
    }
}

// Full (nbf^4) ERI tensor with 8-fold symmetry; out is C-contiguous
// (nbf, nbf, nbf, nbf) float64.
void eri_tensor_native(const double* centers, const int32_t* lmn,
                       const int32_t* prim_off, const double* exps,
                       const double* cn, int nbf, double* out) {
  std::vector<BF> bfs(nbf);
  for (int i = 0; i < nbf; ++i) {
    bfs[i] = BF{centers + 3 * i, lmn + 3 * i, exps + prim_off[i],
                cn + prim_off[i], prim_off[i + 1] - prim_off[i]};
  }
  // unique quartets (i>=j, k>=l, ij>=kl); precompute per-pair Hermite
  // E coefficients once (they depend only on the bra or ket pair)
  const int64_t npair = int64_t(nbf) * (nbf + 1) / 2;
  std::vector<std::pair<int, int>> pairs;
  pairs.reserve(npair);
  for (int i = 0; i < nbf; ++i)
    for (int j = 0; j <= i; ++j) pairs.push_back({i, j});
  std::vector<std::vector<PrimPair>> pair_data(npair);
  std::vector<int> pair_L(npair);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int64_t ij = 0; ij < npair; ++ij) {
    pair_data[ij] = make_pair(bfs[pairs[ij].first], bfs[pairs[ij].second]);
    pair_L[ij] = bfs[pairs[ij].first].L() + bfs[pairs[ij].second].L();
  }

  const int64_t N = nbf;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4)
#endif
  for (int64_t ij = 0; ij < npair; ++ij) {
    const int i = pairs[ij].first, j = pairs[ij].second;
    for (int64_t kl = 0; kl <= ij; ++kl) {
      const int k = pairs[kl].first, l = pairs[kl].second;
      const double v = eri_pairs(pair_data[ij], pair_data[kl],
                                 pair_L[ij] + pair_L[kl]);
      const int64_t idx[8][4] = {
          {i, j, k, l}, {j, i, k, l}, {i, j, l, k}, {j, i, l, k},
          {k, l, i, j}, {l, k, i, j}, {k, l, j, i}, {l, k, j, i}};
      for (auto& q : idx)
        out[((q[0] * N + q[1]) * N + q[2]) * N + q[3]] = v;
    }
  }
}

int eri_engine_version() { return 2; }

}  // extern "C"
