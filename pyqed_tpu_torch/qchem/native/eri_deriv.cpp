// Derivative two-electron integrals d(ij|kl)/d(center_i)_x, derivative on
// the FIRST index: out is (3, nbf, nbf, nbf, nbf) C-contiguous float64, the
// tensor of eri_engine.cpp's eri_deriv_native, by the same McMurchie-
// Davidson recursions arranged for fewer Hermite Coulomb tables.
//
// eri_deriv_native builds one R table for every ordered bra pair (i, j),
// every axis and every unique ket pair (k >= l): 3 n^2 n(n+1)/2 tables of
// contracted quartets. Here each unique quartet (ij >= kl of the pairs
// i >= j, k >= l) builds one R table per primitive quartet, and two
// half-contracted boxes of it,
//   G[t][u][w] = sum_{t',u',w'} (-1)^(t'+u'+w') Ek_t' Ek_u' Ek_w'
//                R_{t+t', u+u', w+w'}        (the ket's plain E),
//   H[t][u][w] = sum_{t',u',w'} Eb_t' Eb_u' Eb_w' R_{t+t', u+u', w+w'}
//                                            (the bra's plain E),
// give all twelve derivatives, on the four centres along x, y, z: those
// on i and j from G, on k and l from H (with the ket's signs), each a short
// sum against the pair's differentiated Hermite coefficients
//   dA_t = 2a E_t^{l1+1, l2} - l1 E_t^{l1-1, l2},
//   dB_t = 2b E_t^{l1, l2+1} - l2 E_t^{l1, l2-1}.
// The derivative on a centre of the quartet is the first-index derivative
// of the permuted quartet that puts that function first, so the sixteen
// positions per axis that the quartet owns are filled from it. R, G and H
// live in per-thread buffers (no allocation per quartet).
//
// Build (done automatically by qchem/engine.py, into pyqed_tpu_torch/build/):
//   g++ -O3 -fopenmp -shared -fPIC eri_deriv.cpp -o liberi_deriv-<hash>.so
// Basis layout: as eri_engine.cpp's.

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double PI = 3.14159265358979323846;

// Boys function F_0..F_nmax (eri_engine.cpp's boys_all).
void boys_all(int nmax, double T, double* F) {
  if (T < 35.0) {
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

// Hermite expansion coefficients E_t^{ij} of one direction, E[i][j][t]
// (eri_engine.cpp's ETable and build_E).
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

// Hermite Coulomb integrals R^n_{t,u,w}, t+u+w <= L-n, in a caller's
// buffer of (L+1)^4 entries [n][t][u][w] (eri_engine.cpp's build_R; only
// the entries the recursion reads are written).
void build_R(double* R, double* F, int L, double p, double X, double Y,
             double Z) {
  const int S = L + 1;
  auto at = [R, S](int n, int t, int u, int w) -> double& {
    return R[((n * S + t) * S + u) * S + w];
  };
  boys_all(L, p * (X * X + Y * Y + Z * Z), F);
  double pw = 1.0;
  for (int n = 0; n <= L; ++n) {
    at(n, 0, 0, 0) = pw * F[n];
    pw *= -2.0 * p;
  }
  for (int total = 1; total <= L; ++total)
    for (int n = 0; n <= L - total; ++n)
      for (int t = 0; t <= total; ++t)
        for (int u = 0; u <= total - t; ++u) {
          const int w = total - t - u;
          double val;
          if (t > 0) {
            val = X * at(n + 1, t - 1, u, w);
            if (t > 1) val += (t - 1) * at(n + 1, t - 2, u, w);
          } else if (u > 0) {
            val = Y * at(n + 1, t, u - 1, w);
            if (u > 1) val += (u - 1) * at(n + 1, t, u - 2, w);
          } else {
            val = Z * at(n + 1, t, u, w - 1);
            if (w > 1) val += (w - 1) * at(n + 1, t, u, w - 2);
          }
          at(n, t, u, w) = val;
        }
}

struct BF {
  const double* center;
  const int32_t* lmn;
  const double* exps;
  const double* cn;
  int nprim;
};

// One primitive pair of a contracted pair (i, j): product centre, total
// exponent, weight and, per direction d, E_t^{l1 l2} (lb[d] + 1 entries)
// and the differentiated dA_t, dB_t (lb[d] + 2 entries).
struct Prim {
  double p, P[3], w;
  std::vector<double> E[3], dA[3], dB[3];
};

struct Pair {
  int lb[3];          // l1 + l2 per direction
  std::vector<Prim> prims;
};

Pair make_pair(const BF& gi, const BF& gj) {
  Pair out;
  for (int d = 0; d < 3; ++d) out.lb[d] = gi.lmn[d] + gj.lmn[d];
  out.prims.reserve(gi.nprim * gj.nprim);
  for (int pa = 0; pa < gi.nprim; ++pa)
    for (int pb = 0; pb < gj.nprim; ++pb) {
      const double a = gi.exps[pa], b = gj.exps[pb];
      Prim pp;
      pp.p = a + b;
      for (int d = 0; d < 3; ++d)
        pp.P[d] = (a * gi.center[d] + b * gj.center[d]) / pp.p;
      pp.w = gi.cn[pa] * gj.cn[pb];
      for (int d = 0; d < 3; ++d) {
        const int l1 = gi.lmn[d], l2 = gj.lmn[d], lb = l1 + l2;
        ETable E(l1 + 1, l2 + 1);
        build_E(E, gi.center[d] - gj.center[d], a, b);
        pp.E[d].assign(lb + 1, 0.0);
        pp.dA[d].assign(lb + 2, 0.0);
        pp.dB[d].assign(lb + 2, 0.0);
        for (int t = 0; t <= lb; ++t) pp.E[d][t] = E.at(l1, l2, t);
        for (int t = 0; t <= lb + 1; ++t) {
          double va = 2.0 * a * E.at(l1 + 1, l2, t);
          if (l1 > 0 && t <= lb - 1) va -= l1 * E.at(l1 - 1, l2, t);
          double vb = 2.0 * b * E.at(l1, l2 + 1, t);
          if (l2 > 0 && t <= lb - 1) vb -= l2 * E.at(l1, l2 - 1, t);
          pp.dA[d][t] = va;
          pp.dB[d][t] = vb;
        }
      }
      out.prims.push_back(std::move(pp));
    }
  return out;
}

// sum_{t,u,w} X_t Y_u Z_w box[t][u][w] over nt x nu x nw of a box with
// rows of gy x gz, each X, Y, Z a differentiated or plain E vector
inline double contract3(const double* X, const double* Y, const double* Z,
                        int nt, int nu, int nw, const double* box, int gy,
                        int gz) {
  double s = 0.0;
  for (int t = 0; t < nt; ++t)
    for (int u = 0; u < nu; ++u) {
      const double f = X[t] * Y[u];
      if (f == 0.0) continue;
      const double* g = box + (t * gy + u) * gz;
      double r = 0.0;
      for (int w = 0; w < nw; ++w) r += Z[w] * g[w];
      s += f * r;
    }
  return s;
}

// One side's Hermite box contracted with the other side's plain E:
// out[t][u][w] = sum_{t',u',w'} sgn Eo_t' Eo_u' Eo_w' R_{t+t',u+u',w+w'}
// over the side's box extended by one in each direction (at most one index
// past its plain range), sgn = (-1)^(t'+u'+w') when the other side is the
// ket and 1 when it is the bra.
void half_contract(const double* R0, int S, const int lb[3], const Prim& O,
                   const int lo[3], bool other_is_ket, double* out) {
  const int gy = lb[1] + 2, gz = lb[2] + 2;
  for (int t = 0; t < lb[0] + 2; ++t)
    for (int u = 0; u < gy; ++u)
      for (int w = 0; w < gz; ++w) {
        if ((t > lb[0]) + (u > lb[1]) + (w > lb[2]) > 1) continue;
        double s = 0.0;
        for (int a = 0; a <= lo[0]; ++a) {
          const double ex = O.E[0][a];
          if (ex == 0.0) continue;
          for (int b = 0; b <= lo[1]; ++b) {
            const double exy = ex * O.E[1][b];
            if (exy == 0.0) continue;
            const double* row = R0 + ((t + a) * S + (u + b)) * S + w;
            if (other_is_ket) {
              for (int c = 0; c <= lo[2]; ++c) {
                const double sgn = ((a + b + c) & 1) ? -1.0 : 1.0;
                s += sgn * exy * O.E[2][c] * row[c];
              }
            } else {
              for (int c = 0; c <= lo[2]; ++c) s += exy * O.E[2][c] * row[c];
            }
          }
        }
        out[(t * gy + u) * gz + w] = s;
      }
}

// The twelve contracted derivatives of (ij|kl) on the four centres, along
// x, y, z: v[0] = (d_A i, j|kl), v[1] = (i, d_B j|kl), v[2] = (ij|d_C k, l),
// v[3] = (ij|k, d_D l). R, F, G, H are per-thread scratch buffers.
void deriv_quartet(const Pair& bra, const Pair& ket, std::vector<double>& R,
                   std::vector<double>& F, std::vector<double>& G,
                   std::vector<double>& H, double v[4][3]) {
  const int* lb = bra.lb;
  const int* lk = ket.lb;
  const int L = lb[0] + lb[1] + lb[2] + lk[0] + lk[1] + lk[2] + 1;
  const int S = L + 1;
  if (R.size() < size_t(S) * S * S * S) R.resize(size_t(S) * S * S * S);
  if (F.size() < size_t(S)) F.resize(S);
  const size_t gsize = size_t(lb[0] + 2) * (lb[1] + 2) * (lb[2] + 2);
  const size_t hsize = size_t(lk[0] + 2) * (lk[1] + 2) * (lk[2] + 2);
  if (G.size() < gsize) G.resize(gsize);
  if (H.size() < hsize) H.resize(hsize);
  const double c = 2.0 * std::pow(PI, 2.5);
  for (int q = 0; q < 4; ++q)
    for (int d = 0; d < 3; ++d) v[q][d] = 0.0;
  for (const Prim& B : bra.prims)
    for (const Prim& K : ket.prims) {
      const double ps = B.p + K.p, alpha = B.p * K.p / ps;
      build_R(R.data(), F.data(), L, alpha, B.P[0] - K.P[0],
              B.P[1] - K.P[1], B.P[2] - K.P[2]);
      half_contract(R.data(), S, lb, K, lk, true, G.data());
      half_contract(R.data(), S, lk, B, lb, false, H.data());
      const double pref = B.w * K.w * c / (B.p * K.p * std::sqrt(ps));
      // the ket's signs (-1)^(t'+u'+w') applied to its E vectors in H
      double sk[3][16], skA[3][16], skB[3][16];
      for (int d = 0; d < 3; ++d)
        for (int t = 0; t <= lk[d] + 1; ++t) {
          const double sg = (t & 1) ? -1.0 : 1.0;
          sk[d][t] = t <= lk[d] ? sg * K.E[d][t] : 0.0;
          skA[d][t] = sg * K.dA[d][t];
          skB[d][t] = sg * K.dB[d][t];
        }
      for (int d = 0; d < 3; ++d) {
        const int nb[3] = {lb[0] + 1 + (d == 0), lb[1] + 1 + (d == 1),
                           lb[2] + 1 + (d == 2)};
        const int nk[3] = {lk[0] + 1 + (d == 0), lk[1] + 1 + (d == 1),
                           lk[2] + 1 + (d == 2)};
        const double* bA[3];
        const double* bB[3];
        const double* kA[3];
        const double* kB[3];
        for (int e = 0; e < 3; ++e) {
          bA[e] = (e == d ? B.dA[e] : B.E[e]).data();
          bB[e] = (e == d ? B.dB[e] : B.E[e]).data();
          kA[e] = e == d ? skA[e] : sk[e];
          kB[e] = e == d ? skB[e] : sk[e];
        }
        const int gy = lb[1] + 2, gz = lb[2] + 2;
        const int hy = lk[1] + 2, hz = lk[2] + 2;
        v[0][d] += pref * contract3(bA[0], bA[1], bA[2], nb[0], nb[1],
                                    nb[2], G.data(), gy, gz);
        v[1][d] += pref * contract3(bB[0], bB[1], bB[2], nb[0], nb[1],
                                    nb[2], G.data(), gy, gz);
        v[2][d] += pref * contract3(kA[0], kA[1], kA[2], nk[0], nk[1],
                                    nk[2], H.data(), hy, hz);
        v[3][d] += pref * contract3(kB[0], kB[1], kB[2], nk[0], nk[1],
                                    nk[2], H.data(), hy, hz);
      }
    }
}

}  // namespace

extern "C" {

void eri_deriv_pairs_native(const double* centers, const int32_t* lmn,
                            const int32_t* prim_off, const double* exps,
                            const double* cn, int nbf, double* out) {
  std::vector<BF> bfs(nbf);
  for (int i = 0; i < nbf; ++i)
    bfs[i] = BF{centers + 3 * i, lmn + 3 * i, exps + prim_off[i],
                cn + prim_off[i], prim_off[i + 1] - prim_off[i]};
  const int64_t npair = int64_t(nbf) * (nbf + 1) / 2;
  std::vector<std::pair<int, int>> pairs;
  pairs.reserve(npair);
  for (int i = 0; i < nbf; ++i)
    for (int j = 0; j <= i; ++j) pairs.push_back({i, j});
  std::vector<Pair> data(npair);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int64_t ij = 0; ij < npair; ++ij)
    data[ij] = make_pair(bfs[pairs[ij].first], bfs[pairs[ij].second]);
  const int64_t N = nbf, N4 = N * N * N * N;
  // each unique quartet (ij >= kl) writes its sixteen positions per axis;
  // every element of out belongs to exactly one quartet
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<double> R, F, G, H;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
    for (int64_t ij = 0; ij < npair; ++ij) {
      const int64_t i = pairs[ij].first, j = pairs[ij].second;
      for (int64_t kl = 0; kl <= ij; ++kl) {
        const int64_t k = pairs[kl].first, l = pairs[kl].second;
        double v[4][3];
        deriv_quartet(data[ij], data[kl], R, F, G, H, v);
        for (int d = 0; d < 3; ++d) {
          double* o = out + d * N4;
          o[((i * N + j) * N + k) * N + l] = v[0][d];
          o[((i * N + j) * N + l) * N + k] = v[0][d];
          o[((j * N + i) * N + k) * N + l] = v[1][d];
          o[((j * N + i) * N + l) * N + k] = v[1][d];
          o[((k * N + l) * N + i) * N + j] = v[2][d];
          o[((k * N + l) * N + j) * N + i] = v[2][d];
          o[((l * N + k) * N + i) * N + j] = v[3][d];
          o[((l * N + k) * N + j) * N + i] = v[3][d];
        }
      }
    }
  }
}

}  // extern "C"
