// Liouvillian commutator on Hopper (sm_90a):
//
//     out = -i (Heff rho - rho Heff^dagger)
//
// the coherent part of the matrix-free Lindblad right-hand side, with the
// non-Hermitian effective Hamiltonian Heff = H - (i/2) sum_k c_k^dagger c_k.
// Replaces the Pallas kernel of the JAX package
// (pyqed_tpu/ops/pallas_kernels.py:364-418, _comm_kernel /
// liouvillian_commutator_pallas), which computes the same function on
// real/imaginary planes padded to multiples of 128, with Heff^dagger
// materialised by its wrapper. Here the operands stay interleaved complex
// and unpadded in device memory: ragged n is masked at the loads and the
// store, and Heff^dagger is read as the conjugate transpose of Heff.
//
// Bound: two complex n x n x n products, 16 n^3 real flops; at n = 1024
// that is 17.2 GFLOP against 48 MB of operands (Heff, rho, out), so the
// kernel is bound by operations at any n worth a launch: 0.26 ms at the
// 67 TFLOP/s of the FP64 tensor cores. The FP64 FMA pipe peaks at half
// that, which held the first (SIMT) version of this kernel to 2.8x the
// time of two cuBLAS ZGEMMs.
//
// complex128 design (FP64 tensor cores):
// - The products run on DMMA through mma.sync.m16n8k8.f64 (wgmma has no
//   f64 type). A complex product is four real ones: with r/i the real and
//   imaginary planes,
//     re += Hr.rr - Hi.ri - rr_I.Hr_J^T - ri_I.Hi_J^T
//     im += Hr.ri + Hi.rr + rr_I.Hi_J^T - ri_I.Hr_J^T
//   into one real and one imaginary accumulator fragment per warp tile
//   (the minus signs are negated B fragments, the -i is applied at the
//   store). No partial product is written to memory.
// - A block owns a 128 x 64 output tile (n = 1024 gives 128 blocks, 0.97
//   of a wave on 132 SMs): eight warps of 32 x 32 outputs, 64 accumulator
//   doubles a thread, one block an SM.
// - Its operands are staged k slice by k slice (8 deep, one mma) through
//   a ring of three stages in dynamic shared memory, filled with 8-byte
//   cp.async, so the loads of slice k + 2 overlap the products of slice
//   k. Staging splits the interleaved complex into real and imaginary
//   planes and pads their rows (12 and 68 doubles), so that every
//   fragment load is one 8-byte load without bank conflicts. The row
//   panels Heff[I, k], rho[I, k] and Heff[J, k] are k-contiguous, the
//   layout of the A and the .col B operands; rho[k, J], the B operand of
//   the first product, is staged as rows of k.
// - What holds it at ~45 TFLOP/s (cuBLAS ZGEMM: ~54-58): the register
//   file. 128 accumulator registers and 64 of A fragments leave ptxas 255
//   registers with a small spill, so the loads of the next fragments
//   cannot run far ahead of the products. m16n8k4, deeper swizzled
//   stages, one pass per A plane, 16-byte fragment loads, smaller block
//   and warp tiles, and the two products run one after the other with
//   deeper stages were each measured and were slower (PERF.md).
//
// complex64 keeps the FP32 FMA tile kernel: FP32 on the tensor cores
// means TF32, which would miss the 1e-5 parity gate (reduced precision is
// a separate, gated kernel name). 64 x 64 tiles, 16 x 16 threads with a
// 4 x 4 register tile of complex accumulators each, 8-deep k slices
// staged through registers into shared memory.
//
// No library GEMM is called.
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using pyqed::cp_async;
using pyqed::cp_async_commit;
using pyqed::cp_async_wait;
using pyqed::dmma;

// ------------------------------------------------------ complex128: DMMA

constexpr int kBM = 128;                // output rows per block
constexpr int kBN = 64;                 // output columns per block
constexpr int kBK = 8;                  // k slice per stage: one mma depth
constexpr int kStages = 3;              // depth of the cp.async ring
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kThreadsTC = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / kWarpsM / 16;   // m16 tiles per warp
constexpr int kNT = kBN / kWarpsN / 8;    // n8 tiles per warp
// padded row lengths (doubles), = 4 (mod 16): the 16 lanes of a
// half-warp, at rows g and columns t of a fragment, hit 16 bank pairs
constexpr int kRowLd = kBK + 4;
constexpr int kColLd = kBN + 4;
constexpr int kRowPlane = kBM * kRowLd;   // Heff[I, k] or rho[I, k], one part
constexpr int kJPlane = kBN * kRowLd;     // Heff[J, k], one part
constexpr int kKPlane = kBK * kColLd;     // rho[k, J], one part
// a stage: Hr_I Hi_I Rr_I Ri_I | Hr_J Hi_J | Rr_K Ri_K
constexpr int kOffJ = 4 * kRowPlane;
constexpr int kOffK = kOffJ + 2 * kJPlane;
constexpr int kStage = kOffK + 2 * kKPlane;
constexpr int kSmemBytes = static_cast<int>(sizeof(double)) * kStages * kStage;
static_assert(kSmemBytes <= 232448, "dynamic shared memory of one block");
static_assert(kBN * 2 * kBK % kThreadsTC == 0, "whole copies per thread");

// Start the copies of k slice kt into its stage of the ring: the 128-row
// panels of Heff and rho at rows i0, the 64-row panel of Heff at rows j0
// (16 doubles of a row each) and the 8 rows of rho at columns j0, split
// into real and imaginary planes; zeros outside the matrix. Consecutive
// threads take consecutive doubles.
__device__ __forceinline__ void stage_slice(double* smem, const double* H,
                                            const double* R, int n, int i0,
                                            int j0, int kt, int tid) {
  double* s = smem + (kt % kStages) * kStage;
  const int k0 = kt * kBK;
  const size_t N = static_cast<size_t>(n);
#pragma unroll
  for (int l = 0; l < kBM * 2 * kBK / kThreadsTC; ++l) {
    const int e = tid + l * kThreadsTC;
    const int r = e / (2 * kBK), kk = (e % (2 * kBK)) >> 1, part = e & 1;
    const bool ok = i0 + r < n && k0 + kk < n;
    const size_t off = ok ? ((i0 + r) * N + k0 + kk) * 2 + part : 0;
    const int d = part * kRowPlane + r * kRowLd + kk;
    cp_async<8>(s + d, H + off, ok);
    cp_async<8>(s + 2 * kRowPlane + d, R + off, ok);
  }
#pragma unroll
  for (int l = 0; l < kBN * 2 * kBK / kThreadsTC; ++l) {
    const int e = tid + l * kThreadsTC;
    const int r = e / (2 * kBK), kk = (e % (2 * kBK)) >> 1, part = e & 1;
    const bool ok = j0 + r < n && k0 + kk < n;
    const size_t off = ok ? ((j0 + r) * N + k0 + kk) * 2 + part : 0;
    cp_async<8>(s + kOffJ + part * kJPlane + r * kRowLd + kk, H + off, ok);
  }
#pragma unroll
  for (int l = 0; l < kBK * 2 * kBN / kThreadsTC; ++l) {
    const int e = tid + l * kThreadsTC;
    const int kk = e / (2 * kBN), c = (e % (2 * kBN)) >> 1, part = e & 1;
    const bool ok = k0 + kk < n && j0 + c < n;
    const size_t off = ok ? ((k0 + kk) * N + j0 + c) * 2 + part : 0;
    cp_async<8>(s + kOffK + part * kKPlane + kk * kColLd + c, R + off, ok);
  }
}

__global__ void __launch_bounds__(kThreadsTC, 1)
commutator_dmma_kernel(const double* __restrict__ H,
                       const double* __restrict__ R,
                       double2* __restrict__ out, int n) {
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;

  double re[kMT][kNT][4], im[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) re[mt][nt][q] = im[mt][nt][q] = 0.0;

  const int nk = (n + kBK - 1) / kBK;
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) stage_slice(smem, H, R, n, i0, j0, kt, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of slice kt
    __syncthreads();                // everyone's; slice kt - 1 is consumed
    if (kt + kStages - 1 < nk)
      stage_slice(smem, H, R, n, i0, j0, kt + kStages - 1, tid);
    cp_async_commit();

    const double* s = smem + (kt % kStages) * kStage;
    const double* hrJ = s + kOffJ;
    const double* hiJ = s + kOffJ + kJPlane;
    const double* rrK = s + kOffK;
    const double* riK = s + kOffK + kKPlane;
    // A fragments of the four row panels
    double ahr[kMT][4], ahi[kMT][4], arr[kMT][4], ari[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * (kBM / kWarpsM) + mt * 16 + g + 8 * (i & 1);
        const int o = row * kRowLd + t + 4 * (i >> 1);
        ahr[mt][i] = s[o];
        ahi[mt][i] = s[kRowPlane + o];
        arr[mt][i] = s[2 * kRowPlane + o];
        ari[mt][i] = s[3 * kRowPlane + o];
      }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int c = wn * (kBN / kWarpsN) + nt * 8 + g;
      // rho[k, c] (+re, +im, -im) and Heff[c, k] (-re, +im, -im)
      double br[2], bi[2], nbi[2], nhr[2], hi[2], nhi[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = t + 4 * i;
        br[i] = rrK[k * kColLd + c];
        bi[i] = riK[k * kColLd + c];
        nbi[i] = -bi[i];
        nhr[i] = -hrJ[c * kRowLd + k];
        hi[i] = hiJ[c * kRowLd + k];
        nhi[i] = -hi[i];
      }
      // four independent accumulators in turn
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        dmma(re[mt][nt], ahr[mt], br);
        dmma(im[mt][nt], ahr[mt], bi);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        dmma(re[mt][nt], ahi[mt], nbi);
        dmma(im[mt][nt], ahi[mt], br);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        dmma(re[mt][nt], arr[mt], nhr);
        dmma(im[mt][nt], arr[mt], hi);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        dmma(re[mt][nt], ari[mt], nhi);
        dmma(im[mt][nt], ari[mt], nhr);
      }
    }
  }
  cp_async_wait<0>();

  // out = -i (re + i im) = im - i re
  const size_t N = static_cast<size_t>(n);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + wm * (kBM / kWarpsM) + mt * 16 + g + 8 * (q >> 1);
        const int j = j0 + wn * (kBN / kWarpsN) + nt * 8 + 2 * t + (q & 1);
        if (i < n && j < n)
          out[i * N + j] = make_double2(im[mt][nt][q], -re[mt][nt][q]);
      }
}

int launch_c128(const void* H, const void* rho, void* out, int n,
                void* stream) {
  static pyqed::SmemAllowance allowance;
  const cudaError_t err = allowance.ensure(
      reinterpret_cast<const void*>(commutator_dmma_kernel), kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  commutator_dmma_kernel<<<grid, kThreadsTC, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(H), static_cast<const double*>(rho),
      static_cast<double2*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ complex64: FMA

constexpr int kTile = 64;                   // output tile side
constexpr int kSide = 16;                   // threads per tile side
constexpr int kPer = kTile / kSide;         // outputs per thread and side
constexpr int kDepth = 8;                   // k slice staged per pass
constexpr int kThreads = kSide * kSide;
constexpr int kLoads = kTile * kDepth / kThreads;   // panel loads/thread
static_assert(kTile * kDepth % kThreads == 0, "panel size");

// Fetch the slice k0 .. k0 + kDepth - 1 of the four panels of the tile at
// (i0, j0) into registers, zero outside the matrix. Row panels are read
// k-fastest (8 threads on 8 consecutive entries of a row), the column
// panel of rho row by row (64 threads on one row segment).
__device__ __forceinline__ void fetch_slice(
    const float2* __restrict__ H, const float2* __restrict__ R, int n,
    int i0, int j0, int k0, int tid, float2 (&p_hi)[kLoads],
    float2 (&p_ri)[kLoads], float2 (&p_hj)[kLoads],
    float2 (&p_rj)[kLoads]) {
  const size_t N = static_cast<size_t>(n);
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int e = tid + l * kThreads;
    const int m = e / kDepth, k = k0 + e % kDepth;
    const bool kin = k < n;
    p_hi[l] = (kin && i0 + m < n) ? H[(i0 + m) * N + k] : zero;
    p_ri[l] = (kin && i0 + m < n) ? R[(i0 + m) * N + k] : zero;
    float2 h = (kin && j0 + m < n) ? H[(j0 + m) * N + k] : zero;
    h.y = -h.y;
    p_hj[l] = h;
    const int kr = k0 + e / kTile, mr = j0 + e % kTile;
    p_rj[l] = (kr < n && mr < n) ? R[kr * N + mr] : zero;
  }
}

__global__ void __launch_bounds__(kThreads)
commutator_fma_kernel(const float2* __restrict__ H,
                      const float2* __restrict__ R,
                      float2* __restrict__ out, int n) {
  // row panels are stored k-major with one element of padding, so the
  // k-fastest global loads store without bank conflicts
  __shared__ float2 hi[kDepth][kTile + 1];   // Heff[i0 + m, k0 + kk]
  __shared__ float2 ri[kDepth][kTile + 1];   // rho[i0 + m, k0 + kk]
  __shared__ float2 hj[kDepth][kTile + 1];   // conj(Heff[j0 + m, k0 + kk])
  __shared__ float2 rj[kDepth][kTile];       // rho[k0 + kk, j0 + m]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const size_t N = static_cast<size_t>(n);
  // one slice of the four panels, in registers
  float2 p_hi[kLoads], p_ri[kLoads], p_hj[kLoads], p_rj[kLoads];
  fetch_slice(H, R, n, i0, j0, 0, tid, p_hi, p_ri, p_hj, p_rj);

  float2 acc[kPer][kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r)
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[r][c] = make_float2(0.f, 0.f);

  for (int k0 = 0; k0 < n; k0 += kDepth) {
    __syncthreads();              // the previous slice is consumed
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      const int m = e / kDepth, kk = e % kDepth;
      hi[kk][m] = p_hi[l];
      ri[kk][m] = p_ri[l];
      hj[kk][m] = p_hj[l];
      rj[e / kTile][e % kTile] = p_rj[l];
    }
    __syncthreads();
    if (k0 + kDepth < n)
      fetch_slice(H, R, n, i0, j0, k0 + kDepth, tid, p_hi, p_ri, p_hj, p_rj);

#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float2 a[kPer], b[kPer];
      // + Heff[i, k] rho[k, j]
#pragma unroll
      for (int r = 0; r < kPer; ++r) a[r] = hi[kk][ty + r * kSide];
#pragma unroll
      for (int c = 0; c < kPer; ++c) b[c] = rj[kk][tx + c * kSide];
#pragma unroll
      for (int r = 0; r < kPer; ++r)
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          acc[r][c].x = __fmaf_rn(a[r].x, b[c].x, acc[r][c].x);
          acc[r][c].x = __fmaf_rn(-a[r].y, b[c].y, acc[r][c].x);
          acc[r][c].y = __fmaf_rn(a[r].x, b[c].y, acc[r][c].y);
          acc[r][c].y = __fmaf_rn(a[r].y, b[c].x, acc[r][c].y);
        }
      // - rho[i, k] conj(Heff[j, k])
#pragma unroll
      for (int r = 0; r < kPer; ++r) a[r] = ri[kk][ty + r * kSide];
#pragma unroll
      for (int c = 0; c < kPer; ++c) b[c] = hj[kk][tx + c * kSide];
#pragma unroll
      for (int r = 0; r < kPer; ++r)
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          acc[r][c].x = __fmaf_rn(-a[r].x, b[c].x, acc[r][c].x);
          acc[r][c].x = __fmaf_rn(a[r].y, b[c].y, acc[r][c].x);
          acc[r][c].y = __fmaf_rn(-a[r].x, b[c].y, acc[r][c].y);
          acc[r][c].y = __fmaf_rn(-a[r].y, b[c].x, acc[r][c].y);
        }
    }
  }

  // out = -i (re + i im) = im - i re
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = i0 + ty + r * kSide;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = j0 + tx + c * kSide;
      if (j < n) out[i * N + j] = make_float2(acc[r][c].y, -acc[r][c].x);
    }
  }
}

int launch_c64(const void* H, const void* rho, void* out, int n,
               void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  commutator_fma_kernel<<<dim3(tiles, tiles), dim3(kSide, kSide), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(H), static_cast<const float2*>(rho),
      static_cast<float2*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Heff, rho and out are device
// pointers to contiguous row-major n x n interleaved complex matrices.
// Returns the cudaError_t of the set-up and the launch (0: launched).
extern "C" int liouvillian_commutator_c128(const void* Heff, const void* rho,
                                           void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_c128(Heff, rho, out, n, stream);
}

extern "C" int liouvillian_commutator_c64(const void* Heff, const void* rho,
                                          void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_c64(Heff, rho, out, n, stream);
}
