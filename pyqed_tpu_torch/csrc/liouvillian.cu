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
// and unpadded: ragged n is masked at the loads and the store, and
// Heff^dagger is read as the conjugate transpose of Heff inside the kernel.
//
// Bound: two complex n x n x n products, 16 n^3 real flops; at n = 1024
// that is 17.2 GFLOP against 48 MB of operands (Heff, rho, out), so the
// kernel is compute-bound at any n worth a launch (0.26 ms at the 67
// TFLOP/s FP64 tensor-core rate; this kernel uses FP64 FMA, 34 TFLOP/s).
//
// Design (simple SIMT tile kernel; wgmma, TMA and DMMA are left for a
// later redesign): one block of 16 x 16 threads per 64 x 64 output tile,
// each thread a 4 x 4 register tile of complex accumulators (outputs
// strided by 16, so the shared-memory reads of a warp are broadcasts or
// contiguous). The k loop stages, per 8-deep slice, the four panels the
// tile needs in shared memory: Heff[I, k], rho[k, J], rho[I, k] and
// conj(Heff[J, k]); the next slice is fetched into registers while the
// current one is multiplied. Both products accumulate into one
// accumulator (FP64 for complex128, FP32 for complex64), and the -i is
// applied once at the store. No library GEMM is called.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                   // output tile side
constexpr int kSide = 16;                   // threads per tile side
constexpr int kPer = kTile / kSide;         // outputs per thread and side
constexpr int kDepth = 8;                   // k slice staged per pass
constexpr int kThreads = kSide * kSide;
constexpr int kLoads = kTile * kDepth / kThreads;   // panel loads/thread
static_assert(kTile * kDepth % kThreads == 0, "panel size");

template <typename T> struct Complex;
template <> struct Complex<double> {
  using type = double2;
  static __device__ __forceinline__ double2 make(double x, double y) {
    return make_double2(x, y);
  }
};
template <> struct Complex<float> {
  using type = float2;
  static __device__ __forceinline__ float2 make(float x, float y) {
    return make_float2(x, y);
  }
};

__device__ __forceinline__ double mad(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mad(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// Fetch the slice k0 .. k0 + kDepth - 1 of the four panels of the tile at
// (i0, j0) into registers, zero outside the matrix. Row panels are read
// k-fastest (8 threads on 8 consecutive entries of a row), the column
// panel of rho row by row (64 threads on one row segment).
template <typename T>
__device__ __forceinline__ void fetch_slice(
    const typename Complex<T>::type* __restrict__ H,
    const typename Complex<T>::type* __restrict__ R, int n, int i0, int j0,
    int k0, int tid, typename Complex<T>::type (&p_hi)[kLoads],
    typename Complex<T>::type (&p_ri)[kLoads],
    typename Complex<T>::type (&p_hj)[kLoads],
    typename Complex<T>::type (&p_rj)[kLoads]) {
  using C = typename Complex<T>::type;
  const size_t N = static_cast<size_t>(n);
  const C zero = Complex<T>::make(0, 0);
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int e = tid + l * kThreads;
    const int m = e / kDepth, k = k0 + e % kDepth;
    const bool kin = k < n;
    p_hi[l] = (kin && i0 + m < n) ? H[(i0 + m) * N + k] : zero;
    p_ri[l] = (kin && i0 + m < n) ? R[(i0 + m) * N + k] : zero;
    C h = (kin && j0 + m < n) ? H[(j0 + m) * N + k] : zero;
    h.y = -h.y;
    p_hj[l] = h;
    const int kr = k0 + e / kTile, mr = j0 + e % kTile;
    p_rj[l] = (kr < n && mr < n) ? R[kr * N + mr] : zero;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
commutator_kernel(const typename Complex<T>::type* __restrict__ H,
                  const typename Complex<T>::type* __restrict__ R,
                  typename Complex<T>::type* __restrict__ out, int n) {
  using C = typename Complex<T>::type;
  // row panels are stored k-major with one element of padding, so the
  // k-fastest global loads store without bank conflicts
  __shared__ C hi[kDepth][kTile + 1];   // Heff[i0 + m, k0 + kk]
  __shared__ C ri[kDepth][kTile + 1];   // rho[i0 + m, k0 + kk]
  __shared__ C hj[kDepth][kTile + 1];   // conj(Heff[j0 + m, k0 + kk])
  __shared__ C rj[kDepth][kTile];       // rho[k0 + kk, j0 + m]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const size_t N = static_cast<size_t>(n);
  const C zero = Complex<T>::make(0, 0);
  // one slice of the four panels, in registers
  C p_hi[kLoads], p_ri[kLoads], p_hj[kLoads], p_rj[kLoads];
  fetch_slice<T>(H, R, n, i0, j0, 0, tid, p_hi, p_ri, p_hj, p_rj);

  C acc[kPer][kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r)
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[r][c] = zero;

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
      fetch_slice<T>(H, R, n, i0, j0, k0 + kDepth, tid, p_hi, p_ri, p_hj,
                     p_rj);

#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      C a[kPer], b[kPer];
      // + Heff[i, k] rho[k, j]
#pragma unroll
      for (int r = 0; r < kPer; ++r) a[r] = hi[kk][ty + r * kSide];
#pragma unroll
      for (int c = 0; c < kPer; ++c) b[c] = rj[kk][tx + c * kSide];
#pragma unroll
      for (int r = 0; r < kPer; ++r)
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          acc[r][c].x = mad(a[r].x, b[c].x, acc[r][c].x);
          acc[r][c].x = mad(-a[r].y, b[c].y, acc[r][c].x);
          acc[r][c].y = mad(a[r].x, b[c].y, acc[r][c].y);
          acc[r][c].y = mad(a[r].y, b[c].x, acc[r][c].y);
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
          acc[r][c].x = mad(-a[r].x, b[c].x, acc[r][c].x);
          acc[r][c].x = mad(a[r].y, b[c].y, acc[r][c].x);
          acc[r][c].y = mad(-a[r].x, b[c].y, acc[r][c].y);
          acc[r][c].y = mad(-a[r].y, b[c].x, acc[r][c].y);
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
      if (j < n)
        out[i * N + j] = Complex<T>::make(acc[r][c].y, -acc[r][c].x);
    }
  }
}

template <typename T>
int launch(const void* H, const void* rho, void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  using C = typename Complex<T>::type;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles);
  const dim3 block(kSide, kSide);
  commutator_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(H), static_cast<const C*>(rho),
      static_cast<C*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Heff, rho and out are device
// pointers to contiguous row-major n x n interleaved complex matrices.
// Returns cudaGetLastError() after the launch.
extern "C" int liouvillian_commutator_c128(const void* Heff, const void* rho,
                                           void* out, int n, void* stream) {
  return launch<double>(Heff, rho, out, n, stream);
}

extern "C" int liouvillian_commutator_c64(const void* Heff, const void* rho,
                                          void* out, int n, void* stream) {
  return launch<float>(Heff, rho, out, n, stream);
}
