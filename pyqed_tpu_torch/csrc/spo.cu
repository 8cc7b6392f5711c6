// Split-operator kernels on Hopper (sm_90a): the kinetic phase multiply
// and the per-grid-point potential matvec of one Strang step.
//
// Replace the two Pallas kernels of the JAX package:
//   spo_phase      <- _spo_phase_kernel / spo_phase_multiply
//                     (pyqed_tpu/ops/pallas_kernels.py:267-306)
//   spo_potential  <- _spo_pot_kernel / spo_potential_apply
//                     (pyqed_tpu/ops/pallas_kernels.py:309-357)
// Both compute, for every grid point p of an N-d grid and ns electronic
// states,
//   phase:      out[p, s] = expK[p] * psik[p, s]
//   potential:  out[p, a] = sum_b expV[p, a, b] * psi[p, b]
// in complex128 (double2) or complex64 (float2), interleaved, as PyTorch
// stores complex tensors.
//
// Bound: both are single elementwise passes with a handful of flops per
// 16-byte complex, so device memory bounds them. At the 256^3-point,
// ns = 2 complex128 step the phase multiply must move
// npts * (2 * ns * 16 + 16) = 1.34 GB (0.40 ms at the H100 SXM's
// 3.35 TB/s) and the potential apply npts * (ns^2 * 16 + 2 * ns * 16) =
// 2.15 GB (0.64 ms); their flops (6 and 8 * ns^2 per point and state)
// are two orders of magnitude below the card's FP64 rate.
//
// Design: one thread per grid point; each operand is read once and each
// output written once, with 16-byte (double2) loads and stores, and
// neighbouring threads on neighbouring grid points, so every load
// instruction of a warp is coalesced. The TPU version's workarounds are
// gone: no real/imag planes, no padding to a tile of 512 or 256 rows, and
// no per-call column-major transpose of expV, which is read in its native
// row-major (npts, ns, ns) layout (a thread reads its ns*ns block as
// consecutive 16-byte words). psi and out share one layout, given as a
// point stride sp and a state stride ss in elements: ss = 1, sp = ns for
// the state-last layout of the public API, and sp = 1, ss = npts for the
// state-major layout that cuFFT's batched transforms return, so the FFT
// output is used in place of a copy. ns is a template parameter for
// ns <= 4 (the state vector lives in registers); for larger ns a generic
// kernel gives each thread one row of one point's block and stages the
// block's contiguous stretch of expV in shared memory, or reads the row
// from device memory when even 32 rows exceed 48 KB (ns > 96 at
// complex128, ns > 192 at complex64), so any ns runs. out is a separate
// buffer, allocated by the caller; nothing is written in place. Vector
// loads wider than 16 bytes, persistent blocks and fusing the phase into
// the FFT round trip are left for later.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Complex;
template <> struct Complex<double> { using type = double2; };
template <> struct Complex<float> { using type = float2; };

template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  C r;
  r.x = a.x * b.x - a.y * b.y;
  r.y = a.x * b.y + a.y * b.x;
  return r;
}

template <typename C>
__device__ __forceinline__ void cfma(C& acc, C a, C b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spo_phase_kernel(const typename Complex<T>::type* __restrict__ expK,
                 const typename Complex<T>::type* __restrict__ psik,
                 typename Complex<T>::type* __restrict__ out,
                 long long npts, int ns, long long sp, long long ss) {
  using C = typename Complex<T>::type;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (p >= npts) return;
  const C e = expK[p];
  const long long base = p * sp;
  for (int s = 0; s < ns; ++s) {
    const long long i = base + s * ss;
    out[i] = cmul(e, psik[i]);
  }
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
spo_potential_kernel(const typename Complex<T>::type* __restrict__ expV,
                     const typename Complex<T>::type* __restrict__ psi,
                     typename Complex<T>::type* __restrict__ out,
                     long long npts, long long sp, long long ss) {
  using C = typename Complex<T>::type;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (p >= npts) return;
  const long long base = p * sp;
  C x[NS];
#pragma unroll
  for (int b = 0; b < NS; ++b) x[b] = psi[base + b * ss];
  const C* m = expV + p * (NS * NS);
#pragma unroll
  for (int a = 0; a < NS; ++a) {
    C acc;
    acc.x = 0;
    acc.y = 0;
#pragma unroll
    for (int b = 0; b < NS; ++b) cfma(acc, m[a * NS + b], x[b]);
    out[base + a * ss] = acc;
  }
}

// ns > 4: one thread per (grid point p, row a), out[p, a] = sum_b
// expV[p, a, b] psi[p, b]. Thread i = p * ns + a owns row i of expV seen
// as a matrix of rows (ns consecutive words at i * ns), so a block's rows
// are one contiguous stretch of expV. Staged: the block copies it into
// shared memory with coalesced loads (neighbouring threads, neighbouring
// words) and each thread then reads its row from there. Not staged (rows
// too long for 32 of them to fit): each thread walks its row in device
// memory, whose consecutive words share cache lines. The ns threads of a
// point read the same psi entries. (A thread per point would walk its
// 16 ns^2-byte block alone: 32 far-apart blocks per warp.)
template <typename T, bool Staged>
__global__ void spo_potential_kernel_rows(
    const typename Complex<T>::type* __restrict__ expV,
    const typename Complex<T>::type* __restrict__ psi,
    typename Complex<T>::type* __restrict__ out, long long npts, int ns,
    long long sp, long long ss) {
  using C = typename Complex<T>::type;
  const long long rows = npts * ns;
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long nrow = rows - row0 < blockDim.x ? rows - row0
                                                  : blockDim.x;
  const C* m = expV + (row0 + threadIdx.x) * ns;
  if (Staged) {
    extern __shared__ unsigned char tile_raw[];
    C* tile = reinterpret_cast<C*>(tile_raw);
    const C* src = expV + row0 * ns;
    for (long long k = threadIdx.x; k < nrow * ns; k += blockDim.x)
      tile[k] = src[k];
    __syncthreads();
    m = tile + static_cast<long long>(threadIdx.x) * ns;
  }
  if (threadIdx.x >= nrow) return;
  const long long i = row0 + threadIdx.x;
  const long long p = i / ns;
  const int a = static_cast<int>(i - p * ns);
  const long long base = p * sp;
  C acc;
  acc.x = 0;
  acc.y = 0;
  for (int b = 0; b < ns; ++b) cfma(acc, m[b], psi[base + b * ss]);
  out[base + a * ss] = acc;
}

// Launch of the generic branch: blocks of up to kThreads rows, fewer for
// large ns so that a block's tile stays within 48 KB of shared memory;
// when even 32 rows do not fit, blocks of kThreads unstaged rows.
template <typename T>
int launch_potential_rows(const typename Complex<T>::type* m,
                          const typename Complex<T>::type* x,
                          typename Complex<T>::type* y, long long npts,
                          int ns, long long sp, long long ss,
                          cudaStream_t st) {
  using C = typename Complex<T>::type;
  constexpr size_t kTileBytes = 48 * 1024;
  const size_t row_bytes = sizeof(C) * static_cast<size_t>(ns);
  int threads = kThreads;
  while (threads > 32 && threads * row_bytes > kTileBytes) threads -= 32;
  const bool staged = threads * row_bytes <= kTileBytes;
  if (!staged) threads = kThreads;
  const long long rows = npts * ns;
  const long long blocks = (rows + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (staged)
    spo_potential_kernel_rows<T, true>
        <<<static_cast<unsigned>(blocks), threads, threads * row_bytes, st>>>(
            m, x, y, npts, ns, sp, ss);
  else
    spo_potential_kernel_rows<T, false>
        <<<static_cast<unsigned>(blocks), threads, 0, st>>>(m, x, y, npts,
                                                            ns, sp, ss);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(long long npts, int ns, long long sp, long long ss) {
  return npts <= 0 || ns <= 0 || sp <= 0 || ss <= 0
         || (npts + kThreads - 1) / kThreads > 0x7fffffffLL;
}

template <typename T>
int launch_phase(const void* expK, const void* psik, void* out,
                 long long npts, int ns, long long sp, long long ss,
                 void* stream) {
  if (bad_args(npts, ns, sp, ss))
    return static_cast<int>(cudaErrorInvalidValue);
  using C = typename Complex<T>::type;
  const unsigned blocks = static_cast<unsigned>((npts + kThreads - 1)
                                                / kThreads);
  spo_phase_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(expK), static_cast<const C*>(psik),
      static_cast<C*>(out), npts, ns, sp, ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_potential(const void* expV, const void* psi, void* out,
                     long long npts, int ns, long long sp, long long ss,
                     void* stream) {
  if (bad_args(npts, ns, sp, ss))
    return static_cast<int>(cudaErrorInvalidValue);
  using C = typename Complex<T>::type;
  const unsigned blocks = static_cast<unsigned>((npts + kThreads - 1)
                                                / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const C* m = static_cast<const C*>(expV);
  const C* x = static_cast<const C*>(psi);
  C* y = static_cast<C*>(out);
  switch (ns) {
    case 1:
      spo_potential_kernel<T, 1><<<blocks, kThreads, 0, st>>>(m, x, y, npts,
                                                              sp, ss);
      break;
    case 2:
      spo_potential_kernel<T, 2><<<blocks, kThreads, 0, st>>>(m, x, y, npts,
                                                              sp, ss);
      break;
    case 3:
      spo_potential_kernel<T, 3><<<blocks, kThreads, 0, st>>>(m, x, y, npts,
                                                              sp, ss);
      break;
    case 4:
      spo_potential_kernel<T, 4><<<blocks, kThreads, 0, st>>>(m, x, y, npts,
                                                              sp, ss);
      break;
    default:
      return launch_potential_rows<T>(m, x, y, npts, ns, sp, ss, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers
// to interleaved complex data; npts is the number of grid points, ns the
// number of states, sp and ss the point and state strides of psi and out
// in elements. Returns cudaGetLastError() after the launch.
extern "C" int spo_phase_c128(const void* expK, const void* psik, void* out,
                              long long npts, int ns, long long sp,
                              long long ss, void* stream) {
  return launch_phase<double>(expK, psik, out, npts, ns, sp, ss, stream);
}

extern "C" int spo_phase_c64(const void* expK, const void* psik, void* out,
                             long long npts, int ns, long long sp,
                             long long ss, void* stream) {
  return launch_phase<float>(expK, psik, out, npts, ns, sp, ss, stream);
}

extern "C" int spo_potential_c128(const void* expV, const void* psi,
                                  void* out, long long npts, int ns,
                                  long long sp, long long ss, void* stream) {
  return launch_potential<double>(expV, psi, out, npts, ns, sp, ss, stream);
}

extern "C" int spo_potential_c64(const void* expV, const void* psi,
                                 void* out, long long npts, int ns,
                                 long long sp, long long ss, void* stream) {
  return launch_potential<float>(expV, psi, out, npts, ns, sp, ss, stream);
}
