// HEOM hierarchy coupling on Hopper (sm_90a), in index form.
//
// Replaces the level-blocked Pallas kernel of the JAX package
// (pyqed_tpu/ops/pallas_kernels.py:681-769, _make_level_coupling_kernel /
// _level_coupling_call). That kernel multiplies one-hot level-to-level
// selection matrices S_k into the ADO planes because a TPU has no cheap
// gather. Every row of S_k holds at most one nonzero, so here the
// selection is a row gather, and the whole coupling term of the HEOM
// right-hand side is, for every destination ADO d,
//
//     out[d, :] = sum_{j < nj} w[d, j] * F[nbr[d, j], :] @ OpT[j]
//
// with OpT = [P_0^T .. P_{M-1}^T ; D_0^T .. D_{M-1}^T] (nj = 2M complex
// (V, V) superoperators, c_k folded into D_k), nbr[d, j] the plus (j < M)
// or minus (j >= M) neighbour of d or -1 when there is none, and w = 1 on
// the plus side and the occupation n_k(d) on the minus side. One launch
// covers every level and both directions; the gathered stack is never
// written to device memory, and the one-hot S-matmul FLOPs of the TPU
// kernel are gone.
//
// Bound: at the FMO flagship (680 ADOs, M = 14, V = 49, complex128) one
// call needs 3,360 edges x 2,401 complex MACs = 65 MFLOP (about 2 us at
// the card's FP64 rate) and reads OpT[j] (38 KB; all of OpT is 1.1 MB, so
// it stays in L2) once per edge: 129 MB of L2 reads. What bounds this
// simple kernel is latency: a thread's column of OpT[j] is a chain of V
// loads from L2, and the ADOs of the low levels have ~15 edges each.
//
// Design: one block per destination ADO and 64 output columns, with the
// j loop split over 8 groups of 64 threads. In each round a group stages
// the weighted source row of its j in shared memory, then each thread
// streams its column of OpT[j] from L2 (unrolled 16 deep, so 16 loads are
// in flight) into one complex accumulator in registers; a group skips a j
// without a neighbour. The 8 partial sums are added in shared memory in a
// fixed order: no atomics, the result is deterministic. Any V works (the
// ragged edges are masked). wgmma, TMA, j-major tiling (one OpT[j] tile
// shared by many rows) and CUDA graphs are left for later.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;      // output columns per block (threadIdx.x)
constexpr int kGroups = 8;     // j groups per block (threadIdx.y)
constexpr int kChunk = kCols;  // source entries staged per pass
constexpr int kUnroll = 16;    // OpT loads in flight per thread

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

template <typename T>
__global__ void __launch_bounds__(kCols * kGroups)
heom_coupling_kernel(const typename Complex<T>::type* __restrict__ F,
                     const int* __restrict__ nbr,
                     const T* __restrict__ w,
                     const typename Complex<T>::type* __restrict__ OpT,
                     typename Complex<T>::type* __restrict__ out,
                     int nj, int V) {
  using C = typename Complex<T>::type;
  // staged source rows; reused for the cross-group sum at the end
  __shared__ C rows[kGroups][kChunk];

  const int tx = threadIdx.x;
  const int g = threadIdx.y;
  const int d = blockIdx.x;
  const int b = blockIdx.y * kCols + tx;   // output column of this thread
  const size_t VV = static_cast<size_t>(V) * V;
  T acc_r = 0, acc_i = 0;

  const int rounds = (nj + kGroups - 1) / kGroups;
  for (int round = 0; round < rounds; ++round) {
    const int j = round * kGroups + g;
    // src is the same for the 64 threads of a group; the barriers below
    // are reached by every thread of the block whatever src is
    const int src = j < nj ? nbr[static_cast<size_t>(d) * nj + j] : -1;
    const T wj = src >= 0 ? w[static_cast<size_t>(d) * nj + j] : T(0);
    const C* frow = F + static_cast<size_t>(src >= 0 ? src : 0) * V;
    const C* op = OpT + (src >= 0 ? j : 0) * VV;

    for (int a0 = 0; a0 < V; a0 += kChunk) {
      if (src >= 0) {
        const int a = a0 + tx;
        C v = Complex<T>::make(0, 0);
        if (a < V) {
          const C f = frow[a];
          v = Complex<T>::make(wj * f.x, wj * f.y);
        }
        rows[g][tx] = v;
      }
      __syncthreads();
      if (src >= 0 && b < V) {
        const int na = min(kChunk, V - a0);
        const C* opa = op + static_cast<size_t>(a0) * V + b;
#pragma unroll kUnroll
        for (int t = 0; t < na; ++t) {
          const C o = opa[static_cast<size_t>(t) * V];
          const C f = rows[g][t];
          acc_r += f.x * o.x - f.y * o.y;
          acc_i += f.x * o.y + f.y * o.x;
        }
      }
      __syncthreads();
    }
  }

  // sum the kGroups partials of each output in a fixed order
  rows[g][tx] = Complex<T>::make(acc_r, acc_i);
  __syncthreads();
  if (g == 0 && b < V) {
    T sr = 0, si = 0;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      sr += rows[q][tx].x;
      si += rows[q][tx].y;
    }
    out[static_cast<size_t>(d) * V + b] = Complex<T>::make(sr, si);
  }
}

template <typename T>
int launch(const void* F, const void* nbr, const void* w, const void* OpT,
           void* out, int nado, int nj, int V, void* stream) {
  if (nado <= 0 || nj < 0 || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using C = typename Complex<T>::type;
  const dim3 grid(nado, (V + kCols - 1) / kCols);
  const dim3 block(kCols, kGroups);
  heom_coupling_kernel<T><<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(F), static_cast<const int*>(nbr),
      static_cast<const T*>(w), static_cast<const C*>(OpT),
      static_cast<C*>(out), nj, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// F, OpT and out are interleaved complex. Returns cudaGetLastError() after
// the launch.
extern "C" int heom_coupling_c128(const void* F, const void* nbr,
                                  const void* w, const void* OpT, void* out,
                                  int nado, int nj, int V, void* stream) {
  return launch<double>(F, nbr, w, OpT, out, nado, nj, V, stream);
}

extern "C" int heom_coupling_c64(const void* F, const void* nbr,
                                 const void* w, const void* OpT, void* out,
                                 int nado, int nj, int V, void* stream) {
  return launch<float>(F, nbr, w, OpT, out, nado, nj, V, stream);
}
