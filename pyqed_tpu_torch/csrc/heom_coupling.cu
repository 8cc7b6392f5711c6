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
// and, for a batch of B hierarchies that share the graph and the
// operators (F of shape (nado, B, V), as the phase-cycled field 2DES of
// signal/field2des.py propagates them), out[d, b] = sum_j w[d, j]
// F[nbr[d, j], b] @ OpT[j] for every b, in the same one launch.
//
// with OpT = [P_0^T .. P_{M-1}^T ; D_0^T .. D_{M-1}^T] (nj = 2M complex
// (V, V) superoperators, c_k folded into D_k), nbr[d, j] the plus (j < M)
// or minus (j >= M) neighbour of d or -1 when there is none, and w = 1 on
// the plus side and the occupation n_k(d) on the minus side. The one-hot
// S-matmul FLOPs of the TPU kernel are gone.
//
// Bound: at the FMO flagship (680 ADOs, M = 14, V = 49, complex128) one
// call needs 3,360 edges x 2,401 complex MACs = 65 MFLOP (about 1 us at
// the card's FP64 tensor-core rate) over 1.1 MB of operators. Streaming
// the 38 KB OpT[j] from L2 for every edge, as a block per destination
// would, is 129 MB of L2 reads a call and bounds such a kernel by the
// latency of those reads (40 us on an H100, PERF.md).
//
// Design, edge-major, one launch. For a fixed j the map d -> nbr[d, j]
// is one-to-one (a key plus or minus e_m is unique), so the edges group
// by j. The host builds a plan once per right-hand side
// (ops/kernels.py::heom_coupling_plan): the edges sorted by j with their
// source row, weight and destination, cut into tiles of at most kRows
// edges of one j, and each destination's edges in ascending j.
// - Partials: a block takes one tile and 64 output columns. It stages
//   its columns of OpT[j] (49 x 49 complex at V = 49, in passes of 64
//   rows for larger V) and the tile's source rows F[s_e] in shared memory
//   with cp.async, all copies in flight at once, and writes
//   P[e] = w_e (F[s_e] @ OpT[j]) for its edges into a scratch buffer
//   (3,360 x 49 complex at the flagship, allocated once per plan), in
//   destination order: each destination's partials are consecutive rows,
//   so their sum needs no index. FP64 FMA from shared memory: each
//   thread owns one column and four edges. OpT
//   is read from L2 once per block, not once per edge: 224 blocks x 38 KB
//   = 8.6 MB at the flagship in place of 129 MB.
// - Sums: each block then counts its edges off their destinations (one
//   acquire-release atomic per edge, after a barrier: no fence in every
//   thread). The block that completes a destination adds all of that
//   destination's partials in the plan's order, 16 loads in flight, and
//   resets its count; the rows a block completes are packed first, so
//   its threads sum them in one pass. The atomics only choose which block
//   sums; the order of every sum is fixed, so the result is
//   deterministic. One launch, not a second one for the sums: the HEOM
//   step loop is bound by the host, and a launch costs it more than the
//   device time it would save (PERF.md).
// - Batch: a block walks all B rows of its tile's edges, one batch row
//   after another, with OpT[j] staged once (V <= 64: one pass) and
//   reused B times; the partials are (nedges, B, V), a destination's
//   edges still consecutive, so the count per destination and the block
//   that sums stay as they are, and that block sums all B rows. At B = 1
//   this is the unbatched kernel. At the field-2DES shape (680 ADOs of
//   the n = 8 chain, V = 64, B = 256; 3,360 edges) one call is 28.2
//   GFLOP, bound by the FP64 rate (0.42 ms at 67 TFLOP/s; the bytes,
//   357 MB, take 0.107 ms); here on FP64 FMA (34 TFLOP/s) it cannot
//   beat 0.83 ms. Putting the partials on the FP64 tensor cores is for
//   a later change.
// Any V works (ragged column tiles are masked). The kernel is bound by
// latency, in three parts of similar size: the staging (a chain of
// dependent loads, tile, source index, rows, before the copies), the
// products (FP64 FMA, four edges a thread), and the sums after them (the
// partials' round trip through L2 and the count's atomic).
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using pyqed::Complex;
using pyqed::cp_async;
using pyqed::cp_async_commit;
using pyqed::cp_async_wait;

constexpr int kRows = 16;      // edges per tile; ops/kernels.py plans with it
constexpr int kCols = 64;      // output columns per block
constexpr int kGroups = 4;     // edge groups of a block (threadIdx / kCols)
constexpr int kPer = kRows / kGroups;   // edges per thread
constexpr int kThreads = kCols * kGroups;
constexpr int kChunk = 64;     // rows of OpT[j] staged per pass
constexpr int kSumDepth = 16;   // partials loaded at once by the sums
static_assert(kRows <= 32, "the sums pick their rows in one warp");

template <typename T>
__global__ void __launch_bounds__(kThreads)
coupling_kernel(const typename Complex<T>::type* __restrict__ F,
                const typename Complex<T>::type* __restrict__ OpT,
                const int* __restrict__ tiles, const int* __restrict__ src,
                const T* __restrict__ w, const int* __restrict__ dst,
                const int* __restrict__ slot, const int* __restrict__ dst_ptr,
                int* arrived,
                typename Complex<T>::type* __restrict__ partial,
                typename Complex<T>::type* __restrict__ out, int V,
                int B) {
  using C = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* op = reinterpret_cast<C*>(smem_raw);             // [chunk][kCols]
  const int rows_ld = min(V, kChunk);
  C* rows = op + rows_ld * kCols;                       // [kRows][rows_ld]
  __shared__ int dest[kRows], first[kRows], stop[kRows];
  __shared__ int act[kRows], nact;   // the rows this block sums

  const int tid = threadIdx.x;
  const int col = tid % kCols;
  const int grp = tid / kCols;
  const int j = tiles[3 * blockIdx.x];
  const int e0 = tiles[3 * blockIdx.x + 1];
  const int cnt = tiles[3 * blockIdx.x + 2];
  const int c0 = blockIdx.y * kCols;
  const int nc = min(kCols, V - c0);
  const C* opj = OpT + static_cast<size_t>(j) * V * V;

  // the tile's source rows (the weights are applied at the partials'
  // store) and the rows of its partials; each edge's destination and the
  // range of that destination's partials, for the sums at the end
  int srow[kPer], prow[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int r = grp * kPer + p;
    srow[p] = r < cnt ? src[e0 + r] : -1;
    prow[p] = r < cnt ? slot[e0 + r] : 0;
  }
  if (tid < cnt) {
    const int d = dst[e0 + tid];
    dest[tid] = d;
    first[tid] = dst_ptr[d];
    stop[tid] = dst_ptr[d + 1];
  }

  // OpT[j] is staged once for all B rows when it fits one pass
  const bool op_once = V <= kChunk;
  const size_t BV = static_cast<size_t>(B) * V;
  for (int bb = 0; bb < B; ++bb) {
    T acc_r[kPer], acc_i[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) acc_r[p] = acc_i[p] = T(0);
    for (int a0 = 0; a0 < V; a0 += kChunk) {
      const int na = min(kChunk, V - a0);
      // OpT[j][a0 + a][c0 + b], zeros past column V
      if (!op_once || bb == 0)
        for (int e = tid; e < na * kCols; e += kThreads) {
          const int a = e / kCols, b = e % kCols;
          const bool ok = b < nc;
          cp_async<sizeof(C)>(
              op + e,
              ok ? opj + static_cast<size_t>(a0 + a) * V + c0 + b : opj,
              ok);
        }
      // F[src, bb][a0 + a] of the tile's edges, zeros past its last edge;
      // the threads of edge group grp copy its kPer rows
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        for (int a = col; a < na; a += kCols) {
          const bool ok = srow[p] >= 0;
          cp_async<sizeof(C)>(
              rows + (grp * kPer + p) * rows_ld + a,
              ok ? F + static_cast<size_t>(srow[p]) * BV +
                       static_cast<size_t>(bb) * V + a0 + a
                 : F,
              ok);
        }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      // the rows of a warp are one edge group: their reads are broadcasts
#pragma unroll 7
      for (int a = 0; a < na; ++a) {
        const C o = op[a * kCols + col];
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const C f = rows[(grp * kPer + p) * rows_ld + a];
          acc_r[p] += f.x * o.x - f.y * o.y;
          acc_i[p] += f.x * o.y + f.y * o.x;
        }
      }
      __syncthreads();
    }

    if (col < nc) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int r = grp * kPer + p;
        if (r < cnt) {
          const T wr = w[e0 + r];
          partial[static_cast<size_t>(prow[p]) * BV +
                  static_cast<size_t>(bb) * V + c0 + col] =
              Complex<T>::make(wr * acc_r[p], wr * acc_i[p]);
        }
      }
    }
  }

  // Publish the partials, then count this block's part of each edge off
  // its destination. The block that completes a destination (all its
  // edges, all column blocks) sums its partials in the plan's order and
  // resets the count for the next call: atomics only pick the block, the
  // order of the sum is fixed, so the result is deterministic.
  __syncthreads();
  if (tid < 32) {
    int d = -1;
    if (tid < cnt) {
      // release: the block's partials (ordered before it by the barrier)
      // are visible to whoever acquires the count; acquire: so are the
      // other blocks' partials to this block once it completes the count
      const int need = (stop[tid] - first[tid]) * gridDim.y;
      int old;
      asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
                   : "=r"(old)
                   : "l"(arrived + dest[tid])
                   : "memory");
      if (old == need - 1) {
        d = dest[tid];
        arrived[d] = 0;
      }
    }
    // the rows this block sums, packed, so that its threads cover them
    // in one pass
    const unsigned m = __ballot_sync(0xffffffffu, d >= 0);
    if (d >= 0) act[__popc(m & ((1u << tid) - 1u))] = tid;
    if (tid == 0) nact = __popc(m);
  }
  __syncthreads();
  // a destination's partials are consecutive rows (of B x V each);
  // kSumDepth of them are loaded at once (from L2, where the other blocks
  // wrote them)
  const long long nsum = static_cast<long long>(BV);
  for (long long idx = tid; idx < nact * nsum; idx += kThreads) {
    const int r = act[idx / nsum];
    const size_t b = static_cast<size_t>(idx % nsum);
    T sr = T(0), si = T(0);
    for (int q = first[r]; q < stop[r]; q += kSumDepth) {
      C p[kSumDepth];
#pragma unroll
      for (int u = 0; u < kSumDepth; ++u)
        p[u] = q + u < stop[r]
                   ? __ldcg(partial + static_cast<size_t>(q + u) * BV + b)
                   : Complex<T>::make(T(0), T(0));
#pragma unroll
      for (int u = 0; u < kSumDepth; ++u) {
        if (q + u < stop[r]) {
          sr += p[u].x;
          si += p[u].y;
        }
      }
    }
    out[static_cast<size_t>(dest[r]) * BV + b] = Complex<T>::make(sr, si);
  }
}

// What a launch on a plan takes that does not change between calls, built
// once per plan, V and B by ops/kernels.py::_coupling_launch_args (a ctypes
// Structure with these fields in this order), so that a call passes five
// arguments through ctypes and not eleven.
struct PlanArgs {
  const void* w;      // (nedges,) real of F's precision: the edges' weights
  void* plan;         // the plan's int32 arrays, one after another
  void* partial;      // (nedges, B, V) interleaved complex: the partials
  int nado;
  int ntiles;
  int nedges;
  int V;
  int B;              // hierarchies in the batch (1: F is (nado, V))
};

template <typename T>
int launch(const void* F, const void* OpT, void* out, const PlanArgs* a,
           void* stream) {
  if (a == nullptr || a->nado <= 0 || a->ntiles <= 0 || a->nedges <= 0 ||
      a->V <= 0 || a->B <= 0 ||
      static_cast<long long>(a->B) * a->V > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  using C = typename Complex<T>::type;
  const int V = a->V;
  const int chunk = V < kChunk ? V : kChunk;
  const int smem = static_cast<int>(sizeof(C)) * chunk * (kCols + kRows);
  static pyqed::SmemAllowance allowance;
  const cudaError_t err = allowance.ensure(
      reinterpret_cast<const void*>(coupling_kernel<T>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the plan's int32 arrays, one after another
  int* const tiles = static_cast<int*>(a->plan);
  int* const src = tiles + 3 * a->ntiles;
  int* const dst = src + a->nedges;
  int* const slot = dst + a->nedges;
  int* const dst_ptr = slot + a->nedges;
  int* const arrived = dst_ptr + a->nado + 1;
  const dim3 grid(a->ntiles, (V + kCols - 1) / kCols);
  coupling_kernel<T><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(F), static_cast<const C*>(OpT), tiles, src,
      static_cast<const T*>(a->w), dst, slot, dst_ptr, arrived,
      static_cast<C*>(a->partial), static_cast<C*>(out), V, a->B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers,
// but for args, which points to a PlanArgs in host memory. F (nado, B, V),
// OpT (nj, V, V), out (nado, B, V) and args->partial (nedges, B, V) are
// interleaved complex (B = args->B; (nado, V) when it is 1). args->plan holds the int32 arrays of
// ops/kernels.py::CouplingPlan one after another: tiles (ntiles, 3) rows
// (j, first edge, edge count); src, dst and slot (nedges,) of the edges
// sorted by j, slot being the edge's row of partial; dst_ptr (nado + 1,),
// destination d's partials being the rows dst_ptr[d] .. dst_ptr[d + 1] - 1;
// arrived (nado,), zero before and after the call. Every destination must
// have an edge (the wrapper zeroes the others). Returns the cudaError_t of
// the set-up and the launch (0: launched).
extern "C" int heom_coupling_c128(const void* F, const void* OpT, void* out,
                                  const void* args, void* stream) {
  return launch<double>(F, OpT, out, static_cast<const PlanArgs*>(args),
                        stream);
}

extern "C" int heom_coupling_c64(const void* F, const void* OpT, void* out,
                                 const void* args, void* stream) {
  return launch<float>(F, OpT, out, static_cast<const PlanArgs*>(args),
                       stream);
}
