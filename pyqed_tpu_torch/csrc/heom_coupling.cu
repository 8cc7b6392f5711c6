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
// F[nbr[d, j], b] @ OpT[j] for every b, in one launch,
//
// The sources F and the destinations out need not be the same ADOs: F
// is a stack of nsrc rows, (nsrc, V) or (nsrc, B, V), that nbr indexes,
// and out holds the nd destinations of nbr's rows, (nd, V) or (nd, B, V).
// A whole hierarchy has nsrc = nd = nado; a sharded run passes the stack
// it all-gathered and its own destinations (nsrc > nd). Neither design
// needs nsrc: a source is only ever an index into F. Below, nado in a
// shape is nd for out and nsrc for F.
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
// Two designs, one launch per right-hand side each; ops/kernels.py picks
// one by the batch B, against B_min = COUPLING_BATCH_MIN there (16 at
// complex128, 32 at complex64: below it the edge-major kernel was the
// faster on an H100, PERF.md):
// - F (nado, V), or (nado, B, V) with B < B_min: edge-major, partial
//   rows, then sums (coupling_kernel, the entry points heom_coupling_*).
//   The unbatched HEOM step (the FMO flagship) is bound by the host, and
//   this design keeps its one launch short.
// - F (nado, B, V) with B >= B_min: destination-major on the FP64 tensor
//   cores (coupling_dm_dmma_kernel; complex64 on FP32 FMA,
//   coupling_dm_fma_kernel; the entry points heom_coupling_batched_*),
//   with no partials and no atomics. It computes a whole 64-row batch
//   tile however few rows are real, so at small B it loses.
//
// Edge-major design. For a fixed j the map d -> nbr[d, j]
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
// - A batch below B_min: a block walks all B rows of its tile's
//   edges, one batch row after another, with OpT[j] staged once (V <= 64)
//   and reused B times; the partials are (nedges, B, V) and the block
//   that completes a destination sums all B rows.
// Any V works (ragged column tiles are masked). The kernel is bound by
// latency, in three parts of similar size: the staging (a chain of
// dependent loads, tile, source index, rows, before the copies), the
// products (FP64 FMA, four edges a thread), and the sums after them (the
// partials' round trip through L2 and the count's atomic).
//
// Why a second design for batches. At the field-2DES shape (680 ADOs of
// the n = 8 chain, V = 64, B = 256; 3,360 edges) one call is 28.2 GFLOP
// and 357 MB (F read once, out written once): bound by the FP64
// tensor-core rate, 0.42 ms at 67 TFLOP/s (the bytes take 0.107 ms). The
// edge-major kernel took 3.69-3.77 ms there (PERF.md): its products ran
// on FP64 FMA (34 TFLOP/s peak, so never below 0.83 ms), its partials
// made a 1.76 GB round trip a call (881 MB each way), its 224 blocks
// walked their 256 batch rows one after another with a full wait and
// two barriers per row, and one block summed all B x V partials of a
// destination alone at the end.
//
// Destination-major design (B >= B_min). A block owns destination d,
// a tile of kDBt batch rows and kDBn output columns: out[d, tile] =
// sum_j w[d, j] F[nbr[d, j], tile] @ OpT[j], a (kDBt x V) @ (V x V)
// complex product per edge, all into one set of accumulators in
// registers, written once. No partials, no count, no atomic: the order
// of every sum is fixed (edges in ascending j, k in ascending slices).
// - The block compacts d's edges from nbr[d, :] and w[d, :] (skipping
//   -1) into shared memory, then runs one K loop over (edge, 8-deep k
//   slice) pairs through a ring of kDStages cp.async stages, continuous
//   across edges, so the next edge's loads overlap this edge's products.
//   A stage holds F[src, b0 .. b0 + kDBt, k slice] (rows of the batch
//   tile are contiguous: the ADO axis is outermost) and OpT[j][k slice,
//   columns], interleaved complex with padded rows (12 and 66 complex),
//   so the 16-byte fragment loads of each quarter-warp hit 8 distinct
//   bank groups; 16-byte cp.async from global memory, zeros past B and V.
// - Products on DMMA (mma.sync.m16n8k8.f64) with the batch rows as M: a
//   complex product is four real ones into a real and an imaginary
//   accumulator (the -Im(OpT) operand negated in registers); the edge's
//   weight scales the A (F) fragments. Eight warps of 32 x 16 outputs:
//   32 accumulator doubles a thread, two blocks an SM (128 registers a
//   thread), so 16 warps hide the latency of the products and of the
//   ring. It reaches about 42 TFLOP/s, 0.62 of the bound (0.68 ms at the
//   field-2DES shape, PERF.md); the register file is what holds it: the
//   weight applied to the B fragments instead, or 16-deep k slices,
//   spill or cost occupancy and were slower, as were rings of 2 and 6
//   stages (3 and 4 are equal).
// - Grid (nado, column tiles, batch tiles), destinations fastest: the
//   blocks in flight share one batch tile's slice of F, which stays in
//   L2 (it is read once per edge, 881 MB at the field-2DES shape, from
//   L2; from HBM about once), as does OpT (1.8 MB).
// - complex64 keeps FP32 FMA in the same destination-major structure
//   (TF32 on the tensor cores would miss the 1e-5 parity gate): 16 x 16
//   threads of 4 x 4 complex accumulators over a 64 x 64 tile.
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using pyqed::Complex;
using pyqed::cp_async;
using pyqed::cp_async_commit;
using pyqed::cp_async_wait;
using pyqed::dmma;

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
  int nd;             // destinations (rows of out; F may have more rows)
  int ntiles;
  int nedges;
  int V;
  int B;              // hierarchies in the batch (1: F is (nado, V))
};

template <typename T>
int launch(const void* F, const void* OpT, void* out, const PlanArgs* a,
           void* stream) {
  if (a == nullptr || a->nd <= 0 || a->ntiles <= 0 || a->nedges <= 0 ||
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
  int* const arrived = dst_ptr + a->nd + 1;
  const dim3 grid(a->ntiles, (V + kCols - 1) / kCols);
  coupling_kernel<T><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(F), static_cast<const C*>(OpT), tiles, src,
      static_cast<const T*>(a->w), dst, slot, dst_ptr, arrived,
      static_cast<C*>(a->partial), static_cast<C*>(out), V, a->B);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------- batched: destination-major (B >= B_min)

// What a destination-major launch takes that does not change between
// calls, built once per plan, V and B by ops/kernels.py (a ctypes
// Structure with these fields in this order).
struct BatchArgs {
  const void* nbr;    // (nd, nj) int32: d's sources in F, -1 for none
  const void* w;      // (nd, nj) real of F's precision: their weights
  int nd;             // destinations (rows of out; F may have more rows)
  int nj;
  int V;
  int B;              // hierarchies in the batch
};

// Destination d's edges in ascending j, compacted from nbr[d, :] and
// w[d, :] (skipping -1) into shared memory by the first warp: sources,
// indices j and weights. Returns their count, after a barrier.
template <typename T>
__device__ __forceinline__ int edge_list(const int* __restrict__ nbr,
                                         const T* __restrict__ w, int d,
                                         int nj, int* esrc, int* ej, T* ew,
                                         int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const size_t row = static_cast<size_t>(d) * nj;
    int base = 0;
    for (int j0 = 0; j0 < nj; j0 += 32) {
      const int j = j0 + lane;
      const int s = j < nj ? nbr[row + j] : -1;
      const unsigned m = __ballot_sync(0xffffffffu, s >= 0);
      if (s >= 0) {
        const int p = base + __popc(m & ((1u << lane) - 1u));
        esrc[p] = s;
        ej[p] = j;
        ew[p] = w[row + j];
      }
      base += __popc(m);
    }
    if (lane == 0) *count = base;
  }
  __syncthreads();
  return *count;
}

// complex128 on DMMA
constexpr int kDBt = 64;               // batch rows per block
constexpr int kDBn = 64;               // output columns per block
constexpr int kDBk = 8;                // k slice per stage: one mma depth
constexpr int kDStages = 4;            // depth of the cp.async ring
constexpr int kDWarpsM = 2;
constexpr int kDWarpsN = 4;
constexpr int kDThreads = 32 * kDWarpsM * kDWarpsN;
// two blocks an SM (ptxas keeps a thread to 128 registers): 16 warps
// hide the latency of the products and of the ring's copies
constexpr int kDBlocksPerSM = 2;
constexpr int kDWarpRows = kDBt / kDWarpsM;
constexpr int kDWarpCols = kDBn / kDWarpsN;
constexpr int kDMT = kDWarpRows / 16;  // m16 tiles per warp
constexpr int kDNT = kDWarpCols / 8;   // n8 tiles per warp
// padded rows of the staged slices, in complex (16-byte) elements: F's
// [row][k] rows = 4 (mod 8), OpT's [k][column] rows = 2 (mod 8), so the
// 8 lanes of a quarter-warp's 16-byte fragment loads hit 8 bank groups
constexpr int kDALd = kDBk + 4;
constexpr int kDBLd = kDBn + 2;
constexpr int kDAElems = kDBt * kDALd;
constexpr int kDStage = kDAElems + kDBk * kDBLd;
constexpr int kDCopiesA = kDBt * kDBk / kDThreads;
constexpr int kDCopiesB = kDBk * kDBn / kDThreads;
static_assert(kDBt * kDBk % kDThreads == 0 && kDBk * kDBn % kDThreads == 0,
              "whole copies per thread");
static_assert(kDWarpRows % 16 == 0 && kDWarpCols % 8 == 0,
              "warp tiles of whole mma tiles");

// Start the copies of step it of the K loop (edge it / nk, k slice
// it % nk) into its stage of the ring: F[src, b0 + r, k0 + kk] and
// OpT[j][k0 + kk, c0 + c], zeros past B and V. Consecutive threads take
// consecutive elements of a row.
__device__ __forceinline__ void stage_dm_c128(
    double2* ring, const double2* __restrict__ F,
    const double2* __restrict__ OpT, const int* esrc, const int* ej, int it,
    int nk, int V, int B, int b0, int c0, int tid) {
  double2* sa = ring + (it % kDStages) * kDStage;
  double2* sb = sa + kDAElems;
  const int e = it / nk;
  const int k0 = (it - e * nk) * kDBk;
  const double2* fs =
      F + (static_cast<size_t>(esrc[e]) * B + b0) * static_cast<size_t>(V);
  const double2* op = OpT + static_cast<size_t>(ej[e]) * V * V;
#pragma unroll
  for (int l = 0; l < kDCopiesA; ++l) {
    const int idx = tid + l * kDThreads;
    const int r = idx / kDBk, kk = idx % kDBk;
    const bool ok = b0 + r < B && k0 + kk < V;
    cp_async<16>(sa + r * kDALd + kk,
                 ok ? fs + static_cast<size_t>(r) * V + k0 + kk : F, ok);
  }
#pragma unroll
  for (int l = 0; l < kDCopiesB; ++l) {
    const int idx = tid + l * kDThreads;
    const int kk = idx / kDBn, c = idx % kDBn;
    const bool ok = k0 + kk < V && c0 + c < V;
    cp_async<16>(sb + kk * kDBLd + c,
                 ok ? op + static_cast<size_t>(k0 + kk) * V + c0 + c : OpT,
                 ok);
  }
}

__global__ void __launch_bounds__(kDThreads, kDBlocksPerSM)
coupling_dm_dmma_kernel(const double2* __restrict__ F,
                        const double2* __restrict__ OpT,
                        const int* __restrict__ nbr,
                        const double* __restrict__ w,
                        double2* __restrict__ out, int nj, int V, int B) {
  extern __shared__ __align__(16) double2 ring[];
  double* ew = reinterpret_cast<double*>(ring + kDStages * kDStage);
  int* esrc = reinterpret_cast<int*>(ew + nj);
  int* ej = esrc + nj;
  __shared__ int ne_s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % kDWarpsM, wn = warp / kDWarpsM;
  const int d = blockIdx.x;
  const int c0 = blockIdx.y * kDBn;
  const int b0 = blockIdx.z * kDBt;
  const int ne = edge_list(nbr, w, d, nj, esrc, ej, ew, &ne_s);
  const int nk = (V + kDBk - 1) / kDBk;
  const int steps = ne * nk;

  double re[kDMT][kDNT][4], im[kDMT][kDNT][4];
#pragma unroll
  for (int mt = 0; mt < kDMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kDNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) re[mt][nt][q] = im[mt][nt][q] = 0.0;

#pragma unroll
  for (int it = 0; it < kDStages - 1; ++it) {
    if (it < steps)
      stage_dm_c128(ring, F, OpT, esrc, ej, it, nk, V, B, b0, c0, tid);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kDStages - 2>();  // this thread's copies of step it
    __syncthreads();                // everyone's; step it - 1 is consumed
    if (it + kDStages - 1 < steps)
      stage_dm_c128(ring, F, OpT, esrc, ej, it + kDStages - 1, nk, V, B,
                    b0, c0, tid);
    cp_async_commit();

    const double2* sa = ring + (it % kDStages) * kDStage;
    const double2* sb = sa + kDAElems;
    const double wv = ew[it / nk];
    // A fragments of the weighted source rows
    double ar[kDMT][4], ai[kDMT][4];
#pragma unroll
    for (int mt = 0; mt < kDMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * kDWarpRows + mt * 16 + g + 8 * (i & 1);
        const double2 v = sa[row * kDALd + t + 4 * (i >> 1)];
        ar[mt][i] = wv * v.x;
        ai[mt][i] = wv * v.y;
      }
#pragma unroll
    for (int nt = 0; nt < kDNT; ++nt) {
      const int c = wn * kDWarpCols + nt * 8 + g;
      double br[2], bi[2], nbi[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const double2 v = sb[(t + 4 * i) * kDBLd + c];
        br[i] = v.x;
        bi[i] = v.y;
        nbi[i] = -v.y;
      }
#pragma unroll
      for (int mt = 0; mt < kDMT; ++mt) {
        dmma(re[mt][nt], ar[mt], br);
        dmma(im[mt][nt], ar[mt], bi);
      }
#pragma unroll
      for (int mt = 0; mt < kDMT; ++mt) {
        dmma(re[mt][nt], ai[mt], nbi);
        dmma(im[mt][nt], ai[mt], br);
      }
    }
  }
  cp_async_wait<0>();

  const size_t V_ = static_cast<size_t>(V);
#pragma unroll
  for (int mt = 0; mt < kDMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kDNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = b0 + wm * kDWarpRows + mt * 16 + g + 8 * (q >> 1);
        const int c = c0 + wn * kDWarpCols + nt * 8 + 2 * t + (q & 1);
        if (b < B && c < V)
          out[(static_cast<size_t>(d) * B + b) * V_ + c] =
              make_double2(re[mt][nt][q], im[mt][nt][q]);
      }
}

// complex64 on FP32 FMA: a 64 x 64 tile, 16 x 16 threads of 4 x 4
// complex accumulators; the slices are staged k-major ([k][row] and
// [k][column], rows padded to 68), so a thread's reads of its rows are
// broadcasts and of its columns consecutive
constexpr int kFTile = 64;
constexpr int kFSide = 16;
constexpr int kFPer = kFTile / kFSide;
constexpr int kFBk = 8;
constexpr int kFStages = 3;
constexpr int kFThreads = kFSide * kFSide;
constexpr int kFLd = kFTile + 4;
constexpr int kFPlane = kFBk * kFLd;
constexpr int kFStage = 2 * kFPlane;
constexpr int kFCopies = kFTile * kFBk / kFThreads;

__device__ __forceinline__ void stage_dm_c64(
    float2* ring, const float2* __restrict__ F,
    const float2* __restrict__ OpT, const int* esrc, const int* ej, int it,
    int nk, int V, int B, int b0, int c0, int tid) {
  float2* sa = ring + (it % kFStages) * kFStage;
  float2* sb = sa + kFPlane;
  const int e = it / nk;
  const int k0 = (it - e * nk) * kFBk;
  const float2* fs =
      F + (static_cast<size_t>(esrc[e]) * B + b0) * static_cast<size_t>(V);
  const float2* op = OpT + static_cast<size_t>(ej[e]) * V * V;
#pragma unroll
  for (int l = 0; l < kFCopies; ++l) {
    const int idx = tid + l * kFThreads;
    const int r = idx / kFBk, kk = idx % kFBk;
    const bool ok = b0 + r < B && k0 + kk < V;
    cp_async<8>(sa + kk * kFLd + r,
                ok ? fs + static_cast<size_t>(r) * V + k0 + kk : F, ok);
  }
#pragma unroll
  for (int l = 0; l < kFCopies; ++l) {
    const int idx = tid + l * kFThreads;
    const int kk = idx / kFTile, c = idx % kFTile;
    const bool ok = k0 + kk < V && c0 + c < V;
    cp_async<8>(sb + kk * kFLd + c,
                ok ? op + static_cast<size_t>(k0 + kk) * V + c0 + c : OpT,
                ok);
  }
}

__global__ void __launch_bounds__(kFThreads)
coupling_dm_fma_kernel(const float2* __restrict__ F,
                       const float2* __restrict__ OpT,
                       const int* __restrict__ nbr,
                       const float* __restrict__ w,
                       float2* __restrict__ out, int nj, int V, int B) {
  extern __shared__ __align__(16) float2 fring[];
  float* ew = reinterpret_cast<float*>(fring + kFStages * kFStage);
  int* esrc = reinterpret_cast<int*>(ew + nj);
  int* ej = esrc + nj;
  __shared__ int ne_s;
  const int tid = threadIdx.x;
  const int tx = tid % kFSide, ty = tid / kFSide;
  const int d = blockIdx.x;
  const int c0 = blockIdx.y * kFTile;
  const int b0 = blockIdx.z * kFTile;
  const int ne = edge_list(nbr, w, d, nj, esrc, ej, ew, &ne_s);
  const int nk = (V + kFBk - 1) / kFBk;
  const int steps = ne * nk;

  float2 acc[kFPer][kFPer];
#pragma unroll
  for (int r = 0; r < kFPer; ++r)
#pragma unroll
    for (int c = 0; c < kFPer; ++c) acc[r][c] = make_float2(0.f, 0.f);

#pragma unroll
  for (int it = 0; it < kFStages - 1; ++it) {
    if (it < steps)
      stage_dm_c64(fring, F, OpT, esrc, ej, it, nk, V, B, b0, c0, tid);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();
    if (it + kFStages - 1 < steps)
      stage_dm_c64(fring, F, OpT, esrc, ej, it + kFStages - 1, nk, V, B, b0,
                   c0, tid);
    cp_async_commit();

    const float2* sa = fring + (it % kFStages) * kFStage;
    const float2* sb = sa + kFPlane;
    const float wv = ew[it / nk];
#pragma unroll
    for (int kk = 0; kk < kFBk; ++kk) {
      float2 a[kFPer], b[kFPer];
#pragma unroll
      for (int r = 0; r < kFPer; ++r) {
        a[r] = sa[kk * kFLd + ty + r * kFSide];
        a[r].x *= wv;
        a[r].y *= wv;
      }
#pragma unroll
      for (int c = 0; c < kFPer; ++c) b[c] = sb[kk * kFLd + tx + c * kFSide];
#pragma unroll
      for (int r = 0; r < kFPer; ++r)
#pragma unroll
        for (int c = 0; c < kFPer; ++c) {
          acc[r][c].x = __fmaf_rn(a[r].x, b[c].x, acc[r][c].x);
          acc[r][c].x = __fmaf_rn(-a[r].y, b[c].y, acc[r][c].x);
          acc[r][c].y = __fmaf_rn(a[r].x, b[c].y, acc[r][c].y);
          acc[r][c].y = __fmaf_rn(a[r].y, b[c].x, acc[r][c].y);
        }
    }
  }
  cp_async_wait<0>();

  const size_t V_ = static_cast<size_t>(V);
#pragma unroll
  for (int r = 0; r < kFPer; ++r) {
    const int b = b0 + ty + r * kFSide;
    if (b >= B) continue;
#pragma unroll
    for (int c = 0; c < kFPer; ++c) {
      const int col = c0 + tx + c * kFSide;
      if (col < V) out[(static_cast<size_t>(d) * B + b) * V_ + col] = acc[r][c];
    }
  }
}

template <typename T>
int launch_batched(const void* F, const void* OpT, void* out,
                   const BatchArgs* a, void* stream) {
  using C = typename Complex<T>::type;
  constexpr bool f64 = sizeof(T) == 8;
  constexpr int rows = f64 ? kDBt : kFTile;
  if (a == nullptr || a->nd <= 0 || a->nj <= 0 || a->V <= 0 ||
      a->B <= 0 || (a->B + rows - 1) / rows > 65535 ||
      (a->V + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t ring = f64 ? sizeof(double2) * kDStages * kDStage
                          : sizeof(float2) * kFStages * kFStage;
  const int smem =
      static_cast<int>(ring + (sizeof(T) + 2 * sizeof(int)) * a->nj);
  const void* kernel =
      f64 ? reinterpret_cast<const void*>(coupling_dm_dmma_kernel)
          : reinterpret_cast<const void*>(coupling_dm_fma_kernel);
  static pyqed::SmemAllowance allowance;
  const cudaError_t err = allowance.ensure(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a->nd, (a->V + 63) / 64, (a->B + rows - 1) / rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (f64)
    coupling_dm_dmma_kernel<<<grid, kDThreads, smem, s>>>(
        static_cast<const C*>(F), static_cast<const C*>(OpT),
        static_cast<const int*>(a->nbr), static_cast<const T*>(a->w),
        static_cast<C*>(out), a->nj, a->V, a->B);
  else
    coupling_dm_fma_kernel<<<grid, kFThreads, smem, s>>>(
        static_cast<const C*>(F), static_cast<const C*>(OpT),
        static_cast<const int*>(a->nbr), static_cast<const T*>(a->w),
        static_cast<C*>(out), a->nj, a->V, a->B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers,
// but for args, which points to a PlanArgs in host memory. F (nsrc, B, V),
// OpT (nj, V, V), out (nd, B, V) and args->partial (nedges, B, V) are
// interleaved complex (B = args->B; (nsrc, V) and (nd, V) when it is 1;
// src indexes F's rows, dst out's). args->plan holds the int32 arrays of
// ops/kernels.py::CouplingPlan one after another: tiles (ntiles, 3) rows
// (j, first edge, edge count); src, dst and slot (nedges,) of the edges
// sorted by j, slot being the edge's row of partial; dst_ptr (nd + 1,),
// destination d's partials being the rows dst_ptr[d] .. dst_ptr[d + 1] - 1;
// arrived (nd,), zero before and after the call. Every destination must
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

// F (nsrc, B, V), OpT (nj, V, V) and out (nd, B, V) interleaved complex,
// device pointers; args points to a BatchArgs in host memory, whose nbr
// and w are device pointers. Every element of out is written (zeros for a
// destination without edges). Returns the cudaError_t of the set-up and
// the launch (0: launched).
extern "C" int heom_coupling_batched_c128(const void* F, const void* OpT,
                                          void* out, const void* args,
                                          void* stream) {
  return launch_batched<double>(F, OpT, out,
                                static_cast<const BatchArgs*>(args), stream);
}

extern "C" int heom_coupling_batched_c64(const void* F, const void* OpT,
                                         void* out, const void* args,
                                         void* stream) {
  return launch_batched<float>(F, OpT, out,
                               static_cast<const BatchArgs*>(args), stream);
}
