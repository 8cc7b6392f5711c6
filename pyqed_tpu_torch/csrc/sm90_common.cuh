// Helpers shared by the hand-written Hopper (sm_90a) kernels of
// pyqed_tpu_torch: interleaved complex types, asynchronous copies from
// global to shared memory (cp.async), the FP64 tensor-core product
// (DMMA) and the opt-in to more than 48 KB of dynamic shared memory. Included by heom_coupling.cu and
// liouvillian.cu; ops/_cuda_lib.py hashes it into each library's name, so
// an edit here rebuilds both.
#pragma once
#include <cuda_runtime.h>

namespace pyqed {

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

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Start an asynchronous copy of kBytes (4, 8 or 16) from global memory at
// src to shared memory at dst. With valid false nothing is read and dst
// is filled with zeros (src must still be a mapped address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "cp.async size");
  const int src_bytes = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_address(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_address(dst)),
                 "l"(src), "n"(kBytes), "r"(src_bytes));
  }
}

// Close the group of copies started by this thread since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's committed groups are still
// in flight. The copies are visible to other threads after a barrier.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// d += a b for one warp on the FP64 tensor cores (m16n8k8). With
// g = lane / 4 and t = lane % 4 (PTX ISA, mma.m16n8k8 .f64), a[i] holds
// A(g + 8 (i % 2), t + 4 (i / 2)), b[i] holds B(t + 4 i, g) and d[i]
// holds D(g + 8 (i / 2), 2 t + i % 2).
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The dynamic shared memory a kernel was allowed on each device, so that
// cudaFuncSetAttribute runs once per device and not before every launch.
// One static instance per kernel.
struct SmemAllowance {
  static constexpr int kDevices = 64;
  int bytes[kDevices] = {};

  cudaError_t ensure(const void* kernel, int need) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && bytes[dev] >= need) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err == cudaSuccess && dev < kDevices) bytes[dev] = need;
    return err;
  }
};

}  // namespace pyqed
