// Helpers shared by the kernels: `cp.async` copies from global into shared
// memory, the card's SM count, and whether a pointer is device memory.
// Included by the *.cu files that use them (and by tensor_core.cuh); the
// build hashes it with the sources and compiles only the *.cu files.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cu {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy `bytes` (0, or all of the copy's 4, 8 or 16) from global to shared
// memory, zero-filling what is not copied. The 16-byte copy bypasses L1
// (.cg, which takes only 16 bytes); the smaller ones go through it (.ca).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The current device's SM count, cached per device (132, an H100 SXM's,
// when CUDA cannot tell).
inline int sm_count() {
  static int cached[64];               // per device; a race writes the same
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      return 132;
    cached[dev] = sms;
  }
  return cached[dev];
}

// True when `p` is device memory (false for mapped host memory, and when
// CUDA cannot tell).
inline bool on_device(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();                // keep the launch's check clean
    return false;
  }
  return a.type == cudaMemoryTypeDevice;
}

}  // namespace cu
