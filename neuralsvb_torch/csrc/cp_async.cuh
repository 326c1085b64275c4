// cp.async (Ampere and later) copies from global into shared memory, for the
// port's hand-written FFMA convolution kernels (dilated_conv_backward.cu,
// mrd_conv_backward.cu): each source file of a library includes it once.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// V floats (4 or 16 bytes), of which the first n are copied and the rest
// zero-filled (src must still be a device address when n is 0)
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int n) {
  static_assert(V == 1 || V == 4, "4- or 16-byte copies");
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(4 * n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(4 * n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace
