// Asynchronous global -> shared copies (cp.async, sm_80 and later), the
// Hopper counterpart of the TPU kernels' `pltpu.make_async_copy` into VMEM.
// Each call copies 16 bytes; both addresses must be 16-byte aligned. A copy
// issued with `valid == false` reads nothing and fills its 16 bytes of
// shared memory with zeros, which is how the kernels pad windows that run
// past an array's edge. Copies are grouped with `cp_async_commit` and
// waited for with `cp_async_wait<N>` (all but the newest N groups of this
// thread done); a __syncthreads() after the wait makes every thread's
// copies visible to the block.

#pragma once

#include <cuda_runtime.h>

namespace dtpu {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Launch-side: allow `bytes` of dynamic shared memory for `kernel` (needed
// above 48 KB). Returns the cudaError_t.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace dtpu
