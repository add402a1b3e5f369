// Tensor Memory Accelerator (TMA) copies and the mbarriers they complete on,
// for Hopper (sm_90a): the counterpart of the TPU kernels'
// `pltpu.make_async_copy` of a whole window into VMEM with a DMA semaphore.
//
// One thread asks for a whole box of a tensor to be copied from device
// memory into shared memory (`tma_load_3d`); the hardware computes the
// addresses, fills elements outside the tensor with zeros, and counts the
// bytes that land against an mbarrier in shared memory. The thread that
// issues a stage's copies first announces their bytes
// (`mbar_expect_tx`); the consumers wait on the barrier's phase parity
// (`mbar_wait`). The other threads spend no instruction on the copy. In a
// ring, consumers hand a slot back with a plain arrive on its empty
// barrier (`mbar_arrive`), which the producer waits on before it refills.
// `bounded_wait` is `mbar_wait` that traps after 4 s instead of hanging.
//
// The way back: threads write a box into shared memory, each fences its
// writes for the TMA unit (`fence_proxy_async_shared`), they meet at a
// barrier, and one thread stores the box into a tensor (`tma_store_3d`),
// closes its bulk group (`bulk_commit`) and, before that shared memory is
// written again, waits until the store has read it (`bulk_wait_read`).
//
// Host side: `encode_map_3d` describes a contiguous 3-D array to the TMA
// unit (a CUtensorMap, passed to the kernel by value as a
// `__grid_constant__` parameter). It calls libcuda's
// `cuTensorMapEncodeTiled`, looked up once through the runtime's
// `cudaGetDriverEntryPoint[ByVersion]`, so the library links against the
// CUDA runtime alone and not against libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace dtpu {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the TMA unit; a
// __syncthreads() after it makes them visible to the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once on `bar` and announce `bytes` of copies that complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Arrive once on `bar`, announcing no bytes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Whether the phase of parity `parity` of `bar` has completed, after a
// wait of at most a time the hardware chooses.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Nanoseconds after which `bounded_wait` gives up.
constexpr unsigned long long kWaitNs = 4000000000ull;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// mbar_wait, trapping after kWaitNs: a wrong byte count leaves a barrier
// incomplete, and the launch then fails instead of hanging the card.
__device__ __forceinline__ void bounded_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long start = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - start > kWaitNs) __trap();
}

// Copy the box of `map` at element coordinates (c0 innermost, c1, c2) into
// `dst` (128-byte aligned), completing on `bar`. Coordinates may be
// negative or run past the tensor: those elements land as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Make this thread's writes to shared memory visible to the TMA unit (the
// async proxy): every writing thread issues it before the barrier after
// which one thread stores what they wrote with `tma_store_3d`.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `src` (128-byte aligned shared memory) into the box of `map` at
// element coordinates (c0 innermost, c1, c2), in this thread's open bulk
// group. Elements of the box outside the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Close this thread's open bulk group of stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory: the shared memory of the others may be written again.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// -- host ---------------------------------------------------------------------

// A failed encode returns -(CUresult); no encoder at all returns this.
constexpr int kNoTensorMapEncoder = -100000;

using TensorMapEncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tensor_map_type() {
  return sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// Describe the contiguous array of T at `base` with extents `dims` (axis 0
// outermost) for boxes of (bx, by, bz) elements, by default (1, by, bz):
// one plane of x. The base must be 16-byte aligned, dims[2] * sizeof(T) a
// multiple of 16, bz * sizeof(T) a multiple of 16, and each box extent at
// most 256. Returns 0, or a negative error.
template <typename T>
int encode_map_3d(CUtensorMap* map, const void* base, const long long* dims,
                  unsigned by, unsigned bz, unsigned bx = 1) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kNoTensorMapEncoder;
  const cuuint64_t gdim[3] = {static_cast<cuuint64_t>(dims[2]),
                              static_cast<cuuint64_t>(dims[1]),
                              static_cast<cuuint64_t>(dims[0])};
  const cuuint64_t gstride[2] = {gdim[0] * sizeof(T),
                                 gdim[0] * gdim[1] * sizeof(T)};
  const cuuint32_t box[3] = {bz, by, bx};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, tensor_map_type<T>(), 3, const_cast<void*>(base), gdim, gstride,
      box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : -static_cast<int>(rc);
}

}  // namespace dtpu
