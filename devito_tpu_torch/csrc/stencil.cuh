// Dense-stencil update for NVIDIA Hopper (sm_90a): evaluates one lowered
// dense equation's right-hand side over its write region and stores it in
// place into the target's time row.
//
// Replaces the TPU kernel experiments/pallas_backend.py `execute_plan`
// (with `plan_for`, `_plan_for` and `_TileCtxV2`). That kernel copied
// halo'd windows of every access group HBM->VMEM, double-buffered across
// tiles, and evaluated the translated right-hand side per tile. Here the
// hand-written part is this template: index arithmetic from the block and
// thread indices, one base pointer and stride set per access group, the
// bounds mask of the ragged edge, 64-bit offsets and the store. The
// per-equation part is one point expression generated from the sympy
// right-hand side (compiler/translate.py `cuda_expr`), passed in as
// `Point`, which loads each access at fixed offsets from its group's
// pointer.
//
// Storage and compute: `T` is the equation's compute type (float or
// double) and every group, and the target, has its own storage type S: T
// itself, or a narrow __nv_bfloat16 / __half row (the `storage-dtype`
// option). A load widens S to T (`ld`), the arithmetic runs in T, and the
// store rounds T to S to nearest even through float (`st`), as PyTorch's
// Tensor.to does. A warp's z-run of a narrow row is 64 contiguous bytes,
// one coalesced transaction as a float row's 128 are.
//
// What bounds it on the card: memory. The acoustic SO=8 update reads
// u[t], u[t-1], vp and damp and writes u[t+1], about five arrays of bytes
// per point (20 B in fp32, 14 B with u in bf16), for about 100 flops: far
// below the H100's ratio of flops to bytes. This design runs one thread
// per output point, z fastest so that a warp's loads and stores coalesce,
// and leaves the reuse of the 3*SO+1 taps of u[t] to the L1 and L2 caches.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <type_traits>

namespace dtpu {

// By value: the launch copies it into the kernel's parameter space, so a
// step costs no host-to-device copy and no synchronisation. The rows are
// untyped: each load and the store name their storage type.
template <typename T, int NG, int NP>
struct StencilArgs {
  void* out;                             // target row at the region's first point
  const void* in[NG > 0 ? NG : 1];       // access-group rows at the region's first point
  long long out_stride[2];               // target row strides of the outer axes
  long long stride[NG > 0 ? NG : 1][2];  // group row strides of the outer axes
  int n[3];                              // region extents, axis 0 outermost
  T p[NP > 0 ? NP : 1];                  // scalar parameters (dt, spacings, ...)
};

// The element at p of a row stored as S, through the read-only data
// cache, in T. Rows read in a launch are never written by it (plan_for
// declines equations that read their target row).
template <typename T, typename S>
__device__ __forceinline__ T ld(const S* p) {
  const S v = __ldg(p);
  if constexpr (std::is_same<S, __nv_bfloat16>::value)
    return static_cast<T>(__bfloat162float(v));
  else if constexpr (std::is_same<S, __half>::value)
    return static_cast<T>(__half2float(v));
  else
    return static_cast<T>(v);
}

// Store v into element i of a row stored as S.
template <typename S, typename T>
__device__ __forceinline__ void st(void* row, long long i, T v) {
  S* p = static_cast<S*>(row) + i;
  if constexpr (std::is_same<S, __nv_bfloat16>::value)
    *p = __float2bfloat16_rn(static_cast<float>(v));
  else if constexpr (std::is_same<S, __half>::value)
    *p = __float2half_rn(static_cast<float>(v));
  else
    *p = static_cast<S>(v);
}

// The generated point expression's loads: `g` is a group's pointer at the
// point (typed by its storage), `rel` an element offset from it.
#define DTPU_LD(g, rel) dtpu::ld<T>((g) + (rel))

// The pointer of group k, stored as S, at the point whose offset in the
// group's row is o[k]: the generated point declares one for each group.
template <typename S, typename T, int NG, int NP>
__device__ __forceinline__ const S* at(const StencilArgs<T, NG, NP>& a,
                                       const long long* o, int k) {
  return static_cast<const S*>(a.in[k]) + o[k];
}

template <typename T, typename SO, int NDIM, int NG, int NP, typename Point>
__global__ void __launch_bounds__(256)
stencil_kernel(const StencilArgs<T, NG, NP> a) {
  static_assert(NDIM == 2 || NDIM == 3, "2-D or 3-D regions only");
  // The innermost (z) axis is contiguous and runs along threadIdx.x.
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  long long off_out;
  long long o[NG > 0 ? NG : 1];
  if (NDIM == 3) {
    const int ix = blockIdx.z;
    if (iy >= a.n[1] || iz >= a.n[2]) return;
    off_out = ix * a.out_stride[0] + iy * a.out_stride[1] + iz;
#pragma unroll
    for (int k = 0; k < NG; ++k)
      o[k] = ix * a.stride[k][0] + iy * a.stride[k][1] + iz;
  } else {
    if (iy >= a.n[0] || iz >= a.n[1]) return;
    off_out = iy * a.out_stride[0] + iz;
#pragma unroll
    for (int k = 0; k < NG; ++k) o[k] = iy * a.stride[k][0] + iz;
  }
  st<SO>(a.out, off_out, Point::eval(o, a));
}

// Host side: packs the arguments and launches on `stream`. Returns the
// cudaError_t of the launch (0 on success); the caller raises otherwise.
template <typename T, typename SO, int NDIM, int NG, int NP, typename Point>
int launch(void* const* ptrs, const long long* strides, const int* n,
           const double* params, void* stream) {
  StencilArgs<T, NG, NP> a;
  a.out = ptrs[0];
  a.out_stride[0] = strides[0];
  a.out_stride[1] = strides[1];
  for (int k = 0; k < NG; ++k) {
    a.in[k] = ptrs[1 + k];
    a.stride[k][0] = strides[2 * (1 + k)];
    a.stride[k][1] = strides[2 * (1 + k) + 1];
  }
  for (int j = 0; j < 3; ++j) a.n[j] = n[j];
  for (int i = 0; i < NP; ++i) a.p[i] = static_cast<T>(params[i]);
  for (int j = 0; j < NDIM; ++j)
    if (n[j] <= 0) return 0;  // empty region: nothing to do
  const int nz = n[NDIM - 1];
  int bx = 32;
  while (bx < nz && bx < 128) bx *= 2;
  const int by = 256 / bx;
  const dim3 block(bx, by, 1);
  const dim3 grid = NDIM == 3
      ? dim3((n[2] + bx - 1) / bx, (n[1] + by - 1) / by, n[0])
      : dim3((n[1] + bx - 1) / bx, (n[0] + by - 1) / by, 1);
  stencil_kernel<T, SO, NDIM, NG, NP, Point>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dtpu
