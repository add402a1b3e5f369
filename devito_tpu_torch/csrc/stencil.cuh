// Dense-stencil update for NVIDIA Hopper (sm_90a): evaluates the
// right-hand sides of NT lowered dense equations over their one write
// region and stores each in place into its target's time row. NT is 1 for
// a single equation; a fused unit (kernels/stencil.py `plan_run`) takes a
// run of mutually independent equations of one region, and reads each
// access group they share through one pointer, once a point.
//
// Replaces the TPU kernel experiments/pallas_backend.py `execute_plan`
// (with `plan_for`, `_plan_for` and `_TileCtxV2`). That kernel copied
// halo'd windows of every access group HBM->VMEM, double-buffered across
// tiles, and evaluated the translated right-hand side per tile. Here the
// hand-written part is this template: index arithmetic from the block and
// thread indices, one base pointer and stride set per access group, the
// bounds mask of the ragged edge, 64-bit offsets and the store. The
// per-equation part is one point expression a target generated from the
// sympy right-hand side (compiler/translate.py `cuda_expr`), passed in as
// `Point`, which loads each access at fixed offsets from its group's
// pointer and writes the NT values of the point.
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
template <typename T, int NG, int NP, int NT = 1>
struct StencilArgs {
  void* out[NT];                         // target rows at the region's first point
  const void* in[NG > 0 ? NG : 1];       // access-group rows at the region's first point
  long long out_stride[NT][2];           // target row strides of the outer axes
  long long stride[NG > 0 ? NG : 1][2];  // group row strides of the outer axes
  int n[3];                              // region extents, axis 0 outermost
  T p[NP > 0 ? NP : 1];                  // scalar parameters (dt, spacings, ...)
};

// The element at p of a row stored as S, through the read-only data
// cache, in T. Rows read in a launch are never written by it (plan_for
// declines equations that read their target row, and plan_run fuses no
// equation that reads a row another of the unit writes).
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
template <typename S, typename T, int NG, int NP, int NT>
__device__ __forceinline__ const S* at(const StencilArgs<T, NG, NP, NT>& a,
                                       const long long* o, int k) {
  return static_cast<const S*>(a.in[k]) + o[k];
}

// Every target row is stored as SO (kernels/stencil.py fuses only
// equations whose targets share a storage type).
template <typename T, typename SO, int NDIM, int NG, int NP, int NT,
          typename Point>
__global__ void __launch_bounds__(256)
stencil_kernel(const StencilArgs<T, NG, NP, NT> a) {
  static_assert(NDIM == 2 || NDIM == 3, "2-D or 3-D regions only");
  // The innermost (z) axis is contiguous and runs along threadIdx.x.
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  long long off_out[NT];
  long long o[NG > 0 ? NG : 1];
  if (NDIM == 3) {
    // grid.z walks the x planes of one chunk of grid.y row blocks, then
    // the next chunk's (see `launch`); one chunk needs no division
    const bool one = gridDim.z == a.n[0];
    const int ix = one ? blockIdx.z : blockIdx.z % a.n[0];
    const int iy = ((one ? 0 : blockIdx.z / a.n[0]) * gridDim.y +
                    blockIdx.y) * blockDim.y + threadIdx.y;
    if (iy >= a.n[1] || iz >= a.n[2]) return;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      off_out[j] = ix * a.out_stride[j][0] + iy * a.out_stride[j][1] + iz;
#pragma unroll
    for (int k = 0; k < NG; ++k)
      o[k] = ix * a.stride[k][0] + iy * a.stride[k][1] + iz;
  } else {
    const int iy = blockIdx.y * blockDim.y + threadIdx.y;
    if (iy >= a.n[0] || iz >= a.n[1]) return;
#pragma unroll
    for (int j = 0; j < NT; ++j) off_out[j] = iy * a.out_stride[j][0] + iz;
#pragma unroll
    for (int k = 0; k < NG; ++k) o[k] = iy * a.stride[k][0] + iz;
  }
  T v[NT];
  Point::eval(o, a, v);
#pragma unroll
  for (int j = 0; j < NT; ++j) st<SO>(a.out[j], off_out[j], v[j]);
}

// Host side: packs the arguments and launches on `stream`. `ptrs` and
// `strides` hold the NT targets' rows first, then the NG groups'; `n` the
// region's three extents, then the rows (axis 1) of a chunk of a 3-D
// region: its blocks run the chunk's rows of every x plane before the
// next chunk's, so that the planes an x tap reads stay in L2 while the
// planes beside them run (0: one chunk, every x plane whole in turn).
// Returns the cudaError_t of the launch (0 on success); the caller raises
// otherwise.
template <typename T, typename SO, int NDIM, int NG, int NP, int NT,
          typename Point>
int launch(void* const* ptrs, const long long* strides, const int* n,
           const double* params, void* stream) {
  StencilArgs<T, NG, NP, NT> a;
  for (int j = 0; j < NT; ++j) {
    a.out[j] = ptrs[j];
    a.out_stride[j][0] = strides[2 * j];
    a.out_stride[j][1] = strides[2 * j + 1];
  }
  for (int k = 0; k < NG; ++k) {
    a.in[k] = ptrs[NT + k];
    a.stride[k][0] = strides[2 * (NT + k)];
    a.stride[k][1] = strides[2 * (NT + k) + 1];
  }
  for (int j = 0; j < 3; ++j) a.n[j] = n[j];
  for (int i = 0; i < NP; ++i) a.p[i] = static_cast<T>(params[i]);
  for (int j = 0; j < NDIM; ++j)
    if (n[j] <= 0) return 0;  // empty region: nothing to do
  // 64 z points by 4 rows: within 1 % of 128 by 2 or faster on every
  // unit of the elastic and TTI cells on the H100, 5 % faster on the
  // fused velocities (PERF.md §6)
  const int nz = n[NDIM - 1];
  int bx = 32;
  while (bx < nz && bx < 64) bx *= 2;
  const int by = 256 / bx;
  const dim3 block(bx, by, 1);
  dim3 grid((n[NDIM - 1] + bx - 1) / bx, (n[NDIM - 2] + by - 1) / by, 1);
  if (NDIM == 3) {
    // row blocks of the region and of a chunk; grid.z: the chunks' planes
    const int blocks = grid.y;
    int chunk = n[3] > 0 ? (n[3] + by - 1) / by : blocks;
    while (chunk < blocks &&
           (long long)n[0] * ((blocks + chunk - 1) / chunk) > 65535)
      chunk *= 2;
    grid.y = chunk < blocks ? chunk : blocks;
    grid.z = n[0] * ((blocks + grid.y - 1) / grid.y);
  }
  stencil_kernel<T, SO, NDIM, NG, NP, NT, Point>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dtpu
