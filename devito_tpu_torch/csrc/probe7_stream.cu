// K13 and K14, the read-pipeline probes: one launch streams the x-chunks of
// src[H:H+n] of a (ny, ny, za) fp32 buffer, ny = n + 16, through a ring of
// DEPTH slots of nwin windows each, and returns
//   out = sum over i = 0 .. n/t0 - 1, in that order, of src[H + i t0, 0:8, 0:128],
// an (8, 128) fp32 tensor.
//
// Replaces the TPU kernels experiments/stencil_probe7.py `probe_D` (K13,
// pallas_call at :243: depth 2) and `probe_E` (K14, pallas_call at :305:
// depth d, the JAX default 3): one kernel invocation whose fori_loop over
// the x-chunks keeps the DMAs of chunks i + 1 .. i + d - 1 (nwin windows of
// the same rows each) in flight while it waits for chunk i, and adds row 0,
// y 0:8, z 0:128 of chunk i's first window into an accumulator.
//
// Here each CTA owns a (TY, TZ) tile of the (ny, za) plane and streams
// every x-chunk of it through the ring of probe7_ring.cuh: DEPTH slots of
// nwin windows, each window one TMA box (several for t0 > 256), fed by a
// producer warp through full and empty barriers. Consumer thread t owns
// output column z = t: it waits for every byte of chunk i (the full
// barrier), adds row 0 of window 0 at its output points y 0:8 inside the
// tile into registers, in x order, so the sum is bit-equal to the
// reference's; then each warp releases the slot. No __syncthreads in the
// chunk loop.
//
// What bounds it on the card: memory. Each chunk comes from device memory
// once and nwin - 1 more times from L2 into shared memory; the output is
// 4 KB.

#include "probe7_ring.cuh"

namespace {

using namespace dtpu::ring;

constexpr int OY = 8, OZ = 128;  // the output tile, y 0:8 and z 0:128
static_assert(NCT == OZ, "one output column a consumer thread");

struct Args {
  Ring r;
  float* out;
};

__global__ void __launch_bounds__(THREADS)
stream_kernel(__grid_constant__ const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const Geo r = a.r.g;
  const Smem sm = init(r, smem_raw);
  const Tile tl = tile_of(r);
  if (threadIdx.x >= NCT) {  // the producer warp
    if (threadIdx.x == NCT) produce(a.r.src, r, sm, tl);
    return;
  }

  const int z = threadIdx.x;  // this thread's output column
  const bool mine = z >= tl.z0 && z < tl.z0 + tl.pitch;
  const int slot = r.nwin * r.t0 * r.ty * r.tz;  // floats of a slot
  float acc[OY];
#pragma unroll
  for (int y = 0; y < OY; ++y) acc[y] = 0.0f;
  Cursor c;
  for (int i = 0; i < r.n / r.t0; ++i) {
    dtpu::bounded_wait(sm.full + c.s, c.phase);  // all of chunk i has landed
    if (mine) {
      const float* row = sm.slots + c.s * slot + (z - tl.z0);  // window 0, x-row 0
#pragma unroll
      for (int y = 0; y < OY; ++y)
        if (y >= tl.y0 && y < tl.y0 + r.ty) acc[y] += row[(y - tl.y0) * tl.pitch];
    }
    release(sm, c.s);
    c.next(r.depth);
  }
  if (mine)
#pragma unroll
    for (int y = 0; y < OY; ++y)
      if (y >= tl.y0 && y < tl.y0 + r.ty) a.out[y * OZ + z] = acc[y];
}

}  // namespace

// src: (ny, ny, za) fp32, contiguous, 16-byte aligned; ny = n + 16 >= 8,
// za >= 128, za % 4 == 0, n % t0 == 0; out: (8, 128) fp32, contiguous; the
// tile (ty, tz), depth and ring as dtpu::ring::valid takes them. Returns
// the cudaError_t (cudaErrorInvalidValue for other arguments) or a
// negative tensor-map error.
extern "C" int dtpu_probe7_stream_launch(const void* src, void* out, int ny, int za,
                                         int n, int t0, int nwin, int depth, int ty,
                                         int tz, void* stream) {
  Args a;
  dim3 grid;
  if (!valid(depth, nwin, t0, ty, tz, 0) ||
      !plan(&a.r.g, &grid, ny, za, n, t0, nwin, 1, depth, ty, tz))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = encode(&a.r.src, a.r.g, src, ny, za);
  if (rc != 0) return rc;
  a.out = static_cast<float*>(out);
  return launch(stream_kernel, a, grid, smem_bytes(depth, nwin, t0, ty, tz, 0),
                static_cast<cudaStream_t>(stream), nullptr);
}

// The CTAs of the kernel for these arguments that fit on one SM, as the
// CUDA runtime computes them from its registers, shared memory and
// threads, into *ctas. Returns the cudaError_t.
extern "C" int dtpu_probe7_stream_occupancy(int nwin, int t0, int depth, int ty,
                                            int tz, int* ctas) {
  if (!valid(depth, nwin, t0, ty, tz, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(stream_kernel, Args{}, dim3(1), smem_bytes(depth, nwin, t0, ty, tz, 0),
                nullptr, ctas);
}
