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
// y 0:8, z 0:128 of chunk i's first window into an accumulator. Here each
// CTA owns a (TY, 64) tile of the (ny, za) plane and walks every x-chunk in
// order, with DEPTH - 1 chunks of its tile in flight by cp.async
// (probe7_windows.cuh). The threads whose tile point lies in y 0:8,
// z 0:128 add that point of window 0, row 0 into a register in x order, so
// the sum is bit-equal to the reference's. D is this kernel at DEPTH = 2.
//
// What bounds it on the card: memory. Each chunk comes from device memory
// once and nwin - 1 more times from L2; the output is 4 KB.

#include "cp_async.cuh"
#include "probe7_windows.cuh"

namespace {

using namespace dtpu::probe7;

constexpr int OY = 8, OZ = 128;  // the output tile, y 0:8 and z 0:128

template <int DEPTH>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const float* __restrict__ src, float* __restrict__ out, int ny, int za,
              int n, int t0, int nwin, int lty) {
  extern __shared__ __align__(16) float win[];
  const int y0 = blockIdx.y << lty, z0 = blockIdx.x * TZ;
  const int slot = slot_floats(nwin, t0, lty);
  const int nxt = n / t0;
#pragma unroll
  for (int p = 0; p < DEPTH - 1; ++p) {
    if (p < nxt) issue(win + p * slot, src, H + p * t0, t0, nwin, 1, ny, za, y0, z0, lty);
    dtpu::cp_async_commit();
  }
  // this thread's point of the tile; window 0, row 0 holds it at threadIdx.x
  const int gy = y0 + (threadIdx.x >> 6), gz = z0 + (threadIdx.x & (TZ - 1));
  const bool mine = (threadIdx.x >> 6) < (1 << lty) && gy < OY && gz < OZ;
  float acc = 0.0f;
  for (int i = 0; i < nxt; ++i) {
    const int f = i + DEPTH - 1;
    if (f < nxt) issue(win + (f % DEPTH) * slot, src, H + f * t0, t0, nwin, 1, ny, za, y0, z0, lty);
    dtpu::cp_async_commit();
    dtpu::cp_async_wait<DEPTH - 1>();  // chunk i has landed
    __syncthreads();
    if (mine) acc += win[(i % DEPTH) * slot + threadIdx.x];
    __syncthreads();  // the slot of chunk i is free for chunk i + DEPTH
  }
  dtpu::cp_async_wait<0>();
  if (mine) out[gy * OZ + gz] = acc;
}

template <int DEPTH>
int launch(const float* src, float* out, int ny, int za, int n, int t0, int nwin,
           int lty, cudaStream_t stream) {
  const size_t smem = sizeof(float) * DEPTH * slot_floats(nwin, t0, lty);
  int rc = dtpu::allow_smem(stream_kernel<DEPTH>, smem);
  if (rc != 0) return rc;
  const dim3 grid((za + TZ - 1) / TZ, ((ny - 1) >> lty) + 1);
  stream_kernel<DEPTH><<<grid, THREADS, smem, stream>>>(src, out, ny, za, n, t0, nwin, lty);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (ny, ny, za) fp32, contiguous, 16-byte aligned; ny = n + 16 >= 8,
// za >= 128, za % 4 == 0, n % t0 == 0; out: (8, 128) fp32, contiguous; the
// tile (1 << lty, 64) with lty <= 2; 1 <= depth <= 8, and depth slots of
// shared memory. Returns the cudaError_t (cudaErrorInvalidValue for another
// depth).
extern "C" int dtpu_probe7_stream_launch(const void* src, void* out, int ny, int za,
                                         int n, int t0, int nwin, int depth, int lty,
                                         void* stream) {
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1: return launch<1>(s, o, ny, za, n, t0, nwin, lty, st);
    case 2: return launch<2>(s, o, ny, za, n, t0, nwin, lty, st);
    case 3: return launch<3>(s, o, ny, za, n, t0, nwin, lty, st);
    case 4: return launch<4>(s, o, ny, za, n, t0, nwin, lty, st);
    case 5: return launch<5>(s, o, ny, za, n, t0, nwin, lty, st);
    case 6: return launch<6>(s, o, ny, za, n, t0, nwin, lty, st);
    case 7: return launch<7>(s, o, ny, za, n, t0, nwin, lty, st);
    case 8: return launch<8>(s, o, ny, za, n, t0, nwin, lty, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
