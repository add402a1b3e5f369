// K10, the streamed window-copy probe: with write-back
//   out[H:H+n] = src[H:H+n] + 1,
// and without it only the reads, over two (ny, ny, za) fp32 buffers,
// ny = n + 16. The x-halo rows of out are never written.
//
// Replaces the TPU kernel experiments/stencil_probe7.py `probe_A`
// (pallas_call at :94): a grid of n / t0 steps, run in order, each waiting
// for nwin DMAs of the x-chunk src[H + i t0 : H + (i+1) t0] (all nwin of the
// same rows, each split into nsplit DMAs of t0 / nsplit rows) into a 2-slot
// VMEM ring while the next chunk's DMAs run, and with write-back storing
// window 0 + 1 into the same rows of out. CUDA blocks run in no order, so
// here each CTA owns a (TY, 64) tile of the (ny, za) plane and walks the
// x-chunks in order itself: the loop inside the block takes the place of the
// sequential grid. cp.async brings chunk i + 1's nwin windows of the tile
// into the other slot of a 2-slot ring in shared memory while chunk i is
// consumed (probe7_windows.cuh). nsplit issues each window's copy as nsplit
// blocks of rows, one after another; on this card a copy is a set of
// 16-byte requests, one per thread and chunk, either way.
//
// What bounds it on the card: memory. Each chunk comes from device memory
// once and nwin - 1 more times from L2; with write-back each point of
// src[H:H+n] is read once and each of out[H:H+n] written once.

#include "cp_async.cuh"
#include "probe7_windows.cuh"

namespace {

using namespace dtpu::probe7;

__global__ void __launch_bounds__(THREADS)
copy_kernel(const float* __restrict__ src, float* __restrict__ out, int ny, int za,
            int n, int t0, int nwin, int nsplit, int writeback, int lty) {
  extern __shared__ __align__(16) float win[];
  const int y0 = blockIdx.y << lty, z0 = blockIdx.x * TZ;
  const int per_row = CZ << lty;
  const int slot = slot_floats(nwin, t0, lty);
  const int nxt = n / t0;
  issue(win, src, H, t0, nwin, nsplit, ny, za, y0, z0, lty);
  dtpu::cp_async_commit();
  for (int i = 0; i < nxt; ++i) {
    if (i + 1 < nxt)
      issue(win + ((i + 1) & 1) * slot, src, H + (i + 1) * t0, t0, nwin, nsplit, ny,
            za, y0, z0, lty);
    dtpu::cp_async_commit();
    dtpu::cp_async_wait<1>();  // chunk i has landed, chunk i + 1 is in flight
    __syncthreads();
    if (writeback) {
      // window 0 of the chunk: its 16-byte chunk c is in x-row c / per_row
      const float4* w0 = reinterpret_cast<const float4*>(win + (i & 1) * slot);
      for (int c = threadIdx.x; c < t0 * per_row; c += THREADS) {
        const int r = c >> (4 + lty), q = c & (per_row - 1);
        const int gy = y0 + (q >> 4), gz = z0 + 4 * (q & (CZ - 1));
        if (gy < ny && gz < za) {
          float4 v = w0[c];
          v.x += 1.0f;
          v.y += 1.0f;
          v.z += 1.0f;
          v.w += 1.0f;
          *reinterpret_cast<float4*>(
              out + ((static_cast<long long>(H) + i * t0 + r) * ny + gy) * za + gz) = v;
        }
      }
    }
    __syncthreads();  // the slot of chunk i is free for chunk i + 2
  }
  dtpu::cp_async_wait<0>();
}

}  // namespace

// src, out: (ny, ny, za) fp32, contiguous, 16-byte aligned; ny = n + 16,
// za % 4 == 0, n % t0 == 0, t0 % nsplit == 0; the tile (1 << lty, 64) with
// lty <= 2, and two slots of shared memory. Returns the cudaError_t.
extern "C" int dtpu_probe7_copy_launch(const void* src, void* out, int ny, int za,
                                       int n, int t0, int nwin, int nsplit,
                                       int writeback, int lty, void* stream) {
  const size_t smem = sizeof(float) * 2 * slot_floats(nwin, t0, lty);
  int rc = dtpu::allow_smem(copy_kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((za + TZ - 1) / TZ, ((ny - 1) >> lty) + 1);
  copy_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(out), ny, za, n, t0, nwin,
      nsplit, writeback, lty);
  return static_cast<int>(cudaGetLastError());
}
