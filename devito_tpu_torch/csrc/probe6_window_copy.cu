// K8, the window-copy probe: copies the window
//   src[x0:x0+nx, y0:y0+ny, z0:z0+nz]  ->  shared memory  ->  the same window of out
// of two (X, Y, Z) fp32 buffers, to measure what a start offset that is not
// 128-byte aligned (z0 = 8 floats = 32 bytes) costs cp.async copies of 16
// bytes, against aligned ones (z0 = 0), and a window length that is not a
// multiple of 128 bytes (nz = 272 against 256).
//
// Replaces the TPU kernel experiments/stencil_probe6.py `p2_misaligned_dma`
// (inner `mk` at :72, pallas_call at :85): one HBM -> VMEM DMA of the
// (64, 256, zlen) window at lane offset zoff, then one VMEM -> HBM DMA back
// into the same window of the output. Here each CTA copies ROWS y-rows of
// one x-row of the window into shared memory with cp.async, waits, and
// stores them to the output with 16-byte stores; the CTAs of the grid
// cover the window.
//
// What bounds it on the card: memory, nothing else; the window is read
// once and written once.

#include "cp_async.cuh"

namespace {

constexpr int ROWS = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
window_copy_kernel(const float* __restrict__ src, float* __restrict__ out,
                   int Y, int Z, int x0, int y0, int ny, int z0, int nz) {
  extern __shared__ __align__(16) float buf[];
  const int cz = nz / 4;                     // 16-byte chunks of a row
  const int yb = blockIdx.x * ROWS;
  const int rows = min(ROWS, ny - yb);
  const long long base =
      (static_cast<long long>(x0 + blockIdx.y) * Y + y0 + yb) * Z + z0;
  for (int c = threadIdx.x; c < rows * cz; c += THREADS) {
    const int r = c / cz, k = c % cz;
    dtpu::cp_async16(buf + 4 * c, src + base + r * static_cast<long long>(Z) + 4 * k,
                     true);
  }
  dtpu::cp_async_commit();
  dtpu::cp_async_wait<0>();
  __syncthreads();
  for (int c = threadIdx.x; c < rows * cz; c += THREADS) {
    const int r = c / cz, k = c % cz;
    *reinterpret_cast<float4*>(out + base + r * static_cast<long long>(Z) + 4 * k) =
        reinterpret_cast<const float4*>(buf)[c];
  }
}

}  // namespace

// src, out: (X, Y, Z) fp32, contiguous, 16-byte aligned; Z, z0 and nz
// multiples of 4; the window inside the buffers. Returns the cudaError_t.
extern "C" int dtpu_window_copy_launch(const void* src, void* out, int Y, int Z,
                                       int x0, int nx, int y0, int ny, int z0,
                                       int nz, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  const size_t smem = sizeof(float) * ROWS * nz;
  int rc = dtpu::allow_smem(window_copy_kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((ny + ROWS - 1) / ROWS, nx);
  window_copy_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(out), Y, Z, x0, y0, ny,
      z0, nz);
  return static_cast<int>(cudaGetLastError());
}
