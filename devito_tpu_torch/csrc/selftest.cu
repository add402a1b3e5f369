// K2, the backend self-test: a miniature of the stencil kernels' data
// movement (a halo'd window copied global -> shared asynchronously, then a
// sum of two shifted views of it) run once before the first stencil launch
// of a process on a device, so that a card or toolkit that mis-builds or
// mis-runs such a kernel raises before any result is produced.
//
// Replaces the TPU kernel experiments/pallas_backend.py `validate_backend`
// (pallas_call at :101): a grid of 2 tiles, each DMA-ing the window
// x[i*T : i*T+T+2H, 0:T+2H, :] HBM -> VMEM (double-buffered across the
// tiles) and writing
//   win[H:-H, H:-H, H:H+NZ] + win[H+1:H+1+T, H:-H, H+1:H+1+NZ]
// zero-padded from NZ to ZP lanes. Here the two tiles are two CTAs that run
// side by side, so there is nothing to double-buffer: each copies its 32 KB
// window into shared memory with cp.async, waits, and writes its (T, T, ZP)
// block. Tiny and bound by launch latency; its point is the check.

#include "cp_async.cuh"

namespace {

constexpr int H = 2, T = 4, NZ = 16, ZP = 128;
constexpr int WX = T + 2 * H, WY = T + 2 * H;  // window rows and columns
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
selftest_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(16) float win[WX][WY][ZP];
  const int i = blockIdx.x;
  const float* src = x + static_cast<long long>(i) * T * WY * ZP;
  constexpr int CHUNKS = WX * WY * ZP / 4;  // 16-byte copies; rows contiguous
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS)
    dtpu::cp_async16(&win[0][0][0] + 4 * c, src + 4 * c, true);
  dtpu::cp_async_commit();
  dtpu::cp_async_wait<0>();
  __syncthreads();
  float* o = out + static_cast<long long>(i) * T * T * ZP;
  for (int e = threadIdx.x; e < T * T * ZP; e += THREADS) {
    const int a = e / (T * ZP), b = (e / ZP) % T, z = e % ZP;
    o[e] = z < NZ ? win[H + a][H + b][H + z] + win[H + 1 + a][H + b][H + 1 + z]
                  : 0.0f;
  }
}

}  // namespace

// x: (2T + 2H, T + 2H, ZP) fp32, contiguous; out: (2T, T, ZP) fp32.
extern "C" int dtpu_selftest_launch(const void* x, void* out, void* stream) {
  selftest_kernel<<<2, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
