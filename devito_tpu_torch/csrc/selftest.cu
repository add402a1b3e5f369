// K2, the backend self-test: a miniature of the stencil kernels' data
// movement -- halo'd windows loaded global -> shared as TMA boxes that
// complete on mbarriers, double-buffered, then a sum of two shifted views
// of each -- run once before the first stencil launch of a process on a
// device, so that a card or toolkit that mis-builds or mis-runs such a
// kernel raises before any result is produced. K1's streaming design
// (csrc/stencil_stream.cuh) loads its tiles through the same path
// (csrc/tma.cuh): the tensor map, `mbar_expect_tx` and `bounded_wait`.
//
// Replaces the TPU kernel experiments/pallas_backend.py `validate_backend`
// (pallas_call at :101): a grid of 2 tiles, each DMA-ing the window
// x[i*T : i*T+T+2H, 0:T+2H, :] HBM -> VMEM into one of two slots, tile
// i+1's copy started before tile i's is waited on, and writing
//   win[H:-H, H:-H, H:H+NZ] + win[H+1:H+1+T, H:-H, H+1:H+1+NZ]
// zero-padded from NZ to ZP lanes. Here one CTA walks the two tiles as the
// TPU grid does: thread 0 issues tile 0's box into slot 0 and tile 1's
// into slot 1 before the block waits on tile 0's full barrier; each box is
// (T+2H, T+2H, ZP) = (8, 8, 128) fp32, 32 KB a slot, 64 KB of dynamic
// shared memory. Every wait traps after 4 s (`bounded_wait`), so a wrong
// byte count fails the launch instead of hanging the card.
//
// What bounds it on the card: the launch. It moves 48 KB and does 4096
// additions, so its cost is the host's path to a launch and the device's
// launch latency; the entry takes the device index and the raw stream and
// sets the device only when it is not the current one, as K12's does
// (csrc/probe7_empty.cu).

#include "tma.cuh"

namespace {

constexpr int H = 2, T = 4, NZ = 16, ZP = 128;
constexpr int WX = T + 2 * H, WY = T + 2 * H;  // window rows and columns
constexpr int TILES = 2, THREADS = 256;
constexpr int SLOT = WX * WY * ZP;             // floats of a slot
constexpr unsigned BOX_BYTES = SLOT * sizeof(float);
// the two slots, 128-byte aligned, then the two full barriers
constexpr int SMEM = 128 + TILES * SLOT * sizeof(float) + TILES * sizeof(uint64_t);

__global__ void __launch_bounds__(THREADS)
selftest_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ out) {
  extern __shared__ unsigned char raw[];
  float* slots = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(raw) + 127) & ~static_cast<uintptr_t>(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + TILES * SLOT);
  if (threadIdx.x == 0) {
    for (int s = 0; s < TILES; ++s) dtpu::mbar_init(&full[s], 1);
    dtpu::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // both tiles' boxes in flight before tile 0 is summed
    for (int i = 0; i < TILES; ++i) {
      dtpu::mbar_expect_tx(&full[i], BOX_BYTES);
      dtpu::tma_load_3d(slots + i * SLOT, &map, &full[i], 0, 0, i * T);
    }
  }
  for (int i = 0; i < TILES; ++i) {
    dtpu::bounded_wait(&full[i], 0);
    const float* win = slots + i * SLOT;
    float* o = out + static_cast<long long>(i) * T * T * ZP;
    for (int e = threadIdx.x; e < T * T * ZP; e += THREADS) {
      const int a = e / (T * ZP), b = (e / ZP) % T, z = e % ZP;
      o[e] = z < NZ ? win[((H + a) * WY + H + b) * ZP + H + z] +
                          win[((H + 1 + a) * WY + H + b) * ZP + H + 1 + z]
                    : 0.0f;
    }
  }
}

// Per device: whether the kernel's dynamic shared memory limit is set.
bool smem_set[64];

}  // namespace

// x: (2T + 2H, T + 2H, ZP) fp32, contiguous, 16-byte aligned; out:
// (2T, T, ZP) fp32; both on device `device`, `stream` a stream of it.
// Launches there, the current device restored after. Returns the
// cudaError_t, or -(CUresult) when the tensor map cannot be encoded
// (-100000: no encoder).
extern "C" int dtpu_selftest_launch(const void* x, void* out, int device, void* stream) {
  int cur = 0;
  cudaError_t rc = cudaGetDevice(&cur);
  if (rc == cudaSuccess && cur != device) rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[device]) {
    rc = cudaFuncSetAttribute(selftest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM);
    smem_set[device] = rc == cudaSuccess;
  }
  int err = static_cast<int>(rc);
  if (rc == cudaSuccess) {
    CUtensorMap map;
    const long long dims[3] = {TILES * T + 2 * H, WY, ZP};
    err = dtpu::encode_map_3d<float>(&map, x, dims, WY, ZP, WX);
    if (err == 0) {
      selftest_kernel<<<1, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
          map, static_cast<float*>(out));
      err = static_cast<int>(cudaGetLastError());
    }
  }
  if (cur != device) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == 0) err = static_cast<int>(back);
  }
  return err;
}
