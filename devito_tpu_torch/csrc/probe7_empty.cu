// K12, the launch probe: one launch of `reps` CTAs of which only the last,
// blockIdx.x == reps - 1, writes, filling an (8, 128) fp32 tensor with
// reps - 1.
//
// Replaces the TPU kernel experiments/stencil_probe7.py `probe_C`
// (pallas_call at :194): a grid of reps steps, each writing its
// program_id into the whole (8, 128) output; the TPU grid runs in order, so
// the last step's value, reps - 1, is what remains. CUDA blocks run in no
// order, so here only the last block writes, and the result is the same.
//
// What bounds it on the card: the launch. It moves 4 KB and does no
// arithmetic, so its time a call is the host's cost of a launch, and in a
// CUDA graph the device's. The design is the launch path: the entry takes
// the device index and the raw stream, so that the wrapper needs neither a
// Python device guard nor a Stream object, and sets the device only when
// it is not the current one.

#include <cuda_runtime.h>

namespace {

constexpr int OUT = 8 * 128, THREADS = 128;

__global__ void __launch_bounds__(THREADS) empty_kernel(float* __restrict__ out, int reps) {
  if (static_cast<int>(blockIdx.x) != reps - 1) return;
  for (int i = threadIdx.x; i < OUT; i += THREADS) out[i] = static_cast<float>(reps - 1);
}

}  // namespace

// out: (8, 128) fp32, contiguous, on device `device`; reps >= 1; `stream`
// a stream of that device. Launches there, the current device restored
// after. Returns the cudaError_t.
extern "C" int dtpu_probe7_empty_launch(void* out, int reps, int device, void* stream) {
  int cur = 0;
  cudaError_t rc = cudaGetDevice(&cur);
  if (rc == cudaSuccess && cur != device) rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  empty_kernel<<<reps, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), reps);
  rc = cudaGetLastError();
  if (cur != device) {
    const cudaError_t back = cudaSetDevice(cur);
    if (rc == cudaSuccess) rc = back;
  }
  return static_cast<int>(rc);
}
