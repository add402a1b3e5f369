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
// Here each CTA owns a (TY, TZ) tile of the (ny, za) plane and walks every
// x-chunk of it in order:
// - Each window of a chunk is one TMA box of (t0, TY, TZ) floats from a
//   tensor map over src (tma.cuh); a box axis holds at most 256 elements,
//   so for t0 > 256 a window is nbox boxes of bx rows, the last of bt.
//   The last column of tiles takes boxes of the ez = za - z0 floats left
//   of the plane's z (za % 4 == 0, so whole 16-byte rows): a zero-filled
//   box costs the card as much as one of data. Boxes past the ragged y
//   edge land zero-filled, and their bytes count all the same.
// - The ring has DEPTH slots of nwin windows, each with a full barrier
//   (count 1: the producer's arrive.expect_tx of the slot's box bytes) and
//   an empty barrier (count NCW: one arrive per consumer warp).
// - Warp NCW is the producer: its lane 0 refills slot s with chunk i once
//   the consumers have released chunk i - DEPTH from it, so chunks
//   i .. i + DEPTH - 1 are in flight while chunk i is waited for.
// - Consumer thread t owns output column z = t. Each consumer thread
//   waits for every byte of chunk i (the full barrier), adds row 0 of
//   window 0 at its output points y 0:8 inside the tile into registers, in
//   x order, so the sum is bit-equal to the reference's; then each warp
//   arrives once on the empty barrier. No __syncthreads in the chunk loop.
// - Every wait is bounded: a wrong byte count would leave a barrier
//   incomplete, and the launch traps after WAIT_NS instead of hanging.
//
// What bounds it on the card: memory. Each chunk comes from device memory
// once and nwin - 1 more times from L2 into shared memory; the output is
// 4 KB. The tile is chosen by experiments/stencil_probe7.py `stream_tile`,
// which mirrors smem_bytes.

#include "cp_async.cuh"
#include "tma.cuh"

namespace {

constexpr int H = 8;                     // x-halo rows of the buffers
constexpr int OY = 8, OZ = 128;          // the output tile, y 0:8 and z 0:128
constexpr int NCW = OZ / 32;             // consumer warps: one output column a thread
constexpr int THREADS = 32 * (NCW + 1);  // and the producer warp
constexpr int MAX_BOX = 256;             // elements of a TMA box axis
constexpr int BARS = 128;                // full[8] and empty[8] barriers
constexpr int MAX_DEPTH = BARS / 16;
constexpr unsigned long long WAIT_NS = 4000000000ull;

// By value, as a __grid_constant__ parameter: the tensor maps must live in
// parameter space for the TMA unit.
struct Args {
  CUtensorMap box[2];   // (bx, ty, tz) boxes over src; [1]: (bx, ty, ez)
  CUtensorMap tail[2];  // a window's last box: (bt, ty, tz); (bt, ty, ez)
  float* out;
  int n, t0, nwin, ty, tz, ez, bx, nbox;
};

// Dynamic shared memory of a launch: 128 bytes of alignment slack, the
// barriers, and DEPTH slots of nwin windows of (t0, ty, tz) floats.
long long smem_bytes(int depth, int nwin, int t0, int ty, int tz) {
  return 128 + BARS + 4ll * depth * nwin * t0 * ty * tz;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// dtpu::mbar_wait, trapping after WAIT_NS.
__device__ __forceinline__ void bounded_wait(uint64_t* bar, unsigned parity) {
  if (dtpu::mbar_try_wait(bar, parity)) return;
  const unsigned long long start = globaltimer();
  while (!dtpu::mbar_try_wait(bar, parity))
    if (globaltimer() - start > WAIT_NS) __trap();
}

template <int DEPTH>
__global__ void __launch_bounds__(THREADS)
stream_kernel(__grid_constant__ const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + DEPTH;
  float* ring = reinterpret_cast<float*>(base + BARS);
  const int plane = a.ty * a.tz;       // floats of one x-row of a window
  const int win = a.t0 * plane;        // floats of a window
  const int slot = a.nwin * win;       // floats of a slot
  const int y0 = blockIdx.y * a.ty, z0 = blockIdx.x * a.tz;
  // the last column's boxes are ez wide and land with that row pitch
  const int edge = blockIdx.x + 1 == gridDim.x;
  const int pitch = edge ? a.ez : a.tz;
  const int nxt = a.n / a.t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      dtpu::mbar_init(full + s, 1);
      dtpu::mbar_init(empty + s, NCW);
    }
    dtpu::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCW) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < nxt; ++i) {
        const int s = i % DEPTH;
        if (i >= DEPTH) bounded_wait(empty + s, (i / DEPTH - 1) & 1);
        dtpu::mbar_expect_tx(full + s, 4u * a.nwin * a.t0 * a.ty * pitch);
        float* dst = ring + s * slot;
        const int x = H + i * a.t0;
        for (int k = 0; k < a.nwin; ++k)
          for (int b = 0; b < a.nbox; ++b)
            dtpu::tma_load_3d(dst + k * win + b * a.bx * plane,
                              b + 1 < a.nbox ? &a.box[edge] : &a.tail[edge],
                              full + s, z0, y0, x + b * a.bx);
      }
    }
    return;
  }

  const int z = threadIdx.x;  // this thread's output column
  const bool mine = z >= z0 && z < z0 + pitch;
  float acc[OY];
#pragma unroll
  for (int y = 0; y < OY; ++y) acc[y] = 0.0f;
  for (int i = 0; i < nxt; ++i) {
    const int s = i % DEPTH;
    bounded_wait(full + s, (i / DEPTH) & 1);  // all of chunk i has landed
    if (mine) {
      const float* row = ring + s * slot + (z - z0);  // window 0, x-row 0
#pragma unroll
      for (int y = 0; y < OY; ++y)
        if (y >= y0 && y < y0 + a.ty) acc[y] += row[(y - y0) * pitch];
    }
    __syncwarp();
    if (lane == 0) dtpu::mbar_arrive(empty + s);  // slot s is free again
  }
  if (mine)
#pragma unroll
    for (int y = 0; y < OY; ++y)
      if (y >= y0 && y < y0 + a.ty) a.out[y * OZ + z] = acc[y];
}

// Launches the kernel of DEPTH on `stream`, or with `ctas` puts the CTAs
// of it that fit on one SM there instead. Returns the cudaError_t.
template <int DEPTH>
int run(const Args& a, dim3 grid, int smem, cudaStream_t stream, int* ctas) {
  const int rc = dtpu::allow_smem(stream_kernel<DEPTH>, smem);
  if (rc != 0) return rc;
  if (ctas != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, stream_kernel<DEPTH>, THREADS, smem));
  stream_kernel<DEPTH><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int depth, const Args& a, dim3 grid, int smem, cudaStream_t stream,
             int* ctas) {
  static_assert(MAX_DEPTH == 8, "a case for every depth");
  switch (depth) {
    case 1: return run<1>(a, grid, smem, stream, ctas);
    case 2: return run<2>(a, grid, smem, stream, ctas);
    case 3: return run<3>(a, grid, smem, stream, ctas);
    case 4: return run<4>(a, grid, smem, stream, ctas);
    case 5: return run<5>(a, grid, smem, stream, ctas);
    case 6: return run<6>(a, grid, smem, stream, ctas);
    case 7: return run<7>(a, grid, smem, stream, ctas);
    case 8: return run<8>(a, grid, smem, stream, ctas);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid(int depth, int nwin, int t0, int ty, int tz) {
  return depth >= 1 && depth <= MAX_DEPTH && nwin >= 1 && t0 >= 1 &&
         ty >= 1 && ty <= MAX_BOX && tz >= 32 && tz <= MAX_BOX &&
         tz % 32 == 0 && smem_bytes(depth, nwin, t0, ty, tz) <= 232448;
}

}  // namespace

// src: (ny, ny, za) fp32, contiguous, 16-byte aligned; ny = n + 16 >= 8,
// za >= 128, za % 4 == 0, n % t0 == 0; out: (8, 128) fp32, contiguous; the
// tile (ty, tz) with tz a multiple of 32 (every box lands 128-byte
// aligned), each at most 256, and the ring within 232,448 bytes of shared
// memory; 1 <= depth <= 8. Returns the cudaError_t (cudaErrorInvalidValue
// for other arguments) or a negative tensor-map error.
extern "C" int dtpu_probe7_stream_launch(const void* src, void* out, int ny, int za,
                                         int n, int t0, int nwin, int depth, int ty,
                                         int tz, void* stream) {
  if (!valid(depth, nwin, t0, ty, tz) || n % t0 != 0 || za % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.nbox = (t0 + MAX_BOX - 1) / MAX_BOX;
  a.bx = (t0 + a.nbox - 1) / a.nbox;
  const dim3 grid((za + tz - 1) / tz, (ny + ty - 1) / ty);
  a.ez = za - (grid.x - 1) * tz;
  const long long dims[3] = {ny, ny, za};
  for (int e = 0; e < 2; ++e) {
    const int bz = e ? a.ez : tz;
    int rc = dtpu::encode_map_3d<float>(&a.box[e], src, dims, ty, bz, a.bx);
    if (rc == 0)
      rc = dtpu::encode_map_3d<float>(&a.tail[e], src, dims, ty, bz,
                                      t0 - (a.nbox - 1) * a.bx);
    if (rc != 0) return rc;
  }
  a.out = static_cast<float*>(out);
  a.n = n;
  a.t0 = t0;
  a.nwin = nwin;
  a.ty = ty;
  a.tz = tz;
  return dispatch(depth, a, grid,
                  static_cast<int>(smem_bytes(depth, nwin, t0, ty, tz)),
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The CTAs of the kernel for these arguments that fit on one SM, as the
// CUDA runtime computes them from its registers, shared memory and
// threads, into *ctas. Returns the cudaError_t.
extern "C" int dtpu_probe7_stream_occupancy(int nwin, int t0, int depth, int ty,
                                            int tz, int* ctas) {
  if (!valid(depth, nwin, t0, ty, tz))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(depth, Args{}, dim3(1), static_cast<int>(smem_bytes(
                                              depth, nwin, t0, ty, tz)),
                  nullptr, ctas);
}
