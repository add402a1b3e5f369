// K10, the streamed window-copy probe: with write-back
//   out[H:H+n] = src[H:H+n] + 1,
// and without it only the reads, over two (ny, ny, za) fp32 buffers,
// ny = n + 16. The x-halo rows of out, and without write-back all of out,
// are never written.
//
// Replaces the TPU kernel experiments/stencil_probe7.py `probe_A`
// (pallas_call at :94): a grid of n / t0 steps, run in order, each waiting
// for nwin DMAs of the x-chunk src[H + i t0 : H + (i+1) t0] (all nwin of the
// same rows, each split into nsplit DMAs of t0 / nsplit rows) into a 2-slot
// VMEM ring while the next chunk's DMAs run, and with write-back storing
// window 0 + 1 into the same rows of out.
//
// What bounds it on the card: memory. With write-back each point of
// src[H:H+n] is read once and each of out[H:H+n] written once (2 S bytes,
// S = 4 n ny za); each chunk also comes nwin - 1 more times from L2 into
// shared memory, and the delivery into shared memory (about 7.4 TB/s on
// the H100, PERF.md §6) binds K13/K14 at nwin 4 before device memory does.
// So the design keeps loads and stores in flight at once, with no thread
// spending instructions on moving bytes:
// - Loads: the ring of probe7_ring.cuh, DEPTH slots fed with TMA boxes by
//   a producer warp through full and empty barriers.
// - Stores, with write-back: the consumer warps add 1 to window 0 of chunk
//   i into staging window i % 2, releasing the slot at once; each writing
//   thread fences its writes for the TMA unit; consumer thread 0 waits
//   until the store of chunk i - 1, from the other staging window, has
//   read it, so that the next chunk may write it; the consumers meet at a
//   named barrier (the producer never reaches it); thread 0 stores the
//   window to out at row H + i t0 with TMA boxes of the loads' shape and
//   commits them as one bulk group. So one store is in flight while the
//   next chunk is written. TMA stores clip at the tensor's edge, so the
//   ragged y and z edges need no masks.
// - No __syncthreads in the chunk loop; the CTA waits for its stores
//   before it exits.

#include "probe7_ring.cuh"

namespace {

using namespace dtpu::ring;

constexpr int STAGES = 2;     // staging windows of the write-back
constexpr int CONSUMERS = 1;  // the consumers' named barrier

struct Args {
  Ring r;
  Maps out;  // the loads' boxes, over out
  int wb;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(CONSUMERS), "n"(NCT) : "memory");
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(__grid_constant__ const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const Geo r = a.r.g;
  const bool wb = a.wb;
  const Smem sm = init(r, smem_raw);
  const Tile tl = tile_of(r);
  if (threadIdx.x >= NCT) {  // the producer warp
    if (threadIdx.x == NCT) produce(a.r.src, r, sm, tl);
    return;
  }
  const CUtensorMap* maps = a.out.m[tl.edge];

  const int plane = r.ty * r.tz;  // floats of one x-row of a window
  const int win = r.t0 * plane;   // floats of a window
  float* stage = sm.slots + r.depth * r.nwin * win;
  const int t = threadIdx.x;
  Cursor c;
  for (int i = 0; i < r.n / r.t0; ++i) {
    dtpu::bounded_wait(sm.full + c.s, c.phase);  // all of chunk i has landed
    float* st = stage + (i % STAGES) * win;
    if (wb) {
      // window 0 + 1 into the staging window; in the last column the box
      // rows are ez floats apart and the rest of the room is never stored
      const float4* w = reinterpret_cast<const float4*>(sm.slots + c.s * r.nwin * win);
      float4* o = reinterpret_cast<float4*>(st);
      for (int q = t; q < win / 4; q += NCT) {
        float4 v = w[q];
        v.x += 1.0f;
        v.y += 1.0f;
        v.z += 1.0f;
        v.w += 1.0f;
        o[q] = v;
      }
      dtpu::fence_proxy_async_shared();
    }
    release(sm, c.s);
    if (wb) {
      // the staging window chunk i + 1 writes was stored from chunk i - 1
      if (t == 0) dtpu::bulk_wait_read<0>();
      consumers_sync();
      if (t == 0) {
        for (int r0 = 0; r0 < r.t0; r0 += r.rps)
          for (int b = 0; b < r.nbox; ++b) {
            const int row = r0 + b * r.bx;
            dtpu::tma_store_3d(maps + (b + 1 == r.nbox), st + row * plane,
                               tl.z0, tl.y0, H + i * r.t0 + row);
          }
        dtpu::bulk_commit();
      }
    }
    c.next(r.depth);
  }
  if (wb && t == 0) dtpu::bulk_wait<0>();
}

long long smem_of(int depth, int nwin, int t0, int ty, int tz, int wb) {
  return smem_bytes(depth, nwin, t0, ty, tz, wb ? STAGES : 0);
}

}  // namespace

// src, out: (ny, ny, za) fp32, contiguous, 16-byte aligned; ny = n + 16,
// za % 4 == 0, n % t0 == 0, t0 % nsplit == 0; the tile (ty, tz), depth and
// ring as dtpu::ring::valid takes them, with write-back two staging
// windows more. Returns the cudaError_t (cudaErrorInvalidValue for other
// arguments) or a negative tensor-map error.
extern "C" int dtpu_probe7_copy_launch(const void* src, void* out, int ny, int za,
                                       int n, int t0, int nwin, int nsplit, int wb,
                                       int depth, int ty, int tz, void* stream) {
  wb = wb != 0;
  Args a;
  dim3 grid;
  if (!valid(depth, nwin, t0, ty, tz, wb ? STAGES : 0) ||
      !plan(&a.r.g, &grid, ny, za, n, t0, nwin, nsplit, depth, ty, tz))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = encode(&a.r.src, a.r.g, src, ny, za);
  if (rc == 0) rc = encode(&a.out, a.r.g, out, ny, za);
  if (rc != 0) return rc;
  a.wb = wb;
  return launch(copy_kernel, a, grid, smem_of(depth, nwin, t0, ty, tz, wb),
                static_cast<cudaStream_t>(stream), nullptr);
}

// The CTAs of the kernel for these arguments that fit on one SM, as the
// CUDA runtime computes them from its registers, shared memory and
// threads, into *ctas. Returns the cudaError_t.
extern "C" int dtpu_probe7_copy_occupancy(int nwin, int t0, int depth, int ty, int tz,
                                          int wb, int* ctas) {
  wb = wb != 0;
  if (!valid(depth, nwin, t0, ty, tz, wb ? STAGES : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(copy_kernel, Args{}, dim3(1), smem_of(depth, nwin, t0, ty, tz, wb),
                nullptr, ctas);
}
