// The read ring of K10 (probe7_copy.cu) and K13/K14 (probe7_stream.cu):
// each CTA owns a (TY, TZ) tile of the (ny, za) plane of a (ny, ny, za)
// fp32 buffer, ny = n + 16, and walks the x-chunks of t0 rows of
// src[H:H+n] in order through a ring of DEPTH slots of nwin windows of
// (t0, TY, TZ) floats each. The loop inside the block takes the place of
// the TPU probes' sequential grid or fori_loop.
// - Loads: lane 0 of the producer warp (warp NCW, `produce`) fills slot s
//   with chunk i once the consumers have released chunk i - DEPTH from it,
//   so chunks i .. i + DEPTH - 1 are in flight while chunk i is waited
//   for. A window is loaded in row blocks of rps = t0 / nsplit rows (the
//   TPU probe's nsplit), each as nbox TMA boxes of bx rows, the last of
//   rps - (nbox - 1) bx from a map of its own: a box axis holds at most
//   256 elements.
// - The last column of tiles takes maps as wide as the ez = za - z0
//   floats left (za % 4 == 0, so whole 16-byte rows), and its boxes land
//   with that row pitch: a zero-filled box costs the card as much as one
//   of data. Boxes past the ragged y edge land zero-filled, and their
//   bytes count all the same.
// - Each slot has a full barrier (count 1: the producer's arrive.expect_tx
//   of the slot's box bytes) and an empty barrier (count NCW: one arrive
//   per consumer warp, `release`). No __syncthreads after `init`.
// - Every wait is bounded: a wrong byte count would leave a barrier
//   incomplete, and the launch traps after 4 s instead of hanging
//   (tma.cuh `bounded_wait`).
// The tiles are chosen by experiments/stencil_probe7.py `copy_tile` and
// `stream_tile`, which mirror `smem_bytes`.

#pragma once

#include "cp_async.cuh"
#include "tma.cuh"

namespace dtpu {
namespace ring {

constexpr int H = 8;                  // x-halo rows of the buffers
constexpr int NCW = 4;                // consumer warps
constexpr int NCT = 32 * NCW;         // consumer threads
constexpr int THREADS = NCT + 32;     // and the producer warp
constexpr int MAX_BOX = 256;          // elements of a TMA box axis
constexpr int MAX_DEPTH = 8;
constexpr int BARS = 16 * MAX_DEPTH;  // full[8] and empty[8] barriers
constexpr int SMEM = 232448;          // shared bytes a block may use

// Box maps over one buffer, [e][t]: e = 1 in the last column of tiles (ez
// wide, else tz), t = 1 for a row block's last box.
struct Maps {
  CUtensorMap m[2][2];
};

// The ring's geometry. Device code takes it by value, so that its fields
// sit in registers: read through a reference to the kernel's parameters,
// each would be loaded again after every asm statement that clobbers
// memory, inside the producer's issue loop too.
struct Geo {
  int n, t0, nwin, depth, ty, tz, ez, rps, bx, nbox;
};

// The ring's maps over src and its geometry; a kernel's arguments hold it
// by value, as a __grid_constant__ parameter: the tensor maps must live in
// parameter space for the TMA unit.
struct Ring {
  Maps src;
  Geo g;
};

// Slot s of the ring and the parity of its current fill.
struct Cursor {
  int s = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void next(int depth) {
    if (++s == depth) {
      s = 0;
      phase ^= 1;
    }
  }
};

// A CTA's shared memory: the barriers, then the slots (and whatever the
// kernel keeps after them), 128-byte aligned.
struct Smem {
  uint64_t* full;
  uint64_t* empty;
  float* slots;
};

// This CTA's tile of the plane: its corner, whether it is in the last
// column, and the row pitch its boxes land with.
struct Tile {
  int y0, z0, edge, pitch;
};

__device__ __forceinline__ Tile tile_of(const Geo r) {
  const int edge = blockIdx.x + 1 == gridDim.x;
  return {static_cast<int>(blockIdx.y) * r.ty, static_cast<int>(blockIdx.x) * r.tz,
          edge, edge ? r.ez : r.tz};
}

// Carves the barriers and slots out of `raw` and initialises the barriers;
// every thread of the block calls it.
__device__ __forceinline__ Smem init(const Geo r, unsigned char* raw) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  const Smem sm{full, full + MAX_DEPTH, reinterpret_cast<float*>(base + BARS)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.depth; ++s) {
      mbar_init(sm.full + s, 1);
      mbar_init(sm.empty + s, NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return sm;
}

// Lane 0 of the producer warp: every chunk of this CTA's tile into the
// ring, in x order, with the boxes of `src`.
__device__ __forceinline__ void produce(const Maps& src, const Geo r, const Smem sm,
                                        const Tile t) {
  const CUtensorMap* maps = src.m[t.edge];
  const int plane = r.ty * r.tz;  // floats of one x-row of a window
  const int win = r.t0 * plane;   // floats of a window
  Cursor c;
  for (int i = 0; i < r.n / r.t0; ++i) {
    if (i >= r.depth) bounded_wait(sm.empty + c.s, c.phase ^ 1);
    mbar_expect_tx(sm.full + c.s, 4u * r.nwin * r.t0 * r.ty * t.pitch);
    float* dst = sm.slots + c.s * r.nwin * win;
    const int x = H + i * r.t0;
    for (int k = 0; k < r.nwin; ++k)
      for (int r0 = 0; r0 < r.t0; r0 += r.rps)
        for (int b = 0; b < r.nbox; ++b) {
          const int row = r0 + b * r.bx;
          tma_load_3d(dst + k * win + row * plane, maps + (b + 1 == r.nbox),
                      sm.full + c.s, t.z0, t.y0, x + row);
        }
    c.next(r.depth);
  }
}

// A consumer warp hands slot s back to the producer.
__device__ __forceinline__ void release(const Smem& sm, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(sm.empty + s);
}

// -- host ---------------------------------------------------------------------

// Dynamic shared memory of a launch: 128 bytes of alignment slack, the
// barriers, DEPTH slots of nwin windows of (t0, ty, tz) floats and `extra`
// windows more.
inline long long smem_bytes(int depth, int nwin, int t0, int ty, int tz, int extra) {
  return 128 + BARS + 4ll * (depth * nwin + extra) * t0 * ty * tz;
}

// The tile (ty, tz) with tz a multiple of 32 (every box lands 128-byte
// aligned), each at most 256; 1 <= depth <= 8; the ring and the extra
// windows within SMEM bytes.
inline bool valid(int depth, int nwin, int t0, int ty, int tz, int extra) {
  return depth >= 1 && depth <= MAX_DEPTH && nwin >= 1 && t0 >= 1 && ty >= 1 &&
         ty <= MAX_BOX && tz >= 32 && tz <= MAX_BOX && tz % 32 == 0 &&
         smem_bytes(depth, nwin, t0, ty, tz, extra) <= SMEM;
}

// The geometry of the arguments over a (ny, ny, za) buffer, and the grid
// of its tiles into *grid. False when n % t0, za % 4 or
// t0 % nsplit is not 0.
inline bool plan(Geo* r, dim3* grid, int ny, int za, int n, int t0, int nwin,
                 int nsplit, int depth, int ty, int tz) {
  if (n % t0 != 0 || za % 4 != 0 || nsplit < 1 || t0 % nsplit != 0) return false;
  r->n = n;
  r->t0 = t0;
  r->nwin = nwin;
  r->depth = depth;
  r->ty = ty;
  r->tz = tz;
  r->rps = t0 / nsplit;
  r->nbox = (r->rps + MAX_BOX - 1) / MAX_BOX;
  r->bx = (r->rps + r->nbox - 1) / r->nbox;
  *grid = dim3((za + tz - 1) / tz, (ny + ty - 1) / ty);
  r->ez = za - (grid->x - 1) * tz;
  return true;
}

// The box maps of ring `r` over the (ny, ny, za) fp32 buffer at `base`.
// Returns 0 or a negative tensor-map error.
inline int encode(Maps* m, const Geo& r, const void* base, int ny, int za) {
  const long long dims[3] = {ny, ny, za};
  const unsigned rows[2] = {static_cast<unsigned>(r.bx),
                            static_cast<unsigned>(r.rps - (r.nbox - 1) * r.bx)};
  for (int e = 0; e < 2; ++e)
    for (int t = 0; t < 2; ++t) {
      const int rc = encode_map_3d<float>(&m->m[e][t], base, dims, r.ty,
                                          e ? r.ez : r.tz, rows[t]);
      if (rc != 0) return rc;
    }
  return 0;
}

// Launches `kernel` on `stream`, or with `ctas` puts the CTAs of it that
// fit on one SM there instead. Returns the cudaError_t.
template <typename Args>
int launch(void (*kernel)(Args), const Args& a, dim3 grid, long long smem,
           cudaStream_t stream, int* ctas) {
  const int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  if (ctas != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, kernel, THREADS, smem));
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ring
}  // namespace dtpu
