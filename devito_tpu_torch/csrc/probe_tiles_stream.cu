// K4, K5, K6 and K7, the acoustic SO=8 steps of stencil_probe2 to
// stencil_probe5, on K1's streaming engine:
//   out = (2 uc - up) + m * lap(uc)   over the region (n, n, n),
//   lap = sum over x, y, z of sum_{k=-4..4} W_k uc(. + k along the axis),
//   out = 0                           over a frame around it,
// where the frame is every point of an outer box of out's allocation that
// lies outside an inner box. K4 (stencil_probe2) and K5 (stencil_probe3):
// uc, up, m and out (n+8, n+8, zp), the update on [4, 4+n)^3; K5 zeroes
// everything else, K4 everything outside the interior columns (y, z in
// [4, 4+n)) and computes their x-halo rows, 0-3 and n+4..n+7, in a third
// kernel (`edge_rows_kernel`). K6 (stencil_probe4): uc (n+8, n+8, za), up
// and m (n, n, za) columns, out the (n, n, za) columns with the update on
// the lanes [4, 4+n) and zeros on the others (the loop passes up's own
// interior columns as out). K7 (stencil_probe5): uc, up, m and out
// (n+16, n+8, za), the update on [8, 8+n) x [4, 4+n) x [4, 4+n) and zeros
// everywhere else. The wrappers give each row's origin and the two boxes.
//
// Replaces the TPU kernels experiments/stencil_probe2.py and
// experiments/stencil_probe3.py `make_pallas_step` (pallas_call at :117
// and :134), experiments/stencil_probe4.py `make_v3_step` (pallas_call at
// :121) and experiments/stencil_probe5.py `make_v4_step` (pallas_call at
// :128). The first two walk x-tiles of T rows, each assembled in VMEM from
// its block of uc and its two neighbour blocks, clamped to the array; the
// third walks (x, y) tiles of columns with z resident, the halo'd window
// of uc DMA-ed into one of two VMEM slots while the previous tile
// computes; the fourth walks x-tiles with y and z resident in the same
// way, masking everything outside the interior to zero. Ported in those
// shapes (one CTA walking a cp.async window at a time, or one CTA an SM
// streaming z or x through a small (y, z) tile, uc read 2.8 to 5 times
// over) they reached 19 to 48 % of their bounds on the H100. Here the
// update is a point of K1's streaming engine (stencil_stream.cuh): uc is
// the staged group, its halo'd (y, z) planes arriving by TMA through a
// ring and its x taps held in register queues; up and m are centre
// groups, their tiles arriving in the same TMA stage; each CTA walks an
// x-chunk of planes and two or more CTAs share an SM. A point of the
// engine does not know its coordinates, so the zeros come from a second
// kernel of this unit, `frame_kernel`, launched in the same call before
// the engine: a warp a (x, y) row at a time, 16-byte stores wherever a
// span reaches a 16-byte boundary, and one span for the zeros between two
// interior rows.
//
// K4's x-halo rows read uc by the TPU kernel's clamped rule: in tile 0 an
// x tap with r + k < 0, and in the last tile one with r + k >= n + 8,
// reads row r + k + T or r + k - T of the tile itself; the interior rows
// never wrap for T >= 4 dividing n + 8, so the engine computes them as
// they are. The x-halo rows are 8 of the n + 8 rows (1.5 % of the points
// at n = 512): one thread a point, 4-byte loads through L2.
//
// When out is up's interior (K6's loop): a CTA's tile of up for plane x
// arrives in the stage of uc's plane x + 4, before the CTA writes plane x,
// and only this CTA writes those points, so it reads the old values. A
// centre box is TZ + 4 wide (StreamTile::CZ): it reads 16 bytes of the
// next z tile's columns, or of the frame past the region, which another
// CTA or the frame kernel may have written; those values are never used.
// The same holds when K4's or K5's out is up (or m): the frame kernel
// writes only points the engine never uses, and the edge-row kernel reads
// up and m only at the point it writes.
//
// What bounds it on the card: memory. A point reads uc, up and m once and
// writes out, 16 bytes in fp32, for 57 flops; the frame adds 6-7 % to the
// bytes at n = 512 (K6 writes (n, n, za), K4, K5 and K7 the whole array).

#include "stencil_stream.cuh"

namespace {

constexpr int R = 4;
// The tiles (TY, TZ, PY, STAGES) the engine is compiled for, one staged
// and two centre groups of radius 4, picked by the launch's flags >> 1;
// experiments/_tiled.py STREAM_TILES mirrors them
using Tile0 = dtpu::StreamTile<float, 1, 2, R, R, R, 16, 64, 4, 3>;
using Tile1 = dtpu::StreamTile<float, 1, 2, R, R, R, 16, 64, 4, 2>;
using Tile2 = dtpu::StreamTile<float, 1, 2, R, R, R, 16, 32, 2, 3>;
using Tile3 = dtpu::StreamTile<float, 1, 2, R, R, R, 16, 64, 4, 4>;
using Args = dtpu::StreamArgs<float, 1, 2, 0>;

__device__ __forceinline__ float w(int k) {
  // SO=8 second-derivative weights, k = -4..4
  switch (k < 0 ? -k : k) {
    case 0: return static_cast<float>(-205.0 / 72.0);
    case 1: return static_cast<float>(8.0 / 5.0);
    case 2: return static_cast<float>(-1.0 / 5.0);
    case 3: return static_cast<float>(8.0 / 315.0);
    default: return static_cast<float>(-1.0 / 560.0);
  }
}

// In an unnamed namespace, as K1's generated points: the engine's kernel
// and launch template instantiated with it then have internal linkage.
template <class L>
struct Point {
  static __device__ __forceinline__ float eval(const float (&q)[1][L::Q],
                                               const float* const (&sp)[1],
                                               const float (&cv)[2],
                                               const Args&) {
    float l = 0.0f;  // x taps, then y, then z, as the TPU kernels sum them
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * q[0][R + k];
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * sp[0][k * L::PZ];
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * sp[0][k];
    return (2.0f * q[0][R] - cv[0]) + cv[1] * l;  // cv: up, m
  }
};

// The frame, in the target allocation's elements: the outer box (origin o,
// extent e) less the inner box (origin i, extent f); d1, d2 the
// allocation's y and z extents.
struct Frame {
  long long d1, d2;
  int o[3], e[3], i[3], f[3];
};

// Zeros over r[a, b) by one warp: scalars up to the first 16-byte
// boundary, float4s, scalars after the last (ragged ends only).
__device__ __forceinline__ void zero_span(float* r, int a, int b, int lane) {
  if (a >= b) return;
  const int head = min(
      b - a, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(r + a) & 15))
                              & 15) / 4);
  const int a4 = a + head, nv = (b - a4) / 4, t = a4 + 4 * nv;
  if (lane < head) r[a + lane] = 0.0f;
  float4* v = reinterpret_cast<float4*>(r + a4);
  for (int k = lane; k < nv; k += 32) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < b - t) r[t + lane] = 0.0f;
}

constexpr int FRAME_ROWS = 4;  // (x, y) rows a warp zeroes

// Eight warps a block, one x-plane of the outer box, 8 * FRAME_ROWS of its
// (x, y) rows, each warp a row at a time: the whole row outside the inner
// box's (x, y) rectangle, the z ends around it inside. Where the outer
// box's rows are whole rows of the allocation, an inner row's tail and the
// next inner row's head are one span, written by the first row's warp
// (K6's and K7's 512-byte gaps between interior rows at n = 512).
__global__ void __launch_bounds__(256) frame_kernel(float* base, Frame g) {
  const int lane = threadIdx.x;
  const int z0 = g.o[2], z1 = g.o[2] + g.e[2];
  const int a = min(z1, g.i[2]), b = max(z0, g.i[2] + g.f[2]);
  const bool whole = z0 == 0 && z1 == g.d2;
  for (int px = blockIdx.y; px < g.e[0]; px += gridDim.y) {
    const int x = g.o[0] + px;
    const bool xin = x >= g.i[0] && x < g.i[0] + g.f[0];
    auto inner = [&](int y) {
      return xin && y >= g.i[1] && y < g.i[1] + g.f[1];
    };
    for (int k = 0; k < FRAME_ROWS; ++k) {
      const int py = (blockIdx.x * FRAME_ROWS + k) * 8 + threadIdx.y;
      if (py >= g.e[1]) break;
      const int y = g.o[1] + py;
      float* r = base + (x * g.d1 + y) * g.d2;
      if (!inner(y)) {
        zero_span(r, z0, z1, lane);
        continue;
      }
      if (!(whole && py > 0 && inner(y - 1))) zero_span(r, z0, a, lane);
      if (whole && py + 1 < g.e[1] && inner(y + 1))
        zero_span(r, b, static_cast<int>(g.d2) + a, lane);
      else
        zero_span(r, b, z1, lane);
    }
  }
}

// K4's x-halo rows, j = blockIdx.z (rows 0-3, then n+4..n+7), over the
// interior columns: the point of the engine with the x taps' rows by the
// clamped rule. up and m are read with plain loads, out may be either.
__global__ void __launch_bounds__(256) edge_rows_kernel(
    const float* __restrict__ uc, const float* up, const float* m,
    float* out, int n, int zp, int t) {
  const int z = R + blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= R + n) return;
  const int np = n + 2 * R, j = blockIdx.z;
  const int r = j < R ? j : np - 2 * R + j;
  const long long plane = static_cast<long long>(np) * zp;
  const long long yz = static_cast<long long>(R + blockIdx.y) * zp + z;
  const float* c = uc + r * plane + yz;
  float l = 0.0f;  // x taps, then y, then z, as the engine's point
#pragma unroll
  for (int k = -R; k <= R; ++k) {
    const int s = r + k < 0 ? r + k + t : r + k >= np ? r + k - t : r + k;
    l += w(k) * __ldg(uc + s * plane + yz);
  }
#pragma unroll
  for (int k = -R; k <= R; ++k) l += w(k) * __ldg(c + k * zp);
#pragma unroll
  for (int k = -R; k <= R; ++k) l += w(k) * __ldg(c + k);
  const long long p = r * plane + yz;
  out[p] = (2.0f * __ldg(c) - up[p]) + m[p] * l;
}

template <class L>
int launch(void* const* ptrs, const long long* dims, const int* org,
           const int* n, int tx, void* stream) {
  return dtpu::stream_launch<L, 0, Point<L>>(ptrs, dims, org, n, nullptr, tx,
                                             stream);
}

}  // namespace

// Rows, in order: out, uc, up, m; each an fp32 allocation (`dims`) with
// the region's first point (`org`); region n (x, y, z); the read rows
// 16-byte aligned, with z rows of whole 16-byte units. params: the frame's
// outer box origin and extent, then its inner box's, 12 values in out's
// allocation. flags: 1 writes the frame (before the engine), and flags >> 1
// is the tile (0: Tile0 ... 3: Tile3). tx: x-planes a CTA walks.
// Returns the cudaError_t of the launches, or a negative tensor-map error.
extern "C" int dtpu_probe_stream_launch(void* const* ptrs,
                                        const long long* dims, const int* org,
                                        const int* n, const double* params,
                                        int tx, int flags, void* stream) {
  if (flags >> 1 > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (flags & 1) {
    Frame g;
    g.d1 = dims[1];
    g.d2 = dims[2];
    for (int j = 0; j < 3; ++j) {
      g.o[j] = static_cast<int>(params[j]);
      g.e[j] = static_cast<int>(params[3 + j]);
      g.i[j] = static_cast<int>(params[6 + j]);
      g.f[j] = static_cast<int>(params[9 + j]);
    }
    if (g.e[0] > 0 && g.e[1] > 0 && g.e[2] > 0) {
      const dim3 grid((g.e[1] + 8 * FRAME_ROWS - 1) / (8 * FRAME_ROWS),
                      min(g.e[0], 65535));
      frame_kernel<<<grid, dim3(32, 8), 0,
                     static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(ptrs[0]), g);
      const cudaError_t rc = cudaGetLastError();
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
  }
  switch (flags >> 1) {
    case 0: return launch<Tile0>(ptrs, dims, org, n, tx, stream);
    case 1: return launch<Tile1>(ptrs, dims, org, n, tx, stream);
    case 2: return launch<Tile2>(ptrs, dims, org, n, tx, stream);
    default: return launch<Tile3>(ptrs, dims, org, n, tx, stream);
  }
}

// CTAs of the engine's kernel of the tile `flags >> 1` that fit on one SM.
extern "C" int dtpu_probe_stream_occupancy(int flags, int* ctas) {
  switch (flags >> 1) {
    case 0: return dtpu::stream_occupancy<Tile0, 0, Point<Tile0>>(ctas);
    case 1: return dtpu::stream_occupancy<Tile1, 0, Point<Tile1>>(ctas);
    case 2: return dtpu::stream_occupancy<Tile2, 0, Point<Tile2>>(ctas);
    case 3: return dtpu::stream_occupancy<Tile3, 0, Point<Tile3>>(ctas);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4's x-halo rows (edge_rows_kernel): uc, up, m and out (n+8, n+8, zp)
// fp32, contiguous, zp >= n + 8; T >= 4 divides n + 8; out is not uc.
// Returns the cudaError_t of the launch.
extern "C" int dtpu_probe_edge_rows_launch(const void* uc, const void* up,
                                           const void* m, void* out, int n,
                                           int zp, int t, void* stream) {
  if (n < 1 || n > 65535 || zp < n + 2 * R || t < R || (n + 2 * R) % t)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + 255) / 256, n, 2 * R);
  edge_rows_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uc), static_cast<const float*>(up),
      static_cast<const float*>(m), static_cast<float*>(out), n, zp, t);
  return static_cast<int>(cudaGetLastError());
}
