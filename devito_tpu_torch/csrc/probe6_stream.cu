// K9, the in-place damped acoustic SO=8 step, on K1's streaming engine:
//   val = ((2a) u - (a - b) u1 + lap / h^2) / (a + b),
//   a = 1 / (vp^2 dt^2), b = damp / (2 dt),
//   lap = 3 W0 u + sum_{k=1..4} W_k (taps at distance k),
// over the interior [H, H+N)^3 of (NY, NY, ZA) buffers (NY = N + 16, halo
// H = 8, radius R = 4), stored straight into the target buffer. With
// `fullz` the rows x in [H, H+N) are written whole, y/z halo zeroed; with
// `interior` only the interior is written. x-halo rows keep the target's
// content. TAPS is the ablation of the TPU probe: 0 none (centre only),
// 1 z taps, 2 all taps; each reads the same planes.
//
// Replaces the TPU kernel experiments/stencil_probe6.py `make_step`
// (pallas_call at :232): a grid over x-tiles of t0 rows, each DMA-ing its
// (t0 + 2R)-plane halo window of u[t] into VMEM, double-buffered across
// tiles, and DMA-ing the result into the target, aliased to the output.
// Ported in that shape (one CTA an SM, cp.async windows of whole x-tiles,
// u[t-1], vp and damp loaded at the point) it reached 16 % of its bound on
// the H100. Here the update is a point of K1's streaming engine
// (stencil_stream.cuh): u[t] is the staged group, its halo'd (y, z) planes
// arriving by TMA through a ring and its x taps held in register queues;
// u[t-1], vp and damp are centre groups, their tiles arriving in the same
// TMA stage; each CTA walks an x-chunk of planes (a run-time argument,
// not t0) and two CTAs share an SM. A point of the engine does not know
// its coordinates, so the zeros of `fullz`'s frame (rows x in [H, H+N)
// outside the interior) come from a second kernel of this unit,
// `frame_kernel`, launched in the same call.
//
// What bounds it on the card: memory. A point reads u[t], u[t-1], vp and
// damp once and writes the target, 20 bytes in fp32, for 42 flops (full
// taps); `fullz` also writes the frame, 6 % more at N = 512.

#include "stencil_stream.cuh"

namespace {

constexpr int H = 8, R = 4;
// K1's fp32 tile: one staged and three centre groups of radius 4;
// experiments/_stream.py TILE mirrors it
using Tile = dtpu::StreamTile<float, 1, 3, R, R, R, 16, 64, 4, 3>;
constexpr int NP = 8;  // W_0 * 3, W_1..W_4, 1/h^2, 1/dt^2, 1/(2 dt)
using Args = dtpu::StreamArgs<float, 1, 3, NP>;
constexpr int PZ = Tile::PZ;

// In an unnamed namespace, as K1's generated points: the engine's kernel
// and launch template instantiated with it then have internal linkage.
template <int TAPS>
struct Point {
  static __device__ __forceinline__ float eval(const float (&q)[1][Tile::Q],
                                               const float* const (&sp)[1],
                                               const float (&cv)[3],
                                               const Args& a) {
    const float u = q[0][R];
    float lap = a.p[0] * u;
    if (TAPS > 0) {
#pragma unroll
      for (int k = 1; k <= R; ++k) {
        float t = sp[0][k] + sp[0][-k];
        if (TAPS > 1)
          t = t + q[0][R + k] + q[0][R - k] + sp[0][k * PZ] + sp[0][-k * PZ];
        lap += a.p[k] * t;
      }
    }
    lap = lap * a.p[5];
    const float v = cv[1];  // cv: u[t-1], vp, damp
    const float am = 1.0f / (v * v) * a.p[6];
    const float b = cv[2] * a.p[7];
    return ((2.0f * am) * u - (am - b) * cv[0] + lap) / (am + b);
  }
};

// Zeros over the frame of rows x in [H, H+n) of the (n+16, ny, za) target
// at `tgt`: every z of the y-halo rows, z outside [H, H+n) of the others.
// One warp a (x, y) row.
__global__ void __launch_bounds__(256) frame_kernel(float* tgt, int n, int ny,
                                                    int za) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.y;
  if (row >= static_cast<long long>(n) * ny) return;
  const int y = static_cast<int>(row % ny);
  float* r = tgt + (static_cast<long long>(H) * ny + row) * za;
  const bool inner = y >= H && y < H + n;
  for (int z = threadIdx.x; z < (inner ? H : za); z += 32) r[z] = 0.0f;
  if (inner)
    for (int z = H + n + threadIdx.x; z < za; z += 32) r[z] = 0.0f;
}

template <int TAPS>
int launch(void* const* ptrs, const long long* dims, const int* org,
           const int* n, const double* params, int tx, void* stream) {
  return dtpu::stream_launch<Tile, NP, Point<TAPS>>(ptrs, dims, org, n,
                                                    params, tx, stream);
}

template <int TAPS>
int occupancy(int* ctas) {
  return dtpu::stream_occupancy<Tile, NP, Point<TAPS>>(ctas);
}

}  // namespace

// Rows, in order: the target, u[t], u[t-1], vp, damp; each an (ny, ny, za)
// fp32 allocation (`dims`), region n = (N, N, N) at origin (H, H, H)
// (`org`); the read rows 16-byte aligned, za % 4 == 0. params: W_0 * 3,
// W_1..W_4, 1/h^2, 1/dt^2, 1/(2 dt). flags: taps (0 none, 1 z, 2 full) +
// 4 * fullz. tx: x-planes a CTA walks. Returns the cudaError_t of the
// launches, or a negative tensor-map error.
extern "C" int dtpu_probe_stream_launch(void* const* ptrs,
                                        const long long* dims, const int* org,
                                        const int* n, const double* params,
                                        int tx, int flags, void* stream) {
  if ((flags & 4) && n[0] > 0) {
    // the target's first element: the region's first point less (H, H, H)
    float* tgt = static_cast<float*>(ptrs[0]) +
                 ((org[0] - H) * dims[1] + org[1] - H) * dims[2] + org[2] - H;
    const long long rows = static_cast<long long>(n[0]) * dims[1];
    frame_kernel<<<static_cast<unsigned>((rows + 7) / 8), dim3(32, 8), 0,
                   static_cast<cudaStream_t>(stream)>>>(
        tgt, n[0], static_cast<int>(dims[1]), static_cast<int>(dims[2]));
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  switch (flags & 3) {
    case 0: return launch<0>(ptrs, dims, org, n, params, tx, stream);
    case 1: return launch<1>(ptrs, dims, org, n, params, tx, stream);
    default: return launch<2>(ptrs, dims, org, n, params, tx, stream);
  }
}

// CTAs of the stream kernel of `flags`' taps that fit on one SM.
extern "C" int dtpu_probe_stream_occupancy(int flags, int* ctas) {
  switch (flags & 3) {
    case 0: return occupancy<0>(ctas);
    case 1: return occupancy<1>(ctas);
    default: return occupancy<2>(ctas);
  }
}
