// K3, the acoustic SO=8 step of stencil_probe, on K1's streaming engine:
//   out = 2 uc - up + m * lap(uc) - damp * uc,
//   lap = sum over x, y, z of sum_{k=-4..4} W_k u(. + k along the axis),
// over the interior of up and uc, (n+8)^3 with a halo of 4; m and damp are
// (n, n, n); out is (n, n, n), a new tensor or a box of any contiguous
// allocation: the loop passes up's own interior.
//
// Replaces the TPU kernel experiments/stencil_probe.py `make_pallas_step`
// (pallas_call at :106): a grid over (x, y) tiles of TX x TY points, each
// DMA-ing the halo'd windows (TX+8, TY+8, n+8) of both up and uc into VMEM,
// z resident, and computing the tile. Ported in that shape ((TX, TY, ZC)
// blocks, both halo'd windows staged by cp.async, no double buffering, one
// CTA an SM, each window read 3.1 times over) it reached 15 % of its bound
// on the H100. Here the update is a point of K1's streaming engine
// (stencil_stream.cuh): uc is the staged group, its halo'd (y, z) planes
// arriving by TMA through a ring and its x taps held in register queues;
// up, m and damp are centre groups, their tiles arriving in the same TMA
// stage; each CTA walks an x-chunk of planes and two CTAs share an SM. The
// tile is the engine's, whatever TX and TY the caller gave.
//
// When out is up's interior: a CTA's tile of up for plane x arrives in the
// stage of uc's plane x + 4, before the CTA writes plane x, and only this
// CTA writes those points, so it reads the old values. A centre box is
// TZ + 4 wide (StreamTile::CZ): it reads 16 bytes of the next z tile's
// columns, which that tile's CTA may be writing; those values are never
// used.
//
// What bounds it on the card: memory. A point reads up, uc, m and damp once
// and writes out, 20 bytes in fp32, for 59 flops.

#include "stencil_stream.cuh"

namespace {

constexpr int R = 4;
// K1's fp32 tile: one staged and three centre groups of radius 4;
// experiments/_stream.py TILE mirrors it
using Tile = dtpu::StreamTile<float, 1, 3, R, R, R, 16, 64, 4, 3>;
using Args = dtpu::StreamArgs<float, 1, 3, 0>;
constexpr int PZ = Tile::PZ;

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
struct Point {
  static __device__ __forceinline__ float eval(const float (&q)[1][Tile::Q],
                                               const float* const (&sp)[1],
                                               const float (&cv)[3],
                                               const Args&) {
    float l = 0.0f;  // x taps, then y, then z, as the TPU kernel sums them
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * q[0][R + k];
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * sp[0][k * PZ];
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * sp[0][k];
    const float u = q[0][R];
    return (2.0f * u - cv[0]) + cv[1] * l - cv[2] * u;  // cv: up, m, damp
  }
};

}  // namespace

// Rows, in order: out (any allocation, written at its origin), uc, up
// ((n+8)^3, origin (4, 4, 4)), m, damp ((n, n, n), origin 0); region
// (n, n, n); the read rows 16-byte aligned, n % 4 == 0. No params or
// flags. tx: x-planes a CTA walks. Returns the cudaError_t of the launch,
// or a negative tensor-map error.
extern "C" int dtpu_probe_stream_launch(void* const* ptrs,
                                        const long long* dims, const int* org,
                                        const int* n, const double*, int tx,
                                        int, void* stream) {
  return dtpu::stream_launch<Tile, 0, Point>(ptrs, dims, org, n, nullptr, tx,
                                             stream);
}

// CTAs of the kernel that fit on one SM.
extern "C" int dtpu_probe_stream_occupancy(int, int* ctas) {
  return dtpu::stream_occupancy<Tile, 0, Point>(ctas);
}
