// K7, the x-tiled acoustic SO=8 step over a layout with an extra x ring:
//   out = 2 uc - up + m * lap(uc)   on the interior
//                                   [8, 8+n) x [4, 4+n) x [4, 4+n),
//   out = 0                         everywhere else,
//   lap = sum over x, y, z of sum_{k=-4..4} W_k u(. + k along the axis),
// on (xp, np, za) arrays: xp = n + 16 rows (halo 4 and a ring of 4 more, so
// that the windows of the TPU kernel never clamp), np = n + 8, za >= np the
// z pad. out is written whole, zeros included.
//
// Replaces the TPU kernel experiments/stencil_probe5.py `make_v4_step`
// (pallas_call at :128): a grid over x-tiles of TX rows, y and z resident,
// each DMA-ing the halo'd window (TX+8, np, za) of uc into one of two VMEM
// slots while the previous tile computes; y/z taps by lane and sublane
// rotations, x taps by row slices, and everything outside the interior
// masked to zero. The TPU kernel shifts the x taps of an edge tile that
// holds interior rows (`jnp.maximum(base + k, 0)`, :108) and clamps the last
// tile's slice, so for TX > 8 it computes wrong values on the interior rows
// of its first and last tiles. This kernel computes the intended update
// for every TX that divides xp.
//
// A (TX+8, np, za) window does not fit in shared memory (14 MB at TX = 32,
// n = 512), and CUDA blocks do not run in order. So here y and z are cut:
// each CTA owns a (SY, SZ) tile of (y, z) and walks every x-tile in a loop,
// with the halo'd window (TX+8, SY+8, SZ+8) of the next x-tile loading with
// cp.async into the other of two buffers while the current one computes. A
// CTA whose (y, z) tile holds no interior point writes zeros and loads
// nothing.
//
// Tile and resources: TX x 8 x 32 points, 256 threads (32 along z, 8 along
// y), each looping over the TX rows; 2 x (TX+8) x 16 x 40 floats of shared
// memory: 204,800 bytes at TX = 32 and 122,880 at TX = 16, one CTA per SM.
//
// What bounds it on the card: memory. A point reads uc, up and m and writes
// out, 16 bytes in fp32, for about 60 flops; the windows read uc
// (TX+8)/TX x 16/8 x 40/32 times over (3.75 at TX = 16, mostly from L2), the
// zero ring and pad are read and written as well, and one 8-warp CTA per SM
// leaves little to hide latency with.

#include "cp_async.cuh"

namespace {

constexpr int R = 4, X0 = 8;                     // radius, first interior row
constexpr int SZ = 32, SY = 8;                   // (z, y) tile
constexpr int PZ = SZ + 2 * R, PY = SY + 2 * R;  // halo'd plane
constexpr int PLANE = PY * PZ;
constexpr int THREADS = SZ * SY;

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

struct Args {
  const float *uc, *up, *m;
  float* out;
  int n, np, xp, za, tx;
};

// Start the cp.async copies of x-tile `ti`'s halo'd window of this CTA's
// (y, z) tile into `win`: rows [ti*tx - 4, ti*tx + tx + 4), y from y0 - 4,
// z from z0 - 4; zeros past the array's edge.
__device__ __forceinline__ void load_window(float* win, const Args& a, int ti,
                                            int y0, int z0) {
  constexpr int CZ = PZ / 4;
  const int planes = a.tx + 2 * R;
  const int tid = threadIdx.y * SZ + threadIdx.x;
  for (int c = tid; c < planes * PY * CZ; c += THREADS) {
    const int p = c / (PY * CZ), yy = (c / CZ) % PY, cz = c % CZ;
    const long long gx = static_cast<long long>(ti) * a.tx - R + p;
    const int gy = y0 - R + yy, gz = z0 - R + 4 * cz;
    const bool ok = gx >= 0 && gx < a.xp && gy >= 0 && gy < a.np && gz >= 0 &&
                    gz < a.za;
    const float* src = ok ? a.uc + (gx * a.np + gy) * a.za + gz : a.uc;
    dtpu::cp_async16(win + p * PLANE + yy * PZ + 4 * cz, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS) xtiles_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int z0 = blockIdx.x * SZ, y0 = blockIdx.y * SY;
  const int z = z0 + threadIdx.x, y = y0 + threadIdx.y;
  const int nxt = a.xp / a.tx;
  const bool covered = y < a.np && z < a.za;
  const bool inside = y >= R && y < R + a.n && z >= R && z < R + a.n;
  const bool active =
      y0 + SY > R && y0 < R + a.n && z0 + SZ > R && z0 < R + a.n;
  if (!active) {
    if (covered)
      for (int x = 0; x < a.xp; ++x)
        a.out[(static_cast<long long>(x) * a.np + y) * a.za + z] = 0.0f;
    return;
  }
  const int wsize = (a.tx + 2 * R) * PLANE;
  load_window(smem, a, 0, y0, z0);
  dtpu::cp_async_commit();
  for (int ti = 0; ti < nxt; ++ti) {
    if (ti + 1 < nxt) {
      load_window(smem + ((ti + 1) & 1) * wsize, a, ti + 1, y0, z0);
      dtpu::cp_async_commit();
      dtpu::cp_async_wait<1>();
    } else {
      dtpu::cp_async_wait<0>();
    }
    __syncthreads();
    const float* win = smem + (ti & 1) * wsize;
    if (covered) {
      for (int p = 0; p < a.tx; ++p) {
        const int x = ti * a.tx + p;
        const long long g = (static_cast<long long>(x) * a.np + y) * a.za + z;
        float v = 0.0f;
        if (inside && x >= X0 && x < X0 + a.n) {
          const int o = (p + R) * PLANE + (threadIdx.y + R) * PZ + threadIdx.x + R;
          float acc = 0.0f;
#pragma unroll
          for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k * PLANE];
#pragma unroll
          for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k * PZ];
#pragma unroll
          for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k];
          v = 2.0f * win[o] - a.up[g] + a.m[g] * acc;
        }
        a.out[g] = v;
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }
}

}  // namespace

// uc, up, m, out: (n+16, n+8, za) fp32, contiguous, uc 16-byte aligned;
// za >= n + 8, za % 4 == 0; tx divides n + 16, with two (tx+8)-plane
// windows within the shared memory of a block; out is not uc. Returns the
// cudaError_t of the launch.
extern "C" int dtpu_xtiles_launch(const void* uc, const void* up,
                                  const void* m, void* out, int n, int za,
                                  int tx, void* stream) {
  Args a;
  a.uc = static_cast<const float*>(uc);
  a.up = static_cast<const float*>(up);
  a.m = static_cast<const float*>(m);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.np = n + 2 * R;
  a.xp = n + 4 * R;
  a.za = za;
  a.tx = tx;
  const size_t smem = sizeof(float) * 2 * (tx + 2 * R) * PLANE;
  const int rc = dtpu::allow_smem(xtiles_kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((za + SZ - 1) / SZ, (a.np + SY - 1) / SY);
  xtiles_kernel<<<grid, dim3(SZ, SY), smem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
