// K4 and K5, the x-tiled neighbour-block acoustic SO=8 step:
//   out = 2 uc - up + mf * lap(uc),
//   lap = sum over x, y, z of sum_{k=-4..4} W_k u(. + k along the axis),
// on (np, np, zp) arrays (np = n + 8, halo 4; zp >= np, the z pad), written
// whole into a fresh array: zero outside the interior columns, i.e. where
// y or z lies outside [4, 4+n). Rows are cut into x-tiles of t rows.
//
// Replaces two TPU kernels: experiments/stencil_probe2.py
// `make_pallas_step` (K4, pallas_call at :117) and experiments/
// stencil_probe3.py `make_pallas_step` (K5, pallas_call at :134). Both run a
// grid over x-tiles of t rows; three BlockSpecs bring the tile's block of
// uc and its two neighbour blocks, the neighbours' indices clamped to the
// array, and the kernel assembles them into one (3t, np, zp) VMEM scratch,
// so that the x taps of row l of tile i read scratch row t + l + k. At the
// edges the clamped neighbour is the tile itself: in tile 0 a tap with
// l + k < 0, and in the last tile one with l + k >= t, reads row
// i*t + ((l + k) mod t). K4 computes every row that way, its x-halo rows
// included (they feed the interior from the next step on); K5 writes its
// x-halo rows as zero. ZERO_X_HALO is that compile-time flag.
//
// A (t, np, zp) block does not fit in shared memory (10.6 MB at n = 512), so
// y and z are cut: each CTA owns x-tile i (blockIdx.z) and a (SY, SZ) tile
// of (y, z). It assembles the t + 8 rows of the neighbour blocks that its x
// taps read (scratch rows t-4 .. 2t+4, by the same clamped rule) over its
// (y, z) tile and the 4-point halo around it into one shared window with
// cp.async, then computes. A CTA whose (y, z) tile, or (K5) whose x-tile,
// holds no interior point writes zeros and loads nothing.
//
// Tile and resources: t x 8 x 32 points, 256 threads (32 along z, 8 along
// y), each looping over the t rows; (t+8) x 16 x 40 floats of shared memory,
// 40,960 bytes at t = 8, five CTAs per SM by shared memory.
//
// What bounds it on the card: memory. A point reads uc, up and mf and
// writes out, 16 bytes in fp32, for about 60 flops; the window reads uc
// (t+8)/t x 16/8 x 40/32 times over (5 times at t = 8, mostly from L2), and
// the zero pad of the layout (zp - n lanes of every row) is read and
// written as well.

#include "cp_async.cuh"

namespace {

constexpr int R = 4;
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
  const float *uc, *up, *mf;
  float* out;
  int n, np, zp, t;
};

template <bool ZERO_X_HALO>
__global__ void __launch_bounds__(THREADS) nb_kernel(const Args a) {
  extern __shared__ __align__(16) float win[];  // (t + 2R) planes
  const int z0 = blockIdx.x * SZ, y0 = blockIdx.y * SY, i = blockIdx.z;
  const int z = z0 + threadIdx.x, y = y0 + threadIdx.y;
  const int nt = a.np / a.t, r0 = i * a.t;
  const bool covered = y < a.np && z < a.zp;
  const bool inside = y >= R && y < R + a.n && z >= R && z < R + a.n;
  const bool active = y0 + SY > R && y0 < R + a.n && z0 + SZ > R &&
                      z0 < R + a.n &&
                      (!ZERO_X_HALO || (r0 + a.t > R && r0 < R + a.n));
  if (!active) {
    if (covered)
      for (int l = 0; l < a.t; ++l)
        a.out[(static_cast<long long>(r0 + l) * a.np + y) * a.zp + z] = 0.0f;
    return;
  }
  // window plane q holds the source row of x tap l + k = q - R: the tile's
  // own block, or the neighbour block before or after it, clamped
  constexpr int CZ = PZ / 4;
  const int tid = threadIdx.y * SZ + threadIdx.x;
  for (int c = tid; c < (a.t + 2 * R) * PY * CZ; c += THREADS) {
    const int q = c / (PY * CZ), yy = (c / CZ) % PY, cz = c % CZ;
    const int lk = q - R;
    const int blk = lk < 0 ? max(i - 1, 0) : lk >= a.t ? min(i + 1, nt - 1) : i;
    const long long gx = static_cast<long long>(blk) * a.t + (lk + a.t) % a.t;
    const int gy = y0 - R + yy, gz = z0 - R + 4 * cz;
    const bool ok = gy >= 0 && gy < a.np && gz >= 0 && gz < a.zp;
    const float* src = ok ? a.uc + (gx * a.np + gy) * a.zp + gz : a.uc;
    dtpu::cp_async16(win + q * PLANE + yy * PZ + 4 * cz, src, ok);
  }
  dtpu::cp_async_commit();
  dtpu::cp_async_wait<0>();
  __syncthreads();
  if (!covered) return;
  for (int l = 0; l < a.t; ++l) {
    const int r = r0 + l;
    const long long g = (static_cast<long long>(r) * a.np + y) * a.zp + z;
    float v = 0.0f;
    if (inside && (!ZERO_X_HALO || (r >= R && r < R + a.n))) {
      const int o = (l + R) * PLANE + (threadIdx.y + R) * PZ + threadIdx.x + R;
      float acc = 0.0f;
#pragma unroll
      for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k * PLANE];
#pragma unroll
      for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k * PZ];
#pragma unroll
      for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k];
      v = 2.0f * win[o] - a.up[g] + a.mf[g] * acc;
    }
    a.out[g] = v;
  }
}

template <bool ZERO_X_HALO>
int launch(const void* uc, const void* up, const void* mf, void* out, int n,
           int zp, int t, void* stream) {
  Args a;
  a.uc = static_cast<const float*>(uc);
  a.up = static_cast<const float*>(up);
  a.mf = static_cast<const float*>(mf);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.np = n + 2 * R;
  a.zp = zp;
  a.t = t;
  const size_t smem = sizeof(float) * (t + 2 * R) * PLANE;
  const int rc = dtpu::allow_smem(nb_kernel<ZERO_X_HALO>, smem);
  if (rc != 0) return rc;
  const dim3 grid((zp + SZ - 1) / SZ, (a.np + SY - 1) / SY, a.np / t);
  nb_kernel<ZERO_X_HALO><<<grid, dim3(SZ, SY), smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// uc, up, mf, out: (n+8, n+8, zp) fp32, contiguous, uc 16-byte aligned;
// zp >= n + 8, zp % 4 == 0; t >= 4 divides n + 8; out is not uc. Return the
// cudaError_t of the launch. K4 leaves its x-halo rows computed:
extern "C" int dtpu_nb_launch(const void* uc, const void* up, const void* mf,
                              void* out, int n, int zp, int t, void* stream) {
  return launch<false>(uc, up, mf, out, n, zp, t, stream);
}

// K5 writes them as zero:
extern "C" int dtpu_nb_zeroed_launch(const void* uc, const void* up,
                                     const void* mf, void* out, int n, int zp,
                                     int t, void* stream) {
  return launch<true>(uc, up, mf, out, n, zp, t, stream);
}
