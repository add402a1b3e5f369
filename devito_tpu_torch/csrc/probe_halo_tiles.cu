// K3, the (x, y)-tiled acoustic SO=8 step with both halo'd windows staged:
//   out = 2 uc - up + m * lap(uc) - damp * uc,
//   lap = sum over x, y, z of sum_{k=-4..4} W_k u(. + k along the axis),
// over the interior of up and uc, (n+8)^3 with a halo of 4; m and damp are
// (n, n, n); out is (n, n, n), written through the strides (osx, osy, 1),
// so that it may be the view of up's interior that the loop updates.
//
// Replaces the TPU kernel experiments/stencil_probe.py `make_pallas_step`
// (pallas_call at :106): a grid over (x, y) tiles of TX x TY points, each
// DMA-ing the halo'd windows (TX+8, TY+8, n+8) of both up and uc into VMEM,
// z resident, waiting for both and computing the tile. Windows over the
// whole z extent do not fit in shared memory (two of 1.7 MB at TX = TY = 32,
// n = 256), so here z is cut: each CTA computes one (TX, TY, ZC) block. It
// stages the halo'd windows (TX+8, TY+8, ZC+8) of up and uc with cp.async,
// waits for both and computes, as the TPU kernel does, with no double
// buffering, as there. ZC is the largest of 32, 16, 8 and 4 whose two
// windows fit (chosen by the wrapper). Tiles need not divide n: the edge
// blocks mask their points.
//
// up's window is staged whole, as on the TPU, but only its centre is read:
// its halo is never used. When out is up's interior, other CTAs may be
// writing that halo while this one loads it; those values are never read.
// Each point reads up only where it writes it, after the block's loads.
//
// Tile and resources at TX = TY = 32: ZC = 8, 256 threads, each looping
// over 32 points; 2 x 40 x 40 x 16 floats = 204,800 bytes of shared memory;
// one CTA per SM.
//
// What bounds it on the card: memory. A point reads up, uc, m and damp and
// writes out, 20 bytes in fp32, for about 60 flops; the windows read up and
// uc (TX+8)(TY+8)(ZC+8) / (TX TY ZC) = 3.1 times over at TX = TY = 32, and
// with one CTA per SM and no double buffering the loads do not overlap the
// arithmetic.

#include "cp_async.cuh"

namespace {

constexpr int R = 4;
constexpr int THREADS = 256;

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
  const float *up, *uc, *m, *damp;
  float* out;
  long long osx, osy;  // out's strides in x and y (z stride 1)
  int n, tx, ty, zc;
};

// Start the cp.async copies of the halo'd window of `src` for the block at
// interior (x0, y0, z0): padded points [x0, x0+tx+8) x [y0, y0+ty+8) x
// [z0, z0+zc+8); zeros past the array's edge.
__device__ __forceinline__ void load_window(float* dst, const float* src,
                                            const Args& a, int x0, int y0,
                                            int z0) {
  const int py = a.ty + 2 * R, pz = a.zc + 2 * R, cz = pz / 4;
  const long long np = a.n + 2 * R;
  const int chunks = (a.tx + 2 * R) * py * cz;
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const int p = c / (py * cz), yy = (c / cz) % py, q = c % cz;
    const long long gx = x0 + p, gy = y0 + yy, gz = z0 + 4 * q;
    const bool ok = gx < np && gy < np && gz < np;
    const float* s = ok ? src + (gx * np + gy) * np + gz : src;
    dtpu::cp_async16(dst + (p * py + yy) * pz + 4 * q, s, ok);
  }
}

__global__ void __launch_bounds__(THREADS) halo_tiles_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int py = a.ty + 2 * R, pz = a.zc + 2 * R, sx = py * pz;
  float* ucw = smem;
  float* upw = smem + (a.tx + 2 * R) * sx;
  const int x0 = blockIdx.x * a.tx, y0 = blockIdx.y * a.ty,
            z0 = blockIdx.z * a.zc;
  load_window(upw, a.up, a, x0, y0, z0);
  load_window(ucw, a.uc, a, x0, y0, z0);
  dtpu::cp_async_commit();
  dtpu::cp_async_wait<0>();
  __syncthreads();
  const int pts = a.tx * a.ty * a.zc;
  for (int p = threadIdx.x; p < pts; p += THREADS) {
    const int lz = p % a.zc, ly = (p / a.zc) % a.ty, lx = p / (a.zc * a.ty);
    const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
    if (x >= a.n || y >= a.n || z >= a.n) continue;
    const int o = ((lx + R) * py + ly + R) * pz + lz + R;
    float l = 0.0f;
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * ucw[o + k * sx];
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * ucw[o + k * pz];
#pragma unroll
    for (int k = -R; k <= R; ++k) l += w(k) * ucw[o + k];
    const float u = ucw[o];
    const long long g = (static_cast<long long>(x) * a.n + y) * a.n + z;
    a.out[x * a.osx + y * a.osy + z] =
        (2.0f * u - upw[o]) + a.m[g] * l - a.damp[g] * u;
  }
}

}  // namespace

// up, uc: (n+8)^3; m, damp: (n, n, n), contiguous; out: (n, n, n) with
// strides (osx, osy, 1); all fp32, up and uc 16-byte aligned; n % 4 == 0;
// zc in {4, 8, 16, 32} with two (tx+8, ty+8, zc+8) windows within the
// shared memory of a block. Returns the cudaError_t of the launch.
extern "C" int dtpu_halo_tiles_launch(const void* up, const void* uc,
                                      const void* m, const void* damp,
                                      void* out, long long osx, long long osy,
                                      int n, int tx, int ty, int zc,
                                      void* stream) {
  Args a;
  a.up = static_cast<const float*>(up);
  a.uc = static_cast<const float*>(uc);
  a.m = static_cast<const float*>(m);
  a.damp = static_cast<const float*>(damp);
  a.out = static_cast<float*>(out);
  a.osx = osx;
  a.osy = osy;
  a.n = n;
  a.tx = tx;
  a.ty = ty;
  a.zc = zc;
  const size_t smem =
      sizeof(float) * 2 * (tx + 2 * R) * (ty + 2 * R) * (zc + 2 * R);
  const int rc = dtpu::allow_smem(halo_tiles_kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((n + tx - 1) / tx, (n + ty - 1) / ty, (n + zc - 1) / zc);
  halo_tiles_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
