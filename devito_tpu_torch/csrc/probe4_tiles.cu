// K6, the (x, y)-tiled acoustic SO=8 step with a double-buffered window:
//   out = 2 uc - up + m * lap(uc)   on the lanes [4, 4+n),
//   out = 0                         on the lanes [0, 4) and [4+n, za),
//   lap = sum over x, y, z of sum_{k=-4..4} W_k u(. + k along the axis),
// for every interior (x, y) column. uc is (np, np, za) (np = n + 8, halo 4;
// za >= np, the z pad); up, m and out are (n, n, za), centre columns only,
// each read or written through its strides (sx, sy, 1), so that up and out
// may both be the view of the previous field's interior columns that the
// loop updates in place.
//
// Replaces the TPU kernel experiments/stencil_probe4.py `make_v3_step`
// (pallas_call at :121): a grid over (x, y) tiles of TX x TY columns with z
// resident, walked in order, whose halo'd window of uc (TX+8, TY+8, za) is
// DMA-ed into one of two VMEM slots while the previous tile computes. A
// window over the whole z extent does not fit in shared memory (2.4 MB at
// TX = 16, TY = 32, za = 640), and CUDA blocks do not run in order. So
// here each CTA owns one (TX, TY) tile and streams z through it: its own
// sequence of blocks (TX, TY, ZC), walked in a loop, with the halo'd window
// (TX+8, TY+8, ZC+8) of the next block loading with cp.async into the other
// of two buffers while the current block computes. ZC is the largest of 32,
// 16, 8 and 4 whose two windows fit (chosen by the wrapper). Tiles need not
// divide n: the edge CTAs mask their columns. Each point reads up only
// where it writes out, so out may be up.
//
// Tile and resources at TX = 16, TY = 32: ZC = 16, 256 threads, each
// looping over 32 points per block; 2 x 24 x 40 x 24 floats = 184,320
// bytes of shared memory; one CTA per SM.
//
// What bounds it on the card: memory. A point reads uc, up and m and writes
// out, 16 bytes in fp32, for about 60 flops; the window reads uc
// (TX+8)(TY+8)(ZC+8) / (TX TY ZC) = 2.8 times over at TX = 16, TY = 32,
// ZC = 16, and one 8-warp CTA per SM leaves little to hide latency with.

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
  const float *uc, *up, *m;
  float* out;
  long long usx, usy, msx, msy, osx, osy;  // x and y strides (z stride 1)
  int n, za, tx, ty, zc;
};

// Start the cp.async copies of the halo'd window of block `c` of the tile
// at interior (x0, y0): padded points [x0, x0+tx+8) x [y0, y0+ty+8) x
// [c*zc, c*zc+zc+8); zeros past the array's edge.
__device__ __forceinline__ void load_window(float* dst, const Args& a,
                                            int x0, int y0, int c) {
  const int py = a.ty + 2 * R, pz = a.zc + 2 * R, cz = pz / 4;
  const long long np = a.n + 2 * R;
  const int chunks = (a.tx + 2 * R) * py * cz;
  for (int i = threadIdx.x; i < chunks; i += THREADS) {
    const int p = i / (py * cz), yy = (i / cz) % py, q = i % cz;
    const long long gx = x0 + p, gy = y0 + yy;
    const int gz = c * a.zc + 4 * q;
    const bool ok = gx < np && gy < np && gz < a.za;
    const float* s = ok ? a.uc + (gx * np + gy) * a.za + gz : a.uc;
    dtpu::cp_async16(dst + (p * py + yy) * pz + 4 * q, s, ok);
  }
}

__global__ void __launch_bounds__(THREADS) tiles_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int py = a.ty + 2 * R, pz = a.zc + 2 * R, sx = py * pz;
  const int wsize = (a.tx + 2 * R) * sx;
  const int x0 = blockIdx.x * a.tx, y0 = blockIdx.y * a.ty;
  // the z halo and pad lanes of the tile's columns
  const int nzero = a.za - a.n;
  for (int p = threadIdx.x; p < a.tx * a.ty * nzero; p += THREADS) {
    const int lz = p % nzero, ly = (p / nzero) % a.ty, lx = p / (nzero * a.ty);
    const int x = x0 + lx, y = y0 + ly, lane = lz < R ? lz : a.n + lz;
    if (x < a.n && y < a.n) a.out[x * a.osx + y * a.osy + lane] = 0.0f;
  }
  const int nch = (a.n + a.zc - 1) / a.zc;
  load_window(smem, a, x0, y0, 0);
  dtpu::cp_async_commit();
  const int pts = a.tx * a.ty * a.zc;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_window(smem + ((c + 1) & 1) * wsize, a, x0, y0, c + 1);
      dtpu::cp_async_commit();
      dtpu::cp_async_wait<1>();
    } else {
      dtpu::cp_async_wait<0>();
    }
    __syncthreads();
    const float* win = smem + (c & 1) * wsize;
    for (int p = threadIdx.x; p < pts; p += THREADS) {
      const int lz = p % a.zc, ly = (p / a.zc) % a.ty, lx = p / (a.zc * a.ty);
      const int x = x0 + lx, y = y0 + ly, z = c * a.zc + lz;
      if (x >= a.n || y >= a.n || z >= a.n) continue;
      const int o = ((lx + R) * py + ly + R) * pz + lz + R;
      float acc = 0.0f;
#pragma unroll
      for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k * sx];
#pragma unroll
      for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k * pz];
#pragma unroll
      for (int k = -R; k <= R; ++k) acc += w(k) * win[o + k];
      const int lane = R + z;
      a.out[x * a.osx + y * a.osy + lane] =
          2.0f * win[o] - a.up[x * a.usx + y * a.usy + lane] +
          a.m[x * a.msx + y * a.msy + lane] * acc;
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }
}

}  // namespace

// uc: (n+8, n+8, za) fp32, contiguous, 16-byte aligned, za >= n + 8,
// za % 4 == 0; up, m, out: (n, n, za) fp32 with strides (sx, sy, 1); zc in
// {4, 8, 16, 32} with two (tx+8, ty+8, zc+8) windows within the shared
// memory of a block. Returns the cudaError_t of the launch.
extern "C" int dtpu_tiles_launch(const void* uc, const void* up,
                                 const void* m, void* out, long long usx,
                                 long long usy, long long msx, long long msy,
                                 long long osx, long long osy, int n, int za,
                                 int tx, int ty, int zc, void* stream) {
  Args a;
  a.uc = static_cast<const float*>(uc);
  a.up = static_cast<const float*>(up);
  a.m = static_cast<const float*>(m);
  a.out = static_cast<float*>(out);
  a.usx = usx;
  a.usy = usy;
  a.msx = msx;
  a.msy = msy;
  a.osx = osx;
  a.osy = osy;
  a.n = n;
  a.za = za;
  a.tx = tx;
  a.ty = ty;
  a.zc = zc;
  const size_t smem =
      sizeof(float) * 2 * (tx + 2 * R) * (ty + 2 * R) * (zc + 2 * R);
  const int rc = dtpu::allow_smem(tiles_kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((n + tx - 1) / tx, (n + ty - 1) / ty);
  tiles_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
