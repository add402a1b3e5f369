// K9, the in-place x-tiled damped acoustic SO=8 step:
//   val = ((2a) u - (a - b) u1 + lap / h^2) / (a + b),
//   a = 1 / (vp^2 dt^2), b = damp / (2 dt),
//   lap = 3 W0 u + sum_{k=1..4} W_k (taps at distance k),
// over the interior [H, H+N)^3 of (NY, NY, ZA) buffers (NY = N + 16, halo
// H = 8, radius R = 4), stored straight into the target buffer. With
// `fullz` the rows x in [H, H+N) are written whole, y/z halo zeroed; with
// `interior` only the interior is written. x-halo rows keep the target's
// content. TAPS is the ablation of the TPU probe: 0 none (centre only),
// 1 z taps, 2 all taps.
//
// Replaces the TPU kernel experiments/stencil_probe6.py `make_step`
// (pallas_call at :232): a grid over x-tiles of t0 rows, each DMA-ing its
// (t0 + 2R)-plane halo window of u[t] HBM -> VMEM, double-buffered across
// tiles, and DMA-ing the result into the target, aliased to the output
// (input_output_aliases={4: 0}). Here CTAs tile (y, z) and each walks x in
// t0-row tiles: the (t0 + 2R)-plane halo window of its u[t] tile goes into
// shared memory with cp.async, double-buffered so that tile i+1's window
// loads while tile i computes, and each output point is stored straight
// into the target. Unlike K15's ring, every x-tile reads its 2R halo
// planes again. u1, vp and damp are read from global memory, coalesced
// along z. The target must not be u[t].
//
// What bounds it on the card: memory. A point reads u[t], u[t-1], vp, damp
// and writes the target, 20 bytes in fp32, plus the re-read halo planes
// (2R / t0 of u[t]) and the y/z halo of the tiles, for about 40 flops.

#include "cp_async.cuh"

namespace {

constexpr int H = 8, R = 4;
constexpr int TZ = 32, TY = 8;                   // tile (z, y): one point a thread
constexpr int PZ = TZ + 2 * R, PY = TY + 2 * R;  // halo'd plane
constexpr int PLANE = PY * PZ;
constexpr int THREADS = TZ * TY;

struct Args {
  const float *ut, *u1, *vp, *dp;
  float* tgt;
  int n, ny, za, t0;
  int ylo, zlo, yhi, zhi;  // covered points: [ylo, yhi) x [zlo, zhi)
  float w[R + 1];          // W_k, W_0 already times 3
  float inv_h2, inv_dt2, half_inv_dt;
};

// Issue the cp.async copies of x-tile `ti`'s halo window of this CTA's
// u[t] tile into `win`: planes x in [H + ti*t0 - R, H + (ti+1)*t0 + R).
__device__ __forceinline__ void load_window(float* win, const Args& a, int ti,
                                            int yb, int zb) {
  constexpr int CZ = PZ / 4;
  const int planes = a.t0 + 2 * R;
  const long long x0 = H + static_cast<long long>(ti) * a.t0 - R;
  const int tid = threadIdx.y * TZ + threadIdx.x;
  for (int c = tid; c < planes * PY * CZ; c += THREADS) {
    const int p = c / (PY * CZ), yy = (c / CZ) % PY, cz = c % CZ;
    const int gy = yb - R + yy, gz = zb - R + 4 * cz;
    const bool ok = gy >= 0 && gy < a.ny && gz >= 0 && gz < a.za;
    const float* src = ok ? a.ut + ((x0 + p) * a.ny + gy) * a.za + gz : a.ut;
    dtpu::cp_async16(win + p * PLANE + yy * PZ + 4 * cz, src, ok);
  }
}

template <int TAPS>
__global__ void __launch_bounds__(THREADS) inplace_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int zb = a.zlo + blockIdx.x * TZ, yb = a.ylo + blockIdx.y * TY;
  const int z = zb + threadIdx.x, y = yb + threadIdx.y;
  const int nxt = a.n / a.t0;
  const bool covered = y < a.yhi && z < a.zhi;
  const bool inside = y >= H && y < H + a.n && z >= H && z < H + a.n;
  // a tile with no interior point only writes zeros (fullz)
  const bool active = yb + TY > H && yb < H + a.n && zb + TZ > H && zb < H + a.n;
  if (!active) {
    if (covered)
      for (int x = H; x < H + a.n; ++x)
        a.tgt[(static_cast<long long>(x) * a.ny + y) * a.za + z] = 0.0f;
    return;
  }
  const int wsize = (a.t0 + 2 * R) * PLANE;
  load_window(smem, a, 0, yb, zb);
  dtpu::cp_async_commit();
  for (int ti = 0; ti < nxt; ++ti) {
    if (ti + 1 < nxt) {
      load_window(smem + ((ti + 1) & 1) * wsize, a, ti + 1, yb, zb);
      dtpu::cp_async_commit();
      dtpu::cp_async_wait<1>();
    } else {
      dtpu::cp_async_wait<0>();
    }
    __syncthreads();
    const float* win = smem + (ti & 1) * wsize;
    for (int p = 0; p < a.t0; ++p) {
      const long long x = H + static_cast<long long>(ti) * a.t0 + p;
      const long long g = (x * a.ny + y) * a.za + z;
      if (inside) {
        const int o = (p + R) * PLANE + (threadIdx.y + R) * PZ + threadIdx.x + R;
        const float u = win[o];
        float lap = a.w[0] * u;
        if (TAPS > 0) {
#pragma unroll
          for (int k = 1; k <= R; ++k) {
            float t = win[o + k] + win[o - k];
            if (TAPS > 1)
              t = t + win[o + k * PLANE] + win[o - k * PLANE] + win[o + k * PZ] +
                  win[o - k * PZ];
            lap += a.w[k] * t;
          }
        }
        lap = lap * a.inv_h2;
        const float v = a.vp[g];
        const float m = 1.0f / (v * v);
        const float am = m * a.inv_dt2;
        const float b = a.dp[g] * a.half_inv_dt;
        a.tgt[g] = ((2.0f * am) * u - (am - b) * a.u1[g] + lap) / (am + b);
      } else if (covered) {
        a.tgt[g] = 0.0f;
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }
}

}  // namespace

// Buffers (ny, ny, za) fp32, contiguous, 16-byte aligned; ny = n + 16,
// za >= ny, za % 4 == 0, n % t0 == 0. fullz != 0 covers rows x in [H, H+n)
// whole; else the interior only. w: W_0 * 3, W_1..W_4. Returns the
// cudaError_t of the launch.
extern "C" int dtpu_inplace_launch(const void* ut, const void* u1,
                                   const void* vp, const void* dp, void* tgt,
                                   int n, int za, int t0, int fullz, int taps,
                                   const float* w, float inv_h2, float inv_dt2,
                                   float half_inv_dt, void* stream) {
  Args a;
  a.ut = static_cast<const float*>(ut);
  a.u1 = static_cast<const float*>(u1);
  a.vp = static_cast<const float*>(vp);
  a.dp = static_cast<const float*>(dp);
  a.tgt = static_cast<float*>(tgt);
  a.n = n;
  a.ny = n + 2 * H;
  a.za = za;
  a.t0 = t0;
  a.ylo = a.zlo = fullz ? 0 : H;
  a.yhi = fullz ? a.ny : H + n;
  a.zhi = fullz ? za : H + n;
  for (int k = 0; k <= R; ++k) a.w[k] = w[k];
  a.inv_h2 = inv_h2;
  a.inv_dt2 = inv_dt2;
  a.half_inv_dt = half_inv_dt;
  const dim3 grid((a.zhi - a.zlo + TZ - 1) / TZ, (a.yhi - a.ylo + TY - 1) / TY);
  const size_t smem = sizeof(float) * 2 * (t0 + 2 * R) * PLANE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (taps) {
    case 0:
      if ((rc = dtpu::allow_smem(inplace_kernel<0>, smem))) return rc;
      inplace_kernel<0><<<grid, dim3(TZ, TY), smem, s>>>(a);
      break;
    case 1:
      if ((rc = dtpu::allow_smem(inplace_kernel<1>, smem))) return rc;
      inplace_kernel<1><<<grid, dim3(TZ, TY), smem, s>>>(a);
      break;
    default:
      if ((rc = dtpu::allow_smem(inplace_kernel<2>, smem))) return rc;
      inplace_kernel<2><<<grid, dim3(TZ, TY), smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
