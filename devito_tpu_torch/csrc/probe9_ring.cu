// K15, the sliding-ring acoustic SO=8 step: one update
//   out = 2u - u1 + c * vp^2 * acc - dp * u,
//   acc = w0*3*u + sum_{k=1..4} w_k (u[x+-k] + u[y+-k] + u[z+-k]),
// of a field u0 stored (N+16, N+16, N): halo 8 in x and y, z compact, z taps
// outside [0, N) reading zero. u1, vp, dp are (N+16, N, N), halo'd in x
// only; out is (N, N, N), written out of place.
//
// Replaces the TPU kernel experiments/stencil_probe9.py `make_kernel`
// (pallas_call at :132). Its defining design is the sliding window: the
// grid walks x-tiles in order and a VMEM window of u0 slides along x, so
// every x-plane of u0 is read from HBM once. Here each CTA owns a (y, z)
// tile of TY x TZ points and marches along x over TX planes. It keeps a
// ring of NSLOT = 2R + 2 halo'd x-planes of its u0 tile in shared memory:
// the 2R + 1 planes the current step reads, plus the next plane, which
// cp.async brings in one step ahead while the current one computes. Each
// plane of the tile is loaded once per CTA; across CTAs the y/z halo of
// the tile (and the 2R planes before each x chunk) is read again, mostly
// from L2. u1, vp and dp are read once, straight from global memory,
// coalesced along z.
//
// What bounds it on the card: memory. A point reads u0, u1, vp, dp and
// writes out, 20 bytes in fp32, for about 40 flops.

#include "cp_async.cuh"

namespace {

constexpr int H = 8, R = 4;
constexpr int TZ = 64, TY = 16;                  // output tile (z, y)
constexpr int PZ = TZ + 2 * R, PY = TY + 2 * R;  // halo'd plane
constexpr int NSLOT = 2 * R + 2;
constexpr int THREADS = 256, RY = THREADS / TZ;  // thread rows
constexpr int PLANE = PY * PZ;
constexpr size_t SMEM = sizeof(float) * NSLOT * PLANE;

__device__ __forceinline__ float w(int k) {
  // SO=8 second-derivative weights, w(0) the centre
  switch (k) {
    case 0: return static_cast<float>(-205.0 / 72.0);
    case 1: return static_cast<float>(8.0 / 5.0);
    case 2: return static_cast<float>(-1.0 / 5.0);
    case 3: return static_cast<float>(8.0 / 315.0);
    default: return static_cast<float>(-1.0 / 560.0);
  }
}

// Issue the cp.async copies of u0 plane `row` (its x index in u0) of this
// CTA's halo'd tile into ring slot `row % NSLOT`; zeros past the edges.
__device__ __forceinline__ void load_plane(float* ring, const float* u0,
                                           int row, int n, int y0, int z0) {
  float* dst = ring + (row % NSLOT) * PLANE;
  const long long ny = n + 2 * H;
  constexpr int CZ = PZ / 4;
  for (int c = threadIdx.y * TZ + threadIdx.x; c < PY * CZ; c += THREADS) {
    const int yy = c / CZ, cz = c % CZ;
    const int gy = H + y0 - R + yy, gz = z0 - R + 4 * cz;
    const bool ok = gy < ny && gz >= 0 && gz < n;
    const float* src = ok ? u0 + (row * ny + gy) * n + gz : u0;
    dtpu::cp_async16(dst + yy * PZ + 4 * cz, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
ring_kernel(const float* __restrict__ u0, const float* __restrict__ u1,
            const float* __restrict__ vp, const float* __restrict__ dp,
            float* __restrict__ out, float c, int n, int tx) {
  extern __shared__ __align__(16) float ring[];
  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY;
  const int x0 = blockIdx.z * tx;
  for (int d = -R; d <= R; ++d) load_plane(ring, u0, H + x0 + d, n, y0, z0);
  dtpu::cp_async_commit();
  load_plane(ring, u0, H + x0 + R + 1, n, y0, z0);
  dtpu::cp_async_commit();
  const int lz = threadIdx.x, z = z0 + lz;
  for (int p = 0; p < tx; ++p) {
    const int x = x0 + p;
    dtpu::cp_async_wait<1>();  // every plane but the newest has landed
    __syncthreads();
    const float* s[2 * R + 1];
#pragma unroll
    for (int d = -R; d <= R; ++d) s[d + R] = ring + ((H + x + d) % NSLOT) * PLANE;
#pragma unroll
    for (int j = 0; j < TY / RY; ++j) {
      const int ly = threadIdx.y + RY * j, y = y0 + ly;
      if (y < n && z < n) {
        const int o = (ly + R) * PZ + lz + R;
        const float u = s[R][o];
        float acc = w(0) * 3.0f * u;
#pragma unroll
        for (int k = 1; k <= R; ++k)
          acc += w(k) * (s[R + k][o] + s[R - k][o] + s[R][o + k * PZ] +
                         s[R][o - k * PZ] + s[R][o + k] + s[R][o - k]);
        const long long g = (static_cast<long long>(H + x) * n + y) * n + z;
        const float v = vp[g];
        out[(static_cast<long long>(x) * n + y) * n + z] =
            2.0f * u - u1[g] + c * v * v * acc - dp[g] * u;
      }
    }
    __syncthreads();  // the oldest plane's slot is free for the next load
    if (p + 2 < tx) load_plane(ring, u0, H + x + R + 2, n, y0, z0);
    dtpu::cp_async_commit();
  }
  dtpu::cp_async_wait<0>();  // tx == 1 leaves the prefetched plane in flight
}

}  // namespace

// u0: (n+16, n+16, n); u1, vp, dp: (n+16, n, n); out: (n, n, n); all fp32,
// contiguous and 16-byte aligned; n % 4 == 0 and n % tx == 0.
extern "C" int dtpu_ring_launch(const void* u0, const void* u1, const void* vp,
                                const void* dp, void* out, float c, int n,
                                int tx, void* stream) {
  int rc = dtpu::allow_smem(ring_kernel, SMEM);
  if (rc != 0) return rc;
  const dim3 grid((n + TZ - 1) / TZ, (n + TY - 1) / TY, n / tx);
  ring_kernel<<<grid, dim3(TZ, RY), SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u0), static_cast<const float*>(u1),
      static_cast<const float*>(vp), static_cast<const float*>(dp),
      static_cast<float*>(out), c, n, tx);
  return static_cast<int>(cudaGetLastError());
}
