// The window copies that K10 (probe7_copy.cu), K13 and K14
// (probe7_stream.cu) share: a CTA owns a (TY, 64) tile, TY = 1 << lty, of
// the (ny, za) plane of a (ny, ny, za) fp32 buffer, and copies nwin windows
// of t0 x-rows of that tile, all of the same rows, into one slot of a ring
// in shared memory with cp.async, the counterpart of the TPU probes' nwin
// DMAs of src[H + i t0 : H + (i+1) t0] into VMEM.

#pragma once

#include "cp_async.cuh"

namespace dtpu {
namespace probe7 {

constexpr int H = 8;          // x-halo rows of the buffers
constexpr int TZ = 64;        // z extent of a tile
constexpr int CZ = TZ / 4;    // 16-byte chunks of a tile row
constexpr int THREADS = 256;  // threads of a CTA

// Floats of one slot: nwin windows of t0 rows of the tile.
__host__ __device__ __forceinline__ int slot_floats(int nwin, int t0, int lty) {
  return nwin * t0 * (TZ << lty);
}

// cp.async copies of x-rows [row, row + t0) of the tile at (y0, z0), nwin
// times, into `slot`, laid out [k][r][y][z]; each window as nsplit blocks of
// t0 / nsplit rows, issued one after another. 16-byte chunks past the
// plane's edge are skipped: nothing reads them back.
__device__ __forceinline__ void issue(float* slot, const float* src, long long row,
                                      int t0, int nwin, int nsplit, int ny, int za,
                                      int y0, int z0, int lty) {
  const int per_row = CZ << lty;  // 16-byte chunks of one x-row of the tile
  const int tc = t0 / nsplit;
  for (int k = 0; k < nwin; ++k)
    for (int j = 0; j < nsplit; ++j)
      for (int c = threadIdx.x; c < tc * per_row; c += THREADS) {
        const int r = j * tc + (c >> (4 + lty)), q = c & (per_row - 1);
        const int gy = y0 + (q >> 4), gz = z0 + 4 * (q & (CZ - 1));
        if (gy < ny && gz < za)
          cp_async16(slot + 4 * ((k * t0 + r) * per_row + q),
                     src + ((row + r) * ny + gy) * za + gz, true);
      }
}

}  // namespace probe7
}  // namespace dtpu
