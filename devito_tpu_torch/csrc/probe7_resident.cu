// K11, the resident-window compute probe: the damped acoustic SO=8 update
//   lap = (3 W0 u + sum_k W_k taps_k) / 100,  m = 1 / vp^2,  a = 100 m,
//   b = 5 damp,  val = (2 a u - (a - b) u1 + lap) / (a + b)
// of probe_B (experiments/stencil_probe7.py:136-156: DT = 0.1, h = 10),
// computed reps times over t0 x-rows of an n x n interior from windows that
// never leave shared memory; no byte is read from device memory. The
// windows hold constant fields, whose four values (u, u1, vp, damp) are
// runtime arguments, except that u may vary with position: at point
// (x, y, z) of its (t0 + 8, n + 8, n + 8) window it holds
// fu (1 + vary ((7 x + 13 y + 29 z) mod 17)), so that with vary != 0 the
// Laplacian does not cancel and a wrong tap, stride or weight shows in the
// output. taps_k is zero ('none', TAPS = 0), the two z taps ('z', 1) or
// all six ('full', 2), summed in the reference's order.
//
// Replaces the TPU kernel experiments/stencil_probe7.py `probe_B`
// (pallas_call at :160): a grid of reps steps that fills four VMEM windows
// at step 0 and computes the whole (t0, N, N) update from them at every
// step. CUDA blocks share no memory, so here each CTA owns a (TY, 32) tile
// of the interior (y, z) plane and fills its own windows once -- u over
// (t0 + 8, TY + 8, 40) points, u1, vp and damp over (t0, TY, 32), in
// 16-byte stores, u's pattern stepped row by row -- then computes its
// tile's t0 x-rows reps times. The grid covers t0 n n reps points, as the
// TPU grid does.
//
// The design. Each thread owns 4 z-neighbours of a (y, z) column and
// walks ROWS x-rows of it (t0 / ROWS threads share a column). Every load
// is a 16-byte load of 4 z-neighbours: the z taps come from two strips a
// row beside the centre, the y taps from the rows above and below, and
// the x taps from a register queue of 9 rows that takes one new row a
// step, as K1's engine keeps its x taps (csrc/stencil_stream.cuh). 'full'
// so reads 2 + 8 + (ROWS + 8) / ROWS + 3 shared words a point, from 28 one
// point a thread. ROWS is a template parameter, so the x walk is unrolled
// and the queue lives in registers; ROWS = 0 is the generic instantiation,
// a runtime loop over all t0 rows. The wrapper picks the tile (TY, ROWS)
// by shape (experiments/stencil_probe7.py `resident_tile`). A thread
// computes its 4 Laplacians before their divisions, which end in branches.
//
// Each repetition reads u, u1, vp and damp from shared memory anew: the
// queue is primed again, nothing is carried from one repetition to the
// next: a compiler barrier between repetitions keeps nvcc from doing so,
// and every address of a repetition adds rep * zero, a runtime 0, which
// keeps ptxas from hoisting a load out of the loop (it hoisted 22 of 64
// from the __fdividef instantiation without it). The reference's output
// reads scratch rows it never wrote (ROADMAP Queue 3); this kernel's
// output is defined instead: out[y][z] is the update of the first x-row
// at interior point (y, z) for y < min(8, n), z < min(128, n), and zero
// elsewhere, stored after the loop from the last repetition's values (a
// store in the loop cost 4 % of 'full'). Every thread also stores the sum
// of its points' values into `sink`, so that nvcc can neither delete nor
// fold the arithmetic. FAST = true divides with __fdividef (the division
// ablation); the default is IEEE division.
//
// What bounds it on the card (chip_smoke.py phase 8 on an NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md §6): issue and shared memory together, each
// short of its floor by about a quarter. At N=512 'full' on the pick,
// (16, 4), the repetition loop issues about 60 SASS instructions a point
// when no division takes its slow path (0.24 ms at 1.98 GHz) and loads 16
// shared words a point (0.26 ms at 128 bytes a clock an SM); it takes
// about 0.35 ms. The two IEEE divisions cost most of the rest: each ends
// in a branch to its slow path, which no instruction crosses, so with
// __fdividef 'full' takes about 0.29 ms and 'none' half as long. More
// warps do not help 'full': 24 an SM on (4, 2) were slower, and blocks of
// 2 y-rows (12 words a point, 8 warps) slower still.

#include <cuda_runtime.h>

namespace {

constexpr int R = 4, TZ = 32, PZ = TZ + 2 * R, BZ = 4, QZ = TZ / BZ;
constexpr int OY = 8, OZ = 128;  // the output tile
constexpr int SMEM = 232448;     // bytes of shared memory a block may use

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

template <bool FAST>
__device__ __forceinline__ float divide(float a, float b) {
  return FAST ? __fdividef(a, b) : a / b;
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// zero is 0, but no compiler can know it: each repetition's addresses add
// rep * zero, so that no shared load is invariant across repetitions.
struct Args {
  int n, t0, reps, ty, zero;
  float fu, f1, fv, fd, vary;
};

__device__ __forceinline__ float pattern(const Args& a, int p) {
  return __fmul_rn(a.fu, __fadd_rn(1.0f, __fmul_rn(a.vary, static_cast<float>(p))));
}

__device__ __forceinline__ int mod17(int p) { return p >= 17 ? p - 17 : p; }

// Fill this CTA's windows in 16-byte stores: u row by row, each thread one
// column of 4 floats, its pattern (7 x + 13 y + 29 z) mod 17 stepped from
// its first element (z + 1 adds 12 mod 17); u1, vp and damp their values.
// Needs blockDim.x >= PZ / 4.
__device__ void fill(const Args& a, float* ut, float* u1, float* vp, float* dp) {
  const int py = a.ty + 2 * R, rows = (a.t0 + 2 * R) * py, q4 = PZ / BZ;
  const int per = blockDim.x / q4, c = threadIdx.x % q4, r0 = threadIdx.x / q4;
  if (r0 < per) {
    const int y0 = blockIdx.y * a.ty, z = blockIdx.x * TZ + BZ * c;
    const int dx = per / py, dy = per - dx * py;
    int x = r0 / py, yw = r0 - x * py;
    for (int r = r0; r < rows; r += per) {
      const int p0 = (7 * x + 13 * (y0 + yw) + 29 * z) % 17, p1 = mod17(p0 + 12),
                p2 = mod17(p1 + 12), p3 = mod17(p2 + 12);
      reinterpret_cast<float4*>(ut)[r * q4 + c] =
          make_float4(pattern(a, p0), pattern(a, p1), pattern(a, p2), pattern(a, p3));
      x += dx;
      yw += dy;
      if (yw >= py) {
        yw -= py;
        ++x;
      }
    }
  }
  const int np4 = a.t0 * a.ty * TZ / BZ;
  for (int i = threadIdx.x; i < np4; i += blockDim.x) {
    reinterpret_cast<float4*>(u1)[i] = make_float4(a.f1, a.f1, a.f1, a.f1);
    reinterpret_cast<float4*>(vp)[i] = make_float4(a.fv, a.fv, a.fv, a.fv);
    reinterpret_cast<float4*>(dp)[i] = make_float4(a.fd, a.fd, a.fd, a.fd);
  }
}

// The x taps a point needs from the queue: all nine rows for 'full', the
// centre alone otherwise.
template <int TAPS>
__host__ __device__ constexpr int queue_rows() { return TAPS == 2 ? 2 * R + 1 : 1; }

// One x-row of a thread's 4 points into val: q[k] holds u at x-row
// x - QC + k (QC the queue's centre) of the points. The Laplacians of the
// 4 points first, as 4 independent chains, then their divisions.
template <int TAPS, bool FAST>
__device__ __forceinline__ void row_update(const float4 (&q)[queue_rows<TAPS>()],
                                           const float* urow, const float* u1,
                                           const float* vp, const float* dp,
                                           float (&val)[BZ]) {
  constexpr int QC = queue_rows<TAPS>() / 2;
  const float c0 = static_cast<float>(3.0 * (-205.0 / 72.0));
  float s[3 * BZ];  // z-4 .. z+7 of the row
  float4 yv[2 * R];  // the rows y-4 .. y-1, y+1 .. y+4
  if constexpr (TAPS > 0) {
    const float4 l = ld4(urow), r = ld4(urow + 2 * R);
    s[0] = l.x, s[1] = l.y, s[2] = l.z, s[3] = l.w;
    s[8] = r.x, s[9] = r.y, s[10] = r.z, s[11] = r.w;
  }
  if constexpr (TAPS == 2) {
#pragma unroll
    for (int k = 1; k <= R; ++k) {
      yv[R - k] = ld4(urow - k * PZ + R);
      yv[R + k - 1] = ld4(urow + k * PZ + R);
    }
  }
  const float4 c = q[QC];
  s[4] = c.x, s[5] = c.y, s[6] = c.z, s[7] = c.w;
  float lap[BZ];
#pragma unroll
  for (int j = 0; j < BZ; ++j) {
    lap[j] = c0 * s[BZ + j];
    if constexpr (TAPS > 0) {
#pragma unroll
      for (int k = 1; k <= R; ++k) {
        float terms = s[BZ + j + k] + s[BZ + j - k];
        if constexpr (TAPS == 2)
          terms = terms + lane(q[QC + k], j) + lane(q[QC - k], j) + lane(yv[R + k - 1], j) +
                  lane(yv[R - k], j);
        lap[j] = lap[j] + w(k) * terms;
      }
    }
    lap[j] = lap[j] * 0.01f;
  }
  const float4 f1 = ld4(u1), fv = ld4(vp), fd = ld4(dp);
  float m[BZ];
#pragma unroll
  for (int j = 0; j < BZ; ++j) m[j] = divide<FAST>(1.0f, lane(fv, j) * lane(fv, j));
#pragma unroll
  for (int j = 0; j < BZ; ++j) {
    const float a = m[j] * 100.0f, b = lane(fd, j) * 5.0f;
    val[j] = divide<FAST>((2.0f * a) * s[BZ + j] - (a - b) * lane(f1, j) + lap[j], a + b);
  }
}

// The most threads a CTA of the instantiation for ROWS takes at t0 = 16
// and TY <= 16, at most 512 (128 registers a thread); the generic one
// walks all rows, one thread a column block.
__host__ __device__ constexpr int max_threads(int rows) {
  return rows == 0 ? 16 * QZ : rows <= 4 ? 512 : 16 * QZ * (16 / rows);
}

template <int TAPS, int ROWS, bool FAST>
__global__ void __launch_bounds__(max_threads(ROWS))
    resident_kernel(float* __restrict__ out, float* __restrict__ sink, const Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QD = queue_rows<TAPS>(), QC = QD / 2;
  const int py = a.ty + 2 * R, plane = py * PZ, ptile = a.ty * TZ;
  float* ut = smem;
  float* u1 = ut + (a.t0 + 2 * R) * plane;
  float* vp = u1 + a.t0 * ptile;
  float* dp = vp + a.t0 * ptile;
  fill(a, ut, u1, vp, dp);
  __syncthreads();

  const int jz = threadIdx.x % QZ, rest = threadIdx.x / QZ;
  const int ly = rest % a.ty, lz = jz * BZ;
  const int rows = ROWS > 0 ? ROWS : a.t0, xb = rest / a.ty * rows;
  const int y = blockIdx.y * a.ty + ly, z = blockIdx.x * TZ + lz;
  // u at window row 0 of the points' row, its z strip's start (the centre
  // at + R); u1, vp, damp at x-row 0 of the points
  const float* ub = ut + (ly + R) * PZ + lz;
  const int pofs = ly * TZ + lz;
  // each point's sum over the rows and repetitions, and its value at the
  // thread's first row (x-row 0 when xb == 0), the last repetition's once
  // the loop ends
  float acc[BZ] = {0.0f, 0.0f, 0.0f, 0.0f}, first[BZ];

  for (int rep = 0; rep < a.reps; ++rep) {
    const int o = rep * a.zero;
    const float* u = ub + o;
    float4 q[QD];
    // the queue's rows before this thread's first: window rows
    // xb + R - QC + k
#pragma unroll
    for (int k = 0; k + 1 < QD; ++k) q[k] = ld4(u + (xb + R - QC + k) * plane + R);
    auto step = [&](int x, bool at_first) {
      q[QD - 1] = ld4(u + (x + R - QC + QD - 1) * plane + R);
      const int p = x * ptile + pofs + o;
      float val[BZ];
      row_update<TAPS, FAST>(q, u + (x + R) * plane, u1 + p, vp + p, dp + p, val);
#pragma unroll
      for (int j = 0; j < BZ; ++j) {
        acc[j] += val[j];
        if (at_first) first[j] = val[j];
      }
#pragma unroll
      for (int k = 0; k + 1 < QD; ++k) q[k] = q[k + 1];
    };
    if constexpr (ROWS > 0) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) step(xb + i, i == 0);
    } else {
      for (int x = 0; x < a.t0; ++x) step(x, x == 0);
    }
    asm volatile("" ::: "memory");  // the next repetition reads the windows anew
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < BZ; ++j) {
    if (y < a.n && z + j < a.n) sum += acc[j];
    if (xb == 0 && y < OY && z + j < OZ && y < a.n && z + j < a.n)
      out[y * OZ + z + j] = first[j];
  }
  sink[(blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x] = sum;
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = threadIdx.x; i < OY * OZ; i += blockDim.x)
      if (i / OZ >= a.n || i % OZ >= a.n) out[i] = 0.0f;
}

// Threads of a CTA: (TY x 8) column blocks of 4 points, t0 / ROWS of them
// on each (one for the generic instantiation).
int threads_of(int t0, int ty, int rows) { return ty * QZ * (rows > 0 ? t0 / rows : 1); }

long long smem_of(int t0, int ty) {
  return 4ll * ((t0 + 2ll * R) * (ty + 2 * R) * PZ + 3ll * t0 * ty * TZ);
}

bool valid(int n, int t0, int reps, int ty, int rows) {
  if (n < 1 || t0 < 1 || reps < 1 || ty < 1) return false;
  if (rows != 0 && t0 % rows) return false;
  const int threads = threads_of(t0, ty, rows);
  return threads >= PZ / BZ && threads <= max_threads(rows) && smem_of(t0, ty) <= SMEM;
}

template <int TAPS, int ROWS, bool FAST>
int launch(float* out, float* sink, const Args& a, cudaStream_t st, int* ctas) {
  auto kernel = resident_kernel<TAPS, ROWS, FAST>;
  const int smem = static_cast<int>(smem_of(a.t0, a.ty));
  const int threads = threads_of(a.t0, a.ty, ROWS);
  int rc = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc != 0) return rc;
  if (ctas != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, threads, smem));
  const dim3 grid((a.n + TZ - 1) / TZ, (a.n + a.ty - 1) / a.ty);
  kernel<<<grid, threads, smem, st>>>(out, sink, a);
  return static_cast<int>(cudaGetLastError());
}

template <int TAPS, int ROWS>
int by_division(int fast, float* out, float* sink, const Args& a, cudaStream_t st,
                int* ctas) {
  return fast ? launch<TAPS, ROWS, true>(out, sink, a, st, ctas)
              : launch<TAPS, ROWS, false>(out, sink, a, st, ctas);
}

template <int TAPS>
int by_rows(int rows, int fast, float* out, float* sink, const Args& a, cudaStream_t st,
            int* ctas) {
  switch (rows) {
    case 0: return by_division<TAPS, 0>(fast, out, sink, a, st, ctas);
    case 2: return by_division<TAPS, 2>(fast, out, sink, a, st, ctas);
    case 4: return by_division<TAPS, 4>(fast, out, sink, a, st, ctas);
    case 8: return by_division<TAPS, 8>(fast, out, sink, a, st, ctas);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int taps, int rows, int fast, float* out, float* sink, const Args& a,
             cudaStream_t st, int* ctas) {
  if (!valid(a.n, a.t0, a.reps, a.ty, rows)) return static_cast<int>(cudaErrorInvalidValue);
  switch (taps) {
    case 0: return by_rows<0>(rows, fast, out, sink, a, st, ctas);
    case 1: return by_rows<1>(rows, fast, out, sink, a, st, ctas);
    case 2: return by_rows<2>(rows, fast, out, sink, a, st, ctas);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out: (8, 128) fp32; sink: one fp32 per thread of the grid, ceil(n / 32)
// ceil(n / ty) CTAs of ty 8 (t0 / rows) threads (rows 0: ty 8); taps 0, 1,
// 2; rows (x-rows a thread walks) 0 (all t0, the generic instantiation),
// 2, 4 or 8 dividing t0; fast: __fdividef instead of IEEE division;
// fills: u, u1, vp, damp; vary: u's variation with position (0:
// constant). Returns the cudaError_t (cudaErrorInvalidValue for arguments
// outside these).
extern "C" int dtpu_probe7_resident_launch(void* out, void* sink, int n, int t0, int reps,
                                           int taps, int ty, int rows, int fast,
                                           const float* fills, float vary, void* stream) {
  const Args a{n, t0, reps, ty, 0, fills[0], fills[1], fills[2], fills[3], vary};
  return dispatch(taps, rows, fast, static_cast<float*>(out), static_cast<float*>(sink), a,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The CTAs of the kernel for these arguments that fit on one SM, as the
// CUDA runtime computes them from its registers, shared memory and
// threads, into *ctas. Returns the cudaError_t.
extern "C" int dtpu_probe7_resident_occupancy(int t0, int taps, int ty, int rows, int fast,
                                              int* ctas) {
  const Args a{1, t0, 1, ty, 0, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  return dispatch(taps, rows, fast, nullptr, nullptr, a, nullptr, ctas);
}
