// Dense-stencil update for NVIDIA Hopper (sm_90a), streaming design: the
// template K1 takes for a 3-D equation whose staged access groups are read
// along the axes only (a star), such as the acoustic update. Equations of
// any other shape keep the one-thread-per-point template (stencil.cuh).
//
// Replaces, as stencil.cuh does, the TPU kernel experiments/pallas_backend.py
// `execute_plan`. That kernel staged halo'd windows of every access group
// in VMEM; VMEM holds megabytes, shared memory 227 KB a block, and the
// probes showed that a design with one CTA per SM reaches 15-23 % of its
// bound on this card. So here:
//
// - Each CTA owns a (TY, TZ) output tile of the (y, z) plane and walks a
//   chunk of x-planes in order (blockIdx.z picks the chunk).
// - A staged group (one read at non-zero offsets, u[t] in the acoustic
//   update) arrives one halo'd plane at a time by TMA into a ring of
//   planes in shared memory. Each group is staged at its own tap shape
//   (rx, ry, rz), the reach of its own taps per axis: its plane box is
//   (TY + 2ry, TZ + 2rz), its ring holds rx + STAGES slots (the rx + 1
//   planes from the current one to the one rx ahead, and STAGES - 1
//   planes in flight) and its register queue 2rx + 1 values. A group of
//   a smaller x reach than the widest (RX) is lagged: stage j brings the
//   widest group's plane RX ahead of the output plane and every other
//   group's plane its own rx ahead, and a group starts 2(RX - rx) stages
//   late. So one x-chunk schedule, one mbarrier a stage, serves every
//   group, and a group read along y or z only (rx = 0) takes no slots for
//   x taps and a queue of one value. Thread 0 issues every copy.
// - Each thread keeps, per staged group and per point, the 2rx + 1 values
//   of its column along x in a register queue: the x taps. Each plane
//   shifts the queue by one and takes the value rx planes ahead from
//   shared memory. The y and z taps come from the current plane in shared
//   memory, read at fixed offsets; a thread's PY points are consecutive in
//   y, so their y taps overlap and repeat loads of one address fold.
// - A centre group (one read at offset 0 only: u[t-1], vp or m, damp) has
//   its (TY, TZ) tile of the output plane travel in the same TMA stage as
//   the staged plane RX ahead, so it is in flight a stage early. (Coalesced
//   __ldg loads at the point instead were 44 % slower on the H100 at 512^3
//   SO=8: they wait a whole memory latency every plane.)
// - Before its chunk a CTA primes its queues with the 2rx planes that
//   precede the first output plane; the ragged edges of y, z and x are
//   masked (TMA fills what lies outside a row with zeros, and the store
//   is skipped).
// - A TMA box starts on a 16-byte boundary in z (a box that did not was
//   refused on the card with an illegal-instruction fault), so a box
//   begins up to 16 bytes before the data it is for, and each row reads
//   from its own shift (`zs`, `czs`).
//
// The per-equation part is the same point expression as the other design's
// (compiler/translate.py `cuda_expr`), printed with the x taps as queue
// reads `q[s][rx + dx]`, the y and z taps as shared reads
// `sp[s][dy * PZ<s>]` (group s's own pitch) and `sp[s][dz]`, and the
// centre groups as the values `cv[c]` that the kernel loaded for the
// point.
//
// What bounds it on the card: memory. The acoustic SO=8 update moves
// about 20 bytes a point (four arrays read once, one written) for 76
// flops. The register queues cut the shared loads a point to about 15 at
// PY = 4 (8 z taps, about 3 y taps, 1 queue value, 3 centre values),
// against 25 for a ring of whole planes (stencil_probe9's K15), and the
// small ring keeps two or more CTAs on an SM (__launch_bounds__ asks the
// compiler for two; kernels/stencil.py `stream_tile` checks the ring).
// Staging each group at its own shape is what lets an equation of many
// groups of unequal reach stream at all: TTI's widest CIRE temporary reads
// u[t] at radius 6 and five more groups, four of them along one or two
// axes at radius 3; at the union's shape its six rings would need about
// 480 KB of shared memory, at its own 100 KB, and it runs in 3.2 ms at
// TTI's canonical size on the H100 against 9.3 on the point design.

#pragma once

#include <type_traits>

#include "tma.cuh"

namespace dtpu {

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The staged groups' tap shapes, (rx, ry, rz) of each group in launch
// order: the generated unit's `dtpu::Radii<...>`.
template <int... R>
struct Radii {
  static constexpr int N = sizeof...(R) / 3;
  static_assert(sizeof...(R) % 3 == 0, "three radii a group");
  __host__ __device__ static constexpr int of(int s, int d) {
    constexpr int r[] = {R...};
    return r[3 * s + d];
  }
};

// NS groups of one shape: the default.
template <int NS, int RX, int RY, int RZ>
struct Uniform {
  static constexpr int N = NS;
  __host__ __device__ static constexpr int of(int, int d) {
    return d == 0 ? RX : d == 1 ? RY : RZ;
  }
};

// Calls f(std::integral_constant<int, s>) for s = 0 .. N - 1, so that a
// group's shape is a constant expression in f.
template <int N, class F, int I = 0>
__device__ __forceinline__ void for_each_group(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    for_each_group<N, F, I + 1>(static_cast<F&&>(f));
  }
}

// By value, as a __grid_constant__ parameter: the tensor maps must live in
// parameter space for the TMA unit.
template <typename T, int NS, int NC, int NP>
struct StreamArgs {
  CUtensorMap smap[NS];                  // staged rows, whole allocations
  CUtensorMap cmap[NC > 0 ? NC : 1];     // centre rows, whole allocations
  T* out;                                // target row at the region's first point
  long long out_stride[2];               // target row strides of x and y
  int sorg[NS][3];                       // staged rows: the region's first point (x, y, z)
  int corg[NC > 0 ? NC : 1][3];          // centre rows: the same
  int zs[NS];                            // staged boxes start zs elements early in z,
  int czs[NC > 0 ? NC : 1];              // centre boxes czs: on a 16-byte boundary
  int n[3];                              // region extents (x, y, z)
  int tx;                                // x-planes a CTA walks
  T p[NP > 0 ? NP : 1];                  // scalar parameters (dt, spacings, ...)
};

// The tile and its shared-memory layout; kernels/stencil.py `stream_tile`
// mirrors these sizes. (RX, RY, RZ) is the union of the groups' shapes G
// (a Radii, or Uniform: every group at the union's); BY, BZ, PZ, PLANE
// and NSLOT are the union's box, pitch, plane and slots, the per-group
// functions each group's own.
template <typename T_, int NS_, int NC_, int RX_, int RY_, int RZ_, int TY_,
          int TZ_, int PY_, int STAGES_,
          class G = Uniform<NS_, RX_, RY_, RZ_>>
struct StreamTile {
  using T = T_;
  static constexpr int NS = NS_, NC = NC_, RX = RX_, RY = RY_, RZ = RZ_;
  static constexpr int TY = TY_, TZ = TZ_, PY = PY_, STAGES = STAGES_;
  static constexpr int Q = 2 * RX + 1;           // the longest queue
  // TMA boxes start on 16-byte boundaries in z and move rows of whole
  // 16-byte units: a box starts up to A - 1 elements before the data it
  // is for, and its row is rounded up to A elements
  static constexpr int A = 16 / int(sizeof(T));
  static constexpr int BY = TY + 2 * RY;         // the union's plane box
  static constexpr int BZ = round_up(TZ + 2 * RZ + A - 1, A);
  static constexpr int PZ = BZ;                  // and its pitch (elements)
  static constexpr int CZ = TZ + A;              // centre box row
  static constexpr int PLANE = round_up(BY * BZ * int(sizeof(T)), 128);
  static constexpr int CTILE = round_up(TY * CZ * int(sizeof(T)), 128);
  static constexpr int NSLOT = RX + STAGES;
  static constexpr int THREADS = TZ * (TY / PY);

  // group s: its radius along axis 0 (x), 1 (y) or 2 (z); its box, pitch,
  // queue length, slot bytes, ring slots, the byte offset of its ring, the
  // bytes a plane moves, and the stages it starts late
  __host__ __device__ static constexpr int rx(int s) { return G::of(s, 0); }
  __host__ __device__ static constexpr int ry(int s) { return G::of(s, 1); }
  __host__ __device__ static constexpr int rz(int s) { return G::of(s, 2); }
  __host__ __device__ static constexpr int by(int s) { return TY + 2 * ry(s); }
  __host__ __device__ static constexpr int bz(int s) {
    return round_up(TZ + 2 * rz(s) + A - 1, A);
  }
  __host__ __device__ static constexpr int pz(int s) { return bz(s); }
  __host__ __device__ static constexpr int qlen(int s) {
    return 2 * rx(s) + 1;
  }
  __host__ __device__ static constexpr int slot_bytes(int s) {
    return round_up(by(s) * bz(s) * int(sizeof(T)), 128);
  }
  __host__ __device__ static constexpr int nslot(int s) {
    return rx(s) + STAGES;
  }
  __host__ __device__ static constexpr int ring_at(int s) {
    int o = 0;
    for (int t = 0; t < s; ++t) o += nslot(t) * slot_bytes(t);
    return o;
  }
  __host__ __device__ static constexpr unsigned box_bytes(int s) {
    return unsigned(by(s) * bz(s)) * unsigned(sizeof(T));
  }
  __host__ __device__ static constexpr int lag(int s) {
    return 2 * (RX - rx(s));
  }
  static constexpr bool union_is_max() {
    for (int d = 0; d < 3; ++d) {
      int m = 0;
      for (int s = 0; s < NS; ++s) m = G::of(s, d) > m ? G::of(s, d) : m;
      if (m != (d == 0 ? RX : d == 1 ? RY : RZ)) return false;
    }
    return true;
  }
  static constexpr bool boxes_fit() {
    for (int s = 0; s < NS; ++s)
      if (by(s) > 256 || bz(s) > 256) return false;
    return true;
  }

  static constexpr int RING = ring_at(NS);       // every group's ring
  static constexpr int NB = RX + STAGES;         // mbarriers, one a stage slot
  static constexpr int BARS = round_up(NB * 8, 128);
  // 128 bytes of slack to align the dynamic shared memory by hand
  static constexpr int SMEM = 128 + BARS + RING + STAGES * NC * CTILE;
  static constexpr unsigned CENTRE_BYTES = NC * TY * CZ * sizeof(T);
  static_assert(NS >= 1, "a staged group streams");
  static_assert(G::N == NS, "a shape for each staged group");
  static_assert(union_is_max(), "(RX, RY, RZ) is the groups' union");
  static_assert(STAGES >= 2, "at least one plane in flight");
  static_assert(TY % PY == 0 && THREADS % 32 == 0, "whole warps");
  static_assert(boxes_fit(), "TMA boxes are at most 256 a side");
  static_assert(TZ % A == 0, "tiles of whole 16-byte rows");
};

template <class L, int NP, class Point>
__global__ void __launch_bounds__(L::THREADS, 2)
stream_kernel(__grid_constant__ const StreamArgs<typename L::T, L::NS, L::NC,
                                                 NP> a) {
  using T = typename L::T;
  constexpr int NS = L::NS, NC = L::NC, RX = L::RX, PY = L::PY;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  unsigned char* ring = base + L::BARS;
  unsigned char* cring = ring + L::RING;

  const int lz = threadIdx.x, ly0 = threadIdx.y * PY;
  const int tid = threadIdx.y * L::TZ + lz;
  const int z0 = blockIdx.x * L::TZ, y0 = blockIdx.y * L::TY;
  const int x0 = blockIdx.z * a.tx;
  const int nx = min(a.tx, a.n[0] - x0);
  // stage j completes output plane x0 + j - 2RX: it brings group s's plane
  // rx(s) beyond it, from stage lag(s) on
  const int nj = nx + 2 * RX;

  // group s's slot of stage j, and its thread's column in it
  auto plane = [&](int j, auto S) {
    constexpr int s = decltype(S)::value;
    return reinterpret_cast<T*>(ring + L::ring_at(s) +
                                (j % L::nslot(s)) * L::slot_bytes(s));
  };
  auto column = [&](int j, auto S) {
    constexpr int s = decltype(S)::value;
    return plane(j, S) + (ly0 + L::ry(s)) * L::pz(s) + lz + L::rz(s) +
           a.zs[s];
  };
  auto ctile = [&](int j, int c) {
    return reinterpret_cast<T*>(cring + ((j % L::STAGES) * NC + c) * L::CTILE);
  };
  // Thread 0: the copies of stage j, and with it the centre tiles of the
  // output plane it completes, x0 + j - 2RX.
  auto issue = [&](int j) {
    uint64_t* b = bar + j % L::NB;
    const bool cen = NC > 0 && j >= 2 * RX;
    unsigned bytes = cen ? L::CENTRE_BYTES : 0u;
    for_each_group<NS>([&](auto S) {
      if (j >= L::lag(S.value)) bytes += L::box_bytes(S.value);
    });
    mbar_expect_tx(b, bytes);
    for_each_group<NS>([&](auto S) {
      constexpr int s = decltype(S)::value;
      if (j >= L::lag(s))
        tma_load_3d(plane(j, S), &a.smap[s], b,
                    a.sorg[s][2] - L::rz(s) - a.zs[s] + z0,
                    a.sorg[s][1] + y0 - L::ry(s),
                    a.sorg[s][0] + x0 - 2 * RX + L::rx(s) + j);
    });
    if (cen) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load_3d(ctile(j, c), &a.cmap[c], b, a.corg[c][2] - a.czs[c] + z0,
                    a.corg[c][1] + y0, a.corg[c][0] + x0 + j - 2 * RX);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < L::NB; ++i) mbar_init(bar + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(nj, L::NB); ++j) issue(j);

  // group s's queue is q[.][s][0 .. qlen(s)); the rest of a row is unused
  T q[PY][NS][L::Q];
#pragma unroll
  for (int k = 0; k < PY; ++k)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < L::Q; ++i) q[k][s][i] = T(0);
  const int z = z0 + lz;

  for (int j = 0; j < nj; ++j) {
    mbar_wait(bar + j % L::NB, (j / L::NB) & 1);
    for_each_group<NS>([&](auto S) {
      constexpr int s = decltype(S)::value, QS = L::qlen(s);
      if (j >= L::lag(s)) {
        const T* nw = column(j, S);
#pragma unroll
        for (int k = 0; k < PY; ++k) {
#pragma unroll
          for (int i = 0; i + 1 < QS; ++i) q[k][s][i] = q[k][s][i + 1];
          q[k][s][QS - 1] = nw[k * L::pz(s)];
        }
      }
    });
    if (j >= 2 * RX) {
      const int x = x0 + j - 2 * RX;
      // each group's current plane: the one its queue is centred on
      const T* sp[PY][NS];
      for_each_group<NS>([&](auto S) {
        constexpr int s = decltype(S)::value;
        const T* cur = column(j - L::rx(s), S);
#pragma unroll
        for (int k = 0; k < PY; ++k) sp[k][s] = cur + k * L::pz(s);
      });
#pragma unroll
      for (int k = 0; k < PY; ++k) {
        const int y = y0 + ly0 + k;
        const bool valid = y < a.n[1] && z < a.n[2];
        T cv[NC > 0 ? NC : 1];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          cv[c] = ctile(j, c)[(ly0 + k) * L::CZ + lz + a.czs[c]];
        const T v = Point::eval(q[k], sp[k], cv, a);
        if (valid)
          a.out[x * a.out_stride[0] + y * a.out_stride[1] + z] = v;
      }
    }
    // every thread is done with the slots of each group's current plane,
    // which stage j + STAGES takes
    __syncthreads();
    if (tid == 0 && j >= RX && j + L::STAGES < nj) issue(j + L::STAGES);
  }
}

// Host side. Rows, in order: the target, the NS staged groups, the NC
// centre groups; for each, `ptrs` its base (the whole allocation), `dims`
// its allocated extents (x, y, z) and `org` the element index of the
// region's first point in it. Encodes the tensor maps (a few microseconds
// of host time) and launches on `stream`. Returns the cudaError_t of the
// launch (0 on success) or a negative tensor-map error; the caller raises
// on anything but 0.
template <class L, int NP, class Point>
int stream_launch(void* const* ptrs, const long long* dims, const int* org,
                  const int* n, const double* params, int tx, void* stream) {
  using T = typename L::T;
  constexpr int NS = L::NS, NC = L::NC;
  for (int j = 0; j < 3; ++j)
    if (n[j] <= 0) return 0;  // empty region: nothing to do
  if (tx <= 0) return static_cast<int>(cudaErrorInvalidValue);
  StreamArgs<T, NS, NC, NP> a;
  // the target row at the region's first point
  a.out = static_cast<T*>(ptrs[0]) + (org[0] * dims[1] + org[1]) * dims[2] +
          org[2];
  a.out_stride[0] = dims[1] * dims[2];
  a.out_stride[1] = dims[2];
  for (int s = 0; s < NS; ++s) {
    const int r = 1 + s;
    const int rc = encode_map_3d<T>(&a.smap[s], ptrs[r], dims + 3 * r,
                                    L::by(s), L::bz(s));
    if (rc != 0) return rc;
    for (int j = 0; j < 3; ++j) a.sorg[s][j] = org[3 * r + j];
    a.zs[s] = ((a.sorg[s][2] - L::rz(s)) % L::A + L::A) % L::A;
  }
  for (int c = 0; c < NC; ++c) {
    const int r = 1 + NS + c;
    for (int j = 0; j < 3; ++j) a.corg[c][j] = org[3 * r + j];
    a.czs[c] = a.corg[c][2] % L::A;
    const int rc = encode_map_3d<T>(&a.cmap[c], ptrs[r], dims + 3 * r, L::TY,
                                    L::CZ);
    if (rc != 0) return rc;
  }
  for (int j = 0; j < 3; ++j) a.n[j] = n[j];
  a.tx = tx;
  for (int i = 0; i < NP; ++i) a.p[i] = static_cast<T>(params[i]);
  // the attribute belongs to a device: set it once on each device the
  // kernel launches on (the caller makes the launch's device current), as
  // the self-test does (csrc/selftest.cu)
  static bool smem_set[64] = {};
  int dev = 0;
  const cudaError_t cur = cudaGetDevice(&dev);
  if (cur != cudaSuccess) return static_cast<int>(cur);
  if (dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    const cudaError_t attr = cudaFuncSetAttribute(
        stream_kernel<L, NP, Point>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    smem_set[dev] = true;
  }
  const dim3 grid((n[2] + L::TZ - 1) / L::TZ, (n[1] + L::TY - 1) / L::TY,
                  (n[0] + tx - 1) / tx);
  stream_kernel<L, NP, Point><<<grid, dim3(L::TZ, L::TY / L::PY), L::SMEM,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of the kernel that fit on one SM, as the runtime computes them
// from its registers, shared memory and threads. Returns the cudaError_t.
template <class L, int NP, class Point>
int stream_occupancy(int* ctas) {
  const cudaError_t attr = cudaFuncSetAttribute(
      stream_kernel<L, NP, Point>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, stream_kernel<L, NP, Point>, L::THREADS, L::SMEM));
}

}  // namespace dtpu
