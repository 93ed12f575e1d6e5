// Dual-quant Lorenzo quantizer over a float32 tensor of up to 8 axes: the
// lattice index q = round(x / 2eb), the Lorenzo residual d = q - L(q), the
// code d + radius (0 for an outlier) and the outlier mask.
//
// Replaces the TPU kernel src/repro/kernels/lorenzo.py:quantize1d (body
// _quant_kernel; entry ops.lorenzo_quantize) and, on the card, also the N-D
// jnp composition the reference's Pallas backend runs beside it
// (core/sz/lorenzo.py:quantize).  It computes what core/sz/lorenzo.py:
// quantize computes, bit for bit:
//   * q = __float2int_rn(__fdiv_rn(x, two_eb)): an IEEE division (never a
//     reciprocal multiply, which moves lattice ties) rounded half to even;
//     two_eb is the runtime float32(eb) * 2;
//   * d over the tensor's k non-unit axes (the wrapper squeezes the unit
//     axes: a difference along a length-1 axis is the identity) is the
//     inclusion-exclusion sum of q over the 2^k corners c - e_S, S a subset
//     of the axes, with sign (-1)^|S| and zero outside the domain.  The
//     reference takes the per-axis differences one after another; those
//     are linear maps and commute, so over int32 the corner sum is the
//     same number.  It is summed in uint32, which wraps as XLA's int32.
//
// What bounds it on the H100: 4 B read and 7 B written per value (u16 code,
// u8 mask, i32 residual), 0.082 ms for isabel3d's 25 M values at 3.35 TB/s.
// The first port gave each value a thread that recomputed q at all 2^k
// corners (8 IEEE divisions a value in 3-D) and found its coordinates with
// k run-time `%` and `/`: compute, not bytes, set its pace (3.1x the bound
// in 3-D, 1.5x in 1-D).  So, for k <= 3 (the tensor seen as Z x R x C,
// unit axes in front), one division a value:
//   * k 2 or 3, the tiled kernel: a block owns an 8 x 128 tile of the two
//     fastest axes and a run of planes of the slowest.  For each plane it
//     stages q of the tile in shared memory, each value loaded (16-byte
//     loads where the rows allow) and divided once, plus a one-value halo
//     on the low side of each tiled axis (zero outside the domain): the
//     row above the tile, the column left of it.  Each thread forms the
//     2-D partial P = q - q_W - q_N + q_NW of 4 consecutive values from
//     two 16-byte shared loads, its west neighbours by a shuffle from the
//     lane before, and d = P(z) - P(z - 1) with the previous plane's P in
//     registers.  The next plane's loads start before this plane's
//     partials are formed.  A run starts by staging the plane before it
//     (P only, nothing stored), so the grid fills the card at any depth:
//     the wrapper's lorenzo.quantize_geometry cuts the planes into runs
//     of at least 4 until the grid is ~8 waves of blocks (more, shorter
//     runs ran faster on the H100 than one wave of long ones, though each
//     run stages a plane twice);
//   * k <= 1, the row kernel: a thread a group of 4 values, the west
//     neighbour by a shuffle, no shared memory;
//   * coordinates come from blockIdx and the loop counters (shifts by the
//     tile's powers of two), no `%` or `/` a value; outputs are stored 4
//     at a time (8 B of codes, 4 B of mask, 16 B of residual) where the
//     rows allow.
// The halos add ~13% of loads and divisions at 8 x 128, plus one plane a
// run of planes (a quarter at isabel3d's runs of 4).  Past 3 axes (a KV page is 4-D) the corner-sum kernel
// runs: one thread a value, 2^k divisions; a page holds 32,768 values.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

constexpr int kMaxAxes = 8;
constexpr int kThreads = 256;
// Blocks of the tiled kernel an SM holds (its registers bounded to fit):
// lorenzo.QUANT_BLOCKS_PER_SM, which sizes its runs of planes.
constexpr int kTiledBlocksPerSm = 6;

__device__ __forceinline__ uint32_t lattice_of(float v, float two_eb) {
  return static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v, two_eb)));
}

__device__ __forceinline__ uint32_t lattice(const float* __restrict__ x,
                                            unsigned i, float two_eb) {
  return lattice_of(__ldg(x + i), two_eb);
}

// The outputs of one value at flat index i from its residual d.
__device__ __forceinline__ void store_one(unsigned i, uint32_t d, int radius,
                                          uint16_t* __restrict__ codes,
                                          uint8_t* __restrict__ outlier,
                                          int* __restrict__ resid) {
  const int code = static_cast<int>(d + static_cast<uint32_t>(radius));
  const bool out = code < 0 || code >= 2 * radius;
  codes[i] = out ? uint16_t{0} : static_cast<uint16_t>(code);
  outlier[i] = out ? 1 : 0;
  resid[i] = static_cast<int>(d);
}

// Four residuals d of the values i..i+3 (i % 4 == 0) into the outputs: one
// vector store each where kVec and all four lie below `end`, else value by
// value below it.
template <bool kVec>
__device__ __forceinline__ void store4(unsigned i, unsigned end,
                                       const uint32_t (&d)[4], int radius,
                                       uint16_t* __restrict__ codes,
                                       uint8_t* __restrict__ outlier,
                                       int* __restrict__ resid) {
  if (kVec && i + 3 < end) {
    uint32_t cw[4];
    uint32_t mask = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int code = static_cast<int>(d[e] + static_cast<uint32_t>(radius));
      const bool out = code < 0 || code >= 2 * radius;
      cw[e] = out ? 0u : static_cast<uint32_t>(code);
      mask |= (out ? 1u : 0u) << (8 * e);
    }
    *reinterpret_cast<uint2*>(codes + i) =
        make_uint2(cw[0] | (cw[1] << 16), cw[2] | (cw[3] << 16));
    *reinterpret_cast<uint32_t*>(outlier + i) = mask;
    *reinterpret_cast<int4*>(resid + i) =
        make_int4(static_cast<int>(d[0]), static_cast<int>(d[1]),
                  static_cast<int>(d[2]), static_cast<int>(d[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (i + e < end) store_one(i + e, d[e], radius, codes, outlier, resid);
    }
  }
}

// Four values x[i..i+3] of a row whose end is `end` (i % 4 == 0 within an
// aligned row where kVec), zero past it: one 16-byte load where all four
// lie inside, else value by value.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        unsigned i, unsigned end) {
  if (kVec && i + 3 < end) {
    return __ldg(reinterpret_cast<const float4*>(x + i));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < end) v.x = __ldg(x + i);
  if (i + 1 < end) v.y = __ldg(x + i + 1);
  if (i + 2 < end) v.z = __ldg(x + i + 2);
  if (i + 3 < end) v.w = __ldg(x + i + 3);
  return v;
}

__device__ __forceinline__ uint4 lattice4(float4 v, float two_eb) {
  return make_uint4(lattice_of(v.x, two_eb), lattice_of(v.y, two_eb),
                    lattice_of(v.z, two_eb), lattice_of(v.w, two_eb));
}

// ---------------------------------------------------------------------------
// Row kernel, k <= 1
// ---------------------------------------------------------------------------

// A thread a group of 4 values, no shared memory and no barrier: the west
// neighbour's q comes from the lane before by a shuffle, at a warp's first
// lane from one more load and division (1 value in 128).  Every lane of a
// warp runs the same iterations (the shuffle needs them all).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) lorenzo_quantize_row(
    const float* __restrict__ x, unsigned n, float two_eb, int radius,
    uint16_t* __restrict__ codes, uint8_t* __restrict__ outlier,
    int* __restrict__ resid) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned step = 4u * gridDim.x * blockDim.x;
  for (unsigned w0 = 4u * (blockIdx.x * blockDim.x + threadIdx.x - lane);
       w0 < n; w0 += step) {
    const unsigned i = w0 + 4 * lane;
    const uint4 q = lattice4(load4<kVec>(x, i, n), two_eb);
    uint32_t west = __shfl_up_sync(0xffffffffu, q.w, 1);
    if (lane == 0) west = i > 0 ? lattice(x, i - 1, two_eb) : 0u;
    const uint32_t d[4] = {q.x - west, q.y - q.x, q.z - q.y, q.w - q.z};
    store4<kVec>(i, n, d, radius, codes, outlier, resid);
  }
}

// ---------------------------------------------------------------------------
// Tiled kernel, k 2 or 3
// ---------------------------------------------------------------------------

// The tensor as Z x R x C (C fastest), tiled TR x TC, runs of z_run planes.
struct Tiled {
  int Z, R, C;
  int tiles_c, tiles_r;  // tiles a plane along C and R
  int z_run;             // planes a block walks
};

// kVec: x is 16-byte aligned and C % 4 == 0, so a group of 4 inside a row
// is one aligned vector.  A plane's loads start before the previous
// plane's partials are formed, so they are in flight meanwhile.
template <int TR, int TC, bool kVec>
__global__ void __launch_bounds__(kThreads, kTiledBlocksPerSm)
    lorenzo_quantize_tiled(
    const float* __restrict__ x, Tiled t, float two_eb, int radius,
    uint16_t* __restrict__ codes, uint8_t* __restrict__ outlier,
    int* __restrict__ resid) {
  constexpr int kGroups = TC / 4;                   // groups of 4 a row
  constexpr int kSlots = TR * TC / (4 * kThreads);  // groups a thread
  constexpr int kHaloCol = kThreads - (TR + 1);     // first halo-col thread
  constexpr int kStride = TC + 4;  // words a staged row: halo at 3, data 4..
  static_assert(TC % 128 == 0 && kGroups <= kThreads && kSlots >= 1 &&
                    (TR * TC) % (4 * kThreads) == 0 && kHaloCol >= kGroups,
                "a warp covers 128 columns of one row; every thread the "
                "same number of groups; the halo row and column threads "
                "apart");
  __shared__ __align__(16) uint32_t s[2][TR + 1][kStride];

  int b = blockIdx.x;
  const int c0 = (b % t.tiles_c) * TC;
  b /= t.tiles_c;
  const int r0 = (b % t.tiles_r) * TR;
  const int zb = (b / t.tiles_r) * t.z_run;
  const int ze = min(zb + t.z_run, t.Z);
  const int lane = threadIdx.x & 31;
  const unsigned row_end = static_cast<unsigned>(t.C);
  const int hr = static_cast<int>(threadIdx.x) - kHaloCol;  // 0..TR, or < 0

  // The thread's values of plane z: its groups, a group of the halo row
  // (threads below kGroups), a value of the halo column (threads from
  // kHaloCol); zero outside the domain.
  float4 v[kSlots];
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  float hc = 0.f;
  auto fetch = [&](int z) {
    const unsigned plane = static_cast<unsigned>(z) * t.R;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int slot = threadIdx.x + j * kThreads;
      const int r = r0 + slot / kGroups;
      const int c = c0 + 4 * (slot % kGroups);
      v[j] = r < t.R ? load4<kVec>(x + (plane + r) * row_end, c, row_end)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (threadIdx.x < kGroups && r0 > 0) {
      hv = load4<kVec>(x + (plane + r0 - 1) * row_end, c0 + 4 * threadIdx.x,
                       row_end);
    }
    const int r = r0 - 1 + hr;
    if (hr >= 0 && c0 > 0 && r >= 0 && r < t.R) {
      hc = __ldg(x + (plane + r) * row_end + c0 - 1);
    }
  };

  uint32_t prev[kSlots][4];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    prev[j][0] = prev[j][1] = prev[j][2] = prev[j][3] = 0;
  }
  int buf = 0;
  int z = zb > 0 ? zb - 1 : 0;
  fetch(z);
  for (; z < ze; ++z, buf ^= 1) {
    // Stage plane z, each value divided once.  (The buffer was last read
    // two planes ago, before the barrier that ended the last staging.)
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int slot = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(
          &s[buf][1 + slot / kGroups][4 + 4 * (slot % kGroups)]) =
          lattice4(v[j], two_eb);
    }
    if (threadIdx.x < kGroups) {
      *reinterpret_cast<uint4*>(&s[buf][0][4 + 4 * threadIdx.x]) =
          lattice4(hv, two_eb);
    }
    if (hr >= 0) s[buf][hr][3] = lattice_of(hc, two_eb);
    __syncthreads();
    if (z + 1 < ze) fetch(z + 1);

    // P of each of the thread's groups; d against the plane before.
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int slot = threadIdx.x + j * kThreads;
      const int rr = slot / kGroups;
      const int g = slot % kGroups;
      const uint32_t* row = &s[buf][rr + 1][4 + 4 * g];
      const uint32_t* north = &s[buf][rr][4 + 4 * g];
      const uint4 a = *reinterpret_cast<const uint4*>(row);
      const uint4 n = *reinterpret_cast<const uint4*>(north);
      // West neighbours of the group's first value: the lane before holds
      // them, except at a warp's first lane (a new row, or the halo).
      uint32_t aw = __shfl_up_sync(0xffffffffu, a.w, 1);
      uint32_t nw = __shfl_up_sync(0xffffffffu, n.w, 1);
      if (lane == 0) {
        aw = row[-1];
        nw = north[-1];
      }
      const uint32_t p[4] = {(a.x - aw) - (n.x - nw), (a.y - a.x) - (n.y - n.x),
                             (a.z - a.y) - (n.z - n.y),
                             (a.w - a.z) - (n.w - n.z)};
      uint32_t d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[e] = p[e] - prev[j][e];
        prev[j][e] = p[e];
      }
      const int r = r0 + rr;
      const int c = c0 + 4 * g;
      if (z >= zb && r < t.R && c < t.C) {
        const unsigned i = (static_cast<unsigned>(z) * t.R + r) * row_end;
        store4<kVec>(i + c, i + row_end, d, radius, codes, outlier, resid);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Corner-sum kernel, k >= 4
// ---------------------------------------------------------------------------

// The squeezed shape.  n < 2^31 (the wrapper checks), so coordinates and
// offsets are 32-bit.
struct Geometry {
  unsigned dim[kMaxAxes];     // sizes, slowest first
  unsigned stride[kMaxAxes];  // C-order strides of the squeezed shape
};

// K, the number of axes, is a template argument: every loop over the axes
// and the corners unrolls, so the shape stays in the parameter space and
// registers.  (With K a run-time value, ptxas gave every thread a 72-byte
// local-memory frame for the shape.)  One thread a value recomputes its
// neighbours' q; the division is deterministic, so the neighbours' q are
// the ones their own threads find.
template <int K>
__global__ void __launch_bounds__(kThreads) lorenzo_quantize_kernel(
    const float* __restrict__ x, unsigned n, Geometry g, float two_eb,
    int radius, uint16_t* __restrict__ codes, uint8_t* __restrict__ outlier,
    int* __restrict__ resid) {
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    // Axes at their lower edge: their corners lie outside the domain.
    unsigned edge = 0;
    unsigned rest = i;
#pragma unroll
    for (int a = K - 1; a >= 0; --a) {
      if (rest % g.dim[a] == 0) edge |= 1u << a;
      rest /= g.dim[a];
    }
    uint32_t d = 0;
#pragma unroll
    for (unsigned s = 0; s < (1u << K); ++s) {
      if (s & edge) continue;
      unsigned off = 0;
#pragma unroll
      for (int a = 0; a < K; ++a) {
        if (s & (1u << a)) off += g.stride[a];
      }
      const uint32_t q = lattice(x, i - off, two_eb);
      d = (__popc(s) & 1) ? d - q : d + q;
    }
    store_one(i, d, radius, codes, outlier, resid);
  }
}

template <int K>
void launch_corners(const float* x, unsigned n, const Geometry& g,
                    float two_eb, int radius, uint16_t* codes,
                    uint8_t* outlier, int* resid, cudaStream_t stream) {
  long long blocks = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  if (blocks > (1ll << 20)) blocks = 1ll << 20;  // grid-stride beyond
  lorenzo_quantize_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(x, n, g, two_eb, radius, codes,
                                         outlier, resid);
}

// The tiled kernel's tile: 8 rows of 128 values, a group of 4 a thread.
constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
// Values a row-kernel block covers a grid-stride step, and its most blocks.
constexpr int kRowBlockValues = 4 * kThreads;
constexpr long long kRowMaxBlocks = 1ll << 20;

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for k
// outside [0, 8], n outside [1, 2^31), a kernel that does not take k, or
// outputs off a 16-byte boundary for the row and tiled kernels.  `dims` is
// a host array of the k non-unit axes' sizes, slowest first, whose product
// is n.  `tile` picks the kernel (the wrapper's lorenzo.quantize_geometry):
// 0 the corner sum (any k), 1 the row kernel (k <= 1: one block a
// grid-stride step of 1,024 values, at most 2^20 blocks), 2 the tiled
// kernel (k 2 or 3: 8 x 128 tiles, runs of `z_run` planes, one block a
// tile and run).  Outputs hold n values each.
extern "C" int repro_lorenzo_quantize(const void* x, long long n,
                                      const long long* dims, int k, int tile,
                                      int z_run, float two_eb, int radius,
                                      void* codes, void* outlier, void* resid,
                                      void* stream) {
  using namespace repro_torch;
  if (k < 0 || k > kMaxAxes || n < 1 || n >= (1ll << 31)) return -1;
  const float* xp = static_cast<const float*>(x);
  const unsigned nn = static_cast<unsigned>(n);
  uint16_t* cp = static_cast<uint16_t*>(codes);
  uint8_t* op = static_cast<uint8_t*>(outlier);
  int* rp = static_cast<int*>(resid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool x_aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool out_aligned = (reinterpret_cast<uintptr_t>(codes) |
                            reinterpret_cast<uintptr_t>(outlier) |
                            reinterpret_cast<uintptr_t>(resid)) % 16 == 0;
  if (tile == 1) {
    if (k > 1 || !out_aligned) return -1;
    long long blocks = (n + kRowBlockValues - 1) / kRowBlockValues;
    if (blocks > kRowMaxBlocks) blocks = kRowMaxBlocks;
    const auto grid = static_cast<unsigned>(blocks);
    if (x_aligned) {
      lorenzo_quantize_row<true><<<grid, kThreads, 0, s>>>(
          xp, nn, two_eb, radius, cp, op, rp);
    } else {
      lorenzo_quantize_row<false><<<grid, kThreads, 0, s>>>(
          xp, nn, two_eb, radius, cp, op, rp);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (tile == 2) {
    if (k < 2 || k > 3 || z_run < 1 || !out_aligned) return -1;
    Tiled t{};
    t.Z = k == 3 ? static_cast<int>(dims[0]) : 1;
    t.R = static_cast<int>(dims[k - 2]);
    t.C = static_cast<int>(dims[k - 1]);
    t.tiles_c = (t.C + kTileCols - 1) / kTileCols;
    t.tiles_r = (t.R + kTileRows - 1) / kTileRows;
    t.z_run = z_run;
    const auto grid = static_cast<unsigned>(
        static_cast<long long>(t.tiles_c) * t.tiles_r *
        ((t.Z + z_run - 1) / z_run));
    if (x_aligned && t.C % 4 == 0) {
      lorenzo_quantize_tiled<kTileRows, kTileCols, true>
          <<<grid, kThreads, 0, s>>>(xp, t, two_eb, radius, cp, op, rp);
    } else {
      lorenzo_quantize_tiled<kTileRows, kTileCols, false>
          <<<grid, kThreads, 0, s>>>(xp, t, two_eb, radius, cp, op, rp);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (tile != 0) return -1;
  Geometry g{};
  unsigned stride = 1;
  for (int a = k - 1; a >= 0; --a) {
    g.dim[a] = static_cast<unsigned>(dims[a]);
    g.stride[a] = stride;
    stride *= g.dim[a];
  }
  switch (k) {
#define REPRO_CASE(K) \
  case K: launch_corners<K>(xp, nn, g, two_eb, radius, cp, op, rp, s); break;
    REPRO_CASE(0) REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
