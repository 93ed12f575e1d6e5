// Device functions shared by the fused kernels: the fused decode kernels
// (decode_tiles_fused.cu, decode_tiles_fused_nd.cu) and the epilogues alone
// that follow the padded decoder (dequant_reconstruct.cu,
// dequant_reconstruct_nd.cu), and the 1-D inverse Lorenzo
// (reconstruct1d.cu).  A fused kernel and its epilogue differ only in where
// a tile's residuals come from (decoded from the stream, or read from a
// code or residual array); the scan, the carries and the float epilogue
// are the functions below.
//
// CUDA counterparts of src/repro/kernels/fused_decode.py's _dequant_block
// (code - radius, outlier scatter) and of the cumsums and float epilogue of
// _dequant_recon_block / _recon_rows_block, plus what a TPU grid gave those
// kernels for free and a CUDA grid does not: an order among tiles.
//
// Work order.  CUDA blocks start and finish in no fixed order.  Each block
// therefore takes a ticket from an atomic counter (take_ticket) before it
// works on anything, and the ticket names its work (a 1-D kernel's unit u,
// a ticket each time its persistent block comes round; an N-D kernel maps
// tickets to units by anti-diagonal), so work is claimed in ticket order by
// blocks that are already running.  A block only ever waits for work of a
// lower ticket, whose block holds it and is running too, and publishes
// what others wait for before it waits itself, so the wait always ends,
// whatever the schedule.
//
// Integer arithmetic.  The residuals and their prefix sums are uint32_t
// (addition mod 2^32, which is associative), cast to int32_t only at the
// end: any grouping gives the bits of the reference's int32 cumsum, and a
// sum that leaves the int32 range mid-scan is not undefined behaviour.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {

// Shared scratch words a fused block uses beside its tile and its LUT:
// 32 warp flags, 32 warp sums (which also hold a unit's outlier slices and
// its look-back's value offsets at other times), the ticket, the carry
// broadcast and the lanes of each tile of a unit.
constexpr int kFusedScratchWords = 80;
constexpr int kTicketWord = 64;
constexpr int kCarryWord = 65;
constexpr int kLaneWords = 66;   // 8 words: the lanes of a unit's tiles
constexpr int kBoundWords = 0;   // 16 words: its tiles' outlier slices

// A 1-D block's unit slot: what the write of a staged unit needs once the
// block has gone on to the next one: its chunk offsets (one a warp,
// at most 16), its outlier slice and its aggregate.
constexpr int kSlotWords = 20;
constexpr int kSlotLo = 16, kSlotHi = 17, kSlotAggregate = 18;

// Shared memory of a 1-D block (decode_tiles_fused.cu): two stages of a unit
// of `unit` codes as uint16, each to a 16-byte boundary, the scratch words,
// two unit slots and the LUT (fused_decode.fused_unit_smem).
inline size_t fused_unit_smem(long long unit, int lut_size) {
  return 2 * ((2 * static_cast<size_t>(unit) + 15) / 16 * 16) +
         4 * (kFusedScratchWords + 2 * kSlotWords) +
         3 * static_cast<size_t>(lut_size);
}

// A 1-D unit's status word carries its flag and its value together, so a
// reader needs no other store ordered before it: relaxed loads and stores
// at GPU scope (coherent in L2, never reordered into a stale read), with
// none of a release's wait for the thread's earlier stores to land.
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The block's tile index: the next value of the launch's ticket counter.
__device__ __forceinline__ int take_ticket(unsigned* ticket,
                                           uint32_t* scratch) {
  if (threadIdx.x == 0) scratch[kTicketWord] = atomicAdd(ticket, 1u);
  __syncthreads();
  return static_cast<int>(scratch[kTicketWord]);
}

// A wait for an earlier tile always ends (see above).  Should a fault break
// that, the block traps after ~2^26 polls (tens of seconds): the launch
// fails with an error instead of holding the card forever.
constexpr long long kMaxPolls = 1ll << 26;

__device__ __forceinline__ void count_poll(long long* polls) {
  if (++*polls > kMaxPolls) __trap();
}

// The slice [lo, hi) of the outlier side list of each of a unit's n_here
// (<= 8) tiles, in scratch words [0, 8) and [8, 16): threads 0 .. n_here-1
// load them; the caller's next barrier publishes them.
template <typename TileOf>
__device__ __forceinline__ void load_unit_bounds(
    int n_here, TileOf tile_of, const int* __restrict__ obounds,
    uint32_t* scratch) {
  if (static_cast<int>(threadIdx.x) < n_here) {
    const int t = tile_of(threadIdx.x);
    scratch[kBoundWords + threadIdx.x] = static_cast<uint32_t>(obounds[t]);
    scratch[kBoundWords + 8 + threadIdx.x] =
        static_cast<uint32_t>(obounds[t + 1]);
  }
}

// What a tile stage holds at a position: the residual d = code - radius
// (uint32_t, the N-D kernels and the epilogues), with each outlier's exact
// residual scattered in, or the code itself (uint16_t, the 1-D kernel,
// which reads residuals through UnitResiduals and patches its outliers in
// there).
__device__ __forceinline__ uint32_t stage_zero(uint32_t*, int radius) {
  return static_cast<uint32_t>(-radius);
}
__device__ __forceinline__ uint16_t stage_zero(uint16_t*, int) { return 0; }
__device__ __forceinline__ void put_code(uint32_t* d, int i, int sym,
                                         int radius) {
  d[i] = static_cast<uint32_t>(sym - radius);
}
__device__ __forceinline__ void put_code(uint16_t* d, int i, int sym, int) {
  d[i] = static_cast<uint16_t>(sym);
}

// The outlier half of _dequant_block for a unit's n_here tiles: the exact
// residuals of each tile's slice of the outlier side list (the slices
// load_unit_bounds left), tile i's scattered into d + i * block.  The
// caller's ops layer finds each tile's slice by searchsorted, which assumes
// the side list's positions ascend with the -1 padding at the tail, as both
// packages' compress write them.  Ends with __syncthreads().
template <typename TileOf>
__device__ __forceinline__ void scatter_unit_outliers(
    int n_here, TileOf tile_of, int block, const int* __restrict__ opos,
    const int* __restrict__ oval, const uint32_t* scratch, uint32_t* d) {
  for (int i = 0; i < n_here; ++i) {
    const int hi = static_cast<int>(scratch[kBoundWords + 8 + i]);
    const long long base = static_cast<long long>(tile_of(i)) * block;
    uint32_t* di = d + static_cast<size_t>(i) * block;
    for (int o = static_cast<int>(scratch[kBoundWords + i]) + threadIdx.x;
         o < hi; o += blockDim.x) {
      const long long loc = opos[o] - base;
      if (loc >= 0 && loc < block) di[loc] = static_cast<uint32_t>(oval[o]);
    }
  }
  __syncthreads();
}

// _dequant_block for a unit's n_here tiles tile_of(0 .. n_here - 1) of
// `block` codes read from a code array (the N-D epilogue), tile i into
// d + i * block: d = code - radius, then the tiles' outliers.  Each thread
// has kLoadBatch codes in flight at once, and the tiles' outlier slices
// load beside them.  Uses scratch words [0, 16).  Ends with
// __syncthreads().
constexpr int kLoadBatch = 8;

template <typename TileOf>
__device__ __forceinline__ void load_unit_residuals(
    const uint16_t* __restrict__ codes, int n_here, TileOf tile_of,
    int block, int radius, const int* __restrict__ opos,
    const int* __restrict__ oval, const int* __restrict__ obounds,
    uint32_t* d, uint32_t* scratch) {
  const int nt = blockDim.x;
  const int n = n_here * block;
  load_unit_bounds(n_here, tile_of, obounds, scratch);
  if (block % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 7) == 0) {
    // Every tile starts on an 8-byte boundary: 4 codes a load.
    const int n4 = n / 4, block4 = block / 4;
    const uint2* codes4 = reinterpret_cast<const uint2*>(codes);
    for (int x0 = threadIdx.x; x0 < n4; x0 += kLoadBatch * nt) {
      uint2 c[kLoadBatch];
      int i = x0 / block4, r = x0 - i * block4;
#pragma unroll
      for (int b = 0; b < kLoadBatch; ++b) {
        const int x = x0 + b * nt;
        c[b] = x < n4 ? codes4[static_cast<long long>(tile_of(i)) * block4 +
                               r]
                      : make_uint2(0u, 0u);
        for (r += nt; r >= block4; r -= block4) ++i;
      }
#pragma unroll
      for (int b = 0; b < kLoadBatch; ++b) {
        const int x = x0 + b * nt;
        if (x < n4) {
          uint32_t* dst = d + 4 * static_cast<size_t>(x);
          dst[0] = static_cast<uint32_t>(static_cast<int>(c[b].x & 0xffffu) -
                                         radius);
          dst[1] = static_cast<uint32_t>(static_cast<int>(c[b].x >> 16) -
                                         radius);
          dst[2] = static_cast<uint32_t>(static_cast<int>(c[b].y & 0xffffu) -
                                         radius);
          dst[3] = static_cast<uint32_t>(static_cast<int>(c[b].y >> 16) -
                                         radius);
        }
      }
    }
    __syncthreads();
    scatter_unit_outliers(n_here, tile_of, block, opos, oval, scratch, d);
    return;
  }
  for (int x0 = threadIdx.x; x0 < n; x0 += kLoadBatch * nt) {
    int c[kLoadBatch];
    int i = x0 / block, r = x0 - i * block;   // tile and place of x
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int x = x0 + b * nt;
      c[b] = x < n ? codes[static_cast<long long>(tile_of(i)) * block + r]
                   : 0;
      for (r += nt; r >= block; r -= block) ++i;
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int x = x0 + b * nt;
      if (x < n) d[x] = static_cast<uint32_t>(c[b] - radius);
    }
  }
  __syncthreads();
  scatter_unit_outliers(n_here, tile_of, block, opos, oval, scratch, d);
}

// The lanes of output tile `tile` (of n_tiles, `block` codes each): the
// subsequences its codes can come from, s0[tile] .. s0[tile + 1] (..
// n_subseq - 1 for the last tile; offsets are an exclusive prefix sum of
// counts, so a later subsequence's output starts past the tile), at most
// ss_max, the lanes the reference has (it drops the rest).
__device__ __forceinline__ int tile_span(const int* __restrict__ s0,
                                         int tile, int n_tiles, int n_subseq,
                                         int ss_max) {
  const int last = tile + 1 < n_tiles ? s0[tile + 1] : n_subseq - 1;
  return min(max(last - s0[tile] + 1, 0), ss_max);
}

// Lane j of output tile `tile` decodes its subsequence through common.cuh's
// bit-buffer lane decoder (decode_lane_buf) and writes d = code - radius
// (or the code: put_code) into the tile's stage at local = offset -
// tile_base + min(k, 127) inside [0, block).  Exits, as in
// decode_tiles.cu: a lane past the last subsequence does no work; a lane
// whose output starts past the tile leaves at once; a lane stops as soon
// as its next symbol would land past the tile end.  Each drops only writes
// the reference drops.
template <typename D>
__device__ __forceinline__ void decode_lane_residuals(
    const uint32_t* __restrict__ units, long long n_units,
    const int* __restrict__ start_abs, const int* __restrict__ end_abs,
    const int* __restrict__ offsets, const int* __restrict__ s0,
    const int* __restrict__ lut_base, int n_subseq, int total_bits,
    const uint16_t* s_sym, const uint8_t* s_len, int lut_size, int max_len,
    int tile, int block, int j, int radius, D* d) {
  const int s = s0[tile] + j;
  if (s >= n_subseq) return;                 // clipped lane: no work
  const long long off_ll =
      offsets[s] - static_cast<long long>(tile) * block;
  if (off_ll >= block) return;               // output starts past the tile
  const int off = static_cast<int>(max(off_ll, -2LL * kMaxSyms));
  int row_id, start, end;
  subseq_window(start_abs[s], end_abs[s], total_bits, &row_id, &start, &end);
  uint32_t row[kRowUnits];
  load_row(units, n_units, row_id, row);
  const int lb = lut_base != nullptr ? lut_base[s] : 0;
  int land;
  decode_lane_buf(row, start, end, s_sym, s_len, lut_size, lb, max_len,
                  &land, [&](int k, int sym) {
                    const int local = off + min(k, kMaxSyms - 1);
                    if (local >= block) return false;
                    if (local >= 0) put_code(d, local, sym, radius);
                    return true;
                  });
}

// _dequant_block for the n_here tiles tile_of(0 .. n_here - 1) of `block`
// codes each, decoded from the stream (the fused decode kernels) into
// d + i * block: d = code - radius at every position (a position no lane
// writes holds code 0, as in the reference's zero-initialised tile), then
// each tile's outliers (with D = uint16_t: the codes alone, the outliers
// left to UnitResiduals).  The lanes of all n_here tiles (at most 8) are
// spread over the block's threads at once.  The caller has staged the LUT
// (stage_lut); the first barrier here publishes it.  Threads 0 .. n_here-1
// find one tile's lanes and outlier slice each.  Uses scratch words
// [0, 16) and [66, 74).  Ends with __syncthreads().
template <typename TileOf, typename D>
__device__ __forceinline__ void stage_unit_residuals(
    const uint32_t* __restrict__ units, long long n_units,
    const int* __restrict__ start_abs, const int* __restrict__ end_abs,
    const int* __restrict__ offsets, const int* __restrict__ s0,
    const int* __restrict__ lut_base, int n_subseq, int total_bits,
    int lut_size, int max_len, int n_tiles, int n_here, TileOf tile_of,
    int block, int ss_max, int radius, const int* __restrict__ opos,
    const int* __restrict__ oval, const int* __restrict__ obounds,
    const uint16_t* s_sym, const uint8_t* s_len, D* d, uint32_t* scratch) {
  uint32_t* span = scratch + kLaneWords;     // span[i]: tile i's lanes
  const D zero_code = stage_zero(d, radius);
  const int n = n_here * block;
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = zero_code;
  load_unit_bounds(n_here, tile_of, obounds, scratch);
  if (static_cast<int>(threadIdx.x) < n_here) {
    span[threadIdx.x] = static_cast<uint32_t>(
        tile_span(s0, tile_of(threadIdx.x), n_tiles, n_subseq, ss_max));
  }
  __syncthreads();
  int lanes = 0;
  for (int i = 0; i < n_here; ++i) lanes += static_cast<int>(span[i]);
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    int i = 0, j = l;                        // tile i, its lane j
    while (j >= static_cast<int>(span[i])) j -= static_cast<int>(span[i++]);
    decode_lane_residuals(units, n_units, start_abs, end_abs, offsets, s0,
                          lut_base, n_subseq, total_bits, s_sym, s_len,
                          lut_size, max_len, tile_of(i), block, j, radius,
                          d + static_cast<size_t>(i) * block);
  }
  __syncthreads();
  if constexpr (sizeof(D) == sizeof(uint32_t)) {
    scatter_unit_outliers(n_here, tile_of, block, opos, oval, scratch, d);
  }
}

// Inclusive prefix sums of v[0, n) in place, restarting at every multiple
// of `seg` (seg = n: one scan; seg = cols: the cumsum along each row).
// Each thread scans a contiguous chunk; the chunks' (restarted?, sum) pairs
// are combined across the block by warp shuffles, a segmented scan.
// `scratch` needs 64 words.  Ends with __syncthreads().
__device__ __forceinline__ void scan_rows(uint32_t* v, int n, int seg,
                                          uint32_t* scratch) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (nt + 31) >> 5;
  const int ipt = (n + nt - 1) / nt;
  const int a = min(tid * ipt, n);
  const int b = min(a + ipt, n);

  uint32_t flag = 0, sum = 0;
  int r = a % seg;
  for (int i = a; i < b; ++i) {
    if (r == 0) {
      flag = 1;
      sum = 0;
    }
    sum += v[i];
    if (++r == seg) r = 0;
  }
  // Warp-inclusive scan of the pairs: (f1, s1) then (f2, s2) is
  // (f1 | f2, f2 ? s2 : s1 + s2).
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t f_up = __shfl_up_sync(0xffffffffu, flag, o);
    const uint32_t s_up = __shfl_up_sync(0xffffffffu, sum, o);
    if (lane >= o) {
      if (!flag) sum += s_up;
      flag |= f_up;
    }
  }
  if (lane == 31) {
    scratch[warp] = flag;
    scratch[32 + warp] = sum;
  }
  // This thread's exclusive pair within its warp.
  uint32_t ex_flag = __shfl_up_sync(0xffffffffu, flag, 1);
  uint32_t ex_sum = __shfl_up_sync(0xffffffffu, sum, 1);
  if (lane == 0) ex_flag = ex_sum = 0;
  __syncthreads();
  if (warp == 0) {
    uint32_t wf = lane < n_warps ? scratch[lane] : 0u;
    uint32_t ws = lane < n_warps ? scratch[32 + lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t f_up = __shfl_up_sync(0xffffffffu, wf, o);
      const uint32_t s_up = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) {
        if (!wf) ws += s_up;
        wf |= f_up;
      }
    }
    const uint32_t ws_ex = __shfl_up_sync(0xffffffffu, ws, 1);
    scratch[32 + lane] = lane == 0 ? 0u : ws_ex;
  }
  __syncthreads();
  // The running sum entering this chunk (up to the chunk's first restart).
  uint32_t run = ex_flag ? ex_sum : scratch[32 + warp] + ex_sum;
  r = a % seg;
  for (int i = a; i < b; ++i) {
    if (r == 0) run = 0;
    run += v[i];
    v[i] = run;
    if (++r == seg) r = 0;
  }
  __syncthreads();
}

// The float epilogue, out = cast(float(int32(q)) * two_eb): the product in
// f32 (round to nearest, never contracted: __fmul_rn) and one cast, as
// lorenzo.dequantize computes it.
template <typename T>
__device__ __forceinline__ T to_out(float x);
template <>
__device__ __forceinline__ float to_out<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half to_out<__half>(float x) {
  return __float2half_rn(x);
}

// Status word of a 1-D unit: (flag << 32) | value, flag 1 = the unit's
// aggregate, 2 = its inclusive prefix, 0 = nothing published yet.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// ---------------------------------------------------------------------------
// 1-D units: warp-chunk scan and a warp-wide look-back
// ---------------------------------------------------------------------------
//
// A 1-D unit is a run of consecutive values staged in shared memory: k
// tiles of uint16 codes (decode_tiles_fused.cu decodes them there,
// dequant_reconstruct.cu copies them in), read as residuals through
// UnitResiduals, or int32 residuals (reconstruct1d.cu), read through
// UnitValues.  Warp w owns the chunk [w * chunk, (w + 1) * chunk) of them
// (chunk a multiple of 128, unit_chunk), read a row of 128 at a time, 4
// consecutive values a lane through one 8-byte (codes) or 16-byte (int32)
// load: the lanes of a warp read consecutive bytes, no bank conflict.  A
// uint16 cannot hold an outlier's residual, so the outliers are not
// scattered into the stage: pass 1 adds each outlier's difference to its
// chunk's total (UnitResiduals::patch_totals), and in pass 2 each warp
// walks its chunk's part of the unit's slice of the side list in step with
// its rows (UnitResiduals::row4).  Either reads each outlier once.  The
// scan takes two passes over the stage and stores nothing back to it:
//   1. unit_chunk_totals: each warp sums its chunk, and warp 0 turns the
//      totals into each chunk's exclusive offset and the unit's aggregate
//      (unit_chunk_offsets);
//   2. write_unit, after the carry: each row's inclusive sums (4 in a lane,
//      then a warp scan of the lanes' totals), plus the chunk's running
//      offset and the unit's exclusive prefix, cast and stored, 4 values a
//      lane, with one vector store where the output's alignment allows.
// Both passes take the source (UnitResiduals, UnitValues) as a template
// parameter: load4 (the values alone), patch_totals (pass 1's outliers),
// walk_from and row4 (pass 2's rows with their outliers).

// The unit's codes per warp: ceil(n / warps), rounded up to a row of 128.
__device__ __forceinline__ int unit_chunk(int n) {
  const int warps = blockDim.x >> 5;
  return ((n + warps - 1) / warps + 127) / 128 * 128;
}

// A warp's place in its unit's outlier slice: `o` the next outlier it has
// not patched in, `at` that outlier's unit position (INT_MAX past the
// slice).
struct OutlierWalk {
  int o, at;
};

// The residuals of a unit's staged codes, code - radius, and the outliers
// of the unit's slice [lo, hi) of the side list (ascending positions), each
// of which replaces the residual at its place.  `base` is the unit's first
// position.
struct UnitResiduals {
  const uint16_t* codes;
  const int* __restrict__ opos;
  const int* __restrict__ oval;
  long long base;
  int lo, hi, radius;

  // The residuals at e .. e + 3 (e a multiple of 4, so one 8-byte load) of
  // the codes alone, 0 at or past `end`.
  __device__ __forceinline__ void load4(int e, int end, uint32_t (&r)[4])
      const {
    uint2 c = make_uint2(0u, 0u);
    if (e < end) c = *reinterpret_cast<const uint2*>(codes + e);
    const uint32_t code[4] = {c.x & 0xffffu, c.x >> 16, c.y & 0xffffu,
                              c.y >> 16};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = e + i < end ? code[i] - static_cast<uint32_t>(radius) : 0u;
    }
  }

  // Outlier o's unit position, INT_MAX past the slice.
  __device__ __forceinline__ int place(int o) const {
    return o < hi ? static_cast<int>(min(opos[o] - base,
                                         static_cast<long long>(INT_MAX)))
                  : INT_MAX;
  }

  // The walk from the first outlier at or past unit position e (a binary
  // search, once a warp).
  __device__ __forceinline__ OutlierWalk walk_from(int e) const {
    const long long pos = base + e;
    int a = lo, b = hi;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (opos[m] < pos) {
        a = m + 1;
      } else {
        b = m;
      }
    }
    return OutlierWalk{a, place(a)};
  }

  // The residuals at row + 4 * lane .. + 3 of the row [row, row + 128) of a
  // warp's chunk [.., end), 0 at or past `end`: load4, then the row's
  // outliers, which `w` reaches first.  Called by the whole warp.  A row
  // without outliers costs one comparison.  Otherwise the warp reads the
  // positions and values of the next 32 outliers, one a lane; those inside
  // the row are a prefix of the lanes.  Up to kBroadcastMax of them are
  // broadcast one at a time, each lane patching its own places; more, and
  // each lane finds the first at or past its places by a binary search
  // over the lanes (5 shuffles) and fetches the next 4 (its places hold at
  // most 4, positions being distinct).
  static constexpr int kBroadcastMax = 4;

  __device__ __forceinline__ void row4(int row, int end, OutlierWalk& w,
                                       uint32_t (&r)[4]) const {
    const int lane = threadIdx.x & 31;
    const int e = row + 4 * lane;
    load4(e, end, r);
    const int stop = min(row + 128, end);
    while (w.at < stop) {                    // the same on every lane
      const int o = w.o + lane;
      const int p = place(o);
      const bool in = p < stop;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      const int v = in ? oval[o] : 0;
      const int count = __popc(m);
      if (count <= kBroadcastMax) {
        for (unsigned bits = m; bits != 0; bits &= bits - 1) {
          const int j = __ffs(bits) - 1;
          const int k = __shfl_sync(0xffffffffu, p, j) - e;
          const int vj = __shfl_sync(0xffffffffu, v, j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (k == i) r[i] = static_cast<uint32_t>(vj);
          }
        }
      } else {
        int j = 0;                           // lanes below j: before e
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(0xffffffffu, p, j + step - 1) < e) j += step;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int src = j + t;
          const int k = __shfl_sync(0xffffffffu, p, src & 31) - e;
          const int vt = __shfl_sync(0xffffffffu, v, src & 31);
          if (src < 32 && (m >> (src & 31) & 1u)) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (k == i) r[i] = static_cast<uint32_t>(vt);
            }
          }
        }
      }
      w.o += count;
      w.at = place(w.o);
    }
  }

  // Pass 1's outliers: the block's threads take the unit's outliers, one a
  // thread at a time, and add to the chunk total of each (scratch words
  // [32, 32 + warps)) the difference between its residual and its code's
  // (uint32 sums, so the order of the additions does not matter).  Ends
  // with __syncthreads().
  __device__ __forceinline__ void patch_totals(int n, int chunk,
                                               uint32_t* scratch) const {
    for (int o = lo + static_cast<int>(threadIdx.x); o < hi;
         o += blockDim.x) {
      const long long p = opos[o] - base;
      if (p >= 0 && p < n) {
        const uint32_t code_r =
            static_cast<uint32_t>(codes[p]) - static_cast<uint32_t>(radius);
        atomicAdd(scratch + 32 + static_cast<int>(p) / chunk,
                  static_cast<uint32_t>(oval[o]) - code_r);
      }
    }
    __syncthreads();
  }
};

// The residuals of a unit of staged int32 values, as they are: no
// outliers, so pass 1 has nothing to patch and pass 2 nothing to walk.
struct UnitValues {
  const int32_t* vals;

  // The values at e .. e + 3 (e a multiple of 4, so one 16-byte load), 0 at
  // or past `end`.
  __device__ __forceinline__ void load4(int e, int end, uint32_t (&r)[4])
      const {
    int4 v = make_int4(0, 0, 0, 0);
    if (e < end) v = *reinterpret_cast<const int4*>(vals + e);
    const int x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = e + i < end ? static_cast<uint32_t>(x[i]) : 0u;
    }
  }

  __device__ __forceinline__ void patch_totals(int, int, uint32_t*) const {}

  __device__ __forceinline__ OutlierWalk walk_from(int) const {
    return OutlierWalk{0, INT_MAX};
  }

  __device__ __forceinline__ void row4(int row, int end, OutlierWalk&,
                                       uint32_t (&r)[4]) const {
    load4(row + 4 * static_cast<int>(threadIdx.x & 31), end, r);
  }
};

// Pass 1: each warp's chunk total, in scratch words [32, 32 + warps), then
// published to the block: the chunks sum the source's values, then the
// source patches in its outliers.  Ends with __syncthreads().
template <typename Src>
__device__ __forceinline__ void unit_chunk_totals(const Src& d, int n,
                                                  int chunk,
                                                  uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = warp * chunk, hi = min(lo + chunk, n);
  uint32_t acc = 0;
  for (int base = lo; base < hi; base += 128) {
    uint32_t r[4];
    d.load4(base + 4 * lane, hi, r);
    acc += r[0] + r[1] + r[2] + r[3];
  }
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) scratch[32 + warp] = acc;
  __syncthreads();
  d.patch_totals(n, chunk, scratch);
}

// Warp 0, after unit_chunk_totals: each chunk's exclusive offset, in
// offs[0 .. warps); returns the unit's aggregate to every lane of warp 0.
__device__ __forceinline__ uint32_t unit_chunk_offsets(
    const uint32_t* scratch, uint32_t* offs) {
  const int lane = threadIdx.x;
  const int warps = static_cast<int>(blockDim.x >> 5);
  const uint32_t t = lane < warps ? scratch[32 + lane] : 0u;
  uint32_t incl = t;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane < warps) offs[lane] = incl - t;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// Lane 0 of the calling warp publishes unit u's aggregate (unit 0: its
// inclusive prefix, the same value).
__device__ __forceinline__ void publish_aggregate(
    int u, uint32_t aggregate, unsigned long long* status) {
  if ((threadIdx.x & 31) == 0) {
    st_relaxed(status + u, (u == 0 ? kPrefix : kAggregate) | aggregate);
  }
}

// The sum of every unit before unit u, by decoupled look-back (Merrill &
// Garland 2016) a warp at a time; called by warp 0 alone once u's
// aggregate is published (publish_aggregate), returns it to every lane.
// Lane l reads the status of unit hi - l, for the `window` (1 to 32) units
// below hi = u - 1: as soon as the nearest unit of the window that has
// published its inclusive prefix has only aggregates between it and u, the
// warp adds that prefix and those aggregates (one warp reduction) and is
// done; if every unit of the window holds its aggregate and none its
// prefix, it adds them all and slides the window down by `window` units;
// otherwise (a unit of the window has published nothing yet) it reads
// again.  Lane 0 then publishes the unit's inclusive prefix.  A window of
// statuses a read, where a walk by one thread would read one predecessor a
// round trip to L2.
__device__ __forceinline__ uint32_t unit_lookback(int u, uint32_t aggregate,
                                                  int window,
                                                  unsigned long long* status) {
  const int lane = threadIdx.x;
  if (u == 0) return 0u;
  uint32_t prefix = 0;
  long long polls = 0;
  for (int hi = u - 1;;) {
    const int j = hi - lane;
    // Past the window: an aggregate of 0; below unit 0: a prefix of 0
    // (unit 0 always publishes a prefix, so the walk stops there first).
    unsigned long long w = kAggregate;
    if (lane < window) w = j >= 0 ? ld_relaxed(status + j) : kPrefix;
    const unsigned long long flag = w & ~0xffffffffull;
    const unsigned none = __ballot_sync(0xffffffffu, flag == 0);
    const unsigned pre = __ballot_sync(0xffffffffu, flag == kPrefix);
    const uint32_t v = static_cast<uint32_t>(w);
    if (pre != 0 && (none == 0 || __ffs(pre) < __ffs(none))) {
      const int p = __ffs(pre) - 1;
      prefix += __reduce_add_sync(0xffffffffu, lane <= p ? v : 0u);
      break;
    }
    if (none == 0) {
      prefix += __reduce_add_sync(0xffffffffu, v);
      hi -= window;
    } else {
      count_poll(&polls);
    }
  }
  if (lane == 0) st_relaxed(status + u, kPrefix | (prefix + aggregate));
  return prefix;
}

template <typename T>
struct alignas(4 * sizeof(T)) Out4 {
  T v[4];
};

// Pass 2: out[i] = cast(float(int32(add + q[i])) * two_eb) for i < n_valid,
// q the unit's inclusive sums, from the source's values and the chunk
// offsets `offs` that unit_chunk_offsets left; `out` is the unit's first
// output.
template <typename Src, typename T>
__device__ __forceinline__ void write_unit(const Src& d, int n, int chunk,
                                           uint32_t add, int n_valid,
                                           float two_eb,
                                           const uint32_t* offs,
                                           T* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = warp * chunk, hi = min(lo + chunk, n);
  const bool vec = (reinterpret_cast<uintptr_t>(out) & (sizeof(Out4<T>) - 1))
                   == 0;
  uint32_t carry = add + offs[warp];
  OutlierWalk w = d.walk_from(lo);
  for (int base = lo; base < hi; base += 128) {
    const int e = base + 4 * lane;
    uint32_t x[4];
    d.row4(base, hi, w, x);
    const uint32_t s[4] = {x[0], x[0] + x[1], x[0] + x[1] + x[2],
                           x[0] + x[1] + x[2] + x[3]};
    uint32_t incl = s[3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const uint32_t ex = carry + incl - s[3];
    carry += __shfl_sync(0xffffffffu, incl, 31);
    Out4<T> o;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o.v[i] = to_out<T>(
          __fmul_rn(__int2float_rn(static_cast<int>(ex + s[i])), two_eb));
    }
    if (vec && e + 3 < n_valid) {
      *reinterpret_cast<Out4<T>*>(out + e) = o;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e + i < n_valid) out[e + i] = o.v[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 1-D epilogues: persistent units, the next unit's read beside the write
// ---------------------------------------------------------------------------
//
// dequant_reconstruct.cu and reconstruct1d.cu run the 1-D units above over
// an array in device memory.  They have no decode to hide their reads
// behind, so a block keeps kEpilogueStages stages of a unit in shared
// memory and reads the next unit while it scans, looks back for and writes
// the ones it holds (epilogue_units).  The read is a bulk copy (cp.async.bulk, the
// TMA's 1-D form): thread 0 asks for the unit's bytes with one instruction
// and the copy completes on the stage's mbarrier, so no thread spends
// registers or issue slots on it.  A bulk copy moves 16-byte-aligned runs
// of a multiple of 16 bytes, so the block's threads load the rest
// themselves: a ragged last unit's tail, or a whole unit whose first value
// is not on a 16-byte boundary (a tile whose bytes are no multiple of 16);
// the barrier after the wait publishes those loads.
//
// Order.  A block takes ticket u + 1 and starts its read, waits for unit
// u's read, sums u and publishes its aggregate, and only then looks back
// for and writes the unit it took before u (decode_tiles_fused's order): a
// round after that unit's aggregate went out, when its predecessors have
// mostly published theirs.  So a block holds three units, one a stage: the
// one it reads, the one it sums, the one it writes.  It publishes a unit's
// aggregate before it waits on any other block, and waits only for lower
// tickets (see "Work order" above).

// The epilogues' block width, the blocks an SM must hold at it, which
// bound their registers to 40 (fused_decode.EPILOGUE_THREADS,
// EPILOGUE_MIN_BLOCKS, EPILOGUE_REGS), and the stages of a unit a block
// keeps (fused_decode.EPILOGUE_STAGES).
constexpr int kEpilogueThreads = 512;
constexpr int kEpilogueMinBlocks = 3;
constexpr int kEpilogueStages = 3;

// Shared memory of an epilogue block (fused_decode.epilogue_smem): the
// stages of a unit of `unit_bytes`, each to a 16-byte boundary, an
// mbarrier a stage, the scratch words and a unit slot a stage.
inline size_t epilogue_smem(long long unit_bytes) {
  return kEpilogueStages *
             ((static_cast<size_t>(unit_bytes) + 15) / 16 * 16 + 8 +
              4 * kSlotWords) +
         4 * kFusedScratchWords;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Start the read of the `len` values at src into `stage`: thread 0 arrives
// on `bar`, expecting the bytes of one bulk copy of the values' 16-byte
// run (none if src is not on a 16-byte boundary), and issues it; every
// thread loads some of the values past the run.  Called by every thread
// after a barrier that ends every read of the stage.
template <typename E>
__device__ __forceinline__ void stage_unit(const E* __restrict__ src,
                                           int len, E* stage,
                                           unsigned long long* bar) {
  const int run =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0
          ? len * static_cast<int>(sizeof(E)) / 16 * 16 /
                static_cast<int>(sizeof(E))
          : 0;
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(run) * sizeof(E);
    // The stage's last reads were the generic proxy's; the copy writes
    // through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
    if (bytes != 0) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_u32(stage)),
          "l"(src), "r"(bytes), "r"(smem_u32(bar))
          : "memory");
    }
  }
  for (int i = run + threadIdx.x; i < len; i += blockDim.x) stage[i] = src[i];
}

// Wait until the read into a stage has landed: its mbarrier's phase of
// parity `parity` completes (the bulk copy's bytes have arrived), then the
// block meets (every thread's own loads are in).  Called by every thread.
__device__ __forceinline__ void stage_wait(unsigned long long* bar,
                                           uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long polls = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) break;
    count_poll(&polls);
  }
  __syncthreads();
}

// Row 6's units: unit_tiles tiles of `tile` uint16 codes, residuals code -
// radius with the outliers of the tiles' slices of the side list.
struct EpilogueCodes {
  using Elem = uint16_t;
  const uint16_t* __restrict__ data;
  const int* __restrict__ opos;
  const int* __restrict__ oval;
  const int* __restrict__ obounds;
  int tile, n_tiles, unit_tiles, radius;

  // The unit's slice of the side list, into its slot (the slices of its
  // tiles are consecutive): one thread of the last warp, which has no
  // look-back to run.
  __device__ __forceinline__ void issue(int u, uint32_t* slot) const {
    if (threadIdx.x == blockDim.x - 1) {
      const int t0 = u * unit_tiles;
      slot[kSlotLo] = static_cast<uint32_t>(obounds[t0]);
      slot[kSlotHi] =
          static_cast<uint32_t>(obounds[min(t0 + unit_tiles, n_tiles)]);
    }
  }

  __device__ __forceinline__ UnitResiduals view(const uint16_t* stage, int u,
                                                const uint32_t* slot) const {
    return UnitResiduals{stage, opos, oval,
                         static_cast<long long>(u) * unit_tiles * tile,
                         static_cast<int>(slot[kSlotLo]),
                         static_cast<int>(slot[kSlotHi]), radius};
  }
};

// Row 9's units: int32 residuals as they are.
struct EpilogueValues {
  using Elem = int32_t;
  const int32_t* __restrict__ data;

  __device__ __forceinline__ void issue(int, uint32_t*) const {}

  __device__ __forceinline__ UnitValues view(const int32_t* stage, int,
                                             const uint32_t*) const {
    return UnitValues{stage};
  }
};

// The 1-D epilogue over the n values of `src`, units of unit_len values,
// on a persistent block (see above).  `status` holds one zeroed uint64 a
// unit, `ticket` one zeroed uint32.  Called by every thread.
template <typename Source, typename T>
__device__ __forceinline__ void epilogue_units(const Source& src,
                                               long long n, int unit_len,
                                               int window, float two_eb,
                                               unsigned* ticket,
                                               unsigned long long* status,
                                               T* __restrict__ out) {
  using E = typename Source::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  // Shared memory (epilogue_smem): the stages, their mbarriers, the
  // scratch words, the stages' unit slots.
  const size_t stage_bytes =
      (static_cast<size_t>(unit_len) * sizeof(E) + 15) / 16 * 16;
  auto stage = [&](int i) {
    return reinterpret_cast<E*>(smem + i * stage_bytes);
  };
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      smem + kEpilogueStages * stage_bytes);
  uint32_t* scratch = reinterpret_cast<uint32_t*>(bars + kEpilogueStages);
  auto slot = [&](int i) {
    return scratch + kFusedScratchWords + i * kSlotWords;
  };
  const int n_units = static_cast<int>((n + unit_len - 1) / unit_len);
  auto len_of = [&](int u) {
    return static_cast<int>(min(static_cast<long long>(unit_len),
                                n - static_cast<long long>(u) * unit_len));
  };
  auto issue = [&](int u, int i) {
    stage_unit(src.data + static_cast<long long>(u) * unit_len, len_of(u),
               stage(i), bars + i);
    src.issue(u, slot(i));
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kEpilogueStages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_u32(bars + i)),
                   "r"(1u)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t parity = 0;          // bit i: the phase stage i's next wait ends
  int u = take_ticket(ticket, scratch);
  if (u < n_units) issue(u, 0);
  int s = 0, prev = -1, ps = 0;  // the unit a round behind, and its stage
  while (true) {
    // The stage after u's held the unit written last round: read the next
    // unit into it.
    const int next = take_ticket(ticket, scratch);
    const int ns = s + 1 < kEpilogueStages ? s + 1 : 0;
    if (next < n_units) issue(next, ns);
    if (u < n_units) {
      stage_wait(bars + s, parity >> s & 1u);
      parity ^= 1u << s;
      const int len = len_of(u);
      unit_chunk_totals(src.view(stage(s), u, slot(s)), len, unit_chunk(len),
                        scratch);
      if (threadIdx.x < 32) {
        const uint32_t aggregate = unit_chunk_offsets(scratch, slot(s));
        publish_aggregate(u, aggregate, status);
        if (threadIdx.x == 0) slot(s)[kSlotAggregate] = aggregate;
      }
    }
    if (prev >= 0) {
      if (threadIdx.x < 32) {
        const uint32_t prefix =
            unit_lookback(prev, slot(ps)[kSlotAggregate], window, status);
        if (threadIdx.x == 0) scratch[kCarryWord] = prefix;
      }
      __syncthreads();
      const int len = len_of(prev);
      write_unit(src.view(stage(ps), prev, slot(ps)), len, unit_chunk(len),
                 scratch[kCarryWord], len, two_eb, slot(ps),
                 out + static_cast<long long>(prev) * unit_len);
    }
    if (u >= n_units) break;
    prev = u;
    ps = s;
    u = next;
    s = ns;
  }
}

// ---------------------------------------------------------------------------
// N-D carries: decoupled look-back along both axes of a grid of units
// ---------------------------------------------------------------------------
//
// The field is (planes, rows, cols) (planes = 1 for 2-D); a tile is w whole
// rows, block = w * cols codes, and for 3-D w divides rows, so a tile never
// crosses a plane.  The inverse Lorenzo is the cumsum along every axis:
//   e = cumsum of d along each row        (inside the tile: scan_rows)
//   f = row carry + cumsum of e down rows (row carry: the sum of e over the
//                                          plane's earlier rows)
//   q = plane carry + f                   (3-D; plane carry: the sum of f
//                                          over the earlier planes)
// On the TPU both carries sat in VMEM scratch across an ordered grid.
//
// Units.  A block takes one unit: unit_planes planes x unit_tiles
// consecutive tiles of a plane (2-D: 1 x up to 8; 3-D: up to 8 x 1), held
// in shared memory as [plane i][nrows rows][cols].  The units form a
// units_p x units_k grid.  Unit (g, k) needs, for each of its planes, the
// column sums of e over the units (g, 0 .. k-1) (its row carry), and, for
// 3-D, the sum of f over the units (0 .. g-1, k) at its rows (its plane
// carry).  Both are prefix sums along a chain of units whose terms, the
// units' aggregates, a unit computes alone:
//   * row aggregate: the column sums of its rows of e, one (cols,) vector
//     a plane, known right after its own scan;
//   * plane aggregate: the sum over its planes of f, one value an element
//     of its rows, known once its row carry is.
//
// Decoupled look-back (Merrill & Garland 2016; unit_lookback above for the
// 1-D kernels), a vector at a time.  A unit publishes its aggregate at
// once, without waiting for anyone: every thread stores its elements'
// values, the block meets, and thread 0 releases the chain's flag,
// "aggregate" (publish_status).  Then warp 0 reads the flags
// of the chain's units k-1, k-2, ... (or g-1, g-2, ...), one a lane, and
// finds the first of them that holds its inclusive prefix with only
// aggregates before it (lookback_depth); every thread then adds, element
// by element, those aggregates and that prefix, the values read through
// L2 (lookback_sums), and the unit publishes its own inclusive prefix (the
// sum plus its aggregate) the same way.  A chain's first unit publishes its
// prefix at once.  Every aggregate is published before its unit reads
// anything, so a walk never waits for a predecessor's own walk unless it
// reaches the depth cap: a walk reads at most `depth` units (<= 32, a
// warp's lanes), and should the depth-th still hold only its aggregate
// (depth units of one chain all unfinished) it waits for that one's
// prefix.  The prefix frontier of a chain so advances up to `depth` units
// a hop, where the chained carry this design replaced advanced one.  A
// flag is a uint32: the unit of ticket t stores 2t + 2 after its
// aggregate's values and 2t + 3 after its prefix's, which sit in separate
// arrays, so a reader never sees values change under it.  The values are
// uint32_t sums mod 2^32 (see the top of this file), so the order of the
// additions does not change a bit of the result.
//
// The ring.  A status vector per unit would be 8 B a code for the plane
// carry (200 MB on a 100 x 500 x 500 field), so statuses live in a ring of
// `slots` slots, the unit of ticket t in slot t % slots, and a slot is
// reused `slots` tickets later.  Tickets go to units by anti-diagonal,
// d = g + k (diagonal_unit), so a unit's chain predecessors, and the units
// within `depth` hops after it, lie on the diagonals just before and just
// after its own.  When a unit finishes its carries (both walks done, both
// prefixes published) it marks its slot's done word.  Before its first
// store to the ring, the unit of ticket t >= slots waits until the slot's
// previous occupant j = t - slots is done, and so is every unit that can
// read j's statuses: a reader lies at most `depth` hops after j along one
// chain, so it is one of j's first `depth` row successors or plane
// successors (ring_gate).  Every one of them has finished its walks, so no
// reader will read j again, and j's own prefix stores have landed: a slot
// is never overwritten while a reader may still need it.  The waits are
// for lower tickets only: those units lie on diagonals d(j) .. d(j) +
// depth, and with slots >= (depth + 1) x the longest diagonal those
// diagonals hold fewer than `slots` tickets, so d(j) + depth < d(t); a
// lower ticket belongs to a block that is already running.  So every wait
// ends, whatever the schedule.  The geometry (fused_decode.nd_geometry)
// also sizes the ring to the blocks the card holds at once beyond that, so
// that in a run the units a gate waits for are mostly done.  A flag larger
// than a reader expects would mean its slot was reused; the kernel traps
// rather than read it (tests/test_torch_launch_geometry.py plays this
// protocol on random schedules and checks that it never happens, and that
// it does without the gate).  The wrapper zeroes the ticket, the flags
// (0: nothing published) and the done words for every launch; the values
// need no zeroing.  A final partial tile of a 2-D field holds fake rows
// after the last row; they pollute only a carry no unit reads, and are
// never written to the output.

// Largest d with d (d + 1) / 2 <= t.
__device__ __forceinline__ long long tri_root(long long t) {
  long long d = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) / 2.0);
  while ((d + 1) * (d + 2) / 2 <= t) ++d;
  while (d * (d + 1) / 2 > t) --d;
  return d;
}

// The unit (p, k) of a planes x K grid that gets ticket t when tickets go
// by anti-diagonal d = p + k, and by p within a diagonal.  With a = min(P,
// K), b = max(P, K), diagonals 0 .. a-2 grow by one tile, a-1 .. b-1 hold a
// tiles, and the last a-1 shrink by one.
__device__ __forceinline__ void diagonal_unit(int t, int planes, int K,
                                              int* p, int* k) {
  const long long a = min(planes, K), b = max(planes, K);
  const long long t1 = a * (a - 1) / 2, t2 = (b - a + 1) * a;
  long long d, off;
  if (t < t1) {
    d = tri_root(t);
    off = t - d * (d + 1) / 2;
  } else if (t < t1 + t2) {
    const long long u = t - t1;
    d = (a - 1) + u / a;
    off = u % a;
  } else {
    const long long r = static_cast<long long>(planes) * K - 1 - t;
    const long long e = tri_root(r);
    d = planes + K - 2 - e;
    off = e - (r - e * (e + 1) / 2);
  }
  *p = static_cast<int>(max(0LL, d - (K - 1)) + off);
  *k = static_cast<int>(d) - *p;
}

// The first ticket on diagonal d of a planes x K grid
// (fused_decode.diagonal_first).
__device__ __forceinline__ long long diagonal_first(int d, int planes,
                                                    int K) {
  const long long a = min(planes, K), b = max(planes, K);
  if (d <= a - 1) return static_cast<long long>(d) * (d + 1) / 2;
  if (d <= b) return a * (a - 1) / 2 + (d - a + 1) * a;
  const long long r = static_cast<long long>(planes) + K - 1 - d;
  return static_cast<long long>(planes) * K - r * (r + 1) / 2;
}

// The ticket of unit (p, k) (the inverse of diagonal_unit).
__device__ __forceinline__ int diagonal_ticket(int p, int k, int planes,
                                               int K) {
  const int d = p + k;
  return static_cast<int>(diagonal_first(d, planes, K)) + p -
         max(0, d - (K - 1));
}

// The geometry of an N-D launch (fused_decode.NdGeometry).
struct NdGrid {
  int rows_per_tile, cols, planes, tiles_per_plane;
  int unit_planes, unit_tiles, units_p, units_k;
  int slots, depth, row_words, plane_words;
};

// The unit of ticket t: its position, its planes and tiles.
struct NdUnit {
  int t, g, k, n_planes, n_tiles, nrows;
};

__device__ __forceinline__ NdUnit nd_unit(int t, const NdGrid& grid) {
  NdUnit u;
  u.t = t;
  diagonal_unit(t, grid.units_p, grid.units_k, &u.g, &u.k);
  u.n_planes = min(grid.unit_planes, grid.planes - u.g * grid.unit_planes);
  u.n_tiles =
      min(grid.unit_tiles, grid.tiles_per_plane - u.k * grid.unit_tiles);
  u.nrows = u.n_tiles * grid.rows_per_tile;
  return u;
}

// Tile j of plane i of the unit: its index among all tiles.
__device__ __forceinline__ int nd_tile(const NdGrid& grid, const NdUnit& u,
                                       int i, int j) {
  return (u.g * grid.unit_planes + i) * grid.tiles_per_plane +
         u.k * grid.unit_tiles + j;
}

// The status of one chain of the unit of ticket t in the ring: its flag,
// and the offset of its aggregate's or its inclusive prefix's values
// (uint32_t, one an element of the chain's vector).  A slot holds two flags
// (row, plane) and 2 x (row_words + plane_words) values.
__device__ __forceinline__ unsigned* status_flag(const NdGrid& grid,
                                                 unsigned* flags, int t,
                                                 bool plane) {
  return flags + 2 * (t % grid.slots) + (plane ? 1 : 0);
}

__device__ __forceinline__ uint32_t status_offset(const NdGrid& grid, int t,
                                                  bool plane, bool prefix) {
  const uint32_t at = static_cast<uint32_t>(t % grid.slots) * 2u *
                      static_cast<uint32_t>(grid.row_words + grid.plane_words);
  return at + (plane ? 2 * grid.row_words + (prefix ? grid.plane_words : 0)
                     : (prefix ? grid.row_words : 0));
}

// The ticket of the h-th predecessor (h >= 1) of unit u along a chain (row:
// unit (g, k - h); plane: unit (g - h, k)).
__device__ __forceinline__ int pred_ticket(const NdGrid& grid,
                                           const NdUnit& u, bool plane,
                                           int h) {
  return plane ? diagonal_ticket(u.g - h, u.k, grid.units_p, grid.units_k)
               : diagonal_ticket(u.g, u.k - h, grid.units_p, grid.units_k);
}

__device__ __forceinline__ unsigned ld_relaxed_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_u32(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Publish a status whose values every thread has stored: the block meets
// (the barrier performs every thread's stores relative to thread 0), and
// thread 0 releases the flag, which makes them visible to any thread that
// acquires it (as CUTLASS's semaphore releases a split-K partial).  Called
// by every thread.
__device__ __forceinline__ void publish_status(unsigned* flag,
                                               unsigned value) {
  __syncthreads();
  if (threadIdx.x == 0) st_release_u32(flag, value);
}

// How far unit u looks back along one chain, found by warp 0 from the
// flags alone: lane h polls the flag of predecessor h + 1 (h < n_pred =
// min(position, depth)), and the walk ends at the first predecessor that
// is not an aggregate once it is a prefix.  At the depth cap it waits for
// that predecessor's prefix.  A flag past the predecessor's own tags would
// mean its slot had been reused under the reader, which the ring's gate
// rules out: trap rather than read it.  Leaves the predecessors' value
// offsets (scratch words [0, depth)) and returns the depth d to every
// thread: the sum is predecessors 1 .. d-1's aggregates plus predecessor
// d's prefix.
__device__ __forceinline__ int lookback_depth(const NdGrid& grid,
                                              const NdUnit& u, bool plane,
                                              int n_pred, unsigned* flags,
                                              uint32_t* scratch) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const bool mine = lane < n_pred;
    const int tp = mine ? pred_ticket(grid, u, plane, lane + 1) : 0;
    const unsigned want = 2u * static_cast<unsigned>(tp) + 2u;
    const unsigned* f = mine ? status_flag(grid, flags, tp, plane) : flags;
    long long polls = 0;
    int depth;
    while (true) {
      const unsigned v = mine ? ld_relaxed_u32(f) : 0u;
      if (mine && v > want + 1) __trap();
      const unsigned agg = __ballot_sync(0xffffffffu, mine && v == want);
      const unsigned pre = __ballot_sync(0xffffffffu, mine && v == want + 1);
      const int first = __ffs(~agg) - 1;        // first lane not an aggregate
      if (first < n_pred && ((pre >> first) & 1u)) {
        depth = first + 1;
        break;
      }
      count_poll(&polls);
    }
    __threadfence();                   // acquire: the flags before the values
    if (mine) {
      scratch[lane] = status_offset(grid, tp, plane, lane + 1 == depth);
    }
    if (lane == 0) scratch[kCarryWord] = static_cast<uint32_t>(depth);
  }
  __syncthreads();
  return static_cast<int>(scratch[kCarryWord]);
}

// The exclusive prefixes, along the chain whose walk lookback_depth left
// in scratch, of this thread's elements e0, e0 + blockDim.x, ... (kSumBatch
// of them, those below n): their depth's predecessors' values, read
// through L2 only, two hops' loads in flight together.  The caller
// stores nothing between the loads, so none waits for another.
constexpr int kSumBatch = 8;

__device__ __forceinline__ void lookback_sums(const uint32_t* vals,
                                              const uint32_t* scratch,
                                              int depth, int e0, int n,
                                              uint32_t excl[kSumBatch]) {
  const int nt = blockDim.x;
#pragma unroll
  for (int b = 0; b < kSumBatch; ++b) excl[b] = 0;
  for (int h = 0; h < depth; h += 2) {
    // two hops a round (the second a zero hop past the depth)
    const uint32_t* src0 = vals + scratch[h];
    const uint32_t* src1 = h + 1 < depth ? vals + scratch[h + 1] : nullptr;
    uint32_t v0[kSumBatch], v1[kSumBatch];
#pragma unroll
    for (int b = 0; b < kSumBatch; ++b) {
      const int e = e0 + b * nt;
      v0[b] = e < n ? __ldcg(src0 + e) : 0u;
      v1[b] = e < n && src1 != nullptr ? __ldcg(src1 + e) : 0u;
    }
#pragma unroll
    for (int b = 0; b < kSumBatch; ++b) excl[b] += v0[b] + v1[b];
  }
}

// Before the unit's first store to its slot: wait until the slot's previous
// occupant j = t - slots, and every unit that can read j's statuses (its
// row successors (g, k+1 .. k+depth) and its plane successors (g+1 ..
// g+depth, k)), are done (see above).  Thread x polls the done word of one
// of them: a unit marks its slot's word t + 1 when it is done, and a later
// occupant of that slot, which came after it through this same gate,
// stores more.  Called by every thread.
__device__ __forceinline__ void ring_gate(const NdGrid& grid, const NdUnit& u,
                                          const unsigned* done) {
  const int x = threadIdx.x;
  if (u.t >= grid.slots && x <= 2 * grid.depth) {
    const int j = u.t - grid.slots;
    int g, k;
    diagonal_unit(j, grid.units_p, grid.units_k, &g, &k);
    if (x > grid.depth) {
      g += x - grid.depth;
    } else {
      k += x;
    }
    if (g < grid.units_p && k < grid.units_k) {
      const int r = x == 0 ? j
                           : diagonal_ticket(g, k, grid.units_p,
                                             grid.units_k);
      const unsigned* w = done + r % grid.slots;
      long long polls = 0;
      unsigned ns = 32;
      while (true) {
        unsigned c;
        asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                     : "=r"(c)
                     : "l"(w)
                     : "memory");
        if (c >= static_cast<unsigned>(r) + 1u) break;
        count_poll(&polls);
        __nanosleep(ns);
        ns = ns < 256 ? 2 * ns : ns;
      }
    }
  }
  __syncthreads();
}

// The row carry and, for 3-D, the plane carry of unit u, applied in place
// to its codes of e in d ([plane i][nrows][cols]), which become q; then the
// unit counts itself done.  Called by every thread; ends with
// __syncthreads().
__device__ __forceinline__ void nd_carries(uint32_t* d, const NdGrid& grid,
                                           const NdUnit& u, unsigned* flags,
                                           uint32_t* vals, unsigned* done,
                                           uint32_t* scratch) {
  const int nt = blockDim.x;
  const int cols = grid.cols;
  const int m = u.nrows * cols;            // codes of one plane of the unit
  const int n_row = u.n_planes * cols;     // row-carry elements (i, c)
  const unsigned agg_tag = 2u * static_cast<unsigned>(u.t) + 2u;

  // Column sums down the unit's rows, in place: F, whose last row is the
  // row aggregate.
  for (int i = 0; i < u.n_planes; ++i) {
    for (int c = threadIdx.x; c < cols; c += nt) {
      uint32_t* col = d + static_cast<size_t>(i) * m + c;
      uint32_t run = 0;
      for (int r = 0; r < u.nrows; ++r) {
        run += col[r * cols];
        col[r * cols] = run;
      }
    }
  }
  __syncthreads();
  ring_gate(grid, u, done);

  if (grid.units_k > 1) {
    const bool next = u.k + 1 < grid.units_k;     // a successor reads it
    const size_t last = static_cast<size_t>(u.nrows - 1) * cols;
    auto agg = [&](int e) {
      return d[static_cast<size_t>(e / cols) * m + last + e % cols];
    };
    if (next) {            // a chain's first unit publishes its prefix
      uint32_t* out = vals + status_offset(grid, u.t, false, u.k == 0);
      for (int e = threadIdx.x; e < n_row; e += nt) out[e] = agg(e);
      publish_status(status_flag(grid, flags, u.t, false),
                     u.k == 0 ? agg_tag + 1 : agg_tag);
    }
    if (u.k > 0) {
      const int depth = lookback_depth(grid, u, false, min(u.k, grid.depth),
                                       flags, scratch);
      uint32_t* out = vals + status_offset(grid, u.t, false, true);
      for (int e0 = threadIdx.x; e0 < n_row; e0 += kSumBatch * nt) {
        uint32_t excl[kSumBatch];
        lookback_sums(vals, scratch, depth, e0, n_row, excl);
#pragma unroll
        for (int b = 0; b < kSumBatch; ++b) {
          const int e = e0 + b * nt;
          if (e >= n_row) break;
          if (next) out[e] = excl[b] + agg(e);
          uint32_t* col = d + static_cast<size_t>(e / cols) * m + e % cols;
          for (int r = 0; r < u.nrows; ++r) col[r * cols] += excl[b];
        }
      }
      if (next) {
        publish_status(status_flag(grid, flags, u.t, false), agg_tag + 1);
      }
    }
    __syncthreads();
  }

  if (grid.planes > 1) {
    // f summed over the unit's planes, in place, then the plane carry from
    // the plane groups before it (none if there is one group).
    const bool next = u.g + 1 < grid.units_p;
    const size_t top = static_cast<size_t>(u.n_planes - 1) * m;
    uint32_t* out = vals + status_offset(grid, u.t, true, u.g == 0);
    for (int e = threadIdx.x; e < m; e += nt) {
      uint32_t run = 0;
      for (int i = 0; i < u.n_planes; ++i) {
        run += d[static_cast<size_t>(i) * m + e];
        d[static_cast<size_t>(i) * m + e] = run;
      }
      if (next) out[e] = run;
    }
    if (next) {
      publish_status(status_flag(grid, flags, u.t, true),
                     u.g == 0 ? agg_tag + 1 : agg_tag);
    }
    if (u.g > 0) {
      const int depth = lookback_depth(grid, u, true, min(u.g, grid.depth),
                                       flags, scratch);
      uint32_t* pre = vals + status_offset(grid, u.t, true, true);
      for (int e0 = threadIdx.x; e0 < m; e0 += kSumBatch * nt) {
        uint32_t excl[kSumBatch];
        lookback_sums(vals, scratch, depth, e0, m, excl);
#pragma unroll
        for (int b = 0; b < kSumBatch; ++b) {
          const int e = e0 + b * nt;
          if (e >= m) break;
          if (next) pre[e] = excl[b] + d[top + e];
          for (int i = 0; i < u.n_planes; ++i) {
            d[static_cast<size_t>(i) * m + e] += excl[b];
          }
        }
      }
      if (next) {
        publish_status(status_flag(grid, flags, u.t, true), agg_tag + 1);
      }
    }
    __syncthreads();
  }

  // Done: every read of the ring and every store to the slot above happen
  // before the done word (the barrier above, then a release), and the gate
  // that reads it acquires it.
  __syncthreads();
  if (threadIdx.x == 0) st_release_u32(done + u.t % grid.slots, u.t + 1u);
}

// Write the unit's q, plane by plane, as the output type (positions past
// n_out, the fake rows of a 2-D field's last tile, are not written).
template <typename T>
__device__ __forceinline__ void nd_write_out(const uint32_t* d,
                                             const NdGrid& grid,
                                             const NdUnit& u, long long n_out,
                                             float two_eb,
                                             T* __restrict__ out) {
  const int block = grid.rows_per_tile * grid.cols;
  const int m = u.nrows * grid.cols;
  for (int i = 0; i < u.n_planes; ++i) {
    const long long base = static_cast<long long>(nd_tile(grid, u, i, 0)) *
                           block;
    const int n_here =
        static_cast<int>(min(static_cast<long long>(m), n_out - base));
    const uint32_t* q = d + static_cast<size_t>(i) * m;
    T* o = out + base;
    for (int e = threadIdx.x; e < n_here; e += blockDim.x) {
      o[e] = to_out<T>(
          __fmul_rn(__int2float_rn(static_cast<int>(q[e])), two_eb));
    }
  }
}

// Block width bound of the N-D kernels (fused_decode.ND_MAX_THREADS), and
// the blocks an SM holds at that width, which bound their registers to 64
// (fused_decode.ND_REGS).
constexpr int kNdMaxThreads = 512;
constexpr int kNdMinBlocks = 2;

// Whether `threads` threads a block can run the N-D protocol on `grid`:
// lookback_depth polls one predecessor a lane of warp 0 (a whole warp,
// depth 1 to 32), and ring_gate one unit a thread (2 x depth + 1 of them;
// with fewer, a slot could be reused under a reader it never waited for).
inline bool nd_launch_ok(const NdGrid& grid, int threads) {
  return threads >= 32 && threads <= kNdMaxThreads && grid.depth >= 1 &&
         grid.depth <= 32 && threads >= 2 * grid.depth + 1 &&
         grid.slots >= 1;
}

}  // namespace repro_torch
