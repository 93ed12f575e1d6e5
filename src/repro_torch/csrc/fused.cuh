// Device functions shared by the fused kernels: the fused decode kernels
// (decode_tiles_fused.cu, decode_tiles_fused_nd.cu) and the epilogues alone
// that follow the padded decoder (dequant_reconstruct.cu,
// dequant_reconstruct_nd.cu).  A fused kernel and its epilogue differ only
// in where a tile's residuals come from (decoded from the stream, or read
// from a code array); the scan, the carries and the float epilogue are the
// functions below.
//
// CUDA counterparts of src/repro/kernels/fused_decode.py's _dequant_block
// (code - radius, outlier scatter) and of the cumsums and float epilogue of
// _dequant_recon_block / _recon_rows_block, plus what a TPU grid gave those
// kernels for free and a CUDA grid does not: an order among tiles.
//
// Work order.  CUDA blocks start and finish in no fixed order.  Each block
// therefore takes a ticket from an atomic counter (take_ticket) before it
// does anything else, and the ticket names its work (a 1-D kernel's tile
// t; an N-D kernel maps tickets to units by anti-diagonal), so work is
// claimed in ticket order by blocks that are already running.  A block
// only ever waits for work of a lower ticket, whose block holds it and is
// running too, so the wait always ends, whatever the schedule.
//
// Integer arithmetic.  The residuals and their prefix sums are uint32_t
// (addition mod 2^32, which is associative), cast to int32_t only at the
// end: any grouping gives the bits of the reference's int32 cumsum, and a
// sum that leaves the int32 range mid-scan is not undefined behaviour.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

#include "common.cuh"

namespace repro_torch {

// Shared scratch words a fused block uses beside its tile and its LUT:
// 32 warp flags, 32 warp sums, the ticket and the carry broadcast.
constexpr int kFusedScratchWords = 80;
constexpr int kTicketWord = 64;
constexpr int kCarryWord = 65;

// Threads of a fused block: one per lane of the decode stage, at least 256
// for the scan and the epilogue, at most 1024 (lanes above loop).
inline int fused_threads(int ss_max) {
  const int lanes = (ss_max + 31) / 32 * 32;
  return lanes < 256 ? 256 : (lanes > 1024 ? 1024 : lanes);
}

inline size_t fused_smem(long long block, int lut_size) {
  return 4 * static_cast<size_t>(block) + 4 * kFusedScratchWords +
         3 * static_cast<size_t>(lut_size);
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
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

// Tagged carries: a 64-bit word (tag << 32) | value, stored and loaded as
// one, so a reader that sees the tag it waits for also sees its value, with
// no flag, fence or barrier between them.  Loads bypass L1.
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

__device__ __forceinline__ unsigned long long tagged(unsigned tag,
                                                     uint32_t value) {
  return (static_cast<unsigned long long>(tag) << 32) | value;
}

// Thread 0 polls one tagged word, backing off between polls, until it
// carries `want`; then the whole block goes on (tag 0: no wait).  A block
// far down a chain waits here, and only the block next in line polls all
// of its words, so the waiting blocks do not crowd the words being handed
// on in L2.  Called by every thread of the block.
__device__ __forceinline__ void gate_on_tag(const unsigned long long* word,
                                            unsigned want) {
  if (want == 0) return;
  if (threadIdx.x == 0) {
    long long polls = 0;
    unsigned ns = 32;
    while (static_cast<unsigned>(ld_relaxed(word) >> 32) != want) {
      count_poll(&polls);
      __nanosleep(ns);
      ns = ns < 256 ? 2 * ns : ns;
    }
  }
  __syncthreads();
}

// Each thread reads the carries of up to kBatch of its indices (first,
// first + stride, ...; those below end) at once: the loads are in flight
// together, and only those whose tag is not yet `want` are read again.
// Waiting for tag 0 (nothing written yet) reads nothing and gives zeros.
constexpr int kBatch = 4;

__device__ __forceinline__ void wait_tags(
    const unsigned long long* words, int first, int stride, int end,
    unsigned want, uint32_t value[kBatch]) {
  if (want == 0) {  // tag 0: nothing to wait for
#pragma unroll
    for (int u = 0; u < kBatch; ++u) value[u] = 0;
    return;
  }
  unsigned long long w[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = first + u * stride;
    w[u] = i < end ? ld_relaxed(words + i) : tagged(want, 0u);
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = first + u * stride;
    long long polls = 0;
    while (static_cast<unsigned>(w[u] >> 32) != want) {
      count_poll(&polls);
      w[u] = ld_relaxed(words + i);
    }
    value[u] = static_cast<uint32_t>(w[u]);
  }
}

// The outlier half of _dequant_block: the exact residuals of the outliers
// [obounds[tile], obounds[tile + 1]) of the side list, scattered into the
// tile's d.  The caller's ops layer finds each tile's range by
// searchsorted, which assumes the side list's positions ascend with the -1
// padding at the tail, as both packages' compress write them.  Ends with
// __syncthreads().
__device__ __forceinline__ void scatter_outliers(
    int tile, int block, const int* __restrict__ opos,
    const int* __restrict__ oval, const int* __restrict__ obounds,
    uint32_t* d) {
  const long long base = static_cast<long long>(tile) * block;
  for (int i = obounds[tile] + threadIdx.x; i < obounds[tile + 1];
       i += blockDim.x) {
    const long long loc = opos[i] - base;
    if (loc >= 0 && loc < block) d[loc] = static_cast<uint32_t>(oval[i]);
  }
  __syncthreads();
}

// _dequant_block for tile `tile` of `block` codes read from a code array
// (the epilogue kernels): d = code - radius, then the tile's outliers.
__device__ __forceinline__ void load_residuals(
    const uint16_t* __restrict__ codes, int tile, int block, int radius,
    const int* __restrict__ opos, const int* __restrict__ oval,
    const int* __restrict__ obounds, uint32_t* d) {
  const uint16_t* src = codes + static_cast<long long>(tile) * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    d[i] = static_cast<uint32_t>(static_cast<int>(src[i]) - radius);
  }
  __syncthreads();
  scatter_outliers(tile, block, opos, oval, obounds, d);
}

// _dequant_block for tile `tile` of `block` codes decoded from the stream
// (the fused decode kernels): d = code - radius at every position (a
// position no lane writes holds code 0, as in the reference's
// zero-initialised tile), then the tile's outliers.  The caller stages the
// LUT (stage_lut) before the first call; the first barrier here publishes
// it.
__device__ __forceinline__ void stage_residuals(
    const uint32_t* __restrict__ units, long long n_units,
    const int* __restrict__ start_abs, const int* __restrict__ end_abs,
    const int* __restrict__ offsets, const int* __restrict__ s0,
    const int* __restrict__ lut_base, int n_subseq, int total_bits,
    int lut_size, int max_len, int tile, int block, int ss_max, int radius,
    const int* __restrict__ opos, const int* __restrict__ oval,
    const int* __restrict__ obounds, const uint16_t* s_sym,
    const uint8_t* s_len, uint32_t* d) {
  const uint32_t zero_code = static_cast<uint32_t>(-radius);
  for (int i = threadIdx.x; i < block; i += blockDim.x) d[i] = zero_code;
  __syncthreads();
  stage_tile_codes(units, n_units, start_abs, end_abs, offsets, s0, lut_base,
                   n_subseq, total_bits, s_sym, s_len, lut_size, max_len,
                   tile, block, ss_max, [&](int local, int sym) {
                     d[local] = static_cast<uint32_t>(sym - radius);
                   });
  __syncthreads();
  scatter_outliers(tile, block, opos, oval, obounds, d);
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

// The float epilogue: out[i] = cast(float(int32(q[i] + add)) * two_eb), the
// product in f32 (round to nearest, never contracted) and one cast, as
// lorenzo.dequantize computes it.
template <typename T>
__device__ __forceinline__ void write_out(const uint32_t* q, uint32_t add,
                                          int n_here, float two_eb,
                                          T* __restrict__ out) {
  for (int i = threadIdx.x; i < n_here; i += blockDim.x) {
    const int qi = static_cast<int>(q[i] + add);
    out[i] = to_out<T>(__fmul_rn(__int2float_rn(qi), two_eb));
  }
}

// ---------------------------------------------------------------------------
// 1-D carry: decoupled look-back
// ---------------------------------------------------------------------------

// Status word of a 1-D tile: (flag << 32) | value, flag 1 = the tile's
// aggregate, 2 = its inclusive prefix, 0 = nothing published yet.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// The sum of every tile before tile t, by decoupled look-back (Merrill &
// Garland 2016, the design of CUB's DeviceScan): thread 0 publishes the
// tile's aggregate in status[t], walks t-1, t-2, ... adding aggregates
// until it meets a tile that has published its inclusive prefix, and
// publishes its own inclusive prefix.  A tile waits only for its
// predecessors, which publish their aggregates as soon as their own scans
// are done.  Called by every thread; returns the exclusive prefix to all.
__device__ __forceinline__ uint32_t lookback_prefix(
    int t, uint32_t aggregate, unsigned long long* status,
    uint32_t* scratch) {
  if (threadIdx.x == 0) {
    uint32_t prefix = 0;
    if (t == 0) {
      st_release(status, kPrefix | aggregate);
    } else {
      st_release(status + t, kAggregate | aggregate);
      long long polls = 0;
      for (int j = t - 1;; --j) {
        unsigned long long w;
        while (((w = ld_acquire(status + j)) >> 32) == 0) count_poll(&polls);
        prefix += static_cast<uint32_t>(w);
        if ((w & ~0xffffffffull) == kPrefix) break;
      }
      st_release(status + t, kPrefix | (prefix + aggregate));
    }
    scratch[kCarryWord] = prefix;
  }
  __syncthreads();
  return scratch[kCarryWord];
}

// ---------------------------------------------------------------------------
// N-D carries: chained row carries and the plane carry, as tagged words
// ---------------------------------------------------------------------------
//
// The field is (planes, rows, cols) (planes = 1 for 2-D); a tile is w whole
// rows, block = w * cols codes, and for 3-D w divides rows, so a tile never
// crosses a plane.  The inverse Lorenzo is the cumsum along every axis:
//   e = cumsum of d along each row        (inside the tile: scan_rows)
//   f = row carry + cumsum of e down rows (row carry: f of the plane's
//                                          previous row, 0 at a plane start)
//   q = plane carry + f                   (3-D; plane carry: q of the same
//                                          rows in the previous plane)
// On the TPU both carries sat in VMEM scratch across an ordered grid.  Here
// a block takes a unit of `group` consecutive tiles (one tile for 3-D) and
// hands the carries on through global memory as tagged words, (tag << 32)
// | value, one per column or element, whose tag names the unit that wrote
// it.  A reader polls the words it needs until they carry the tag it waits
// for; the value comes in the same 64-bit load, so a hand-over costs one
// store and one load through L2, with no flag, fence or barrier.
//   * Row carry: a chained scan.  Unit (p, k), of index u = p * K + k (K
//     units a plane), waits for the (cols,) carry unit (p, k-1) wrote (tag
//     u), adds its rows and writes the carry of its last row (tag u + 1).
//     One vector is enough per chain, because only the next unit reads it.
//     The chains of the planes share a ring of slots = min(planes, K)
//     vectors, vector p % slots, so the first unit of plane p waits (for
//     the tag, not the value) until the last unit of plane p - slots has
//     written its vector, which it does after reading it.
//   * Plane carry (3-D): one (rows, cols) plane of tagged words, 8 MiB at
//     most, which stays in the 50 MB L2.  Tile (p, k) waits for the words
//     tile (p-1, k) wrote (tag p), adds them and writes q (tag p + 1),
//     except on the last plane.
// Tickets go to units by anti-diagonal, d = p + k (diagonal_unit), not
// plane by plane: unit (p, k) waits only for units of diagonal d - 1 (with
// slots = K, plane p - K's last unit is on diagonal d - 1 too), so every
// wait is for a unit of lower ticket, and the blocks in flight hold whole
// diagonals, all of whose units can proceed at once.  The ring and the
// plane are zeroed (tag 0: nothing written) by the wrapper for every
// launch.  A final partial tile of a 2-D field holds fake rows after the
// last row; they pollute only a carry no unit reads, and are never written
// to the output.

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

// The row carry and, for 3-D, the plane carry of unit (p, k), applied in
// place to its n codes of e (n / cols whole rows, `block` codes a tile),
// which become q.  Called by every thread; ends with __syncthreads().
__device__ __forceinline__ void nd_carries(
    uint32_t* d, int n, int cols, int block, int p, int k,
    int units_per_plane, int planes, int slots,
    unsigned long long* row_carry, unsigned long long* plane_carry) {
  const int nt = blockDim.x;
  const int rows = n / cols;
  const int u = p * units_per_plane + k;
  // Row carry from unit (p, k-1); a plane's first unit starts from 0 but
  // waits until plane p - slots has left the ring vector.  Tag 0: no wait.
  const unsigned want =
      k > 0 ? static_cast<unsigned>(u)
            : (p >= slots
                   ? static_cast<unsigned>(u - (slots - 1) * units_per_plane)
                   : 0u);
  unsigned long long* rc =
      row_carry + static_cast<size_t>(p % slots) * cols;
  gate_on_tag(rc, want);
  for (int c0 = threadIdx.x; c0 < cols; c0 += kBatch * nt) {
    uint32_t carry[kBatch];
    wait_tags(rc, c0, nt, cols, want, carry);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c0 + b * nt;
      if (c >= cols) break;
      uint32_t run = k > 0 ? carry[b] : 0u;
      for (int r = 0; r < rows; ++r) {
        run += d[r * cols + c];
        d[r * cols + c] = run;
      }
      st_relaxed(rc + c, tagged(static_cast<unsigned>(u + 1), run));
    }
  }
  __syncthreads();

  if (planes > 1) {
    // Plane carry (group = 1): q of the same rows in plane p - 1, from tile
    // (p-1, k).
    unsigned long long* pc = plane_carry + static_cast<size_t>(k) * block;
    const bool keep = p + 1 < planes;
    for (int i0 = threadIdx.x; i0 < block; i0 += kBatch * nt) {
      uint32_t prev[kBatch];
      wait_tags(pc, i0, nt, block, static_cast<unsigned>(p), prev);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * nt;
        if (i >= block) break;
        const uint32_t q = d[i] + (p > 0 ? prev[b] : 0u);
        if (keep) st_relaxed(pc + i, tagged(static_cast<unsigned>(p + 1), q));
        d[i] = q;
      }
    }
    __syncthreads();
  }
}

// Threads of an N-D block: enough for `lanes`, and for every column's
// carry in one batch of tagged loads (kBatch a thread); at most 1024.
inline int nd_threads(int cols, int lanes) {
  const int col_threads = ((cols + kBatch - 1) / kBatch + 31) / 32 * 32;
  const int t = col_threads > lanes ? col_threads : lanes;
  return t > 1024 ? 1024 : t;
}

}  // namespace repro_torch
