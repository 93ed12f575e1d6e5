// Device functions shared by the two fused decode kernels
// (decode_tiles_fused.cu, decode_tiles_fused_nd.cu).
//
// CUDA counterparts of src/repro/kernels/fused_decode.py's _dequant_block
// (code - radius, outlier scatter) and of the cumsums and float epilogue of
// _dequant_recon_block / _recon_rows_block, plus what a TPU grid gave those
// kernels for free and a CUDA grid does not: an order among tiles.
//
// Work order.  CUDA blocks start and finish in no fixed order.  Each block
// therefore takes a ticket from an atomic counter (take_ticket) before it
// does anything else, and the ticket names its work (the 1-D kernel's tile
// t; the N-D kernel maps tickets to tiles by anti-diagonal), so work is
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

// _dequant_block for tile `tile` of `block` codes: d = code - radius at
// every position (a position no lane writes holds code 0, as in the
// reference's zero-initialised tile), then the exact residuals of the
// outliers [obounds[tile], obounds[tile + 1]) of the side list.  The
// caller's ops layer finds each tile's range by searchsorted, which assumes
// the side list's positions ascend with the -1 padding at the tail, as
// both packages' compress write it.  The caller stages the LUT (stage_lut)
// before the first call; the first barrier here publishes it.
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
  const long long base = static_cast<long long>(tile) * block;
  for (int i = obounds[tile] + threadIdx.x; i < obounds[tile + 1];
       i += blockDim.x) {
    const long long loc = opos[i] - base;
    if (loc >= 0 && loc < block) d[loc] = static_cast<uint32_t>(oval[i]);
  }
  __syncthreads();
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

}  // namespace repro_torch
