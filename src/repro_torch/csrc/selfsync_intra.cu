// Phase 1 of the self-synchronization decoder: per-sequence sync discovery.
//
// Replaces the TPU kernel src/repro/kernels/huffman_selfsync.py:
// selfsync_intra (body selfsync_kernel_body; prep ops.selfsync_sync).  Same
// function, bit for bit: lane j of sequence s owns subsequence s*sps + j,
// whose row is units[4i : 4i+6] (reads past the stream are zero) and whose
// window ends at clip(min(b+128, total_bits) - b, 0, 192).  Lane 0 starts
// at heads[s], every other lane at 0.  A round is synchronous (Jacobi):
// every lane decodes from the previous round's start, then
// new_start = [start[0], landing[0:-1] - 128].  With early_exit the rounds
// stop when no start changed or after sps rounds; without it exactly sps
// rounds run, each decoding every lane.  The outputs are the last round's:
// start after its update, counts and landing from its decode, and the
// rounds run.
//
// Two kernels; the wrapper's launch geometry (huffman_selfsync.py:
// selfsync_geometry) picks one by sps and passes its block shape.
//
// sps <= 32 (the codec's default is 32): a warp a sequence, several
// sequences a block.  Lane j owns subsequence s*sps + j; its row, start,
// landing and count live in registers for all rounds.  Lane j+1's next
// start is __shfl_up_sync of lane j's landing, and the fixed-point test is
// a warp vote (__any_sync: the paper's __all_sync exit), so no block
// barrier sits in the round loop and each warp leaves when its own
// sequence is done.  Lanes at or past sps decode nothing (an empty window)
// and join every shuffle and vote.  The LUT is staged once a block for all
// its sequences; the block's width is chosen in Python so that the blocks
// an SM's shared memory holds fill its 64 warps (8 warps a block at a
// 4,096-entry LUT: 28 registers a thread, 8 blocks an SM).
//
// sps > 32: one block a sequence, round_up(sps, 32) threads (at most
// 1024); a thread owns lanes t, t + blockDim, ..., so any sps works.  The
// row of a thread's first lane is loaded once into registers; further
// lanes, which exist only past 1024 lanes a sequence, re-read theirs from
// the cache each round.  Starts (double-buffered), landings and counts
// live in shared memory beside the LUT, and the round ends in two block
// barriers, the second a __syncthreads_or vote.
//
// Both kernels have a variant (kGlobalLut) that leaves a LUT too large for
// shared memory (3 B an entry: max_len 17 and up) in device memory and
// reads it through the read-only path; huffman_selfsync.selfsync_geometry
// chooses it by size, before the launch.
//
// What bounds it on the H100: the byte floor is the payload, 8 B per
// sequence (head and rounds) and 12 B written per subsequence (0.005 ms on a
// 577,152-subsequence stream).  The real limit is the bit-serial decode
// (common.cuh:decode_lane), repeated once per round: 2-3 rounds a pass with
// early exit on smooth fields, sps without.  A round costs a little less
// than one count_subseq launch over the same windows (the same lane loop).
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

// Row-local window end of subsequence `sub`.
__device__ __forceinline__ int window_end(int sub, int total_bits) {
  const long long b = static_cast<long long>(sub) * kSubseqBits;
  return static_cast<int>(
      min(max(min(b + kSubseqBits, static_cast<long long>(total_bits)) - b,
              0LL),
          static_cast<long long>(kRowBits)));
}

template <bool kGlobalLut>
__global__ void __launch_bounds__(1024)
selfsync_intra_warp_kernel(const uint32_t* __restrict__ units,
                           long long n_units, const int* __restrict__ heads,
                           int n_seq, int sps, int total_bits,
                           const uint16_t* __restrict__ dec_sym,
                           const uint8_t* __restrict__ dec_len, int lut_size,
                           int max_len, int early_exit,
                           int* __restrict__ start_out,
                           int* __restrict__ counts_out,
                           int* __restrict__ landing_out,
                           int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* sym = dec_sym;
  const uint8_t* len = dec_len;
  if constexpr (!kGlobalLut) {
    uint16_t* s_sym = reinterpret_cast<uint16_t*>(smem);
    uint8_t* s_len = smem + 2 * static_cast<size_t>(lut_size);
    stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
    __syncthreads();
    sym = s_sym;
    len = s_len;
  }

  const int lane = threadIdx.x & 31;
  const int seq = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (seq >= n_seq) return;              // the whole warp; no barrier follows
  const bool live = lane < sps;
  const int sub = seq * sps + lane;
  uint32_t row[kRowUnits] = {};
  int end = 0;
  if (live) {
    load_row(units, n_units, sub, row);
    end = window_end(sub, total_bits);
  }
  int start = lane == 0 ? heads[seq] : 0;
  int count = 0, land = 0, rounds = 0;
  bool more = true;
  while (more) {                         // warp-uniform
    count = decode_lane<kGlobalLut>(row, start, end, sym, len, lut_size, 0,
                                    max_len, &land,
                                    [](int, int) { return true; });
    const int prev = __shfl_up_sync(kFullMask, land, 1);
    const int next = lane == 0 ? start : prev - kSubseqBits;
    const bool changed = __any_sync(kFullMask, live && next != start);
    start = next;
    ++rounds;
    more = rounds < sps && (changed || early_exit == 0);
  }
  if (live) {
    start_out[sub] = start;
    counts_out[sub] = count;
    landing_out[sub] = land;
  }
  if (lane == 0) rounds_out[seq] = rounds;
}

template <bool kGlobalLut>
__global__ void selfsync_intra_block_kernel(
    const uint32_t* __restrict__ units, long long n_units,
    const int* __restrict__ heads, int sps, int total_bits,
    const uint16_t* __restrict__ dec_sym, const uint8_t* __restrict__ dec_len,
    int lut_size, int max_len, int early_exit, int* __restrict__ start_out,
    int* __restrict__ counts_out, int* __restrict__ landing_out,
    int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_buf = reinterpret_cast<int*>(smem);     // starts, two buffers
  int* s_land = s_buf + 2 * sps;
  int* s_cnt = s_land + sps;
  const uint16_t* sym = dec_sym;
  const uint8_t* len = dec_len;
  if constexpr (!kGlobalLut) {
    uint16_t* s_sym = reinterpret_cast<uint16_t*>(s_cnt + sps);
    uint8_t* s_len = reinterpret_cast<uint8_t*>(s_sym + lut_size);
    stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
    sym = s_sym;
    len = s_len;
  }

  const int seq = blockIdx.x;
  const int first = seq * sps;                   // first subsequence
  const int t = threadIdx.x;
  uint32_t row0[kRowUnits];
  if (t < sps) load_row(units, n_units, first + t, row0);
  for (int j = t; j < sps; j += blockDim.x) {
    s_buf[j] = j == 0 ? heads[seq] : 0;
  }
  __syncthreads();

  int* cur = s_buf;
  int* nxt = s_buf + sps;
  int rounds = 0;
  bool more = true;
  while (more) {
    for (int j = t; j < sps; j += blockDim.x) {
      uint32_t row[kRowUnits];
      if (j == t) {
#pragma unroll
        for (int i = 0; i < kRowUnits; ++i) row[i] = row0[i];
      } else {
        load_row(units, n_units, first + j, row);
      }
      int land;
      s_cnt[j] = decode_lane<kGlobalLut>(
          row, cur[j], window_end(first + j, total_bits), sym, len, lut_size,
          0, max_len, &land, [](int, int) { return true; });
      s_land[j] = land;
    }
    __syncthreads();
    int changed = 0;
    for (int j = t; j < sps; j += blockDim.x) {
      const int v = j == 0 ? cur[0] : s_land[j - 1] - kSubseqBits;
      nxt[j] = v;
      changed |= v != cur[j];
    }
    ++rounds;
    const int any = __syncthreads_or(changed);
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    more = rounds < sps && (any != 0 || early_exit == 0);
  }

  for (int j = t; j < sps; j += blockDim.x) {
    const long long o = static_cast<long long>(first) + j;
    start_out[o] = cur[j];
    counts_out[o] = s_cnt[j];
    landing_out[o] = s_land[j];
  }
  if (t == 0) rounds_out[seq] = rounds;
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Check the geometry against sps and launch the kernel it names.
template <bool kGlobalLut>
int launch(const uint32_t* u, long long n_units, const int* h, int n_seq,
           int sps, int total_bits, const uint16_t* sym, const uint8_t* len,
           int lut_size, int max_len, int early_exit, int seqs_per_block,
           int threads, int smem, int* st, int* cn, int* ld, int* rd,
           cudaStream_t s) {
  const int lut_smem = kGlobalLut ? 0 : 3 * lut_size;
  if (sps < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      smem < lut_smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sps <= 32) {
    if (threads != 32 * seqs_per_block) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t e =
        allow_smem(selfsync_intra_warp_kernel<kGlobalLut>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (n_seq + seqs_per_block - 1) / seqs_per_block;
    selfsync_intra_warp_kernel<kGlobalLut><<<blocks, threads, smem, s>>>(
        u, n_units, h, n_seq, sps, total_bits, sym, len, lut_size, max_len,
        early_exit, st, cn, ld, rd);
  } else {
    if (seqs_per_block != 1 || smem < 16 * sps + lut_smem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t e =
        allow_smem(selfsync_intra_block_kernel<kGlobalLut>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    selfsync_intra_block_kernel<kGlobalLut><<<n_seq, threads, smem, s>>>(
        u, n_units, h, sps, total_bits, sym, len, lut_size, max_len,
        early_exit, st, cn, ld, rd);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  The geometry comes from the wrapper
// (huffman_selfsync.py:selfsync_geometry): sps <= 32 runs the warp kernel
// with seqs_per_block warps of 32 threads, sps > 32 the block kernel with
// one sequence and `threads` threads a block; `smem` is a block's dynamic
// shared memory.  `global_lut` (0 or 1) selects the variants that read the
// LUT from device memory instead of staging it.  A geometry that does not
// match sps is refused with cudaErrorInvalidValue.  Launches on `stream`,
// allocates nothing, does not synchronize; returns cudaGetLastError() (0 on
// success).
extern "C" int repro_selfsync_intra(const void* units, long long n_units,
                                    const void* heads, int n_seq, int sps,
                                    int total_bits, const void* dec_sym,
                                    const void* dec_len, int lut_size,
                                    int max_len, int global_lut,
                                    int early_exit, int seqs_per_block,
                                    int threads, int smem, void* start,
                                    void* counts, void* landing, void* rounds,
                                    void* stream) {
  using namespace repro_torch;
  const auto* u = static_cast<const uint32_t*>(units);
  const auto* h = static_cast<const int*>(heads);
  const auto* sym = static_cast<const uint16_t*>(dec_sym);
  const auto* len = static_cast<const uint8_t*>(dec_len);
  auto* st = static_cast<int*>(start);
  auto* cn = static_cast<int*>(counts);
  auto* ld = static_cast<int*>(landing);
  auto* rd = static_cast<int*>(rounds);
  const auto s = static_cast<cudaStream_t>(stream);
  return global_lut
             ? launch<true>(u, n_units, h, n_seq, sps, total_bits, sym, len,
                            lut_size, max_len, early_exit, seqs_per_block,
                            threads, smem, st, cn, ld, rd, s)
             : launch<false>(u, n_units, h, n_seq, sps, total_bits, sym, len,
                             lut_size, max_len, early_exit, seqs_per_block,
                             threads, smem, st, cn, ld, rd, s);
}
