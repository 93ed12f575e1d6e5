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
// stop when no start changed (the paper's __all_sync exit, here at block
// scope through __syncthreads_or) or after sps rounds; without it exactly
// sps rounds run.  The outputs are the last round's: start after its
// update, counts and landing from its decode, and the rounds run.
//
// Design: one block per sequence, round_up(sps, 32) threads (at most
// 1024); a thread owns lanes t, t + blockDim, ..., so any sps works.  The
// row of a thread's first lane is loaded once into registers (it does not
// change across rounds, only the start does); further lanes, which exist
// only past 1024 lanes a sequence, re-read theirs from the cache each
// round.  Starts (double-buffered), landings and counts live in shared
// memory beside the LUT, which is staged once per block.  Idle threads
// join every barrier, so the block leaves the loop together.
//
// What bounds it on the H100: the byte floor is the payload plus 4 B of
// head per sequence and 12 B written per subsequence (0.006 ms on a
// 577,152-subsequence stream).  The real limit is the bit-serial decode,
// repeated once per round (2-3 rounds a pass with early exit on smooth
// fields, sps without), and a block of one warp at the default sps of 32.
// Packing several sequences into a block and exchanging landings by warp
// shuffles are later work.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

__global__ void selfsync_intra_kernel(const uint32_t* __restrict__ units,
                                      long long n_units,
                                      const int* __restrict__ heads, int sps,
                                      int total_bits,
                                      const uint16_t* __restrict__ dec_sym,
                                      const uint8_t* __restrict__ dec_len,
                                      int lut_size, int max_len,
                                      int early_exit,
                                      int* __restrict__ start_out,
                                      int* __restrict__ counts_out,
                                      int* __restrict__ landing_out,
                                      int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_buf = reinterpret_cast<int*>(smem);     // starts, two buffers
  int* s_land = s_buf + 2 * sps;
  int* s_cnt = s_land + sps;
  uint16_t* s_sym = reinterpret_cast<uint16_t*>(s_cnt + sps);
  uint8_t* s_len = reinterpret_cast<uint8_t*>(s_sym + lut_size);
  stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);

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
      const long long b = static_cast<long long>(first + j) * kSubseqBits;
      const int end = static_cast<int>(
          min(max(min(b + kSubseqBits, static_cast<long long>(total_bits)) -
                      b,
                  0LL),
              static_cast<long long>(kRowBits)));
      int land;
      s_cnt[j] = decode_lane(row, cur[j], end, s_sym, s_len, lut_size, 0,
                             max_len, &land, [](int, int) { return true; });
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

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success).
extern "C" int repro_selfsync_intra(const void* units, long long n_units,
                                    const void* heads, int n_seq, int sps,
                                    int total_bits, const void* dec_sym,
                                    const void* dec_len, int lut_size,
                                    int max_len, int early_exit,
                                    void* start, void* counts, void* landing,
                                    void* rounds, void* stream) {
  using namespace repro_torch;
  const int threads = min((sps + 31) / 32 * 32, 1024);
  const size_t smem =
      16 * static_cast<size_t>(sps) + 3 * static_cast<size_t>(lut_size);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        selfsync_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  selfsync_intra_kernel<<<n_seq, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(heads), sps, total_bits,
      static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len, early_exit,
      static_cast<int*>(start), static_cast<int*>(counts),
      static_cast<int*>(landing), static_cast<int*>(rounds));
  return static_cast<int>(cudaGetLastError());
}
