// Phase 1 of the gap-array decoder: codewords per 128-bit subsequence.
//
// Replaces the TPU kernel src/repro/kernels/huffman_decode.py:count_subseq
// (body count_kernel_body -> common.decode_window; prep ops.subseq_counts).
// It computes the same function, not the same blocking: one thread a
// subsequence at a time.  Each thread applies the reference's window rules
// to its absolute [start, end), reads its 6-unit row straight from the
// stream (no (n, 6) row copy in device memory, unlike the TPU path), and
// decodes it through common.cuh's bit-buffer lane decoder
// (decode_lane_buf).
//
// What bounds it on the H100: the byte floor is the payload (total_bits/8)
// plus 8 B read and 8 B written per subsequence (18.5 MB, 0.0055 ms at
// isabel3d's 577,152 subsequences).  The real limit is the rate at which
// the SMs issue the bit-serial loop: one LUT lookup a codeword, ~25 M on
// isabel3d, on a dependent chain.  So the design cuts the instructions a
// codeword and the work around the loop:
//   * the lane decoder keeps the next bits in a 64-bit buffer refilled
//     once per 32 bits from a register queue: a step is a buffer shift, a
//     LUT load and a few integer operations, where decode_lane's peek_row
//     took two 6-way selects, a 64-bit shift and clamps;
//   * the kernel reads only the code lengths, so a block stages the u8
//     length table alone (4 KB at max_len 12, 64 KB at 16), 16 bytes a load;
//     a table past shared memory (max_len 18 and up) stays in device memory
//     and is read through the read-only path (the kGlobalLut variant, which
//     huffman_decode.count_subseq_geometry chooses by size);
//   * the grid is sized to the card: at most as many blocks as the SMs
//     hold resident, never more than ceil(n / threads), and each thread
//     takes the same number of subsequences (a grid stride, so neighbouring
//     threads keep neighbouring subsequences and every load and store stays
//     coalesced).  The table is staged once a resident block, not once for
//     every 256 subsequences, and no wave of blocks is left over at the
//     end.  huffman_decode.count_subseq_geometry computes the geometry.
// Warp-cooperative decode (lanes of a warp splitting one subsequence) was
// not taken: a subsequence's codewords are a serial chain, and the one
// thread a subsequence already keeps every lane busy on the same loop.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

// Threads a block and resident blocks an SM: __launch_bounds__ holds the
// kernel to 32 registers so that 8 blocks fit an SM, as
// huffman_decode.count_subseq_geometry assumes.
constexpr int kCountThreads = 256;
constexpr int kCountMinBlocks = 8;

template <bool kGlobalLut>
__global__ void __launch_bounds__(kCountThreads, kCountMinBlocks)
    count_subseq_kernel(const uint32_t* __restrict__ units, long long n_units,
                        const int* __restrict__ start_abs,
                        const int* __restrict__ end_abs, int n,
                        int total_bits, const uint8_t* __restrict__ dec_len,
                        int lut_size, int max_len, int* __restrict__ counts,
                        int* __restrict__ landing) {
  extern __shared__ __align__(16) unsigned char s_len[];
  const uint8_t* len = dec_len;
  if constexpr (!kGlobalLut) {
    stage_bytes(s_len, dec_len, lut_size);
    __syncthreads();
    len = s_len;
  }

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int row_id, start, end;
    subseq_window(start_abs[i], end_abs[i], total_bits, &row_id, &start,
                  &end);
    uint32_t row[kRowUnits];
    load_row(units, n_units, row_id, row);
    int land;
    const int c = decode_lane_buf<kGlobalLut, false>(
        row, start, end, nullptr, len, lut_size, 0, max_len, &land,
        [](int, int) { return true; });
    counts[i] = c;
    landing[i] = land;
  }
}

template <bool kGlobalLut>
int launch(const void* units, long long n_units, const void* start_abs,
           const void* end_abs, int n, int total_bits, const void* dec_len,
           int lut_size, int max_len, int blocks, int threads, int smem,
           void* counts, void* landing, void* stream) {
  auto kernel = count_subseq_kernel<kGlobalLut>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs), n,
      total_bits, static_cast<const uint8_t*>(dec_len), lut_size, max_len,
      static_cast<int*>(counts), static_cast<int*>(landing));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches `blocks` blocks of `threads` (<= 256) threads
// with `smem` bytes of shared memory (the length table rounded up to 16
// bytes, or 0 with `global_lut`) on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success).  `global_lut` (0
// or 1) selects the variant that reads the lengths from device memory.
extern "C" int repro_count_subseq(const void* units, long long n_units,
                                  const void* start_abs, const void* end_abs,
                                  int n, int total_bits, const void* dec_len,
                                  int lut_size, int max_len, int global_lut,
                                  int blocks, int threads, int smem,
                                  void* counts, void* landing, void* stream) {
  using namespace repro_torch;
  return global_lut
             ? launch<true>(units, n_units, start_abs, end_abs, n, total_bits,
                            dec_len, lut_size, max_len, blocks, threads, smem,
                            counts, landing, stream)
             : launch<false>(units, n_units, start_abs, end_abs, n,
                             total_bits, dec_len, lut_size, max_len, blocks,
                             threads, smem, counts, landing, stream);
}
