// Phase 1 of the gap-array decoder: codewords per 128-bit subsequence.
//
// Replaces the TPU kernel src/repro/kernels/huffman_decode.py:count_subseq
// (body count_kernel_body -> common.decode_window; prep ops.subseq_counts).
// It computes the same function, not the same blocking: one thread per
// subsequence, 256 threads a block.  Each thread applies the reference's
// window rules to its absolute [start, end), reads its 6-unit row straight
// from the stream (no (n, 6) row copy in device memory, unlike the TPU
// path), and decodes through a LUT staged once per block in shared memory.
//
// What bounds it on the H100: the byte floor is the payload (total_bits/8)
// plus 8 B read and 8 B written per subsequence, well under a millisecond
// at the smoke shapes.  The real limit is the bit-serial loop (one LUT
// lookup per codeword, up to 128 per thread) and divergence between lanes
// of a warp whose subsequences hold different codeword counts.  The design
// keeps the loop's state in registers (row select by predication, no local
// memory) and the LUT in shared memory; warp-cooperative decode is later
// work.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

__global__ void count_subseq_kernel(const uint32_t* __restrict__ units,
                                    long long n_units,
                                    const int* __restrict__ start_abs,
                                    const int* __restrict__ end_abs, int n,
                                    int total_bits,
                                    const uint16_t* __restrict__ dec_sym,
                                    const uint8_t* __restrict__ dec_len,
                                    int lut_size, int max_len,
                                    int* __restrict__ counts,
                                    int* __restrict__ landing) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_sym = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s_len = smem + 2 * static_cast<size_t>(lut_size);
  stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int row_id, start, end;
  subseq_window(start_abs[i], end_abs[i], total_bits, &row_id, &start, &end);
  uint32_t row[kRowUnits];
  load_row(units, n_units, row_id, row);
  int land;
  const int c = decode_lane(row, start, end, s_sym, s_len, lut_size, 0,
                            max_len, &land, [](int, int) { return true; });
  counts[i] = c;
  landing[i] = land;
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success).
extern "C" int repro_count_subseq(const void* units, long long n_units,
                                  const void* start_abs, const void* end_abs,
                                  int n, int total_bits, const void* dec_sym,
                                  const void* dec_len, int lut_size,
                                  int max_len, void* counts, void* landing,
                                  void* stream) {
  using namespace repro_torch;
  const int threads = 256;
  const size_t smem = 3 * static_cast<size_t>(lut_size);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        count_subseq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + threads - 1) / threads;
  count_subseq_kernel<<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs), n,
      total_bits, static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len,
      static_cast<int*>(counts), static_cast<int*>(landing));
  return static_cast<int>(cudaGetLastError());
}
