// Phase 4 of the padded baseline decoder: each subsequence decodes into its
// own row of a padded (n_subseq, 128) code array.
//
// Replaces the TPU kernel src/repro/kernels/huffman_decode.py:decode_padded
// (body decode_padded_kernel_body -> common.decode_window with collect;
// compaction in ops.decode_padded_compact).  This is the paper's "before"
// case, the write pattern of the original decoders, kept as the A/B
// baseline of the staged tile decode (decode_tiles.cu): one thread per
// subsequence, 256 threads a block, the LUT staged once per block in
// shared memory.  A thread applies the reference's window rules to its
// absolute [start, end), reads its 6-unit row straight from the stream,
// and writes its k-th code to padded[s, min(k, 127)] as it decodes it, then
// zeros the rest of its row.  Those writes are deliberately scattered: the
// 32 threads of a warp store into 32 rows 256 B apart, so no store of a
// warp is coalesced.  The ops layer then compacts the rows into the dense
// output with torch ops (output offsets, searchsorted owner, gather), as
// the reference does outside its kernel.
//
// What bounds it on the H100: the byte floor is the payload, 12 B read per
// subsequence and 256 B + 4 B written per subsequence (the padded row and
// the count): 148 MB of rows at isabel3d's 577,152 subsequences, against
// ~50 MB of codes.  Beyond the bytes, the bit-serial loop and the
// uncoalesced stores bound it; both are the point of the baseline.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

__global__ void decode_padded_kernel(const uint32_t* __restrict__ units,
                                     long long n_units,
                                     const int* __restrict__ start_abs,
                                     const int* __restrict__ end_abs, int n,
                                     int total_bits,
                                     const uint16_t* __restrict__ dec_sym,
                                     const uint8_t* __restrict__ dec_len,
                                     int lut_size, int max_len,
                                     uint16_t* __restrict__ padded,
                                     int* __restrict__ counts) {
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
  uint16_t* dst = padded + static_cast<long long>(i) * kMaxSyms;
  int land;
  const int c = decode_lane(row, start, end, s_sym, s_len, lut_size, 0,
                            max_len, &land, [&](int k, int sym) {
                              dst[min(k, kMaxSyms - 1)] =
                                  static_cast<uint16_t>(sym);
                              return true;
                            });
  for (int k = c; k < kMaxSyms; ++k) dst[k] = 0;
  counts[i] = c;
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success).  `padded` holds
// n * 128 uint16 codes and is written in full.
extern "C" int repro_decode_padded(const void* units, long long n_units,
                                   const void* start_abs, const void* end_abs,
                                   int n, int total_bits, const void* dec_sym,
                                   const void* dec_len, int lut_size,
                                   int max_len, void* padded, void* counts,
                                   void* stream) {
  using namespace repro_torch;
  const int threads = 256;
  const size_t smem = 3 * static_cast<size_t>(lut_size);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_padded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + threads - 1) / threads;
  decode_padded_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs), n,
      total_bits, static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len,
      static_cast<uint16_t*>(padded), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
