// Phase 4 of the padded baseline decoder: each subsequence decodes into its
// own row of a padded (n_subseq, 128) code array.
//
// Replaces the TPU kernel src/repro/kernels/huffman_decode.py:decode_padded
// (body decode_padded_kernel_body -> common.decode_window with collect;
// compaction in ops.decode_padded_compact).  This is the paper's "before"
// case, the write pattern of the original decoders, kept as the A/B
// baseline of the staged tile decode (decode_tiles.cu): one thread per
// subsequence, 256 threads a block, the LUT staged once per block in
// shared memory (or, past shared memory at max_len 17 and up, read from
// device memory through the read-only path: the kGlobalLut variant, which
// huffman_decode.decode_padded_lut_in_smem chooses by size).  A thread
// applies the reference's window rules to its absolute [start, end),
// reads its 6-unit row straight from the stream, and writes its k-th code
// to padded[s, min(k, 127)] in device memory as it decodes it.  Those
// writes are deliberately scattered: the 32 threads of a warp store into
// 32 rows 256 B apart, so no code store of a warp is coalesced.  The ops
// layer then compacts the rows into the dense output with torch ops
// (output offsets, searchsorted owner, gather), as the reference does
// outside its kernel.
//
// The zeros past each count are this repo's padded layout, not part of the
// original decoders' cost.  So the block writes them first and together:
// its 256 rows are 64 KB of contiguous memory, zeroed with 16-byte stores
// (neighbouring threads on neighbouring addresses) before the decode, and
// the block barrier that follows the LUT staging orders them before the
// codes, which then overwrite their slots.  Writing only the tail, after
// the decode (the lane zeroes up to its next 16-byte chunk, the block the
// chunks past each count), writes each slot once but adds scattered
// stores and a second pass: on an H100 80GB HBM3 at 700 W it took 0.58 ms
// on isabel3d's 577,152 rows against 0.49 ms for this kernel.
//
// What bounds it on the H100: the byte floor is the payload, 12 B read per
// subsequence and 256 B + 4 B written per subsequence (the padded row and
// the count): 148 MB of rows at isabel3d's 577,152 subsequences, against
// ~50 MB of codes.  Beyond the bytes, the bit-serial loop and the
// uncoalesced code stores bound it; both are the point of the baseline.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

template <bool kGlobalLut>
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
  const uint16_t* sym = dec_sym;
  const uint8_t* len = dec_len;
  if constexpr (!kGlobalLut) {
    uint16_t* s_sym = reinterpret_cast<uint16_t*>(smem);
    uint8_t* s_len = smem + 2 * static_cast<size_t>(lut_size);
    stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
    sym = s_sym;
    len = s_len;
  }
  // Zero the block's rows, 16 B a store (a row is 256 B, 16-byte aligned).
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int n_rows = static_cast<int>(min(static_cast<long long>(blockDim.x),
                                          n - row0));
  constexpr int kChunks = kMaxSyms * 2 / 16;     // 16-byte chunks a row
  uint4* zero = reinterpret_cast<uint4*>(padded + row0 * kMaxSyms);
  for (int k = threadIdx.x; k < n_rows * kChunks; k += blockDim.x) {
    zero[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int row_id, start, end;
  subseq_window(start_abs[i], end_abs[i], total_bits, &row_id, &start, &end);
  uint32_t row[kRowUnits];
  load_row(units, n_units, row_id, row);
  uint16_t* dst = padded + static_cast<long long>(i) * kMaxSyms;
  int land;
  const int c = decode_lane<kGlobalLut>(
      row, start, end, sym, len, lut_size, 0, max_len, &land,
      [&](int k, int code) {
        dst[min(k, kMaxSyms - 1)] = static_cast<uint16_t>(code);
        return true;
      });
  counts[i] = c;
}

template <bool kGlobalLut>
int launch(const void* units, long long n_units, const void* start_abs,
           const void* end_abs, int n, int total_bits, const void* dec_sym,
           const void* dec_len, int lut_size, int max_len, void* padded,
           void* counts, void* stream) {
  const int threads = 256;
  const size_t smem = kGlobalLut ? 0 : 3 * static_cast<size_t>(lut_size);
  auto kernel = decode_padded_kernel<kGlobalLut>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs), n,
      total_bits, static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len,
      static_cast<uint16_t*>(padded), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success).  `padded` holds
// n * 128 uint16 codes, is 16-byte aligned (cudaErrorMisalignedAddress
// otherwise) and is written in full.  `global_lut` (0 or 1) selects the
// variant that reads the LUT from device memory instead of staging it.
extern "C" int repro_decode_padded(const void* units, long long n_units,
                                   const void* start_abs, const void* end_abs,
                                   int n, int total_bits, const void* dec_sym,
                                   const void* dec_len, int lut_size,
                                   int max_len, int global_lut, void* padded,
                                   void* counts, void* stream) {
  using namespace repro_torch;
  if (reinterpret_cast<uintptr_t>(padded) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return global_lut
             ? launch<true>(units, n_units, start_abs, end_abs, n, total_bits,
                            dec_sym, dec_len, lut_size, max_len, padded,
                            counts, stream)
             : launch<false>(units, n_units, start_abs, end_abs, n,
                             total_bits, dec_sym, dec_len, lut_size, max_len,
                             padded, counts, stream);
}
