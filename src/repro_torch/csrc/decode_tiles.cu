// Phase 4 of the decoder (paper Alg. 1): tile-staged decode and write.
//
// Replaces the TPU kernel src/repro/kernels/huffman_decode.py:decode_tiles
// (body decode_tiles_kernel_body -> common.stage_tile; lane metadata in
// ops._tile_inputs).  One block per output tile of tile_syms codes.  The
// block stages the decode LUT and a zeroed u16 tile in shared memory, and
// its lanes decode into the tile through common.cuh's stage_tile_codes (the
// decode stage the fused kernels share).  After __syncthreads() the block
// writes the tile to device memory densely and coalesced: the paper's
// shared-memory staged write.  The lane budget is ss_max = pipeline.ss_max_for_tile(tile_syms,
// max_len) (411 at the defaults); above blockDim lanes a thread loops.
//
// What bounds it on the H100: the byte floor is the payload plus 12 B read
// per subsequence plus 2 B written per code.  The real limit is the
// bit-serial decode loop and lane divergence, and the static lane budget:
// at a high compression ratio a tile overlaps only ~tile_syms/128 + 2
// subsequences, so most of the ss_max lanes have nothing to do.  Those
// lanes leave at once (their output starts past the tile), and a lane stops
// decoding as soon as its next symbol would land past the tile end.  Both
// early exits drop only writes the reference drops, so the output is the
// reference's bit for bit.
//
// LUT placement.  The batched decode (pipeline.decode_batch) hands the
// kernel one LUT merged from every tensor's codebook at a common max_len:
// 3 B x 2^max_len per tensor, 12 KB at max_len 12, so past ~17 tensors the
// LUT and a class tile no longer fit 227 KB of shared memory.  A second
// variant of the kernel (kGlobalLut) stages only the tile and reads the LUT
// from device memory through the read-only path; the wrapper picks it by
// size (huffman_decode.decode_tiles_lut_in_smem), before the launch.  A
// lane reads only its own tensor's slice of the merged table, so the slices
// a block touches are few and stay in L1/L2.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

template <bool kGlobalLut>
__global__ void decode_tiles_kernel(
    const uint32_t* __restrict__ units, long long n_units,
    const int* __restrict__ start_abs, const int* __restrict__ end_abs,
    const int* __restrict__ offsets, const int* __restrict__ s0,
    const int* __restrict__ lut_base, int n_subseq, int total_bits,
    const uint16_t* __restrict__ dec_sym, const uint8_t* __restrict__ dec_len,
    int lut_size, int max_len, int tile_syms, int ss_max, long long n_out,
    uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* stage = reinterpret_cast<uint16_t*>(smem);
  const uint16_t* sym_tab = dec_sym;
  const uint8_t* len_tab = dec_len;
  if constexpr (!kGlobalLut) {
    uint16_t* s_sym = stage + tile_syms;
    uint8_t* s_len = reinterpret_cast<uint8_t*>(s_sym + lut_size);
    stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
    sym_tab = s_sym;
    len_tab = s_len;
  }
  for (int i = threadIdx.x; i < tile_syms; i += blockDim.x) stage[i] = 0;
  __syncthreads();

  stage_tile_codes<kGlobalLut>(
      units, n_units, start_abs, end_abs, offsets, s0, lut_base, n_subseq,
      total_bits, sym_tab, len_tab, lut_size, max_len,
      static_cast<int>(blockIdx.x), tile_syms, ss_max,
      [&](int local, int sym) { stage[local] = static_cast<uint16_t>(sym); });
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * tile_syms;
  const int n_here = static_cast<int>(
      min(static_cast<long long>(tile_syms), n_out - base));
  for (int i = threadIdx.x; i < n_here; i += blockDim.x) out[base + i] = stage[i];
}

template <bool kGlobalLut>
int launch(const void* units, long long n_units, const void* start_abs,
           const void* end_abs, const void* offsets, const void* s0,
           const void* lut_base, int n_subseq, int total_bits,
           const void* dec_sym, const void* dec_len, int lut_size,
           int max_len, int tile_syms, int ss_max, long long n_out,
           int n_tiles, void* out, void* stream) {
  const int threads = ss_max >= 1024 ? 1024 : (ss_max + 31) / 32 * 32;
  const size_t smem = 2 * static_cast<size_t>(tile_syms) +
                      (kGlobalLut ? 0 : 3 * static_cast<size_t>(lut_size));
  auto kernel = decode_tiles_kernel<kGlobalLut>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs),
      static_cast<const int*>(offsets), static_cast<const int*>(s0),
      static_cast<const int*>(lut_base), n_subseq, total_bits,
      static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len, tile_syms,
      ss_max, n_out, static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success).  `lut_base` may be
// null (single-codebook decode).  `global_lut` (0 or 1) selects the variant
// that reads the LUT from device memory instead of staging it.
extern "C" int repro_decode_tiles(const void* units, long long n_units,
                                  const void* start_abs, const void* end_abs,
                                  const void* offsets, const void* s0,
                                  const void* lut_base, int n_subseq,
                                  int total_bits, const void* dec_sym,
                                  const void* dec_len, int lut_size,
                                  int max_len, int tile_syms, int ss_max,
                                  long long n_out, int n_tiles,
                                  int global_lut, void* out, void* stream) {
  using namespace repro_torch;
  return global_lut
             ? launch<true>(units, n_units, start_abs, end_abs, offsets, s0,
                            lut_base, n_subseq, total_bits, dec_sym, dec_len,
                            lut_size, max_len, tile_syms, ss_max, n_out,
                            n_tiles, out, stream)
             : launch<false>(units, n_units, start_abs, end_abs, offsets, s0,
                             lut_base, n_subseq, total_bits, dec_sym, dec_len,
                             lut_size, max_len, tile_syms, ss_max, n_out,
                             n_tiles, out, stream);
}
