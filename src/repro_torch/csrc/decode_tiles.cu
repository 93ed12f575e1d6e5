// Phase 4 of the decoder (paper Alg. 1): tile-staged decode and write.
//
// Replaces the TPU kernel src/repro/kernels/huffman_decode.py:decode_tiles
// (body decode_tiles_kernel_body -> common.stage_tile; lane metadata in
// ops._tile_inputs).  Output tile t holds codes [t * tile_syms, (t + 1) *
// tile_syms).  A block decodes a tile's subsequences into a zeroed u16
// tile in shared memory, then writes the tile to device memory densely and
// coalesced: the paper's shared-memory staged write.
//
// What bounds it on the H100: the byte floor is the payload plus 12 B read
// per subsequence plus 2 B written per code (66 MB, 0.0197 ms on
// isabel3d).  The real limit is the rate at which the SMs issue the
// bit-serial decode loop, the same loop as count_subseq's (~25 M codewords
// on isabel3d), plus the staging and the write.  The design:
//   * The lanes decode through common.cuh's bit-buffer lane decoder
//     (decode_lane_buf), in a tile stage of this kernel's own (the fused
//     kernels have theirs in fused.cuh).
//   * Lanes are sized to the tile, not to the static budget ss_max
//     (pipeline.ss_max_for_tile: 411 at 4,096 codes and max_len 12).  The
//     subsequences whose output can fall in tile t are s0[t] .. s0[t + 1]
//     (.. n_subseq - 1 for the last tile): offsets are an exclusive prefix
//     sum of counts, so a later subsequence's output starts past the tile.
//     The span is capped at ss_max, the lanes the reference has (it drops
//     the rest), and the block's threads loop over it.  At isabel3d's 2.955
//     bits a code a 4,096-code tile spans ~97 subsequences, of which the
//     old one-thread-a-lane block of 416 threads left ~3 warps in 13 busy.
//     huffman_decode.decode_tiles_geometry sizes the block to the mean span
//     rounded up to a warp (128 threads there), so most threads decode.
//   * The LUT is staged once a block, 16 bytes a load, and the block loops
//     over tiles t = blockIdx.x, blockIdx.x + gridDim.x, ...: at most as
//     many blocks as the SMs hold resident, each taking the same number of
//     tiles.  The old kernel staged 12 KB of LUT for every tile (75 MB of
//     L2 reads on isabel3d's 6,104 tiles).  A tile is decoded between two
//     barriers; then each thread writes its 16-byte chunks of the staging
//     tile to device memory and zeroes them behind it for the next tile.
//   * Exits, as in common.stage_tile: a lane past the last subsequence does
//     no work; a lane whose output starts past the tile leaves at once; a
//     lane stops as soon as its next symbol would land past the tile end;
//     the k-th symbol goes to slot min(k, 127).  Each drops only writes the
//     reference drops, so the output is the reference's bit for bit.
//
// LUT placement.  The batched decode (pipeline.decode_batch) hands the
// kernel one LUT merged from every tensor's codebook at a common max_len:
// 3 B x 2^max_len per tensor, 12 KB at max_len 12, so past ~17 tensors the
// LUT and a class tile no longer fit 227 KB of shared memory.  A second
// variant of the kernel (kGlobalLut) stages only the tile and reads the LUT
// from device memory through the read-only path; the wrapper picks it by
// size (huffman_decode.decode_tiles_lut_in_smem), before the launch.  A
// lane reads only its own tensor's slice of the merged table, so the slices
// a block touches are few and stay in L1/L2.  The loop over tiles serves
// that variant too.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

// Threads a block at most, and resident blocks an SM at that width:
// __launch_bounds__ holds the kernel to 40 registers, as
// huffman_decode.decode_tiles_geometry assumes.
constexpr int kTileMaxThreads = 256;
constexpr int kTileMinBlocks = 6;

__device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

// Decode output tile `tile` into the zeroed staging tile `stage`.
template <bool kGlobalLut>
__device__ __forceinline__ void decode_tile(
    const uint32_t* __restrict__ units, long long n_units,
    const int* __restrict__ start_abs, const int* __restrict__ end_abs,
    const int* __restrict__ offsets, const int* __restrict__ s0,
    const int* __restrict__ lut_base, int n_subseq, int total_bits,
    const uint16_t* sym, const uint8_t* len, int lut_size, int max_len,
    int tile, int n_tiles, int tile_syms, int ss_max, uint16_t* stage) {
  const long long tile_base = static_cast<long long>(tile) * tile_syms;
  const int first = s0[tile];
  const int last = tile + 1 < n_tiles ? s0[tile + 1] : n_subseq - 1;
  const int span = min(max(last - first + 1, 0), ss_max);
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const int s = first + j;
    if (s >= n_subseq) continue;             // clipped lane: no work
    const long long off_ll = offsets[s] - tile_base;
    if (off_ll >= tile_syms) continue;       // output starts past the tile
    const int off = static_cast<int>(max(off_ll, -2LL * kMaxSyms));
    int row_id, start, end;
    subseq_window(start_abs[s], end_abs[s], total_bits, &row_id, &start,
                  &end);
    uint32_t row[kRowUnits];
    load_row(units, n_units, row_id, row);
    const int lb = lut_base != nullptr ? lut_base[s] : 0;
    int land;
    decode_lane_buf<kGlobalLut>(row, start, end, sym, len, lut_size, lb,
                                max_len, &land, [&](int k, int code) {
                                  const int local =
                                      off + min(k, kMaxSyms - 1);
                                  if (local >= tile_syms) return false;
                                  if (local >= 0)
                                    stage[local] =
                                        static_cast<uint16_t>(code);
                                  return true;
                                });
  }
}

template <bool kGlobalLut>
__global__ void __launch_bounds__(kTileMaxThreads, kTileMinBlocks)
    decode_tiles_kernel(const uint32_t* __restrict__ units,
                        long long n_units, const int* __restrict__ start_abs,
                        const int* __restrict__ end_abs,
                        const int* __restrict__ offsets,
                        const int* __restrict__ s0,
                        const int* __restrict__ lut_base, int n_subseq,
                        int total_bits, const uint16_t* __restrict__ dec_sym,
                        const uint8_t* __restrict__ dec_len, int lut_size,
                        int max_len, int tile_syms, int ss_max,
                        long long n_out, int n_tiles,
                        uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Shared memory: the staging tile, then the LUT's symbols and lengths,
  // each from a 16-byte boundary (huffman_decode.decode_tiles_smem).
  const int stage_bytes16 = round16(2 * tile_syms);
  uint16_t* stage = reinterpret_cast<uint16_t*>(smem);
  uint4* stage16 = reinterpret_cast<uint4*>(smem);
  const int chunks = stage_bytes16 / 16;
  const uint16_t* sym = dec_sym;
  const uint8_t* len = dec_len;
  if constexpr (!kGlobalLut) {
    uint16_t* s_sym = reinterpret_cast<uint16_t*>(smem + stage_bytes16);
    uint8_t* s_len = smem + stage_bytes16 + round16(2 * lut_size);
    stage_bytes(s_sym, dec_sym, 2 * lut_size);
    stage_bytes(s_len, dec_len, lut_size);
    sym = s_sym;
    len = s_len;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) stage16[i] = zero;
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    decode_tile<kGlobalLut>(units, n_units, start_abs, end_abs, offsets, s0,
                            lut_base, n_subseq, total_bits, sym, len,
                            lut_size, max_len, tile, n_tiles, tile_syms,
                            ss_max, stage);
    __syncthreads();
    // Write the tile's codes densely and zero the staging tile behind them;
    // each thread reads and zeroes only its own chunks or codes.
    const long long base = static_cast<long long>(tile) * tile_syms;
    const int n_here = static_cast<int>(
        min(static_cast<long long>(tile_syms), n_out - base));
    uint16_t* dst = out + base;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      uint4* dst16 = reinterpret_cast<uint4*>(dst);
      for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
        const uint4 v = stage16[i];
        if (8 * i + 8 <= n_here) {
          dst16[i] = v;
        } else if (8 * i < n_here) {
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (8 * i + e < n_here)
              dst[8 * i + e] = static_cast<uint16_t>(w[e >> 1] >> (16 * (e & 1)));
          }
        }
        stage16[i] = zero;
      }
    } else {
      for (int i = threadIdx.x; i < tile_syms; i += blockDim.x) {
        if (i < n_here) dst[i] = stage[i];
        stage[i] = 0;
      }
    }
    __syncthreads();
  }
}

template <bool kGlobalLut>
int launch(const void* units, long long n_units, const void* start_abs,
           const void* end_abs, const void* offsets, const void* s0,
           const void* lut_base, int n_subseq, int total_bits,
           const void* dec_sym, const void* dec_len, int lut_size,
           int max_len, int tile_syms, int ss_max, long long n_out,
           int n_tiles, int blocks, int threads, int smem, void* out,
           void* stream) {
  auto kernel = decode_tiles_kernel<kGlobalLut>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs),
      static_cast<const int*>(offsets), static_cast<const int*>(s0),
      static_cast<const int*>(lut_base), n_subseq, total_bits,
      static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len, tile_syms,
      ss_max, n_out, n_tiles, static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches `blocks` blocks of `threads` (<= 256) threads
// with `smem` bytes of shared memory on `stream`, allocates nothing, does
// not synchronize; returns cudaGetLastError() (0 on success).  `lut_base`
// may be null (single-codebook decode).  `global_lut` (0 or 1) selects the
// variant that reads the LUT from device memory instead of staging it.
extern "C" int repro_decode_tiles(const void* units, long long n_units,
                                  const void* start_abs, const void* end_abs,
                                  const void* offsets, const void* s0,
                                  const void* lut_base, int n_subseq,
                                  int total_bits, const void* dec_sym,
                                  const void* dec_len, int lut_size,
                                  int max_len, int tile_syms, int ss_max,
                                  long long n_out, int n_tiles,
                                  int global_lut, int blocks, int threads,
                                  int smem, void* out, void* stream) {
  using namespace repro_torch;
  return global_lut
             ? launch<true>(units, n_units, start_abs, end_abs, offsets, s0,
                            lut_base, n_subseq, total_bits, dec_sym, dec_len,
                            lut_size, max_len, tile_syms, ss_max, n_out,
                            n_tiles, blocks, threads, smem, out, stream)
             : launch<false>(units, n_units, start_abs, end_abs, offsets, s0,
                             lut_base, n_subseq, total_bits, dec_sym, dec_len,
                             lut_size, max_len, tile_syms, ss_max, n_out,
                             n_tiles, blocks, threads, smem, out, stream);
}
