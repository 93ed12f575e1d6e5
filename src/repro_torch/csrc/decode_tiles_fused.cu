// Fused phase 4 for flat fields: tile decode + dequantize + 1-D inverse
// Lorenzo, with no quant-code array in device memory.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:
// decode_tiles_fused (body decode_tiles_fused_kernel_body ->
// common.stage_tile + _dequant_recon_block; entry
// ops.decode_write_tiles_fused).  On the TPU the carry was one int32 in
// VMEM scratch across an ordered grid.  Here the grid is persistent:
// blocks of kFusedMaxThreads threads, at most the blocks the card holds at
// once (the geometry,
// fused_decode.fused_geometry, sizes it with huffman_decode.resident_blocks
// for this kernel's block width, shared memory and register bound).  Each
// block stages the LUT once, then loops, two units in flight:
//   1. it takes a ticket, the next unit u of k consecutive tiles t = u * k
//      .. u * k + k - 1 of tile_syms codes (k = unit_tiles, sized so that
//      the unit's lanes, about k x the mean lanes a tile, fill the block);
//   2. it decodes the unit's lanes (sized to each tile, as decode_tiles.cu
//      sizes them) through common.cuh's bit-buffer lane decoder into uint16
//      codes in one of its two stages in shared memory (fused.cuh:
//      stage_unit_residuals); the residuals are read from the codes, d =
//      code - radius, and the unit's slice of the outlier side list
//      replaces them at its places: in the chunk totals of step 3 each
//      outlier adds its difference, and in the write of step 4 each warp
//      walks the slice in step with its rows (fused.cuh: UnitResiduals);
//   3. it sums each warp's chunk of d, takes the unit's aggregate and
//      publishes it (fused.cuh: unit_chunk_totals, unit_chunk_offsets,
//      publish_aggregate);
//   4. then, for the unit it decoded before this one, warp 0 finds the sum
//      of every earlier unit by a decoupled look-back over a window of 32
//      statuses, one a lane (fused.cuh: unit_lookback), and the block
//      writes out[i] = cast(float(int32(prefix + cumsum(d)[i])) * two_eb),
//      4 values a lane, a 16-byte (8-byte for bf16 and f16) store where the
//      unit's first output allows (fused.cuh: write_unit).
// Step 4 comes a whole decode after the unit's own aggregate: by then its
// predecessors have published theirs, so the look-back rarely waits, and
// one block's writes overlap other blocks' decodes.  The carry is one
// 64-bit status word a unit ((flag << 32) | value, flag 1 = aggregate, 2 =
// inclusive prefix), zeroed by the wrapper for every launch.  A unit's
// aggregate is published before its block waits for anything, and a
// look-back waits only for units of lower tickets, which running blocks
// decode (fused.cuh, "Work order"): every wait ends.  The final tile's
// positions past n_out decode as code 0 and are never written.
//
// What bounds it on the H100: the byte floor is the payload, 12 B per
// subsequence, the output and 8 B per outlier (0.0227 ms on hacc1d).  The
// real limit is the decode stage, as in decode_tiles: the rate at which the
// SMs issue the bit-serial lane loop (about decode_tiles' whole time on
// the same stream), then the output's writes, which a wave of blocks
// issues after its decodes.  The kernel this replaced ran one block of 256
// threads a tile (4,096 blocks on hacc1d), ~80 of them decoding, staged
// the LUT for every tile, scanned with 16 lanes on a bank, and walked the
// look-back one predecessor a round trip; a tile's decode, wait and write
// ran one after another.
#include <cuda_runtime.h>

#include "fused.cuh"

namespace repro_torch {

// The block width and the blocks an SM holds at it, which bound the
// registers to 40 (fused_decode.FUSED_MAX_THREADS, FUSED_REGS).
constexpr int kFusedMaxThreads = 512;
constexpr int kFusedMinBlocks = 3;

// The residuals of unit u's staged codes, with its outlier slice [lo, hi).
__device__ __forceinline__ UnitResiduals unit_view(
    const uint16_t* codes, int u, int unit_tiles, int tile_syms,
    const int* __restrict__ opos, const int* __restrict__ oval, uint32_t lo,
    uint32_t hi, int radius) {
  return UnitResiduals{codes, opos, oval,
                       static_cast<long long>(u) * unit_tiles * tile_syms,
                       static_cast<int>(lo), static_cast<int>(hi), radius};
}

template <typename T>
__global__ void __launch_bounds__(kFusedMaxThreads, kFusedMinBlocks)
    decode_tiles_fused_kernel(
        const uint32_t* __restrict__ units, long long n_units,
        const int* __restrict__ start_abs, const int* __restrict__ end_abs,
        const int* __restrict__ offsets, const int* __restrict__ s0,
        const int* __restrict__ lut_base, int n_subseq, int total_bits,
        const uint16_t* __restrict__ dec_sym,
        const uint8_t* __restrict__ dec_len, int lut_size, int max_len,
        int tile_syms, int ss_max, long long n_out, int n_tiles,
        int unit_tiles, int window, const int* __restrict__ opos,
        const int* __restrict__ oval, const int* __restrict__ obounds,
        int radius, float two_eb, unsigned* ticket,
        unsigned long long* status, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Shared memory (fused_decode.fused_unit_smem): two stages of a unit's
  // uint16 codes, each to a 16-byte boundary, the scratch words, two unit
  // slots, the LUT.
  const size_t stage_bytes =
      (2 * static_cast<size_t>(unit_tiles) * tile_syms + 15) / 16 * 16;
  auto stage = [&](int i) {
    return reinterpret_cast<uint16_t*>(smem + i * stage_bytes);
  };
  uint32_t* scratch = reinterpret_cast<uint32_t*>(smem + 2 * stage_bytes);
  auto slot = [&](int i) {
    return scratch + kFusedScratchWords + i * kSlotWords;
  };
  uint16_t* s_sym =
      reinterpret_cast<uint16_t*>(scratch + kFusedScratchWords +
                                  2 * kSlotWords);
  uint8_t* s_len = reinterpret_cast<uint8_t*>(s_sym + lut_size);
  stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
  const int n_work = (n_tiles + unit_tiles - 1) / unit_tiles;
  auto unit_codes = [&](int u) {
    return min(unit_tiles, n_tiles - u * unit_tiles) * tile_syms;
  };
  // Unit `prev`, if any, waits in stage(1 - s) for its look-back and write
  // while unit u is decoded into stage(s).
  int prev = -1, s = 0;
  while (true) {
    const int u = take_ticket(ticket, scratch);
    if (u < n_work) {
      const int t0 = u * unit_tiles;
      const int n_here = min(unit_tiles, n_tiles - t0);
      stage_unit_residuals(units, n_units, start_abs, end_abs, offsets, s0,
                           lut_base, n_subseq, total_bits, lut_size, max_len,
                           n_tiles, n_here, [t0](int i) { return t0 + i; },
                           tile_syms, ss_max, radius, opos, oval, obounds,
                           s_sym, s_len, stage(s), scratch);
      const uint32_t lo = scratch[kBoundWords];
      const uint32_t hi = scratch[kBoundWords + 8 + n_here - 1];
      if (threadIdx.x == 0) {
        slot(s)[kSlotLo] = lo;
        slot(s)[kSlotHi] = hi;
      }
      const int n = unit_codes(u);
      unit_chunk_totals(unit_view(stage(s), u, unit_tiles, tile_syms, opos,
                                  oval, lo, hi, radius),
                        n, unit_chunk(n), scratch);
      if (threadIdx.x < 32) {
        const uint32_t aggregate = unit_chunk_offsets(scratch, slot(s));
        publish_aggregate(u, aggregate, status);
        if (threadIdx.x == 0) slot(s)[kSlotAggregate] = aggregate;
      }
    }
    if (prev >= 0) {
      const uint32_t* ps = slot(1 - s);
      if (threadIdx.x < 32) {
        const uint32_t prefix =
            unit_lookback(prev, ps[kSlotAggregate], window, status);
        if (threadIdx.x == 0) scratch[kCarryWord] = prefix;
      }
      __syncthreads();
      const long long base =
          static_cast<long long>(prev) * unit_tiles * tile_syms;
      const int n = unit_codes(prev);
      const int n_valid =
          static_cast<int>(min(static_cast<long long>(n), n_out - base));
      write_unit(unit_view(stage(1 - s), prev, unit_tiles, tile_syms, opos,
                           oval, ps[kSlotLo], ps[kSlotHi], radius),
                 n, unit_chunk(n), scratch[kCarryWord], n_valid, two_eb, ps,
                 out + base);
    }
    __syncthreads();   // the stages, slots and scratch serve the next unit
    if (u >= n_work) break;
    prev = u;
    s ^= 1;
  }
}

template <typename T>
int launch(const void* units, long long n_units, const void* start_abs,
           const void* end_abs, const void* offsets, const void* s0,
           const void* lut_base, int n_subseq, int total_bits,
           const void* dec_sym, const void* dec_len, int lut_size,
           int max_len, int tile_syms, int ss_max, long long n_out,
           int n_tiles, int unit_tiles, int window, int blocks, int smem, const void* opos, const void* oval, const void* obounds,
           int radius, float two_eb, void* ticket, void* status, void* out,
           void* stream) {
  auto kernel = decode_tiles_fused_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kFusedMaxThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs),
      static_cast<const int*>(offsets), static_cast<const int*>(s0),
      static_cast<const int*>(lut_base), n_subseq, total_bits,
      static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len, tile_syms,
      ss_max, n_out, n_tiles, unit_tiles, window,
      static_cast<const int*>(opos), static_cast<const int*>(oval),
      static_cast<const int*>(obounds), radius, two_eb,
      static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(status), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches `blocks` blocks of kFusedMaxThreads threads with
// `smem` bytes of shared memory on `stream` (fused_decode.fused_geometry),
// allocates nothing, does not synchronize; returns cudaGetLastError() (0
// on success), or -1 for an unknown out_kind (0 float32, 1 bfloat16, 2
// float16) or a geometry the kernel cannot run: unit_tiles outside 1-8
// (stage_unit_residuals' slots), a look-back window outside 1-32 (a warp's
// lanes), or smem short of the unit's tiles, the scratch words and the
// LUT.  The wrapper's window is always 32; a card test passes narrower
// ones, which make the look-back slide.  `lut_base` may be null.
// `ticket` (one uint32) and `status` (one uint64 a unit of unit_tiles
// tiles) must be zero.
extern "C" int repro_decode_tiles_fused(
    const void* units, long long n_units, const void* start_abs,
    const void* end_abs, const void* offsets, const void* s0,
    const void* lut_base, int n_subseq, int total_bits, const void* dec_sym,
    const void* dec_len, int lut_size, int max_len, int tile_syms,
    int ss_max, long long n_out, int n_tiles, int unit_tiles, int window,
    int blocks, int smem, const void* opos, const void* oval,
    const void* obounds, int radius, float two_eb, void* ticket,
    void* status, int out_kind, void* out, void* stream) {
  using namespace repro_torch;
  if (unit_tiles < 1 || unit_tiles > 8 || window < 1 || window > 32 ||
      blocks < 1 ||
      static_cast<size_t>(smem) < fused_unit_smem(
          static_cast<long long>(unit_tiles) * tile_syms, lut_size))
    return -1;
#define REPRO_LAUNCH(T)                                                     \
  launch<T>(units, n_units, start_abs, end_abs, offsets, s0, lut_base,     \
            n_subseq, total_bits, dec_sym, dec_len, lut_size, max_len,     \
            tile_syms, ss_max, n_out, n_tiles, unit_tiles, window, blocks, \
            smem, opos, oval, obounds, radius, two_eb, ticket, status, out, \
            stream)
  switch (out_kind) {
    case 0: return REPRO_LAUNCH(float);
    case 1: return REPRO_LAUNCH(__nv_bfloat16);
    case 2: return REPRO_LAUNCH(__half);
    default: return -1;
  }
#undef REPRO_LAUNCH
}
