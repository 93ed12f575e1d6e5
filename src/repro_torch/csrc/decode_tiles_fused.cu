// Fused phase 4 for flat fields: tile decode + dequantize + 1-D inverse
// Lorenzo, with no quant-code array in device memory.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:
// decode_tiles_fused (body decode_tiles_fused_kernel_body ->
// common.stage_tile + _dequant_recon_block; entry
// ops.decode_write_tiles_fused).  One block per output tile of tile_syms
// codes.  The block
//   1. takes its tile index t from the launch's ticket counter;
//   2. decodes the tile's lanes (sized to the tile, as decode_tiles.cu
//      sizes them) through common.cuh's bit-buffer lane decoder into int32
//      residuals d = code - radius in shared memory and scatters the tile's
//      outliers (fused.cuh: stage_unit_residuals);
//   3. scans d in place (the tile's inclusive cumsum) and takes the tile
//      total, its aggregate;
//   4. finds the sum of every earlier tile by decoupled look-back
//      (fused.cuh: lookback_prefix);
//   5. writes out[i] = cast(float(int32(prefix + d[i])) * two_eb).
// On the TPU the carry was one int32 in VMEM scratch across an ordered
// grid; here it is one 64-bit status word per tile ((flag << 32) | value,
// flag 1 = aggregate, 2 = inclusive prefix), zeroed by the wrapper for
// every launch.  The final tile's positions past n_out decode as code 0
// and are never written.
//
// What bounds it on the H100: the byte floor is the payload, 12 B per
// subsequence, the output and 8 B per outlier.  The real limits are the
// decode stage (as in decode_tiles) and the look-back: a tile waits for its
// predecessors' aggregates, which they publish as soon as their own decode
// and scan are done, so the wait is short unless a predecessor has not
// started yet.
#include <cuda_runtime.h>

#include "fused.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(1024) decode_tiles_fused_kernel(
    const uint32_t* __restrict__ units, long long n_units,
    const int* __restrict__ start_abs, const int* __restrict__ end_abs,
    const int* __restrict__ offsets, const int* __restrict__ s0,
    const int* __restrict__ lut_base, int n_subseq, int total_bits,
    const uint16_t* __restrict__ dec_sym, const uint8_t* __restrict__ dec_len,
    int lut_size, int max_len, int tile_syms, int ss_max, long long n_out,
    const int* __restrict__ opos, const int* __restrict__ oval,
    const int* __restrict__ obounds, int radius, float two_eb,
    unsigned* ticket, unsigned long long* status, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* d = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scratch = d + tile_syms;
  uint16_t* s_sym = reinterpret_cast<uint16_t*>(scratch + kFusedScratchWords);
  uint8_t* s_len = reinterpret_cast<uint8_t*>(s_sym + lut_size);

  const int t = take_ticket(ticket, scratch);
  const int n_tiles =
      static_cast<int>((n_out + tile_syms - 1) / tile_syms);
  stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
  stage_unit_residuals(units, n_units, start_abs, end_abs, offsets, s0,
                       lut_base, n_subseq, total_bits, lut_size, max_len,
                       n_tiles, 1, [t](int) { return t; }, tile_syms, ss_max,
                       radius, opos, oval, obounds, s_sym, s_len, d, scratch);
  scan_rows(d, tile_syms, tile_syms, scratch);
  const uint32_t prefix =
      lookback_prefix(t, d[tile_syms - 1], status, scratch);

  const long long base = static_cast<long long>(t) * tile_syms;
  const int n_here =
      static_cast<int>(min(static_cast<long long>(tile_syms), n_out - base));
  write_out(d, prefix, n_here, two_eb, out + base);
}

template <typename T>
int launch(const void* units, long long n_units, const void* start_abs,
           const void* end_abs, const void* offsets, const void* s0,
           const void* lut_base, int n_subseq, int total_bits,
           const void* dec_sym, const void* dec_len, int lut_size,
           int max_len, int tile_syms, int ss_max, long long n_out,
           int n_tiles, const void* opos, const void* oval,
           const void* obounds, int radius, float two_eb, void* ticket,
           void* status, void* out, void* stream) {
  const int threads = fused_threads(ss_max);
  const size_t smem = fused_smem(tile_syms, lut_size);
  auto kernel = decode_tiles_fused_kernel<T>;
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
      ss_max, n_out, static_cast<const int*>(opos),
      static_cast<const int*>(oval), static_cast<const int*>(obounds), radius,
      two_eb, static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(status), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for an
// unknown out_kind (0 float32, 1 bfloat16, 2 float16).  `lut_base` may be
// null.  `ticket` (one uint32) and `status` (n_tiles uint64) must be zero.
extern "C" int repro_decode_tiles_fused(
    const void* units, long long n_units, const void* start_abs,
    const void* end_abs, const void* offsets, const void* s0,
    const void* lut_base, int n_subseq, int total_bits, const void* dec_sym,
    const void* dec_len, int lut_size, int max_len, int tile_syms,
    int ss_max, long long n_out, int n_tiles, const void* opos,
    const void* oval, const void* obounds, int radius, float two_eb,
    void* ticket, void* status, int out_kind, void* out, void* stream) {
  using namespace repro_torch;
#define REPRO_LAUNCH(T)                                                     \
  launch<T>(units, n_units, start_abs, end_abs, offsets, s0, lut_base,     \
            n_subseq, total_bits, dec_sym, dec_len, lut_size, max_len,     \
            tile_syms, ss_max, n_out, n_tiles, opos, oval, obounds, radius, \
            two_eb, ticket, status, out, stream)
  switch (out_kind) {
    case 0: return REPRO_LAUNCH(float);
    case 1: return REPRO_LAUNCH(__nv_bfloat16);
    case 2: return REPRO_LAUNCH(__half);
    default: return -1;
  }
#undef REPRO_LAUNCH
}
