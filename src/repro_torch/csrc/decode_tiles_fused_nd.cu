// Fused phase 4 for 2-D and 3-D fields: tile decode + dequantize + N-D
// inverse Lorenzo, with no quant-code array in device memory.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:
// decode_tiles_fused_nd (body decode_tiles_fused_nd_kernel_body ->
// common.stage_tile + _dequant_block + _recon_rows_block; entry
// ops.decode_write_tiles_fused, tiles from ops.fused_tile_rows).  The field
// is (planes, rows, cols) (planes = 1 for 2-D); a tile is w whole rows,
// block = w * cols codes, and for 3-D w divides rows, so a tile never
// crosses a plane.  The inverse Lorenzo is the cumsum along every axis:
//   e = cumsum of d along each row        (inside the tile)
//   f = row carry + cumsum of e down rows (row carry: f of the plane's
//                                          previous row, 0 at a plane start)
//   q = plane carry + f                   (3-D; plane carry: q of the same
//                                          rows in the previous plane)
// On the TPU both carries sat in VMEM scratch across an ordered grid.  Here
// a block takes a unit of `group` consecutive tiles (one tile for 3-D),
// decodes them one by one into shared memory, and hands the carries on
// through global memory as tagged words (fused.cuh: nd_carries, which
// describes the row-carry chains, the ring, the plane carry and the
// diagonal ticket order).
//
// What bounds it on the H100: the byte floor is the payload, 12 B per
// subsequence, the output and 8 B per outlier.  The real limit is the
// chained row carry: one unit at a time passes each chain, at the latency
// of a store and a load through L2.  A 2-D field is one chain, which the
// groups of tiles shorten `group` times (up to 8, as many whole tiles as
// shared memory holds); a 3-D field has one chain per plane, and the
// diagonal order runs them side by side.  A decoupled look-back on the
// (cols,) vectors would cut the chain further, at the cost of an aggregate
// vector per unit in flight.
#include <cuda_runtime.h>

#include "fused.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(1024) decode_tiles_fused_nd_kernel(
    const uint32_t* __restrict__ units, long long n_units,
    const int* __restrict__ start_abs, const int* __restrict__ end_abs,
    const int* __restrict__ offsets, const int* __restrict__ s0,
    const int* __restrict__ lut_base, int n_subseq, int total_bits,
    const uint16_t* __restrict__ dec_sym, const uint8_t* __restrict__ dec_len,
    int lut_size, int max_len, int rows_per_tile, int cols, int planes,
    int units_per_plane, int group, int slots, int ss_max, long long n_out,
    int n_tiles, const int* __restrict__ opos, const int* __restrict__ oval,
    const int* __restrict__ obounds, int radius, float two_eb,
    unsigned* ticket, unsigned long long* row_carry,
    unsigned long long* plane_carry, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int block = rows_per_tile * cols;
  uint32_t* d = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scratch = d + static_cast<size_t>(group) * block;
  uint16_t* s_sym = reinterpret_cast<uint16_t*>(scratch + kFusedScratchWords);
  uint8_t* s_len = reinterpret_cast<uint8_t*>(s_sym + lut_size);

  int p, k;
  diagonal_unit(take_ticket(ticket, scratch), planes, units_per_plane, &p,
                &k);
  const int first = (p * units_per_plane + k) * group;
  const int n_here_tiles = min(group, n_tiles - first);
  const int n = n_here_tiles * block;
  stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
  for (int i = 0; i < n_here_tiles; ++i) {
    stage_residuals(units, n_units, start_abs, end_abs, offsets, s0,
                    lut_base, n_subseq, total_bits, lut_size, max_len,
                    first + i, block, ss_max, radius, opos, oval, obounds,
                    s_sym, s_len, d + static_cast<size_t>(i) * block);
  }
  scan_rows(d, n, cols, scratch);              // e, in place
  nd_carries(d, n, cols, block, p, k, units_per_plane, planes, slots,
             row_carry, plane_carry);        // q, in place

  const long long base = static_cast<long long>(first) * block;
  const int n_write =
      static_cast<int>(min(static_cast<long long>(n), n_out - base));
  write_out(d, 0u, n_write, two_eb, out + base);
}

template <typename T>
int launch(const void* units, long long n_units, const void* start_abs,
           const void* end_abs, const void* offsets, const void* s0,
           const void* lut_base, int n_subseq, int total_bits,
           const void* dec_sym, const void* dec_len, int lut_size,
           int max_len, int rows_per_tile, int cols, int planes,
           int units_per_plane, int group, int slots, int ss_max,
           long long n_out, int n_tiles, const void* opos, const void* oval,
           const void* obounds, int radius, float two_eb, void* ticket,
           void* row_carry, void* plane_carry, void* out, void* stream) {
  const int threads = nd_threads(cols, fused_threads(ss_max));
  const size_t smem = fused_smem(
      static_cast<long long>(group) * rows_per_tile * cols, lut_size);
  auto kernel = decode_tiles_fused_nd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<planes * units_per_plane, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs),
      static_cast<const int*>(offsets), static_cast<const int*>(s0),
      static_cast<const int*>(lut_base), n_subseq, total_bits,
      static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len, rows_per_tile,
      cols, planes, units_per_plane, group, slots, ss_max, n_out, n_tiles,
      static_cast<const int*>(opos), static_cast<const int*>(oval),
      static_cast<const int*>(obounds), radius, two_eb,
      static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(row_carry),
      static_cast<unsigned long long*>(plane_carry), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for an
// unknown out_kind (0 float32, 1 bfloat16, 2 float16).  `lut_base` may be
// null.  A block takes `group` tiles (1 for 3-D); there are planes x
// units_per_plane blocks.  `plane_carry` is null for a 2-D field (planes =
// 1).  `ticket` (one uint32), `row_carry` (slots x cols uint64) and
// `plane_carry` (rows x cols uint64) must be zero.
extern "C" int repro_decode_tiles_fused_nd(
    const void* units, long long n_units, const void* start_abs,
    const void* end_abs, const void* offsets, const void* s0,
    const void* lut_base, int n_subseq, int total_bits, const void* dec_sym,
    const void* dec_len, int lut_size, int max_len, int rows_per_tile,
    int cols, int planes, int units_per_plane, int group, int slots,
    int ss_max, long long n_out, int n_tiles, const void* opos,
    const void* oval, const void* obounds, int radius, float two_eb,
    void* ticket, void* row_carry, void* plane_carry, int out_kind, void* out,
    void* stream) {
  using namespace repro_torch;
#define REPRO_LAUNCH(T)                                                      \
  launch<T>(units, n_units, start_abs, end_abs, offsets, s0, lut_base,      \
            n_subseq, total_bits, dec_sym, dec_len, lut_size, max_len,      \
            rows_per_tile, cols, planes, units_per_plane, group, slots,     \
            ss_max, n_out, n_tiles, opos, oval, obounds, radius, two_eb,    \
            ticket, row_carry, plane_carry, out, stream)
  switch (out_kind) {
    case 0: return REPRO_LAUNCH(float);
    case 1: return REPRO_LAUNCH(__nv_bfloat16);
    case 2: return REPRO_LAUNCH(__half);
    default: return -1;
  }
#undef REPRO_LAUNCH
}
