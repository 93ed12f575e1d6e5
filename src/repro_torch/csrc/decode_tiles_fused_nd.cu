// Fused phase 4 for 2-D and 3-D fields: tile decode + dequantize + N-D
// inverse Lorenzo, with no quant-code array in device memory.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:
// decode_tiles_fused_nd (body decode_tiles_fused_nd_kernel_body ->
// common.stage_tile + _dequant_block + _recon_rows_block; entry
// ops.decode_write_tiles_fused, tiles from ops.fused_tile_rows).  The field
// is (planes, rows, cols) (planes = 1 for 2-D); a tile is w whole rows,
// block = w * cols codes, and for 3-D w divides rows, so a tile never
// crosses a plane.  On the TPU the row and plane carries sat in VMEM
// scratch across an ordered grid.  Here a block takes a unit of tiles by
// ticket (fused.cuh: 1 x up to 8 consecutive tiles for 2-D, up to 8 planes
// x one tile for 3-D; the geometry from fused_decode.nd_geometry):
//   1. it stages the LUT, then decodes all the unit's tiles at once, their
//      lanes (sized to each tile, as decode_tiles.cu sizes them) spread
//      over the block's threads, through common.cuh's bit-buffer lane
//      decoder, into int32 residuals d = code - radius in shared memory,
//      and scatters the tiles' outliers (fused.cuh: stage_unit_residuals);
//   2. it scans every row (scan_rows);
//   3. it takes the row carry and, for 3-D, the plane carry by decoupled
//      look-back over a ring of flagged statuses (fused.cuh: nd_carries,
//      which gives the protocol and the ring's reuse argument);
//   4. it writes out[i] = cast(float(int32(q[i])) * two_eb).
//
// What bounds it on the H100: the byte floor is the payload, 12 B per
// subsequence, the output and 8 B per outlier.  The chained carries this
// kernel had (one unit at a time down each chain, at the latency of an L2
// round trip a hop: 0.39 ms on isabel3d, 0.53 on cesm2d) are gone: a unit
// waits for its predecessors' aggregates, or at the look-back's depth cap
// for the prefix of the unit that far back, so a chain's prefix advances
// up to `depth` units a hop.  What is left is the decode stage (as in
// decode_tiles), a unit's latency chain of barriers and L2 round trips
// (publish, find the depth, add, publish; fused.cuh), which the few units
// an SM holds only partly hide, and on a 2-D field the hops of its one
// row chain.
#include <cuda_runtime.h>

#include "fused.cuh"
#include "smem.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(kNdMaxThreads, kNdMinBlocks)
    decode_tiles_fused_nd_kernel(
        const uint32_t* __restrict__ units, long long n_units,
        const int* __restrict__ start_abs, const int* __restrict__ end_abs,
        const int* __restrict__ offsets, const int* __restrict__ s0,
        const int* __restrict__ lut_base, int n_subseq, int total_bits,
        const uint16_t* __restrict__ dec_sym,
        const uint8_t* __restrict__ dec_len, int lut_size, int max_len,
        NdGrid grid, int ss_max, long long n_out, int n_tiles,
        const int* __restrict__ opos, const int* __restrict__ oval,
        const int* __restrict__ obounds, int radius, float two_eb,
        unsigned* ticket, unsigned* done, unsigned* flags, uint32_t* vals,
        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int block = grid.rows_per_tile * grid.cols;
  const int group = grid.unit_planes * grid.unit_tiles;
  uint32_t* d = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scratch = d + static_cast<size_t>(group) * block;
  uint16_t* s_sym = reinterpret_cast<uint16_t*>(scratch + kFusedScratchWords);
  uint8_t* s_len = reinterpret_cast<uint8_t*>(s_sym + lut_size);

  const NdUnit u = nd_unit(take_ticket(ticket, scratch), grid);
  stage_lut(dec_sym, dec_len, lut_size, s_sym, s_len);
  stage_unit_residuals(
      units, n_units, start_abs, end_abs, offsets, s0, lut_base, n_subseq,
      total_bits, lut_size, max_len, n_tiles, u.n_planes * u.n_tiles,
      [&](int x) { return nd_tile(grid, u, x / u.n_tiles, x % u.n_tiles); },
      block, ss_max, radius, opos, oval, obounds, s_sym, s_len, d, scratch);
  scan_rows(d, u.n_planes * u.nrows * grid.cols, grid.cols, scratch);  // e
  nd_carries(d, grid, u, flags, vals, done, scratch);                 // q
  nd_write_out(d, grid, u, n_out, two_eb, out);
}

template <typename T>
int launch(const void* units, long long n_units, const void* start_abs,
           const void* end_abs, const void* offsets, const void* s0,
           const void* lut_base, int n_subseq, int total_bits,
           const void* dec_sym, const void* dec_len, int lut_size,
           int max_len, const NdGrid& grid, int ss_max, long long n_out,
           int n_tiles, const void* opos, const void* oval,
           const void* obounds, int radius, float two_eb, int threads,
           int smem, void* ticket, void* done, void* flags, void* vals,
           void* out, void* stream) {
  auto kernel = decode_tiles_fused_nd_kernel<T>;
  const cudaError_t allowed = allow_dynamic_smem(kernel, smem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<grid.units_p * grid.units_k, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_units,
      static_cast<const int*>(start_abs), static_cast<const int*>(end_abs),
      static_cast<const int*>(offsets), static_cast<const int*>(s0),
      static_cast<const int*>(lut_base), n_subseq, total_bits,
      static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut_size, max_len, grid, ss_max,
      n_out, n_tiles, static_cast<const int*>(opos),
      static_cast<const int*>(oval), static_cast<const int*>(obounds),
      radius, two_eb, static_cast<unsigned*>(ticket),
      static_cast<unsigned*>(done), static_cast<unsigned*>(flags),
      static_cast<uint32_t*>(vals), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches units_p x units_k blocks of `threads` (<= 512)
// threads with `smem` bytes of shared memory on `stream`, allocates
// nothing, does not synchronize; returns cudaGetLastError() (0 on success),
// or -1 for an unknown out_kind (0 float32, 1 bfloat16, 2 float16) or a
// block width and look-back depth the protocol cannot run (nd_launch_ok).
// `lut_base` may be null.  The grid arguments are fused_decode.NdGeometry's.
// `ticket` (one uint32), `done` (slots uint32) and `flags` (2 x slots
// uint32) must be zero; `vals` holds slots x 2 x (row_words + plane_words)
// uint32, any contents.
extern "C" int repro_decode_tiles_fused_nd(
    const void* units, long long n_units, const void* start_abs,
    const void* end_abs, const void* offsets, const void* s0,
    const void* lut_base, int n_subseq, int total_bits, const void* dec_sym,
    const void* dec_len, int lut_size, int max_len, int rows_per_tile,
    int cols, int planes, int tiles_per_plane, int unit_planes,
    int unit_tiles, int units_p, int units_k, int slots, int depth,
    int row_words, int plane_words, int ss_max, long long n_out, int n_tiles,
    const void* opos, const void* oval, const void* obounds, int radius,
    float two_eb, int threads, int smem, void* ticket, void* done,
    void* flags, void* vals, int out_kind, void* out, void* stream) {
  using namespace repro_torch;
  const NdGrid grid{rows_per_tile, cols,        planes,    tiles_per_plane,
                    unit_planes,   unit_tiles,  units_p,   units_k,
                    slots,         depth,       row_words, plane_words};
  if (!nd_launch_ok(grid, threads)) return -1;
#define REPRO_LAUNCH(T)                                                      \
  launch<T>(units, n_units, start_abs, end_abs, offsets, s0, lut_base,      \
            n_subseq, total_bits, dec_sym, dec_len, lut_size, max_len, grid, \
            ss_max, n_out, n_tiles, opos, oval, obounds, radius, two_eb,    \
            threads, smem, ticket, done, flags, vals, out, stream)
  switch (out_kind) {
    case 0: return REPRO_LAUNCH(float);
    case 1: return REPRO_LAUNCH(__nv_bfloat16);
    case 2: return REPRO_LAUNCH(__half);
    default: return -1;
  }
#undef REPRO_LAUNCH
}
