// The fused epilogue alone for 2-D and 3-D fields: dequantize + N-D
// inverse Lorenzo over a uint16 code array, the padded decoder's fused
// form.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:
// dequant_reconstruct_nd (body dequant_recon_nd_kernel_body ->
// _dequant_block + _recon_rows_block; entry ops.decode_padded_fused, tiles
// of ops.fused_tile_rows(shape, 4096) whole rows).  It is
// decode_tiles_fused_nd.cu with the decode stage replaced by a coalesced
// read of the codes (fused.cuh: load_unit_residuals): a block takes a unit of
// tiles by ticket (1 x up to 8 consecutive tiles for 2-D, up to 8 planes x
// one tile for 3-D; fused_decode.nd_geometry), scans each row in shared
// memory, and takes the row carry and, for 3-D, the plane carry by
// decoupled look-back over a ring of flagged statuses in global memory
// (fused.cuh: nd_carries, which gives the protocol and the ring's reuse
// argument).  On the TPU both carries sat in VMEM scratch across an ordered
// grid.
//
// What bounds it on the H100: the byte floor is 2 B read per code, the
// output, and 8 B per outlier.  The chained row carry that bounded this
// kernel (one unit at a time down each chain: 0.37 ms on isabel3d, 0.54 on
// cesm2d, for ~0.05 of bytes) is gone: a chain's prefix advances up to
// `depth` units a hop (fused.cuh).  What is left is a unit's latency chain
// of barriers and L2 round trips, which the few units an SM holds only
// partly hide, and on a 2-D field the hops of its one row chain.  The
// block holds no LUT, so a one-row tile may be wider than the fused
// decode's (compressor.FUSED_PADDED_MAX_COLS).
#include <cuda_runtime.h>

#include "fused.cuh"
#include "smem.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(kNdMaxThreads, kNdMinBlocks)
    dequant_reconstruct_nd_kernel(
        const uint16_t* __restrict__ codes, NdGrid grid, long long n_out,
        const int* __restrict__ opos, const int* __restrict__ oval,
        const int* __restrict__ obounds, int radius, float two_eb,
        unsigned* ticket, unsigned* done, unsigned* flags, uint32_t* vals,
        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int block = grid.rows_per_tile * grid.cols;
  const int group = grid.unit_planes * grid.unit_tiles;
  uint32_t* d = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scratch = d + static_cast<size_t>(group) * block;

  const NdUnit u = nd_unit(take_ticket(ticket, scratch), grid);
  load_unit_residuals(
      codes, u.n_planes * u.n_tiles,
      [&](int x) { return nd_tile(grid, u, x / u.n_tiles, x % u.n_tiles); },
      block, radius, opos, oval, obounds, d, scratch);
  scan_rows(d, u.n_planes * u.nrows * grid.cols, grid.cols, scratch);  // e
  nd_carries(d, grid, u, flags, vals, done, scratch);                 // q
  nd_write_out(d, grid, u, n_out, two_eb, out);
}

template <typename T>
int launch(const void* codes, const NdGrid& grid, long long n_out,
           const void* opos, const void* oval, const void* obounds,
           int radius, float two_eb, int threads, int smem, void* ticket,
           void* done, void* flags, void* vals, void* out, void* stream) {
  auto kernel = dequant_reconstruct_nd_kernel<T>;
  const cudaError_t allowed = allow_dynamic_smem(kernel, smem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<grid.units_p * grid.units_k, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(codes), grid, n_out,
      static_cast<const int*>(opos), static_cast<const int*>(oval),
      static_cast<const int*>(obounds), radius, two_eb,
      static_cast<unsigned*>(ticket), static_cast<unsigned*>(done),
      static_cast<unsigned*>(flags), static_cast<uint32_t*>(vals),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches units_p x units_k blocks of `threads` (<= 512)
// threads with `smem` bytes of shared memory on `stream`, allocates
// nothing, does not synchronize; returns cudaGetLastError() (0 on success),
// or -1 for an unknown out_kind (0 float32, 1 bfloat16, 2 float16) or a
// block width and look-back depth the protocol cannot run (nd_launch_ok).
// `codes` holds n_tiles * rows_per_tile * cols codes, `out` n_out values.
// The grid arguments are fused_decode.NdGeometry's.  `ticket` (one
// uint32), `done` (slots uint32) and `flags` (2 x slots uint32) must be
// zero; `vals` holds slots x 2 x (row_words + plane_words) uint32, any
// contents.
extern "C" int repro_dequant_reconstruct_nd(
    const void* codes, int rows_per_tile, int cols, int planes,
    int tiles_per_plane, int unit_planes, int unit_tiles, int units_p,
    int units_k, int slots, int depth, int row_words, int plane_words,
    long long n_out, const void* opos, const void* oval, const void* obounds,
    int radius, float two_eb, int threads, int smem, void* ticket,
    void* done, void* flags, void* vals, int out_kind, void* out,
    void* stream) {
  using namespace repro_torch;
  const NdGrid grid{rows_per_tile, cols,        planes,    tiles_per_plane,
                    unit_planes,   unit_tiles,  units_p,   units_k,
                    slots,         depth,       row_words, plane_words};
  if (!nd_launch_ok(grid, threads)) return -1;
#define REPRO_LAUNCH(T)                                                     \
  launch<T>(codes, grid, n_out, opos, oval, obounds, radius, two_eb,       \
            threads, smem, ticket, done, flags, vals, out, stream)
  switch (out_kind) {
    case 0: return REPRO_LAUNCH(float);
    case 1: return REPRO_LAUNCH(__nv_bfloat16);
    case 2: return REPRO_LAUNCH(__half);
    default: return -1;
  }
#undef REPRO_LAUNCH
}
