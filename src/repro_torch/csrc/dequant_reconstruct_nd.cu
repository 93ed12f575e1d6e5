// The fused epilogue alone for 2-D and 3-D fields: dequantize + N-D
// inverse Lorenzo over a uint16 code array, the padded decoder's fused
// form.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:
// dequant_reconstruct_nd (body dequant_recon_nd_kernel_body ->
// _dequant_block + _recon_rows_block; entry ops.decode_padded_fused, tiles
// of ops.fused_tile_rows(shape, 4096) whole rows).  It is
// decode_tiles_fused_nd.cu with the decode stage replaced by a coalesced
// read of the codes (fused.cuh: load_residuals): a block takes a unit of
// `group` consecutive tiles (for 2-D as many as shared memory holds, up to
// 8; one tile for 3-D) by ticket, in anti-diagonal order, scans each row
// in shared memory, and takes the row carry and, for 3-D, the plane carry
// from the units before it as tagged words in global memory (fused.cuh:
// nd_carries, which describes the design).  On the TPU both carries sat in
// VMEM scratch across an ordered grid.
//
// What bounds it on the H100: the byte floor is 2 B read per code, the
// output, and 8 B per outlier.  As in decode_tiles_fused_nd, the chained
// row carry is the real limit: one unit at a time passes each chain, at
// the latency of a store and a load through L2.  A 2-D field is one chain
// (cesm2d: 1,800 one-row tiles, 225 units of 8); a 3-D field has one chain
// per plane, and the diagonal order runs them side by side.  The block
// holds no LUT, so a one-row tile may be wider than the fused decode's
// (compressor.FUSED_PADDED_MAX_COLS).
#include <cuda_runtime.h>

#include "fused.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(1024) dequant_reconstruct_nd_kernel(
    const uint16_t* __restrict__ codes, int rows_per_tile, int cols,
    int planes, int units_per_plane, int group, int slots, long long n_out,
    int n_tiles, const int* __restrict__ opos, const int* __restrict__ oval,
    const int* __restrict__ obounds, int radius, float two_eb,
    unsigned* ticket, unsigned long long* row_carry,
    unsigned long long* plane_carry, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int block = rows_per_tile * cols;
  uint32_t* d = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scratch = d + static_cast<size_t>(group) * block;

  int p, k;
  diagonal_unit(take_ticket(ticket, scratch), planes, units_per_plane, &p,
                &k);
  const int first = (p * units_per_plane + k) * group;
  const int n_here_tiles = min(group, n_tiles - first);
  const int n = n_here_tiles * block;
  for (int i = 0; i < n_here_tiles; ++i) {
    load_residuals(codes, first + i, block, radius, opos, oval, obounds,
                   d + static_cast<size_t>(i) * block);
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
int launch(const void* codes, int rows_per_tile, int cols, int planes,
           int units_per_plane, int group, int slots, long long n_out,
           int n_tiles, const void* opos, const void* oval,
           const void* obounds, int radius, float two_eb, void* ticket,
           void* row_carry, void* plane_carry, void* out, void* stream) {
  const int threads = nd_threads(cols, 256);
  const size_t smem = fused_smem(
      static_cast<long long>(group) * rows_per_tile * cols, 0);
  auto kernel = dequant_reconstruct_nd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<planes * units_per_plane, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(codes), rows_per_tile, cols, planes,
      units_per_plane, group, slots, n_out, n_tiles,
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
// unknown out_kind (0 float32, 1 bfloat16, 2 float16).  `codes` holds
// n_tiles * rows_per_tile * cols codes, `out` n_out values.  A block takes
// `group` tiles (1 for 3-D); there are planes x units_per_plane blocks.
// `plane_carry` is null for a 2-D field (planes = 1).  `ticket` (one
// uint32), `row_carry` (slots x cols uint64) and `plane_carry` (rows x
// cols uint64) must be zero.
extern "C" int repro_dequant_reconstruct_nd(
    const void* codes, int rows_per_tile, int cols, int planes,
    int units_per_plane, int group, int slots, long long n_out, int n_tiles,
    const void* opos, const void* oval, const void* obounds, int radius,
    float two_eb, void* ticket, void* row_carry, void* plane_carry,
    int out_kind, void* out, void* stream) {
  using namespace repro_torch;
#define REPRO_LAUNCH(T)                                                     \
  launch<T>(codes, rows_per_tile, cols, planes, units_per_plane, group,    \
            slots, n_out, n_tiles, opos, oval, obounds, radius, two_eb,    \
            ticket, row_carry, plane_carry, out, stream)
  switch (out_kind) {
    case 0: return REPRO_LAUNCH(float);
    case 1: return REPRO_LAUNCH(__nv_bfloat16);
    case 2: return REPRO_LAUNCH(__half);
    default: return -1;
  }
#undef REPRO_LAUNCH
}
