// The fused epilogue alone for flat fields: dequantize + 1-D inverse
// Lorenzo over a uint16 code array, the padded decoder's fused form.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:
// dequant_reconstruct (body dequant_recon_kernel_body ->
// _dequant_recon_block; entry ops.decode_padded_fused).  On the TPU the
// carry was one int32 in VMEM scratch across an ordered grid.  Here it is
// decode_tiles_fused.cu's unit path with the decode replaced by a read of
// the codes (fused.cuh, "1-D epilogues"): persistent blocks of
// kEpilogueThreads threads, at most the blocks the card holds at once
// (fused_decode.epilogue_geometry).  Each block loops:
//   1. it takes a ticket, the next unit u of unit_tiles consecutive tiles
//      of `tile` codes, and starts the unit's read: one bulk copy of its
//      codes into one of three stages in shared memory, and its slice of
//      the outlier side list (fused.cuh: stage_unit, EpilogueCodes);
//   2. it waits for the unit it took before, sums each warp's chunk of its
//      residuals d = code - radius, the outliers' differences added in, and
//      publishes the unit's aggregate (unit_chunk_totals,
//      unit_chunk_offsets, publish_aggregate);
//   3. for the unit taken before that one, warp 0 finds the sum of every
//      earlier unit by a decoupled look-back over a window of 32 statuses,
//      one a lane (unit_lookback), and the block writes out[i] =
//      cast(float(int32(prefix + cumsum(d)[i])) * two_eb), 4 values a lane,
//      each warp walking the unit's outliers beside its rows, with a
//      16-byte (8-byte for bf16 and f16) store where the unit's first output
//      allows (write_unit).
// Step 1's copy runs while the block does steps 2 and 3, and step 3's
// look-back comes a round after its unit's aggregate went out, so it
// rarely waits.  The carry is one 64-bit status word a unit, zeroed by the
// wrapper for every launch.
//
// What bounds it on the H100: the byte floor is 2 B read a code, the
// output, and 8 B an outlier: 0.030 ms for hacc1d's 2^24 float32 values at
// 3.35 TB/s.  The scan is a few operations a code, so the floor is reached
// only if the reads stay in flight: a unit's read overlaps the block's
// look-back and write, and the look-back waits only for units whose
// aggregates their blocks published before they looked back themselves.
#include <cuda_runtime.h>

#include "fused.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(kEpilogueThreads, kEpilogueMinBlocks)
    dequant_reconstruct_kernel(const uint16_t* __restrict__ codes, int tile,
                               int n_tiles, int unit_tiles, int window,
                               const int* __restrict__ opos,
                               const int* __restrict__ oval,
                               const int* __restrict__ obounds, int radius,
                               float two_eb, unsigned* ticket,
                               unsigned long long* status,
                               T* __restrict__ out) {
  const EpilogueCodes src{codes, opos,    oval,       obounds,
                          tile,  n_tiles, unit_tiles, radius};
  epilogue_units(src, static_cast<long long>(n_tiles) * tile,
                 unit_tiles * tile, window, two_eb, ticket, status, out);
}

template <typename T>
int launch(const void* codes, int tile, int n_tiles, int unit_tiles,
           int window, int blocks, int smem, const void* opos,
           const void* oval, const void* obounds, int radius, float two_eb,
           void* ticket, void* status, void* out, void* stream) {
  auto kernel = dequant_reconstruct_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kEpilogueThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(codes), tile, n_tiles, unit_tiles, window,
      static_cast<const int*>(opos), static_cast<const int*>(oval),
      static_cast<const int*>(obounds), radius, two_eb,
      static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(status), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches `blocks` blocks of kEpilogueThreads threads
// with `smem` bytes of shared memory on `stream`
// (fused_decode.epilogue_geometry), allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for an
// unknown out_kind (0 float32, 1 bfloat16, 2 float16) or a geometry the
// kernel cannot run: no tile, unit_tiles outside 1-8, a look-back window
// outside 1-32 (a warp's lanes), no blocks, or smem short of the stages,
// the scratch words and the slots.  The wrapper's window is always 32; a
// card test passes narrower ones, which make the look-back slide.  `codes`
// and `out` hold n_tiles * tile values.  `ticket` (one uint32) and
// `status` (one uint64 a unit of unit_tiles tiles) must be zero.
extern "C" int repro_dequant_reconstruct(
    const void* codes, int tile, int n_tiles, int unit_tiles, int window,
    int blocks, int smem, const void* opos, const void* oval,
    const void* obounds, int radius, float two_eb, void* ticket,
    void* status, int out_kind, void* out, void* stream) {
  using namespace repro_torch;
  if (tile < 1 || n_tiles < 1 || unit_tiles < 1 || unit_tiles > 8 ||
      window < 1 || window > 32 || blocks < 1 ||
      static_cast<size_t>(smem) < epilogue_smem(2ll * unit_tiles * tile))
    return -1;
#define REPRO_LAUNCH(T)                                                     \
  launch<T>(codes, tile, n_tiles, unit_tiles, window, blocks, smem, opos,  \
            oval, obounds, radius, two_eb, ticket, status, out, stream)
  switch (out_kind) {
    case 0: return REPRO_LAUNCH(float);
    case 1: return REPRO_LAUNCH(__nv_bfloat16);
    case 2: return REPRO_LAUNCH(__half);
    default: return -1;
  }
#undef REPRO_LAUNCH
}
