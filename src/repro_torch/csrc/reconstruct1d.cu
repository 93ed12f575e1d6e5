// Inverse 1-D Lorenzo over an int32 residual array: x'[i] = 2eb * q[i],
// q the inclusive int32 prefix sum of d.
//
// Replaces the TPU kernel src/repro/kernels/lorenzo.py:reconstruct1d (body
// _recon_kernel; entry ops.lorenzo_reconstruct for 1-D).  On the TPU the
// carry between blocks was one int32 in VMEM scratch across the ordered
// grid.  Here it is dequant_reconstruct.cu with the residuals read as they
// are (fused.cuh: EpilogueValues, UnitValues: no code - radius, no
// outliers): persistent blocks (fused_decode.epilogue_geometry) that take
// units of unit_tiles tiles of `tile` values by ticket, start the next
// unit's bulk copy into shared memory, sum and publish the unit they hold,
// then look back for (a window of 32 statuses a read) and write the unit
// they took before it, 4 values a lane with 16-byte loads and stores
// (fused.cuh, "1-D epilogues").  The
// sums are uint32 and wrap as XLA's int32 cumsum does; out[i] =
// __fmul_rn(__int2float_rn(q), two_eb), the reference's q.astype(f32) *
// f32(2eb).  The last unit is ragged at any n: its bulk copy takes its
// 16-byte run and the threads load the rest.
//
// What bounds it on the H100: 4 B read and 4 B written a value, 0.040 ms
// for hacc1d's 2^24 values at 3.35 TB/s; the scan is a few operations a
// value, so the reads must stay in flight while blocks wait on their
// look-backs: each block's next read overlaps its look-back and write.
#include <cuda_runtime.h>

#include "fused.cuh"
#include "smem.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kEpilogueThreads, kEpilogueMinBlocks)
    reconstruct1d_kernel(const int* __restrict__ resid, long long n,
                         int unit_len, int window, float two_eb,
                         unsigned* ticket, unsigned long long* status,
                         float* __restrict__ out) {
  const EpilogueValues src{resid};
  epilogue_units(src, n, unit_len, window, two_eb, ticket, status, out);
}

int launch(const void* resid, long long n, int unit_len, int window,
           int blocks, int smem, float two_eb, void* ticket, void* status,
           void* out, void* stream) {
  auto kernel = reconstruct1d_kernel;
  const cudaError_t allowed = allow_dynamic_smem(kernel, smem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<blocks, kEpilogueThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(resid), n, unit_len, window, two_eb,
      static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(status), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches `blocks` blocks of kEpilogueThreads threads
// with `smem` bytes of shared memory on `stream`
// (fused_decode.epilogue_geometry), allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for n < 1
// or a geometry the kernel cannot run: a tile outside [32, 16384],
// unit_tiles outside 1-8, 2**31 units or more, a look-back window outside
// 1-32 (a warp's lanes), no blocks, or smem short of the stages, the
// scratch words and the slots.  `resid` and `out` hold n values; `ticket`
// (one uint32) and `status` (one uint64 a unit of unit_tiles tiles) must
// be zero.
extern "C" int repro_reconstruct1d(const void* resid, long long n, int tile,
                                   int unit_tiles, int window, int blocks,
                                   int smem, float two_eb, void* ticket,
                                   void* status, void* out, void* stream) {
  using namespace repro_torch;
  if (n < 1 || tile < 32 || tile > 16384 || unit_tiles < 1 ||
      unit_tiles > 8 || window < 1 || window > 32 || blocks < 1 ||
      static_cast<size_t>(smem) < epilogue_smem(4ll * unit_tiles * tile))
    return -1;
  const int unit_len = unit_tiles * tile;
  if ((n + unit_len - 1) / unit_len >= (1ll << 31)) return -1;
  return launch(resid, n, unit_len, window, blocks, smem, two_eb, ticket,
                status, out, stream);
}
