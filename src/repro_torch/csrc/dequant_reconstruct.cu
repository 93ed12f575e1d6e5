// The fused epilogue alone for flat fields: dequantize + 1-D inverse
// Lorenzo over a uint16 code array, the padded decoder's fused form.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:
// dequant_reconstruct (body dequant_recon_kernel_body ->
// _dequant_recon_block; entry ops.decode_padded_fused).  It is
// decode_tiles_fused.cu with the decode stage replaced by a read of the
// codes: one block per tile of `block` codes (4,096 on the padded path, as
// in the reference).  The block
//   1. takes its tile index t from the launch's ticket counter;
//   2. reads the tile's codes as int32 residuals d = code - radius into
//      shared memory, coalesced, and scatters the tile's outliers
//      (fused.cuh: load_residuals);
//   3. scans d in place (the tile's inclusive cumsum);
//   4. finds the sum of every earlier tile by decoupled look-back
//      (fused.cuh: lookback_prefix), one 64-bit status word per tile;
//   5. writes out[i] = cast(float(int32(prefix + d[i])) * two_eb).
// On the TPU the carry was one int32 in VMEM scratch across an ordered
// grid; here the status words, zeroed by the wrapper for every launch,
// carry it between blocks that run in no fixed order.
//
// What bounds it on the H100: the byte floor is 2 B read per code, the
// output, and 8 B per outlier: 0.03 ms for hacc1d's 2^24 float32 values.
// The scan is a few operations per code, so the kernel should sit near its
// byte floor unless the look-back waits; a tile waits only for the
// aggregates of earlier tiles, which those publish as soon as their own
// scans are done.
#include <cuda_runtime.h>

#include "fused.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(1024) dequant_reconstruct_kernel(
    const uint16_t* __restrict__ codes, int block,
    const int* __restrict__ opos, const int* __restrict__ oval,
    const int* __restrict__ obounds, int radius, float two_eb,
    unsigned* ticket, unsigned long long* status, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* d = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scratch = d + block;

  const int t = take_ticket(ticket, scratch);
  load_residuals(codes, t, block, radius, opos, oval, obounds, d);
  scan_rows(d, block, block, scratch);
  const uint32_t prefix = lookback_prefix(t, d[block - 1], status, scratch);
  write_out(d, prefix, block, two_eb,
            out + static_cast<long long>(t) * block);
}

template <typename T>
int launch(const void* codes, int block, int n_tiles, const void* opos,
           const void* oval, const void* obounds, int radius, float two_eb,
           void* ticket, void* status, void* out, void* stream) {
  const int threads = 512;
  const size_t smem = fused_smem(block, 0);
  auto kernel = dequant_reconstruct_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(codes), block,
      static_cast<const int*>(opos), static_cast<const int*>(oval),
      static_cast<const int*>(obounds), radius, two_eb,
      static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(status), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for an
// unknown out_kind (0 float32, 1 bfloat16, 2 float16).  `codes` and `out`
// hold n_tiles * block values.  `ticket` (one uint32) and `status`
// (n_tiles uint64) must be zero.
extern "C" int repro_dequant_reconstruct(const void* codes, int block,
                                         int n_tiles, const void* opos,
                                         const void* oval,
                                         const void* obounds, int radius,
                                         float two_eb, void* ticket,
                                         void* status, int out_kind,
                                         void* out, void* stream) {
  using namespace repro_torch;
#define REPRO_LAUNCH(T)                                                    \
  launch<T>(codes, block, n_tiles, opos, oval, obounds, radius, two_eb,   \
            ticket, status, out, stream)
  switch (out_kind) {
    case 0: return REPRO_LAUNCH(float);
    case 1: return REPRO_LAUNCH(__nv_bfloat16);
    case 2: return REPRO_LAUNCH(__half);
    default: return -1;
  }
#undef REPRO_LAUNCH
}
