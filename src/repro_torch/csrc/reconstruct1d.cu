// Inverse 1-D Lorenzo over an int32 residual array: x'[i] = 2eb * q[i],
// q the inclusive int32 prefix sum of d.
//
// Replaces the TPU kernel src/repro/kernels/lorenzo.py:reconstruct1d (body
// _recon_kernel; entry ops.lorenzo_reconstruct for 1-D).  On the TPU the
// carry between blocks was one int32 in VMEM scratch across the ordered
// grid.  Here it is dequant_reconstruct.cu with the residuals read as they
// are (no code - radius, no outliers): one block per tile of `block`
// values, which
//   1. takes its tile index t from the launch's ticket counter
//      (fused.cuh: take_ticket);
//   2. reads its residuals into shared memory, coalesced, the ragged last
//      tile padded with zeros;
//   3. scans them in place (fused.cuh: scan_rows, uint32 sums that wrap as
//      XLA's int32 cumsum does);
//   4. finds the sum of every earlier tile by decoupled look-back
//      (fused.cuh: lookback_prefix), one 64-bit status word per tile;
//   5. writes out[i] = __fmul_rn(__int2float_rn(q), two_eb), the reference's
//      q.astype(f32) * f32(2eb).
//
// What bounds it on the H100: 4 B read and 4 B written per value, 0.040 ms
// for hacc1d's 2^24 values at 3.35 TB/s; the scan is a few operations a
// value, so the look-back's wait is what can hold it above its floor.
#include <cuda_runtime.h>

#include "fused.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(1024) reconstruct1d_kernel(
    const int* __restrict__ resid, long long n, int block, float two_eb,
    unsigned* ticket, unsigned long long* status, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* d = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scratch = d + block;

  const int t = take_ticket(ticket, scratch);
  const long long base = static_cast<long long>(t) * block;
  const int n_here = static_cast<int>(min(static_cast<long long>(block),
                                          n - base));
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    d[i] = i < n_here ? static_cast<uint32_t>(resid[base + i]) : 0u;
  }
  __syncthreads();
  scan_rows(d, block, block, scratch);
  const uint32_t prefix = lookback_prefix(t, d[block - 1], status, scratch);
  write_out(d, prefix, n_here, two_eb, out + base);
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for n < 1
// or a block outside [32, 16384].  `resid` and `out` hold n values;
// `ticket` (one uint32) and `status` (ceil(n / block) uint64) must be zero.
extern "C" int repro_reconstruct1d(const void* resid, long long n, int block,
                                   float two_eb, void* ticket, void* status,
                                   void* out, void* stream) {
  using namespace repro_torch;
  if (n < 1 || block < 32 || block > 16384) return -1;
  const long long n_tiles = (n + block - 1) / block;
  if (n_tiles >= (1ll << 31)) return -1;
  const int threads = 512;
  const size_t smem = fused_smem(block, 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reconstruct1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  reconstruct1d_kernel<<<static_cast<unsigned>(n_tiles), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(resid), n, block, two_eb,
      static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(status), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
