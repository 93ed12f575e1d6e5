// Integer histogram: out[b] = #{i : clip(x[i], 0, nbins - 1) == b}.
//
// Replaces the TPU kernel src/repro/kernels/histogram.py:histogram (body
// _hist_kernel; entry ops.histogram): a privatized per-chunk histogram
// summed into one output block that stayed resident across the TPU's
// ordered grid.  CUDA blocks run in no order, so each block keeps a
// sub-histogram of its share of x in shared memory (shared atomicAdd) and
// then adds its nonzero bins into the int32 output with global atomicAdd.
// Integer additions commute, so the result is exact and the same on every
// run.  When 4 * nbins bytes do not fit a block's shared memory (radius
// past ~28K), the wrapper picks the variant that adds into the output
// directly, by size, before the launch.  The output must be zero.
//
// What bounds it on the H100: 2 B read per uint16 code, 0.015 ms for
// isabel3d's 25 M codes at 3.35 TB/s.  At 2.5-3 bits per code one bin
// (code = radius) holds most codes, so a warp's shared atomics mostly hit
// one address and serialize; that, not the bytes, is the first suspect if
// the kernel sits far above its floor.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

template <typename T>
__device__ __forceinline__ int bin_of(T v, int nbins) {
  const int b = static_cast<int>(v);
  return b < 0 ? 0 : (b >= nbins ? nbins - 1 : b);
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(512) histogram_kernel(
    const T* __restrict__ x, long long n, int nbins, int* __restrict__ out) {
  extern __shared__ int sub[];
  if constexpr (kShared) {
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) sub[b] = 0;
    __syncthreads();
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int b = bin_of(__ldg(x + i), nbins);
    if constexpr (kShared) {
      atomicAdd(sub + b, 1);
    } else {
      atomicAdd(out + b, 1);
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
      if (sub[b] != 0) atomicAdd(out + b, sub[b]);
    }
  }
}

template <typename T>
int launch(const void* x, long long n, int nbins, int global_only,
           void* out, void* stream) {
  const int threads = 512;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Enough blocks to fill the card, few enough that each block's flush of
  // its nbins counters stays small beside its share of x.
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 4ll * (sms > 0 ? sms : 132);
  if (blocks > cap) blocks = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (global_only) {
    histogram_kernel<T, false><<<static_cast<unsigned>(blocks), threads, 0,
                                 s>>>(static_cast<const T*>(x), n, nbins,
                                      static_cast<int*>(out));
  } else {
    const size_t smem = 4 * static_cast<size_t>(nbins);
    auto kernel = histogram_kernel<T, true>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
        static_cast<const T*>(x), n, nbins, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for an
// unknown in_kind (0 uint16, 1 int32), n < 1 or nbins < 1.  `out` holds
// nbins int32 counts and must be zero; global_only = 1 launches the variant
// without a shared-memory sub-histogram.
extern "C" int repro_histogram(const void* x, long long n, int in_kind,
                               int nbins, int global_only, void* out,
                               void* stream) {
  using namespace repro_torch;
  if (n < 1 || nbins < 1) return -1;
  switch (in_kind) {
    case 0: return launch<uint16_t>(x, n, nbins, global_only, out, stream);
    case 1: return launch<int>(x, n, nbins, global_only, out, stream);
    default: return -1;
  }
}
