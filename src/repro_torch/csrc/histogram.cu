// Integer histogram: out[b] = #{i : clip(x[i], 0, nbins - 1) == b}.
//
// Replaces the TPU kernel src/repro/kernels/histogram.py:histogram (body
// _hist_kernel; entry ops.histogram): a privatized per-chunk histogram
// summed into one output block that stayed resident across the TPU's
// ordered grid.  CUDA blocks run in no order, so each block counts its
// share of x into sub-histograms in shared memory and then adds them into
// the int32 output.  Integer additions commute, so the result is exact and
// the same on every run, whatever the order of the atomics.
//
// What bounds it on the H100: 2 B read per uint16 code, 0.015 ms for
// isabel3d's 25 M codes at 3.35 TB/s.  The old kernel (one code a thread a
// step, a grid of 4 blocks an SM) read 2 B a load and ran at a third of
// that.  The design (kernels/histogram.py:histogram_geometry computes every
// number of it):
//   * Loads of 16 bytes (8 uint16 codes or 4 int32 values) over a grid
//     stride, kUnroll of them in flight a thread; the elements before the
//     first 16-byte boundary of x (the head) and after the last whole
//     vector (the tail), fewer than one vector each, are read one at a time
//     by the first threads of the grid.
//   * One sub-histogram a block in shared memory, a shared atomicAdd a
//     value.  At 2.5-3 bits a code a few bins around code = radius hold
//     most codes, so a warp's atomics mostly meet on one address; on the
//     H100 that costs no more than atomics on 32 addresses: interleaved
//     copies of the sub-histogram, one a lane, were no faster, even with
//     every code in one bin, and runs merged in registers before the
//     atomics were slower.
//   * The grid is one wave of blocks, each a share of x of at least
//     HIST_SHARE_PER_BIN x nbins values (its zeroing and its flush are
//     small beside its counting), and up to HIST_SINGLE_MAX values (a KV
//     page) one block, which stores every bin of the output itself: the
//     output then needs no zero fill, one launch less.  Otherwise each
//     block adds its nonzero bins into the output, which must be zero, with
//     global atomics.
//   * When nbins counters do not fit a block's shared memory (radius past
//     ~28K), shared = 0 picks the variant that adds every value into the
//     output directly; its output must be zero too.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

constexpr int kHistMaxThreads = 1024;
constexpr int kUnroll = 4;

__device__ __forceinline__ int bin_of(uint32_t v, int nbins) {
  return v >= static_cast<uint32_t>(nbins) ? nbins - 1 : static_cast<int>(v);
}

__device__ __forceinline__ int bin_of(int v, int nbins) {
  return v < 0 ? 0 : (v >= nbins ? nbins - 1 : v);
}

template <typename T>
__device__ __forceinline__ int bin_at(const T* __restrict__ x, long long i,
                                      int nbins) {
  if constexpr (sizeof(T) == 2) {
    return bin_of(static_cast<uint32_t>(__ldg(x + i)), nbins);
  } else {
    return bin_of(static_cast<int>(__ldg(x + i)), nbins);
  }
}

// Add the bins of one 16-byte load (8 uint16 codes or 4 int32 values) into
// `dst`.
template <typename T>
__device__ __forceinline__ void count_vector(const uint4& r, int nbins,
                                             int* dst) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 2) {
      atomicAdd(dst + bin_of(w[k] & 0xffffu, nbins), 1);
      atomicAdd(dst + bin_of(w[k] >> 16, nbins), 1);
    } else {
      atomicAdd(dst + bin_of(static_cast<int>(w[k]), nbins), 1);
    }
  }
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kHistMaxThreads) histogram_kernel(
    const T* __restrict__ x, long long n, int head, long long vectors,
    int nbins, int single, int* __restrict__ out) {
  extern __shared__ __align__(16) int sub[];
  constexpr int kPer = 16 / sizeof(T);
  if constexpr (kShared) {
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) sub[b] = 0;
    __syncthreads();
  }
  int* dst = kShared ? sub : out;

  const long long gtid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (long long v0 = gtid; v0 < vectors; v0 += kUnroll * step) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * step;
      if (v < vectors) r[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v0 + u * step < vectors) count_vector<T>(r[u], nbins, dst);
    }
  }
  // The head and the tail: fewer than kPer elements each.
  const long long tail0 = head + vectors * kPer;
  if (gtid < head) atomicAdd(dst + bin_at(x, gtid, nbins), 1);
  if (gtid < n - tail0) atomicAdd(dst + bin_at(x, tail0 + gtid, nbins), 1);

  if constexpr (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
      if (single) {
        out[b] = sub[b];
      } else if (sub[b] != 0) {
        atomicAdd(out + b, sub[b]);
      }
    }
  }
}

template <typename T, bool kShared>
int launch_variant(const void* x, long long n, int head, long long vectors,
                   int nbins, int blocks, int threads, int single, void* out,
                   cudaStream_t stream) {
  auto kernel = histogram_kernel<T, kShared>;
  const int smem = kShared ? 4 * nbins : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(x), n,
                                            head, vectors, nbins, single,
                                            static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, long long n, int head, long long vectors,
           int nbins, int blocks, int threads, int shared, int single,
           void* out, cudaStream_t stream) {
  return shared ? launch_variant<T, true>(x, n, head, vectors, nbins, blocks,
                                          threads, single, out, stream)
                : launch_variant<T, false>(x, n, head, vectors, nbins,
                                           blocks, threads, 0, out, stream);
}

}  // namespace repro_torch

// C entry point.  Launches `blocks` blocks of `threads` threads on
// `stream`, allocates nothing, does not synchronize; returns
// cudaGetLastError() (0 on success), or -1 for an unknown in_kind (0
// uint16, 1 int32) or a geometry the kernel cannot run: n < 1, nbins < 1,
// elements of x not covered exactly once by the head, the vectors and a
// tail shorter than a vector, a block of no whole warps or past 1,024
// threads, a single-block launch of more than one block or without the
// shared sub-histogram.  The geometry is
// kernels/histogram.py:histogram_geometry's.  `out` holds nbins int32
// counts; it must be zero unless `single` is 1, in which case the one
// block stores every bin.
extern "C" int repro_histogram(const void* x, long long n, int in_kind,
                               int nbins, int head, long long vectors,
                               int blocks, int threads, int shared,
                               int single, void* out, void* stream) {
  using namespace repro_torch;
  const int per = in_kind == 0 ? 8 : 4;
  const long long tail = n - head - vectors * per;
  if (n < 1 || nbins < 1 || head < 0 || head >= per || vectors < 0 ||
      tail < 0 || tail >= per || blocks < 1 || threads < 32 ||
      threads > kHistMaxThreads || threads % 32 != 0 ||
      (single && (blocks != 1 || !shared)))
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_kind) {
    case 0:
      return launch<uint16_t>(x, n, head, vectors, nbins, blocks, threads,
                              shared, single, out, s);
    case 1:
      return launch<int>(x, n, head, vectors, nbins, blocks, threads, shared,
                         single, out, s);
    default: return -1;
  }
}
