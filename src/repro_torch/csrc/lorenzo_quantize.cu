// Dual-quant Lorenzo quantizer over a float32 tensor of up to 8 axes: the
// lattice index q = round(x / 2eb), the Lorenzo residual d = q - L(q), the
// code d + radius (0 for an outlier) and the outlier mask.
//
// Replaces the TPU kernel src/repro/kernels/lorenzo.py:quantize1d (body
// _quant_kernel; entry ops.lorenzo_quantize) and, on the card, also the N-D
// jnp composition the reference's Pallas backend runs beside it
// (core/sz/lorenzo.py:quantize).  It computes what core/sz/lorenzo.py:
// quantize computes, bit for bit:
//   * q = __float2int_rn(__fdiv_rn(x, two_eb)): an IEEE division (never a
//     reciprocal multiply, which moves lattice ties) rounded half to even;
//     two_eb is the runtime float32(eb) * 2;
//   * d over the tensor's k non-unit axes (the wrapper squeezes the unit
//     axes: a difference along a length-1 axis is the identity) is the
//     inclusion-exclusion sum of q over the 2^k corners c - e_S, S a subset
//     of the axes, with sign (-1)^|S| and zero outside the domain.  The
//     reference takes the per-axis differences one after another; those
//     are linear maps and commute, so over int32 the corner sum is the
//     same number.  It is summed in uint32, which wraps as XLA's int32.
// One thread per element recomputes its neighbours' q; the division is
// deterministic, so the neighbours' q are the ones their own threads find.
//
// What bounds it on the H100: 4 B read and 7 B written per value (u16 code,
// u8 mask, i32 residual), 0.082 ms for isabel3d's 25 M values at 3.35 TB/s.
// The neighbour reads hit L1/L2 (each value is read by up to 2^k threads
// of nearby blocks); the 2^k divisions and the k integer divisions for
// the coordinates are the compute, ~8 + 3 a value for 3-D.  A
// shared-memory halo tile would read and divide each value once.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

constexpr int kMaxAxes = 8;

// The squeezed shape.  n < 2^31 (the wrapper checks), so coordinates and
// offsets are 32-bit: the per-axis division is the costliest integer step.
struct Geometry {
  unsigned dim[kMaxAxes];     // sizes, slowest first
  unsigned stride[kMaxAxes];  // C-order strides of the squeezed shape
};

__device__ __forceinline__ uint32_t lattice(const float* __restrict__ x,
                                            unsigned i, float two_eb) {
  const float v = __fdiv_rn(__ldg(x + i), two_eb);
  return static_cast<uint32_t>(__float2int_rn(v));
}

// K, the number of axes, is a template argument: every loop over the axes
// and the corners unrolls, so the shape stays in the parameter space and
// registers.  (With K a run-time value, ptxas gave every thread a 72-byte
// local-memory frame for the shape.)
template <int K>
__global__ void __launch_bounds__(256) lorenzo_quantize_kernel(
    const float* __restrict__ x, unsigned n, Geometry g, float two_eb,
    int radius, uint16_t* __restrict__ codes, uint8_t* __restrict__ outlier,
    int* __restrict__ resid) {
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    // Axes at their lower edge: their corners lie outside the domain.
    unsigned edge = 0;
    unsigned rest = i;
#pragma unroll
    for (int a = K - 1; a >= 0; --a) {
      if (rest % g.dim[a] == 0) edge |= 1u << a;
      rest /= g.dim[a];
    }
    uint32_t d = 0;
#pragma unroll
    for (unsigned s = 0; s < (1u << K); ++s) {
      if (s & edge) continue;
      unsigned off = 0;
#pragma unroll
      for (int a = 0; a < K; ++a) {
        if (s & (1u << a)) off += g.stride[a];
      }
      const uint32_t q = lattice(x, i - off, two_eb);
      d = (__popc(s) & 1) ? d - q : d + q;
    }
    const int code = static_cast<int>(d + static_cast<uint32_t>(radius));
    const bool out = code < 0 || code >= 2 * radius;
    codes[i] = out ? uint16_t{0} : static_cast<uint16_t>(code);
    outlier[i] = out ? 1 : 0;
    resid[i] = static_cast<int>(d);
  }
}

template <int K>
void launch(const float* x, unsigned n, const Geometry& g, float two_eb,
            int radius, uint16_t* codes, uint8_t* outlier, int* resid,
            cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (static_cast<long long>(n) + threads - 1) / threads;
  if (blocks > (1ll << 20)) blocks = 1ll << 20;  // grid-stride beyond
  lorenzo_quantize_kernel<K><<<static_cast<unsigned>(blocks), threads, 0,
                               stream>>>(x, n, g, two_eb, radius, codes,
                                         outlier, resid);
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for k
// outside [0, 8] or n outside [1, 2^31).  `dims` is a host array of the k
// non-unit axes' sizes, slowest first, whose product is n.  Outputs hold n
// values each.
extern "C" int repro_lorenzo_quantize(const void* x, long long n,
                                      const long long* dims, int k,
                                      float two_eb, int radius, void* codes,
                                      void* outlier, void* resid,
                                      void* stream) {
  using namespace repro_torch;
  if (k < 0 || k > kMaxAxes || n < 1 || n >= (1ll << 31)) return -1;
  Geometry g{};
  unsigned stride = 1;
  for (int a = k - 1; a >= 0; --a) {
    g.dim[a] = static_cast<unsigned>(dims[a]);
    g.stride[a] = stride;
    stride *= g.dim[a];
  }
  const float* xp = static_cast<const float*>(x);
  const unsigned nn = static_cast<unsigned>(n);
  uint16_t* cp = static_cast<uint16_t*>(codes);
  uint8_t* op = static_cast<uint8_t*>(outlier);
  int* rp = static_cast<int*>(resid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define REPRO_CASE(K) \
  case K: launch<K>(xp, nn, g, two_eb, radius, cp, op, rp, s); break;
    REPRO_CASE(0) REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
