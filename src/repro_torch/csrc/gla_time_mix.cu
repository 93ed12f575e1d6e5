// RWKV-6 time-mix recurrence, one (batch, head) pair a block:
//   y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t,
// with S the (dk, dv) float32 state, given in and written out.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_gla.py:gla_time_mix (body
// _gla_kernel).  On the TPU the sequence chunks were a sequential grid axis
// and S sat in VMEM scratch from one chunk to the next.  CUDA blocks run in
// no order, so here one block owns one bh row and loops over the whole
// sequence itself: thread j of dv owns state column j, S[:, j], in
// registers (DK floats, DK a template bound of 16, 32 or 64 >= dk; the
// padding rows stay 0) for the block's life, and nothing carries across
// blocks.  Per chunk of steps the block stages r, k, w (dk each) and v
// (dv) in shared memory with coalesced loads and one barrier; then each
// thread runs the chunk's steps from shared memory alone, reading r_t, k_t,
// w_t and u as broadcasts.  Differences from the Pallas kernel, which
// time_mix needs: the state comes in (zero when none is given) and goes
// out, and u is per head, (H, dk): row bh uses u[bh % H].  With a zero
// state in and the state out dropped, it computes the reference's
// gla_time_mix.
//
// What bounds it on the H100: per step and state element, 7 float32
// operations (k v, u (k v) + S, r (...) summed, w S + k v) without tensor
// cores, at 67 TFLOP/s; and the bytes of r, k, v, w and y plus the state
// in and out at 3.35 TB/s.  For rwkv6-3b's prefill (B 4, H 40, S 1024,
// dk = dv = 64) that is 4.7 GFLOP = 0.070 ms against 215 MB = 0.064 ms.
// This kernel runs B * H blocks of dv threads, each a sequential loop of S
// steps: few warps an SM, so it is held by the latency of its dependent
// FMA chain (four partial sums shorten it), not by either floor.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxDv = 256;
constexpr int kSmemBudget = 48 * 1024;

inline int gla_chunk(int dk_pad, int dv) {
  const int per_step = 3 * dk_pad + dv;
  const int c = (kSmemBudget / 4 - dk_pad) / per_step;
  return c < 1 ? 1 : (c > 64 ? 64 : c);
}

template <int DK>
__global__ void __launch_bounds__(kMaxDv) gla_time_mix_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ state_in,
    float* __restrict__ y, float* __restrict__ state_out, int s, int dk,
    int dv, int h, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* su = smem;                         // [DK]
  float* sr = su + DK;                      // [chunk][DK]
  float* sk = sr + chunk * DK;
  float* sw = sk + chunk * DK;
  float* sv = sw + chunk * DK;              // [chunk][dv]

  const int bh = blockIdx.x;
  const int j = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = j; i < DK; i += nt) su[i] = i < dk ? u[(bh % h) * dk + i] : 0.f;
  // rows dk..DK-1 of the staged chunks are never written: zero them once
  for (int idx = j; idx < 3 * chunk * DK; idx += nt) sr[idx] = 0.f;

  float st[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) st[i] = 0.f;
  if (state_in != nullptr) {
    const float* sin_ = state_in + static_cast<long long>(bh) * dk * dv;
#pragma unroll
    for (int i = 0; i < DK; ++i)
      if (i < dk) st[i] = sin_[i * dv + j];
  }

  const long long row = static_cast<long long>(bh) * s;
  for (int t0 = 0; t0 < s; t0 += chunk) {
    const int n = min(chunk, s - t0);
    __syncthreads();                        // the previous chunk is consumed
    const long long kbase = (row + t0) * dk;
    for (int idx = j; idx < n * dk; idx += nt) {
      const int tt = idx / dk, i = idx - tt * dk;
      sr[tt * DK + i] = r[kbase + idx];
      sk[tt * DK + i] = k[kbase + idx];
      sw[tt * DK + i] = w[kbase + idx];
    }
    const long long vbase = (row + t0) * dv;
    for (int idx = j; idx < n * dv; idx += nt) sv[idx] = v[vbase + idx];
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt * dv + j];
      const float* rt = sr + tt * DK;
      const float* kt = sk + tt * DK;
      const float* wt = sw + tt * DK;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        const float kv = kt[i] * vj;
        acc[i & 3] = fmaf(rt[i], fmaf(su[i], kv, st[i]), acc[i & 3]);
        st[i] = fmaf(wt[i], st[i], kv);
      }
      y[vbase + static_cast<long long>(tt) * dv + j] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }

  float* sout = state_out + static_cast<long long>(bh) * dk * dv;
#pragma unroll
  for (int i = 0; i < DK; ++i)
    if (i < dk) sout[i * dv + j] = st[i];
}

template <int DK>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* state_in, float* y,
           float* state_out, int bh, int s, int dk, int dv, int h,
           cudaStream_t stream) {
  const int chunk = gla_chunk(DK, dv);
  const size_t smem = sizeof(float) * (DK + static_cast<size_t>(chunk) *
                                                (3 * DK + dv));
  gla_time_mix_kernel<DK><<<bh, dv, smem, stream>>>(
      r, k, v, w, u, state_in, y, state_out, s, dk, dv, h, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  r, k, w (bh, s, dk), v (bh, s, dv), u (h, dk) with
// bh % h == 0, state_in (bh, dk, dv) or null for a zero state, y (bh, s,
// dv) and state_out (bh, dk, dv); all float32, contiguous; state_out must
// not alias state_in.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for a
// shape the kernel does not take.
extern "C" int repro_gla_time_mix(const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* state_in,
                                  void* y, void* state_out, int bh, int s,
                                  int dk, int dv, int h, void* stream) {
  using namespace repro_torch;
  if (bh < 1 || s < 1 || dk < 1 || dk > 64 || dv < 1 || dv > kMaxDv ||
      h < 1 || bh % h != 0)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* si = static_cast<const float*>(state_in);
  auto* yf = static_cast<float*>(y);
  auto* so = static_cast<float*>(state_out);
  if (dk <= 16) return launch<16>(rf, kf, vf, wf, uf, si, yf, so, bh, s, dk,
                                  dv, h, st);
  if (dk <= 32) return launch<32>(rf, kf, vf, wf, uf, si, yf, so, bh, s, dk,
                                  dv, h, st);
  return launch<64>(rf, kf, vf, wf, uf, si, yf, so, bh, s, dk, dv, h, st);
}
