// RWKV-6 time-mix recurrence for every (batch, head) row:
//   y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t,
// with S the (dk, dv) float32 state, given in and written out.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_gla.py:gla_time_mix (body
// _gla_kernel).  On the TPU the sequence chunks were a sequential grid axis
// and S sat in VMEM scratch from one chunk to the next.  CUDA blocks run in
// no order, so here each block loops over the whole sequence itself, with
// its part of S in registers, and nothing carries across blocks.
// Differences from the Pallas kernel, which time_mix needs: the state comes
// in (zero when none is given) and goes out, and u is per head, (H, dk):
// row bh uses u[bh % H].  With a zero state in and the state out dropped,
// it computes the reference's gla_time_mix.
//
// What bounds it on the H100: per step and state element, 7 float32
// operations (k v, u (k v) + S, r (...) summed, w S + k v) without tensor
// cores, at 67 TFLOP/s; and the bytes of r, k, v, w and y plus the state
// in and out at 3.35 TB/s.  For rwkv6-3b's prefill (B 4, H 40, S 1024,
// dk = dv = 64) that is 4.7 GFLOP = 0.070 ms against 215 MB = 0.064 ms;
// for one decode step (S 1) the state's 5.2 MB in and out, 1.6 us.
//
// The design spreads the state over the card.  The update is elementwise
// in (i, j): S_ij depends only on its own previous value, and only y_j
// sums over the rows i.  So
//   * the dv columns are split across blocks, DVB = 16 a block: the grid is
//     BH x ceil(dv / DVB), the blocks of one bh row adjacent so that their
//     repeated reads of r, k and w hit L2;
//   * the dk rows are split across the lanes of a warp: lane (g, c) of
//     8 x 4 owns rows g R .. g R + R - 1 (R = DK / 8, DK the template bound
//     16, 32 or 64 >= dk, or 8) of one column, in registers, and updates
//     each with its own FMA chain a step.  y_j sums over the 8 lanes sharing
//     j: each lane stores its partial sum in shared memory, and once a
//     chunk is done the partials of its 16 steps are summed in a fixed
//     order (no atomics), which keeps shuffles and their latency out of the
//     step loop.  4 warps a block own its 16 columns.  rwkv6-3b's prefill
//     runs 640 blocks, 2,560 warps: about 19 an SM;
//   * r_t, k_t and w_t are read from shared memory as float4 (R >= 4), u
//     sits in registers;
//   * the chunks of r, k, w (16 steps x DK) and of v (16 steps x DVB) are
//     staged with 16-byte cp.async copies, two buffers deep, so chunk c + 1
//     loads while chunk c runs; y is summed a chunk at a time and written
//     in coalesced rows;
//   * the state in and out passes through shared memory, read and written
//     in coalesced rows.
// Rows not a multiple of 4 floats long (or unaligned tensors) are staged by
// plain loads instead; the arithmetic is the same.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

constexpr int kMaxDv = 256;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kDvb = 4 * kWarps;   // state columns a block
constexpr int kChunk = 16;         // steps a staged chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// R consecutive floats of shared memory into registers, as float4 where R
// allows (the address is R floats aligned).
template <int R>
__device__ __forceinline__ void load_rows(float (&x)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      x[i] = f.x;
      x[i + 1] = f.y;
      x[i + 2] = f.z;
      x[i + 3] = f.w;
    }
  } else if constexpr (R == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = p[i];
  }
}

template <int DK>
struct GlaSmem {
  static constexpr int SS = kDvb + 1;  // state staging row stride
  // two buffers of r, k, w [kChunk][DK] and v [kChunk][kDvb]; the partial
  // sums of y [kChunk][kDvb][8]; the state [DK][SS]
  static constexpr int kBuf = 3 * kChunk * DK + kChunk * kDvb;
  static constexpr size_t bytes =
      sizeof(float) * (2 * kBuf + kChunk * kDvb * 8 + DK * SS);
};

// Stage steps t0 .. t0 + n - 1 of this block's r, k, w and v in `buf`.
template <int DK>
__device__ __forceinline__ void load_chunk(
    float* buf, const float* r, const float* k, const float* w,
    const float* v, long long row, int t0, int n, int dk, int dv, int j0,
    bool vec, int tid) {
  float* sr = buf;
  float* sk = sr + kChunk * DK;
  float* sw = sk + kChunk * DK;
  float* sv = sw + kChunk * DK;
  const long long kbase = (row + t0) * dk;
  const long long vbase = (row + t0) * dv + j0;
  if (vec) {
    const int cpr = dk >> 2;
    for (int idx = tid; idx < n * cpr; idx += kThreads) {
      const int tt = idx / cpr, q = idx - tt * cpr;
      const long long off = kbase + tt * dk + q * 4;
      cp_async16(sr + tt * DK + q * 4, r + off, true);
      cp_async16(sk + tt * DK + q * 4, k + off, true);
      cp_async16(sw + tt * DK + q * 4, w + off, true);
    }
    for (int idx = tid; idx < n * (kDvb / 4); idx += kThreads) {
      const int tt = idx / (kDvb / 4), q = idx - tt * (kDvb / 4);
      const bool ok = j0 + q * 4 < dv;
      cp_async16(sv + tt * kDvb + q * 4,
                 ok ? v + vbase + static_cast<long long>(tt) * dv + q * 4 : v,
                 ok);
    }
  } else {
    for (int idx = tid; idx < n * dk; idx += kThreads) {
      const int tt = idx / dk, i = idx - tt * dk;
      sr[tt * DK + i] = r[kbase + idx];
      sk[tt * DK + i] = k[kbase + idx];
      sw[tt * DK + i] = w[kbase + idx];
    }
    for (int idx = tid; idx < n * kDvb; idx += kThreads) {
      const int tt = idx / kDvb, c = idx - tt * kDvb;
      sv[idx] = j0 + c < dv
                    ? v[vbase + static_cast<long long>(tt) * dv + c]
                    : 0.f;
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreads) gla_time_mix_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ state_in,
    float* __restrict__ y, float* __restrict__ state_out, int s, int dk,
    int dv, int h, int n_cb, int vec) {
  constexpr int R = DK / 8;
  using Smem = GlaSmem<DK>;
  constexpr int SS = Smem::SS;
  extern __shared__ __align__(16) float smem[];
  float* bufs = smem;                          // [2][kBuf]
  float* sy = bufs + 2 * Smem::kBuf;           // [kChunk][kDvb][8]
  float* sst = sy + kChunk * kDvb * 8;         // [DK][SS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;                     // row group
  const int col = warp * 4 + (lane & 3);       // column within the block
  const int bh = static_cast<int>(blockIdx.x) / n_cb;
  const int j0 = (static_cast<int>(blockIdx.x) % n_cb) * kDvb;
  const long long row = static_cast<long long>(bh) * s;
  const int n_chunks = (s + kChunk - 1) / kChunk;

  load_chunk<DK>(bufs, r, k, w, v, row, 0, min(kChunk, s), dk, dv, j0,
                 vec, tid);
  cp_async_commit();

  // the padding rows dk .. DK - 1 of r, k, w stay 0 (no copy writes them)
  if (dk < DK)
    for (int idx = tid; idx < 2 * 3 * kChunk * (DK - dk);
         idx += kThreads) {
      const int rr = idx / (DK - dk), i = dk + idx - rr * (DK - dk);
      const int b = rr / (3 * kChunk), tt = rr - b * 3 * kChunk;
      bufs[b * Smem::kBuf + tt * DK + i] = 0.f;
    }
  // the state in, coalesced rows of this block's columns
  const long long sbase = static_cast<long long>(bh) * dk * dv + j0;
  for (int idx = tid; idx < DK * kDvb; idx += kThreads) {
    const int i = idx / kDvb, c = idx - i * kDvb;
    sst[i * SS + c] = state_in != nullptr && i < dk && j0 + c < dv
                          ? state_in[sbase + static_cast<long long>(i) * dv + c]
                          : 0.f;
  }
  __syncthreads();
  float st[R], uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int ii = g * R + i;
    st[i] = sst[ii * SS + col];
    uu[i] = ii < dk ? u[static_cast<long long>(bh % h) * dk + ii] : 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, s - t0);
    if (c + 1 < n_chunks) {
      const int t1 = t0 + kChunk;
      load_chunk<DK>(bufs + ((c + 1) & 1) * Smem::kBuf, r, k, w, v, row, t1,
                     min(kChunk, s - t1), dk, dv, j0, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sr = bufs + (c & 1) * Smem::kBuf;
    const float* sk = sr + kChunk * DK;
    const float* sw = sk + kChunk * DK;
    const float* sv = sw + kChunk * DK;
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      float rt[R], kt[R], wt[R];
      load_rows<R>(rt, sr + tt * DK + g * R);
      load_rows<R>(kt, sk + tt * DK + g * R);
      load_rows<R>(wt, sw + tt * DK + g * R);
      const float vj = sv[tt * kDvb + col];
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float kv = kt[i] * vj;
        acc[i & 1] = fmaf(rt[i], fmaf(uu[i], kv, st[i]), acc[i & 1]);
        st[i] = fmaf(wt[i], st[i], kv);
      }
      // lane (g, c) of warp w stores to bank 8 c + g: no conflicts
      sy[(tt * kDvb + col) * 8 + g] = acc[0] + acc[1];
    }
    __syncthreads();  // the chunk is consumed and its partial sums staged
    const long long ybase = (row + t0) * dv + j0;
    for (int idx = tid; idx < n * kDvb; idx += kThreads) {
      const int tt = idx / kDvb, cc = idx - tt * kDvb;
      const float4 a = *reinterpret_cast<const float4*>(sy + idx * 8);
      const float4 b = *reinterpret_cast<const float4*>(sy + idx * 8 + 4);
      if (j0 + cc < dv)
        y[ybase + static_cast<long long>(tt) * dv + cc] =
            ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w));
    }
  }

  // the state out, through shared memory (every read of sst was before the
  // first chunk's barrier)
#pragma unroll
  for (int i = 0; i < R; ++i) sst[(g * R + i) * SS + col] = st[i];
  __syncthreads();
  float* sout = state_out + sbase;
  for (int idx = tid; idx < dk * kDvb; idx += kThreads) {
    const int i = idx / kDvb, c = idx - i * kDvb;
    if (j0 + c < dv) sout[static_cast<long long>(i) * dv + c] = sst[i * SS + c];
  }
}

template <int DK>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* state_in, float* y,
           float* state_out, int bh, int s, int dk, int dv, int h,
           cudaStream_t stream) {
  const int n_cb = (dv + kDvb - 1) / kDvb;
  const long long n_blocks = static_cast<long long>(bh) * n_cb;
  if (n_blocks >= (1ll << 31)) return -1;
  constexpr size_t smem = GlaSmem<DK>::bytes;
  static_assert(smem <= 48 * 1024, "GLA staging exceeds 48 KB");
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) &
       15) == 0;
  const int vec = aligned && dk % 4 == 0 && dv % 4 == 0;
  gla_time_mix_kernel<DK>
      <<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
          r, k, v, w, u, state_in, y, state_out, s, dk, dv, h, n_cb, vec);
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
  if (dk <= 8) return launch<8>(rf, kf, vf, wf, uf, si, yf, so, bh, s, dk,
                                dv, h, st);
  if (dk <= 16) return launch<16>(rf, kf, vf, wf, uf, si, yf, so, bh, s, dk,
                                  dv, h, st);
  if (dk <= 32) return launch<32>(rf, kf, vf, wf, uf, si, yf, so, bh, s, dk,
                                  dv, h, st);
  return launch<64>(rf, kf, vf, wf, uf, si, yf, so, bh, s, dk, dv, h, st);
}
