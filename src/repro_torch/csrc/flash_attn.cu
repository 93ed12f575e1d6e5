// Flash-attention forward: out = softmax(scale * q k^T [causal mask]) v,
// with an online softmax over kv tiles, in float32 inside.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py:flash_attention
// (body _flash_kernel).  On the TPU the kv blocks were a sequential grid
// axis and the running max m, sum l and accumulator acc sat in VMEM scratch
// from one grid step to the next.  CUDA blocks run in no order, so here one
// block owns one (bh, 64-row query tile) and runs the whole kv loop itself:
// m, l and acc stay in registers for the block's life and nothing carries
// across blocks.  Per 32-row kv tile the block
//   1. stages K and V in shared memory as float32 (Q was staged once,
//      scaled by `scale` as the Pallas kernel scales q);
//   2. computes its 64 x 32 scores with scalar FMAs: thread (ty, tx) of
//      16 x 16 owns rows 4ty..4ty+3 and columns tx, tx + 16;
//   3. masks columns past Skv and, when causal, above the diagonal
//      (top-left aligned: key j is seen by query i iff j <= i, as Pallas
//      masks), takes the row max and row sum by shuffles over the 16 lanes
//      of a row, rescales acc by exp(m_old - m_new) and writes p to shared
//      memory;
//   4. adds p v to acc (rows 4ty..4ty+3, columns tx + 16c).
// Tiles wholly above the causal diagonal are never loaded (Pallas skips
// them with pl.when).  Any Sq and Skv work: the ragged last tiles are
// masked.  GQA: query row bh reads kv row bh / groups, so the caller does
// not repeat the kv heads.  The output is acc / max(l, 1e-30), cast once to
// the input type (float32 or bfloat16).
//
// What bounds it on the H100: the products.  At the qwen3-0.6b prefill
// shape (B 4, 16 query heads, 8 kv heads, S 1024, D 128, causal) the
// floor is 17.2 GFLOP at 989 TFLOP/s bf16 = 0.017 ms against 50 MB of
// Q, K, V and O at 3.35 TB/s = 0.015 ms.  This first kernel does the
// products as scalar float32 FMAs from shared memory (no mma.sync, no
// wgmma), so it is held by shared-memory loads, about 1.1 loads a FMA,
// far above that floor; tensor-core tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 32;          // kv rows a tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxD = 128;       // largest D and Dv
constexpr int kAccCols = kMaxD / 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

inline size_t flash_smem(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (d + 1) +
                          static_cast<size_t>(kBK) * (d + 1) +
                          static_cast<size_t>(kBK) * dv +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int n_qt, int groups,
    int sq, int skv, int d, int dv, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ds = d + 1;                     // padded row: no bank conflicts
  float* sq_ = smem;                        // [kBQ][ds]
  float* sk = sq_ + kBQ * ds;               // [kBK][ds]
  float* sv = sk + kBK * ds;                // [kBK][dv]
  float* sp = sv + kBK * dv;                // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  // heavier (later) query tiles first: causal work grows with the tile
  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x % n_qt;
  const int q0 = qt * kBQ;
  const long long kv_row = bh / groups;
  const T* qb = q + (static_cast<long long>(bh) * sq + q0) * d;
  const T* kb = k + kv_row * skv * d;
  const T* vb = v + kv_row * skv * dv;

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    sq_[r * ds + c] = q0 + r < sq ? to_f32(qb[idx]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (skv + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, sq) - 1;
    n_kt = min(n_kt, last_row / kBK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                        // the previous tile is consumed
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      sk[r * ds + c] =
          k0 + r < skv ? to_f32(kb[static_cast<long long>(k0) * d + idx])
                       : 0.f;
    }
    for (int idx = tid; idx < kBK * dv; idx += kThreads) {
      const int r = idx / dv;
      sv[idx] = k0 + r < skv
                    ? to_f32(vb[static_cast<long long>(k0) * dv + idx])
                    : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq_[(4 * ty + i) * ds + c];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = sk[(tx + 16 * j) * ds + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      bool valid[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < skv && (!causal || kpos <= qpos);
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sp[(4 * ty + i) * (kBK + 1) + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(4 * ty + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) {
        const int col = tx + 16 * c;
        if (col < dv) {
          const float vv = sv[kk * dv + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<long long>(bh) * sq + qpos) * dv;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) store(o + col, acc[i][c] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int groups, int sq, int skv, int d, int dv, int causal,
           float scale, cudaStream_t stream) {
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const long long n_blocks = static_cast<long long>(n_qt) * bh;
  if (n_blocks >= (1ll << 31)) return -1;
  const size_t smem = flash_smem(d, dv);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_attn_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, smem,
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_qt, groups, sq, skv,
      d, dv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  q (bh, sq, d), k (bh / groups, skv, d), v (bh / groups,
// skv, dv) and out (bh, sq, dv), contiguous, all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1).  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for a shape
// the kernel does not take.
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                void* out, int bh, int groups, int sq,
                                int skv, int d, int dv, int causal,
                                float scale, int bf16, void* stream) {
  using namespace repro_torch;
  if (bh < 1 || groups < 1 || bh % groups != 0 || sq < 1 || skv < 1 ||
      d < 1 || d > kMaxD || dv < 1 || dv > kMaxD)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, bh, groups, sq, skv, d,
                                      dv, causal, scale, s)
              : launch<float>(q, k, v, out, bh, groups, sq, skv, d, dv,
                              causal, scale, s);
}
