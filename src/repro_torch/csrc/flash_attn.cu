// Flash-attention forward: out = softmax(scale * q k^T [causal mask]) v,
// with an online softmax over kv tiles, in float32 inside.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py:flash_attention
// (body _flash_kernel).  On the TPU the kv blocks were a sequential grid
// axis and the running max m, sum l and accumulator acc sat in VMEM scratch
// from one grid step to the next.  CUDA blocks run in no order, so here one
// block owns one (bh, 64-row query tile) and runs the whole kv loop itself:
// m, l and acc stay in registers for the block's life and nothing carries
// across blocks.  Tiles wholly above the causal diagonal are never loaded
// (Pallas skips them with pl.when); masking is top-left aligned (key j is
// seen by query i iff j <= i, as Pallas masks).  Any Sq and Skv work: the
// ragged last tiles are masked.
//
// Beyond the Pallas kernel, the two masking arguments of the reference's
// XLA blockwise_attn (src/repro/models/attention.py, which the port runs
// through this kernel): query i sits at qpos = q_offset + i and sees key j
// iff (!causal || j <= qpos) && (window == 0 || j > qpos - window).  The kv
// loop of a block runs from the first tile any of its rows can see (tiles
// wholly below the window are never loaded, the double-buffer prologue
// loads that first tile) to the last.  A row may see nothing in the tile
// it starts with; its running max stays -inf there and the rescale takes
// mu = 0, so exp2(-inf - mu) is 0 and no NaN arises.  The wrapper refuses
// shapes with a row that sees no key at all.  GQA: query row bh reads kv
// row bh / groups, so the caller does not repeat the kv heads.  The output
// is acc / max(l, 1e-30), cast once to the input type.
//
// What bounds it on the H100: the products.  At the qwen3-0.6b prefill
// shape (B 4, 16 query heads, 8 kv heads, S 1024, D 128, causal) the floor
// is 17.2 GFLOP at 989 TFLOP/s bf16 = 0.017 ms against 50 MB of Q, K, V
// and O at 3.35 TB/s = 0.015 ms; at h2o-danube's (B 1, 32 query heads, 8
// kv heads, S 8192, D 80, window 4096) the window keeps 25.2 M of the 33.6
// M causal pairs a head, 258 GFLOP = 0.26 ms, and D 80 runs padded to 128
// (the template widths below).  Two kernels:
//
// bfloat16 (the prefill), flash_attn_mma_kernel, FlashAttention-2's shape
// on the tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate):
//   * a block of 4 warps owns 64 query rows, 16 a warp, so each row's max
//     and sum live in one quad of lanes (shuffles over lanes 1 and 2);
//     blocks are ordered heaviest query tile first across all bh rows;
//   * Q is copied into shared memory once (cp.async) and its A fragments
//     (ldmatrix) stay in registers for the whole kv loop;
//   * K and V come in tiles of 64 rows, bf16, two buffers deep: the 16-byte
//     cp.async.cg copies of tile t + 1 are in flight while tile t computes.
//     Rows are padded by 16 bytes, so the 8 rows an ldmatrix phase reads
//     start in 8 different bank quads: K (ldmatrix) and V (ldmatrix.trans)
//     load without bank conflicts;
//   * S = Q K^T on the tensor cores, scaled by scale * log2(e) in float32,
//     exponentiated by ex2.approx.ftz (one MUFU op; exp2f adds a denormal
//     path that p, at most 1, never needs); masks only on diagonal and
//     ragged tiles.  p is rounded to bf16 once, packed in pairs: the C
//     fragments of two adjacent n8 tiles of P are the A fragment of one
//     k16 step of P V, so P never touches shared memory.  The row sum l
//     adds the packed (rounded) p, so the weights P V applies sum to l
//     exactly;
//   * the epilogue divides by max(l, 1e-30) in float32, rounds to bf16 once
//     and stages the tile in shared memory for 16-byte coalesced stores.
//   D up to 192 and Dv up to 128 are zero-padded in shared memory to 64,
//   128 or 192 (D) and 64 or 128 (Dv) (template arguments); the products
//   run over the padded width in straight-line code, the k16 steps
//   outermost, so that neighbouring MMAs write different accumulators and
//   no branch splits them.  Rows not a multiple of 8 elements long (or
//   unaligned tensors) are staged by plain loads instead of cp.async; the
//   arithmetic is the same.
//
//   The (192, 128) template is multi-head latent attention's prefill
//   (deepseek-v3: a query/key head of qk_nope 128 + qk_rope 64, a value
//   head of 128).  Its Q fragments take 48 registers a thread beside the
//   64 of the O accumulator and 32 of S, and its tiles take 2 x (64 x 200
//   + 2 x 64 x 200 + 2 x 64 x 136) = 111,616 bytes of shared memory: two
//   blocks an SM, past the 48 KiB default, so launch_mma opts in.  At
//   deepseek's prefill shape (B 2, 128 heads, S 2048, causal) the floor is
//   the products: 537 M pairs x 2 x (192 + 128) = 344 GFLOP, 0.348 ms at
//   989 TFLOP/s, against 671 MB of Q, K, V and O, 0.200 ms.
//
// float32 (only the float32 step-decode check's forward runs it),
// flash_attn_f32_kernel: scalar float32 FMAs from shared memory, q scaled
// in float32 first, p kept in float32; its gate against the plain version
// (2e-5) rules out bf16 or TF32 tensor-core products.  It is held by
// shared-memory loads (about 1.1 a FMA), far above the floor.  It takes D
// up to 192 and Dv up to 128: its accumulator holds Dv columns, its
// shared Q and K rows D + 1 floats.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem.cuh"

namespace repro_torch {

constexpr int kMaxD = 192;       // largest D (query and key head)
constexpr int kMaxDv = 128;      // largest Dv (value head)

// ---------------------------------------------------------------------------
// bfloat16: tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;       // query rows a block (16 a warp)
constexpr int kMmaBK = 64;       // kv rows a tile
constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read).
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x by one MUFU op, subnormal results flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// The low and the high bf16 of a packed pair, as float.
__device__ __forceinline__ float lo_bf16(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// Padded shared-memory row strides (elements) and the bytes a block uses.
template <int DP, int DVP>
struct MmaTile {
  static constexpr int QS = DP + 8;
  static constexpr int VS = DVP + 8;
  static constexpr size_t smem =
      sizeof(bf16) * (static_cast<size_t>(kMmaBQ) * QS +
                      2 * static_cast<size_t>(kMmaBK) * QS +
                      2 * static_cast<size_t>(kMmaBK) * VS);
};

// Rows row0 .. row0 + 63 of a (rows, cols) bf16 matrix into shared memory
// with row stride `stride`, zero-padded to P columns; rows >= n_rows are
// zero.  vec: cols % 8 == 0 and src 16-byte aligned, copied by cp.async
// (the padding chunks zero-filled); otherwise plain loads of the cols
// columns (the padding was zeroed once).
template <int P>
__device__ __forceinline__ void load_tile(bf16* dst, int stride,
                                          const bf16* src, int row0,
                                          int n_rows, int cols, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int CPR = P / 8;  // 16-byte chunks a padded row
    const int cpr = cols >> 3;
#pragma unroll
    for (int idx = tid; idx < kMmaBK * CPR; idx += kMmaThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const bool ok = row0 + r < n_rows && c < cpr;
      const bf16* g =
          ok ? src + static_cast<long long>(row0 + r) * cols + c * 8 : src;
      cp_async16(dst + r * stride + c * 8, g, ok);
    }
  } else {
    for (int idx = tid; idx < kMmaBK * cols; idx += kMmaThreads) {
      const int r = idx / cols, c = idx - r * cols;
      dst[r * stride + c] =
          row0 + r < n_rows
              ? src[static_cast<long long>(row0 + r) * cols + c]
              : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kMmaThreads) flash_attn_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int n_qt, int bh_n,
    int groups, int sq, int skv, int d, int dv, int causal, int window,
    int q_offset, float scale_log2, int vec) {
  using Tile = MmaTile<DP, DVP>;
  constexpr int QS = Tile::QS, VS = Tile::VS;
  constexpr int NT = kMmaBK / 8;   // n8 tiles of S a kv tile
  constexpr int NO = DVP / 8;      // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq_ = reinterpret_cast<bf16*>(smem_raw);  // [64][QS]
  bf16* sk = sq_ + kMmaBQ * QS;                   // [2][64][QS]
  bf16* sv = sk + 2 * kMmaBK * QS;                // [2][64][VS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // heaviest query tiles first across every bh row: causal work grows with
  // the tile, and neighbouring blocks share their kv row in L2
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_n;
  const int bh = static_cast<int>(blockIdx.x) % bh_n;
  const int q0 = qt * kMmaBQ;
  const long long kv_row = bh / groups;
  const bf16* qb = q + static_cast<long long>(bh) * sq * d;
  const bf16* kb = k + kv_row * skv * d;
  const bf16* vb = v + kv_row * skv * dv;

  // plain loads never write the padding columns: zero them once
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (!vec && d < DP)
    for (int idx = tid; idx < 3 * kMmaBK * (DP - d); idx += kMmaThreads) {
      const int r = idx / (DP - d);
      sq_[r * QS + d + idx - r * (DP - d)] = zero;
    }
  if (!vec && dv < DVP)
    for (int idx = tid; idx < 2 * kMmaBK * (DVP - dv); idx += kMmaThreads) {
      const int r = idx / (DVP - dv);
      sv[r * VS + dv + idx - r * (DVP - dv)] = zero;
    }

  // kv tiles [kt0, n_kt): the loop bounds come from the tile's rows alone,
  // not from the block order
  const int qa = q_offset + q0;  // absolute position of the tile's row 0
  int n_kt = (skv + kMmaBK - 1) / kMmaBK;
  if (causal) {
    const int last_key = qa + min(kMmaBQ, sq - q0) - 1;
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / kMmaBK + 1);
  }
  const int kt0 = window > 0 && qa - window + 1 > 0
                      ? (qa - window + 1) / kMmaBK
                      : 0;
  load_tile<DP>(sq_, QS, qb, q0, sq, d, vec, tid);
  cp_async_commit();
  load_tile<DP>(sk, QS, kb, kt0 * kMmaBK, skv, d, vec, tid);
  load_tile<DVP>(sv, VS, vb, kt0 * kMmaBK, skv, dv, vec, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldmatrix_x4(qf[kk], sq_ + (warp * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * QS +
                            kk * 16 + (lane >> 4) * 8);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_a = qa + warp * 16 + g, row_b = row_a + 8;  // absolute

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < n_kt) {
      load_tile<DP>(sk + (buf ^ 1) * kMmaBK * QS, QS, kb, (kt + 1) * kMmaBK,
                    skv, d, vec, tid);
      load_tile<DVP>(sv + (buf ^ 1) * kMmaBK * VS, VS, vb, (kt + 1) * kMmaBK,
                     skv, dv, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ck = sk + buf * kMmaBK * QS;
    const bf16* cv = sv + buf * kMmaBK * VS;
    const int k0 = kt * kMmaBK;

    // S = Q K^T over the zero-padded width, straight-line code: 16 keys (two
    // n8 tiles) an ldmatrix.x4, the k16 steps outermost so that neighbouring
    // MMAs write different accumulators
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ck + (np * 16 + (lane & 7) + (lane >> 4) * 8) * QS +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax in log2 units; rows g and g + 8 of the warp's 16
    const bool masked = k0 + kMmaBK > skv ||
                        (causal && k0 + kMmaBK - 1 > qa) ||
                        (window > 0 && k0 <= qa + kMmaBQ - 1 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (key >= skv || (causal && key > row) ||
              (window > 0 && key <= row - window))
            x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mu[h] = mx[h] == -INFINITY ? 0.f : mx[h];
      alpha[h] = fast_exp2(m[h] - mu[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // p rounded to bf16 once, packed as the A fragments of P V
    uint32_t pk[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pk[j][h] = pack_bf16(fast_exp2(s[j][2 * h] - mu[h]),
                             fast_exp2(s[j][2 * h + 1] - mu[h]));
        l[h] += lo_bf16(pk[j][h]) + hi_bf16(pk[j][h]);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the C fragments of S tiles 2kk and 2kk + 1 are the A
    // fragment of k16 step kk
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                             pk[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < DVP / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, cv + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * VS +
                                 np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  if (kt0 >= n_kt) {  // no tile: the prologue's copies land before reuse
    cp_async_wait<0>();
    __syncthreads();
  }

  // epilogue: O / max(l, 1e-30) in float32, rounded once, staged in the
  // first V buffer (every copy has landed and every warp is past its reads)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  bf16* so = sv;  // [64][VS]
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(so + (warp * 16 + g) * VS + col) =
        pack_bf16(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(so + (warp * 16 + g + 8) * VS + col) =
        pack_bf16(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
  bf16* ob = out + (static_cast<long long>(bh) * sq + q0 + warp * 16) * dv;
  const int rows = min(16, sq - q0 - warp * 16);
  if (vec) {
    const int cpr = dv >> 3;
    for (int idx = lane; idx < rows * cpr; idx += 32) {
      const int r = idx / cpr, c = idx - r * cpr;
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * dv + c * 8) =
          *reinterpret_cast<const uint4*>(so + (warp * 16 + r) * VS + c * 8);
    }
  } else {
    for (int idx = lane; idx < rows * dv; idx += 32) {
      const int r = idx / dv, c = idx - r * dv;
      ob[static_cast<long long>(r) * dv + c] = so[(warp * 16 + r) * VS + c];
    }
  }
}

template <int DP, int DVP>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int bh, int groups, int sq, int skv, int d, int dv,
               int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  const int n_qt = (sq + kMmaBQ - 1) / kMmaBQ;
  const long long n_blocks = static_cast<long long>(n_qt) * bh;
  if (n_blocks >= (1ll << 31)) return -1;
  constexpr size_t smem = MmaTile<DP, DVP>::smem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_mma_kernel<DP, DVP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const int vec = aligned && d % 8 == 0 && dv % 8 == 0;
  flash_attn_mma_kernel<DP, DVP>
      <<<static_cast<unsigned>(n_blocks), kMmaThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out), n_qt, bh,
          groups, sq, skv, d, dv, causal, window, q_offset, scale * kLog2e,
          vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int bh, int groups, int sq, int skv, int d, int dv,
                int causal, int window, int q_offset, float scale,
                cudaStream_t s) {
  if (d <= 64)
    return dv <= 64 ? launch_mma<64, 64>(q, k, v, out, bh, groups, sq, skv,
                                         d, dv, causal, window, q_offset,
                                         scale, s)
                    : launch_mma<64, 128>(q, k, v, out, bh, groups, sq, skv,
                                          d, dv, causal, window, q_offset,
                                          scale, s);
  if (d <= 128)
    return dv <= 64 ? launch_mma<128, 64>(q, k, v, out, bh, groups, sq, skv,
                                          d, dv, causal, window, q_offset,
                                          scale, s)
                    : launch_mma<128, 128>(q, k, v, out, bh, groups, sq, skv,
                                           d, dv, causal, window, q_offset,
                                           scale, s);
  return dv <= 64 ? launch_mma<192, 64>(q, k, v, out, bh, groups, sq, skv, d,
                                        dv, causal, window, q_offset, scale,
                                        s)
                  : launch_mma<192, 128>(q, k, v, out, bh, groups, sq, skv,
                                         d, dv, causal, window, q_offset,
                                         scale, s);
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 32;          // kv rows a tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kAccCols = kMaxDv / 16;
constexpr float kNegInf = -1e30f;

inline size_t flash_smem(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (d + 1) +
                          static_cast<size_t>(kBK) * (d + 1) +
                          static_cast<size_t>(kBK) * dv +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

// Per 32-row kv tile the block stages K and V in shared memory (Q was
// staged once, scaled by `scale` as the Pallas kernel scales q); computes
// its 64 x 32 scores with scalar FMAs (thread (ty, tx) of 16 x 16 owns rows
// 4ty..4ty+3 and columns tx, tx + 16); masks, takes the row max and sum by
// shuffles over the 16 lanes of a row, rescales acc by exp(m_old - m_new)
// and writes p to shared memory; adds p v to acc.
__global__ void __launch_bounds__(kThreads) flash_attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int n_qt,
    int groups, int sq, int skv, int d, int dv, int causal, int window,
    int q_offset, float scale) {
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
  const float* qb = q + (static_cast<long long>(bh) * sq + q0) * d;
  const float* kb = k + kv_row * skv * d;
  const float* vb = v + kv_row * skv * dv;

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    sq_[r * ds + c] = q0 + r < sq ? qb[idx] * scale : 0.f;
  }

  float m[4], l[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[i][c] = 0.f;
  }

  // kv tiles [kt0, n_kt), as the bf16 kernel bounds them
  const int qa = q_offset + q0;
  int n_kt = (skv + kBK - 1) / kBK;
  if (causal) {
    const int last_key = qa + min(kBQ, sq - q0) - 1;
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / kBK + 1);
  }
  const int kt0 =
      window > 0 && qa - window + 1 > 0 ? (qa - window + 1) / kBK : 0;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                        // the previous tile is consumed
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      sk[r * ds + c] =
          k0 + r < skv ? kb[static_cast<long long>(k0) * d + idx] : 0.f;
    }
    for (int idx = tid; idx < kBK * dv; idx += kThreads) {
      const int r = idx / dv;
      sv[idx] = k0 + r < skv ? vb[static_cast<long long>(k0) * dv + idx]
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
      const int qpos = qa + 4 * ty + i;
      bool valid[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < skv && (!causal || kpos <= qpos) &&
                   (window <= 0 || kpos > qpos - window);
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
    float* o = out + (static_cast<long long>(bh) * sq + qpos) * dv;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) o[col] = acc[i][c] / den;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int groups, int sq, int skv, int d, int dv,
               int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const long long n_blocks = static_cast<long long>(n_qt) * bh;
  if (n_blocks >= (1ll << 31)) return -1;
  const size_t smem = flash_smem(d, dv);
  const cudaError_t allowed = allow_dynamic_smem(flash_attn_f32_kernel, smem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  flash_attn_f32_kernel<<<static_cast<unsigned>(n_blocks), kThreads, smem,
                          stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n_qt, groups,
      sq, skv, d, dv, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  q (bh, sq, d), k (bh / groups, skv, d), v (bh / groups,
// skv, dv) and out (bh, sq, dv), contiguous, all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1).  window: the sliding window, 0 for none; q_offset:
// the absolute position of query 0 (the wrapper keeps |q_offset|, window
// and q_offset + sq below 2**30).  Launches on `stream`, allocates nothing,
// does not synchronize; returns cudaGetLastError() (0 on success), or -1
// for a shape the kernel does not take.
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                void* out, int bh, int groups, int sq,
                                int skv, int d, int dv, int causal,
                                int window, int q_offset, float scale,
                                int bf16, void* stream) {
  using namespace repro_torch;
  if (bh < 1 || groups < 1 || bh % groups != 0 || sq < 1 || skv < 1 ||
      d < 1 || d > kMaxD || dv < 1 || dv > kMaxDv || window < 0 ||
      window >= (1 << 30) || q_offset <= -(1 << 30) ||
      q_offset >= (1 << 30) - sq)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bf16(q, k, v, out, bh, groups, sq, skv, d, dv, causal,
                            window, q_offset, scale, s)
              : launch_f32(q, k, v, out, bh, groups, sq, skv, d, dv, causal,
                           window, q_offset, scale, s);
}
