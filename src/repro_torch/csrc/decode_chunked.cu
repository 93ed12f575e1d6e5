// cuSZ's coarse-grained chunked Huffman decoder: one thread a chunk.
//
// Replaces no TPU kernel.  It is the paper's yardstick, the decoder that
// Table V's speedups are taken over: the reference runs it as a vmap of a
// lax.scan (src/repro/core/huffman/decode.py:372 decode_chunked, over the
// rows of encode.py:313 encode_chunked).  A scan written in torch ops would
// launch a kernel a symbol, so the port's version is this kernel.
//
// It keeps cuSZ's structure and nothing more: each thread owns one chunk's
// row of the reference's padded [n_chunks, max_units] layout and walks it
// sequentially, chunk_symbols steps of
//   peek max_len bits at pos (bits.py:peek: the unit read clipped to the
//   row, the next unit past the row read as 0), look up (sym, len) in the
//   decode LUT, emit sym while pos < n_bits (0 after), advance by
//   max(len, 1).
// The loop stops once pos >= n_bits and the thread writes zeros for the
// rest of its row, which is the reference's output (it emits 0 there).
// No warp-cooperative decode and no re-layout of the rows: either would be
// a new decoder, and the speedup over it would measure nothing.
//
// The LUT is staged once a block in shared memory when its 2**max_len
// entries fit (3 B an entry: up to max_len 16), else read from device
// memory through the read-only path (the kGlobalLut variant), chosen by
// size before the launch (huffman_chunked.decode_chunked_lut_in_smem), as
// decode_tiles chooses.
//
// Block width: the narrowest of 32, 64, 128 and 256 threads whose grid
// fits the card in one wave (huffman_chunked.decode_chunked_geometry), so
// the chunks' threads spread over as many SMs as they can.  A warp's step
// loads from and stores to 32 rows, 32 different lines, which its SM
// serves one line at a time: the fewer warps an SM holds, the shorter
// each step.  The width changes where the threads run, not what a thread
// does.
//
// What bounds it on the H100: not the bytes (the rows once, the LUT once,
// 2 B a code written: 0.012 ms on a field of 2**24 codes), but the chain
// of dependent steps a thread runs, chunk_symbols of them, each two unit
// loads, a LUT load and a code store that its warp spreads over 32 rows.
// At 16,384 symbols a chunk that field has 1,024 chunks, 32 one-warp
// blocks on 32 SMs of 132; that is the baseline's nature.  On an H100
// 80GB HBM3 at 700 W (chip_smoke.py's width sweep) a step took ~180 ns
// with one warp an SM (2.94 ms a launch) and ~330 ns with four (5.44 ms
// in 128-thread blocks).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "smem.cuh"

namespace repro_torch {

constexpr int kChunkMaxThreads = 256;
constexpr int kSmemLimit = 232448;   // Hopper: 227 KB a block

__host__ __device__ inline int chunk_round16(int n) {
  return (n + 15) / 16 * 16;
}

// Bytes of shared memory of the shared-memory LUT variant: the uint16
// symbols, then the uint8 lengths from a 16-byte boundary.
inline long long chunk_lut_smem(int lut) {
  return static_cast<long long>(chunk_round16(2 * lut)) + lut;
}

template <bool kGlobalLut>
__global__ void __launch_bounds__(kChunkMaxThreads)
decode_chunked_kernel(const uint32_t* __restrict__ units, int n_chunks,
                      int max_units, const long long* __restrict__ chunk_bits,
                      const uint16_t* __restrict__ dec_sym,
                      const uint8_t* __restrict__ dec_len, int lut,
                      int max_len, int chunk_symbols,
                      uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* sym = dec_sym;
  const uint8_t* len = dec_len;
  if constexpr (!kGlobalLut) {
    uint16_t* s_sym = reinterpret_cast<uint16_t*>(smem);
    uint8_t* s_len = smem + chunk_round16(2 * lut);
    stage_lut(dec_sym, dec_len, lut, s_sym, s_len);
    __syncthreads();
    sym = s_sym;
    len = s_len;
  }
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const uint32_t* __restrict__ row =
      units + static_cast<long long>(c) * max_units;
  uint16_t* __restrict__ dst = out + static_cast<long long>(c) * chunk_symbols;
  const long long n_bits = chunk_bits[c];
  const int shift = 32 - max_len;
  int pos = 0;
  int k = 0;
  for (; k < chunk_symbols && pos < n_bits; ++k) {
    const int u = pos >> 5;
    const unsigned sh = static_cast<unsigned>(pos & 31);
    const uint32_t w0 = __ldg(row + min(u, max_units - 1));
    const uint32_t w1 = u + 1 < max_units ? __ldg(row + u + 1) : 0u;
    const uint32_t window = (w0 << sh) | (sh ? w1 >> (32u - sh) : 0u);
    const uint32_t win = window >> shift;
    uint16_t s;
    int l;
    if constexpr (kGlobalLut) {
      s = __ldg(sym + win);
      l = __ldg(len + win);
    } else {
      s = sym[win];
      l = len[win];
    }
    dst[k] = s;
    pos += max(l, 1);
  }
  for (; k < chunk_symbols; ++k) dst[k] = 0;
}

template <bool kGlobalLut>
int launch(const void* units, int n_chunks, int max_units,
           const void* chunk_bits, const void* dec_sym, const void* dec_len,
           int lut, int max_len, int chunk_symbols, int blocks, int threads,
           int smem, void* out, void* stream) {
  auto kernel = decode_chunked_kernel<kGlobalLut>;
  const cudaError_t allowed = allow_dynamic_smem(kernel, smem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), n_chunks, max_units,
      static_cast<const long long*>(chunk_bits),
      static_cast<const uint16_t*>(dec_sym),
      static_cast<const uint8_t*>(dec_len), lut, max_len, chunk_symbols,
      static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success).  `units` is
// uint32[n_chunks, max_units], `chunk_bits` int64[n_chunks], the LUT
// (uint16 symbols, uint8 lengths) has 1 << max_len entries read, `out` is
// uint16[n_chunks, chunk_symbols] and is written in full.  `global_lut` (0
// or 1) selects the variant that reads the LUT from device memory; the
// grid (`blocks` of `threads`, a thread a chunk) and the shared memory a
// block gets come from the caller.  Refuses (-1) before launching
// anything: a max_len outside 1-24, no chunks, no row units, a
// chunk_symbols below 1, a block that is not 1-8 whole warps, a grid with
// fewer threads than chunks, or a shared-memory LUT that `smem` cannot
// hold or Hopper cannot give.
extern "C" int repro_decode_chunked(const void* units, int n_chunks,
                                    int max_units, const void* chunk_bits,
                                    const void* dec_sym, const void* dec_len,
                                    int max_len, int chunk_symbols,
                                    int global_lut, int blocks, int threads,
                                    int smem, void* out, void* stream) {
  using namespace repro_torch;
  if (max_len < 1 || max_len > 24) return -1;
  if (n_chunks < 1 || max_units < 1 || chunk_symbols < 1) return -1;
  if (threads < 32 || threads > kChunkMaxThreads || threads % 32 != 0) {
    return -1;
  }
  if (blocks < 1 || static_cast<long long>(blocks) * threads < n_chunks) {
    return -1;
  }
  const int lut = 1 << max_len;
  if (smem < 0 || smem > kSmemLimit) return -1;
  if (!global_lut && smem < chunk_lut_smem(lut)) return -1;
  return global_lut
             ? launch<true>(units, n_chunks, max_units, chunk_bits, dec_sym,
                            dec_len, lut, max_len, chunk_symbols, blocks,
                            threads, smem, out, stream)
             : launch<false>(units, n_chunks, max_units, chunk_bits, dec_sym,
                             dec_len, lut, max_len, chunk_symbols, blocks,
                             threads, smem, out, stream);
}
