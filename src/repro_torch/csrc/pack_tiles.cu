// Huffman bit-pack: the MSB-first uint32 units of the stream, from the
// symbols, their codeword start bits and the encoder tables.
//
// Replaces the TPU kernel src/repro/kernels/huffman_encode.py:pack_tiles
// (body _pack_kernel; entry ops.encode_bitpack).  The reference first
// builds (n_tiles, sym_max) arrays of code, length and start for every
// tile of 8 units at the ops level, 12 B a lane with sym_max = 256 /
// min_len + 2: at min_len 1 on isabel3d that is ~0.9 GB of metadata for a
// 9.2 MB payload.  Here no such arrays exist.  Each block owns a tile of
// `tile_units` output units (bits [B, E)) and
//   1. finds its symbols [upper_bound(starts, B) - 1, lower_bound(starts,
//      E)) with two binary searches over the exclusive scan `starts`;
//   2. walks them 32 at a time, one warp a chunk, lane l on symbol
//      chunk + l, so each warp's loads of symbols and starts are
//      coalesced; a lane reads its code and length from enc_code /
//      enc_len through the read-only path and places the codeword in the
//      64-bit window of its first unit u = floor(p / 32), p = start - B:
//        v = (uint64)code << (64 - o - len),  o = p - 32u,
//      hi = v >> 32 belongs to unit u and lo = (uint32)v to unit u + 1 (a
//      codeword of <= 32 bits spans at most two units; the shift is in
//      [1, 63], so no shift by 32 or 64 is undefined);
//   3. for each unit the chunk touches (about its bits / 32 + 2 of them),
//      ORs the lanes' halves for that unit across the warp
//      (__reduce_or_sync), and one lane ORs the word into the tile in
//      shared memory (atomicOr: the neighbouring chunk may touch the same
//      unit); halves outside the tile are dropped, the neighbouring tile
//      emits them;
//   4. writes the tile once, coalesced.
//
// What bounds it on the H100: 2 B of symbol and 4 B of start read per code,
// plus the payload written: 0.048 ms for isabel3d (25 M codes, 9.2 MB) at
// 3.35 TB/s.  The two binary searches per tile read a few cached lines.
// (A first version gave each thread a contiguous run of ~43 symbols: a
// warp's loads then touched 64 lines at once, more than L1 kept for the
// resident blocks.)
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace repro_torch {

// First index in [0, n) whose start exceeds (kUpper) or reaches (!kUpper)
// `bit`; n if none.
template <bool kUpper>
__device__ __forceinline__ long long search(const int* __restrict__ starts,
                                            long long n, long long bit) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long s = __ldg(starts + mid);
    if (kUpper ? s <= bit : s < bit) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(256) pack_tiles_kernel(
    const uint16_t* __restrict__ symbols, const int* __restrict__ starts,
    long long n, const uint32_t* __restrict__ enc_code,
    const uint8_t* __restrict__ enc_len, int n_codes, long long n_units,
    int tile_units, uint32_t* __restrict__ units) {
  extern __shared__ uint32_t tile[];
  __shared__ long long range[2];
  const long long unit0 = static_cast<long long>(blockIdx.x) * tile_units;
  const long long bit0 = unit0 * 32;
  for (int i = threadIdx.x; i < tile_units; i += blockDim.x) tile[i] = 0;
  if (threadIdx.x == 0) {
    const long long first = search<true>(starts, n, bit0) - 1;
    range[0] = first < 0 ? 0 : first;
  } else if (threadIdx.x == 32) {
    range[1] = search<false>(starts, n,
                             bit0 + static_cast<long long>(tile_units) * 32);
  }
  __syncthreads();
  const long long end = range[1];
  const int lane = threadIdx.x & 31;
  const long long stride = blockDim.x;  // 32 symbols a warp, all warps
  for (long long chunk = range[0] + (threadIdx.x - lane); chunk < end;
       chunk += stride) {
    const long long i = chunk + lane;
    bool active = false;
    int u = 0;
    uint32_t hi = 0, lo = 0;
    if (i < end) {
      int sym = __ldg(symbols + i);
      sym = sym < n_codes ? sym : n_codes - 1;
      const int len = __ldg(enc_len + sym);
      if (len >= 1 && len <= 32) {  // a length of 0: no codeword
        const uint32_t code = __ldg(enc_code + sym);
        const long long p = static_cast<long long>(__ldg(starts + i)) - bit0;
        u = static_cast<int>(p >= 0 ? p / 32 : -((31 - p) / 32));
        const int o = static_cast<int>(p - 32ll * u);
        const uint64_t v = static_cast<uint64_t>(code) << (64 - o - len);
        hi = static_cast<uint32_t>(v >> 32);
        lo = static_cast<uint32_t>(v);
        active = true;
      }
    }
    // The units the chunk touches, clipped to the tile (warp-uniform).
    const int first = max(__reduce_min_sync(0xffffffffu,
                                            active ? u : INT_MAX), 0);
    const int last = min(__reduce_max_sync(0xffffffffu,
                                           active ? u + 1 : INT_MIN),
                         tile_units - 1);
    for (int w = first; w <= last; ++w) {
      const uint32_t mine = (active && u == w ? hi : 0u) |
                            (active && u + 1 == w ? lo : 0u);
      const uint32_t word = __reduce_or_sync(0xffffffffu, mine);
      if (lane == 0 && word != 0) atomicOr(tile + w, word);
    }
  }
  __syncthreads();
  const long long n_here = min(static_cast<long long>(tile_units),
                               n_units - unit0);
  for (int i = threadIdx.x; i < n_here; i += blockDim.x) {
    units[unit0 + i] = tile[i];
  }
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns cudaGetLastError() (0 on success), or -1 for n < 1,
// n_units < 1, n_codes < 1 or tile_units outside [1, 2^15].  `starts` is
// the int32 exclusive scan of the symbols' code lengths; `units` receives
// n_units uint32 words (every one written).
extern "C" int repro_pack_tiles(const void* symbols, const void* starts,
                                long long n, const void* enc_code,
                                const void* enc_len, int n_codes,
                                long long n_units, int tile_units,
                                void* units, void* stream) {
  using namespace repro_torch;
  if (n < 1 || n_units < 1 || n_codes < 1 || tile_units < 1 ||
      tile_units > (1 << 15)) {
    return -1;
  }
  const long long n_tiles = (n_units + tile_units - 1) / tile_units;
  if (n_tiles >= (1ll << 31)) return -1;
  const size_t smem = 4 * static_cast<size_t>(tile_units);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pack_tiles_kernel<<<static_cast<unsigned>(n_tiles), 256, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(symbols), static_cast<const int*>(starts),
      n, static_cast<const uint32_t*>(enc_code),
      static_cast<const uint8_t*>(enc_len), n_codes, n_units, tile_units,
      static_cast<uint32_t*>(units));
  return static_cast<int>(cudaGetLastError());
}
