// Huffman bit-pack: the MSB-first uint32 units of the stream, from the
// symbols, their codeword start bits and the encoder tables.
//
// Replaces the TPU kernel src/repro/kernels/huffman_encode.py:pack_tiles
// (body _pack_kernel; entry ops.encode_bitpack).  The reference first
// builds (n_tiles, sym_max) arrays of code, length and start for every
// tile of 8 units at the ops level, 12 B a lane with sym_max = 256 /
// min_len + 2: at min_len 1 on isabel3d that is ~0.9 GB of metadata for a
// 9.2 MB payload.  Here no such arrays exist: each block owns a tile of
// `tile_units` output units (bits [B, E)) and finds its symbols itself.
//
// What bounds it on the H100: 2 B of symbol and 4 B of start read per code,
// plus the payload written: 0.048 ms for isabel3d (25 M codes, 9.2 MB) at
// 3.35 TB/s.  The first port took a fixed 1,024-unit tile (6 blocks for a
// 32,768-value KV page on 132 SMs), searched its symbol range with a
// binary search (15 dependent loads on a page), walked the symbols 32 at a
// time with a gathered table load each, and ORed each unit of a chunk into
// the tile with a warp reduction and a shared atomic: 4.6x the bound on
// isabel3d.  This design:
//   1. the tile comes from the stream's size (the wrapper's
//      huffman_encode.pack_tiles_geometry): at least ~2 blocks an SM where
//      the stream allows, at most 1,024 units, and a block as wide as the
//      tile's symbols need (64-256 threads);
//   2. enc_code / enc_len are staged in shared memory once a block (5 B an
//      entry: 5 KB at radius 512); a table past what shared memory holds
//      beside the tile is read from device memory (kSmemTables false),
//      chosen by size before the launch;
//   3. the tile's symbols [upper_bound(starts, B) - 1, lower_bound(starts,
//      E)) are found by two warps at once, each a 33-way search (one probe
//      a lane, a ballot a step): 3 dependent loads on a page, 5 on
//      isabel3d;
//   4. each thread takes runs of 8 consecutive symbols (one 16-byte load of
//      symbols, two of starts) and places each codeword in the 64-bit
//      window of its first unit u = floor(p / 32), p = start - B:
//        v = (uint64)code << (64 - o - len),  o = p - 32u,
//      hi = v >> 32 to unit u and lo = (uint32)v to unit u + 1 (a codeword
//      of <= 32 bits spans at most two units; the shift is in [1, 63]).
//      It ORs a unit's codewords in a register and writes each unit it
//      owns whole (every bit of it inside its run) to the tile with a
//      plain store; only its edge units, the first and the last one or
//      two, which the runs before and after may share, take a shared
//      atomicOr.  Halves outside the tile are dropped: the neighbouring
//      tile emits them;
//   5. writes the tile once, coalesced.
// `starts` must be non-decreasing (it is an exclusive scan of lengths).
#include <cuda_runtime.h>

#include <cstdint>

#include "smem.cuh"

namespace repro_torch {

constexpr int kRun = 8;  // symbols a thread takes at once: 16 B of uint16

// First index in [0, n) whose start exceeds (kUpper) or reaches (!kUpper)
// `bit`; n if none.  Called by all 32 lanes of a warp: each step probes 32
// points that cut [lo, hi) into 33 parts and keeps the part the first
// true probe closes; a range of at most 32 is probed whole.
template <bool kUpper>
__device__ long long warp_search(const int* __restrict__ starts, long long n,
                                 long long bit) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long len = hi - lo;
    const bool whole = len <= 32;
    const long long idx = whole ? lo + lane : lo + ((lane + 1) * len) / 33;
    bool past = true;  // a lane past the range counts as past the bit
    if (idx < hi) {
      const long long s = __ldg(starts + idx);
      past = kUpper ? s > bit : s >= bit;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, past);
    if (whole) return ballot ? lo + __ffs(ballot) - 1 : hi;
    if (ballot == 0) {
      lo = lo + (32 * len) / 33 + 1;
    } else {
      const int f = __ffs(ballot) - 1;
      hi = lo + ((f + 1) * len) / 33;
      if (f > 0) lo = lo + (f * len) / 33 + 1;
    }
  }
  return lo;
}

// ORs `word` into unit u of the tile if u lies in it: a plain store for a
// unit the thread owns whole, else an atomic.
__device__ __forceinline__ void flush(uint32_t* tile, int tile_units, int u,
                                      uint32_t word, bool shared_unit) {
  if (word == 0 || u < 0 || u >= tile_units) return;
  if (shared_unit) {
    atomicOr(tile + u, word);
  } else {
    tile[u] = word;
  }
}

__host__ __device__ constexpr size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// kSmemTables: the encoder tables are staged in shared memory after the
// tile.  kVec: symbols and starts are 16-byte aligned, so a whole run is
// one load of symbols and two of starts.
template <bool kSmemTables, bool kVec>
__global__ void __launch_bounds__(256) pack_tiles_kernel(
    const uint16_t* __restrict__ symbols, const int* __restrict__ starts,
    long long n, const uint32_t* __restrict__ enc_code,
    const uint8_t* __restrict__ enc_len, int n_codes, long long n_units,
    int tile_units, uint32_t* __restrict__ units) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_code = reinterpret_cast<uint32_t*>(
      smem + round16(4 * static_cast<size_t>(tile_units)));
  uint8_t* s_len = reinterpret_cast<uint8_t*>(s_code) +
                   round16(4 * static_cast<size_t>(n_codes));
  __shared__ long long range[2];
  const long long unit0 = static_cast<long long>(blockIdx.x) * tile_units;
  const long long bit0 = unit0 * 32;
  for (int i = threadIdx.x; i < tile_units; i += blockDim.x) tile[i] = 0;
  if (kSmemTables) {
#pragma unroll 4
    for (int i = threadIdx.x; i < n_codes; i += blockDim.x) {
      s_code[i] = __ldg(enc_code + i);
      s_len[i] = __ldg(enc_len + i);
    }
  }
  if (threadIdx.x < 32) {
    const long long lo = warp_search<true>(starts, n, bit0) - 1;
    if (threadIdx.x == 0) range[0] = lo < 0 ? 0 : lo;
  } else if (threadIdx.x < 64) {
    const long long hi = warp_search<false>(
        starts, n, bit0 + static_cast<long long>(tile_units) * 32);
    if (threadIdx.x == 32) range[1] = hi;
  }
  __syncthreads();
  const long long first = range[0];
  const long long end = range[1];
  for (long long i0 = (first / kRun + threadIdx.x) * kRun; i0 < end;
       i0 += static_cast<long long>(blockDim.x) * kRun) {
    uint16_t sym[kRun];
    int start[kRun];
    if (kVec && i0 + kRun <= n) {
      const uint4 sv = __ldg(reinterpret_cast<const uint4*>(symbols + i0));
      const int4 s0 = __ldg(reinterpret_cast<const int4*>(starts + i0));
      const int4 s1 = __ldg(reinterpret_cast<const int4*>(starts + i0 + 4));
      const uint32_t words[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sym[2 * e] = static_cast<uint16_t>(words[e]);
        sym[2 * e + 1] = static_cast<uint16_t>(words[e] >> 16);
      }
      start[0] = s0.x; start[1] = s0.y; start[2] = s0.z; start[3] = s0.w;
      start[4] = s1.x; start[5] = s1.y; start[6] = s1.z; start[7] = s1.w;
    } else {
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const bool in = i0 + e < n;
        sym[e] = in ? __ldg(symbols + i0 + e) : uint16_t{0};
        start[e] = in ? __ldg(starts + i0 + e) : 0;
      }
    }
    // cur holds unit cu's bits, nxt unit cu + 1's; the first unit the run
    // flushes and its last two may be shared with the runs beside it.
    uint32_t cur = 0, nxt = 0;
    int cu = 0;
    bool started = false, first_flush = true;
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      const long long i = i0 + e;
      if (i < first || i >= end) continue;
      int s = sym[e];
      s = s < n_codes ? s : n_codes - 1;
      const int len = kSmemTables ? s_len[s] : __ldg(enc_len + s);
      if (len < 1 || len > 32) continue;  // a length of 0: no codeword
      const uint32_t code = kSmemTables ? s_code[s] : __ldg(enc_code + s);
      const long long pl = start[e] - bit0;
      if (pl <= -32) continue;  // wholly before the tile
      const int p = static_cast<int>(pl);
      const int u = p >= 0 ? p / 32 : -1;
      const int o = p - 32 * u;
      const uint64_t v = static_cast<uint64_t>(code) << (64 - o - len);
      if (!started) {
        cu = u;
        started = true;
      } else if (u != cu) {
        flush(tile, tile_units, cu, cur, first_flush);
        first_flush = false;
        if (u == cu + 1) {
          cur = nxt;
        } else {
          flush(tile, tile_units, cu + 1, nxt, false);
          cur = 0;
        }
        nxt = 0;
        cu = u;
      }
      cur |= static_cast<uint32_t>(v >> 32);
      nxt |= static_cast<uint32_t>(v);
    }
    if (started) {
      flush(tile, tile_units, cu, cur, true);
      flush(tile, tile_units, cu + 1, nxt, true);
    }
  }
  __syncthreads();
  const long long n_here = min(static_cast<long long>(tile_units),
                               n_units - unit0);
  for (int i = threadIdx.x; i < n_here; i += blockDim.x) {
    units[unit0 + i] = tile[i];
  }
}

template <bool kSmemTables, bool kVec>
int launch(const uint16_t* symbols, const int* starts, long long n,
           const uint32_t* enc_code, const uint8_t* enc_len, int n_codes,
           long long n_units, int tile_units, unsigned blocks, int threads,
           size_t smem, uint32_t* units, cudaStream_t stream) {
  const cudaError_t allowed =
      allow_dynamic_smem(pack_tiles_kernel<kSmemTables, kVec>, smem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  pack_tiles_kernel<kSmemTables, kVec><<<blocks, threads, smem, stream>>>(
      symbols, starts, n, enc_code, enc_len, n_codes, n_units, tile_units,
      units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// C entry point.  Launches on `stream`, allocates nothing, does not
// synchronize; returns the CUDA error (0 on success), or -1 for n < 1,
// n_units < 1, n_codes < 1, tile_units outside [1, 2^15] or threads not a
// multiple of 32 in [64, 256].  The geometry (tile_units, threads,
// tables_in_smem) is the wrapper's huffman_encode.pack_tiles_geometry;
// shared memory is the tile, then with tables_in_smem the tables, each
// from a 16-byte boundary.  `starts` is the int32 exclusive scan of the
// symbols' code lengths; `units` receives n_units uint32 words (every one
// written).
extern "C" int repro_pack_tiles(const void* symbols, const void* starts,
                                long long n, const void* enc_code,
                                const void* enc_len, int n_codes,
                                long long n_units, int tile_units,
                                int threads, int tables_in_smem, void* units,
                                void* stream) {
  using namespace repro_torch;
  if (n < 1 || n_units < 1 || n_codes < 1 || tile_units < 1 ||
      tile_units > (1 << 15) || threads < 64 || threads > 256 ||
      threads % 32 != 0) {
    return -1;
  }
  const long long n_tiles = (n_units + tile_units - 1) / tile_units;
  if (n_tiles >= (1ll << 31)) return -1;
  size_t smem = round16(4 * static_cast<size_t>(tile_units));
  if (tables_in_smem) {
    smem += round16(4 * static_cast<size_t>(n_codes)) +
            round16(static_cast<size_t>(n_codes));
  }
  const auto* sp = static_cast<const uint16_t*>(symbols);
  const auto* st = static_cast<const int*>(starts);
  const bool vec = (reinterpret_cast<uintptr_t>(symbols) |
                    reinterpret_cast<uintptr_t>(starts)) % 16 == 0;
  const auto* ec = static_cast<const uint32_t*>(enc_code);
  const auto* el = static_cast<const uint8_t*>(enc_len);
  auto* up = static_cast<uint32_t*>(units);
  const auto blocks = static_cast<unsigned>(n_tiles);
  const auto s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(T, V)                                                  \
  return launch<T, V>(sp, st, n, ec, el, n_codes, n_units, tile_units,    \
                      blocks, threads, smem, up, s)
  if (tables_in_smem) {
    if (vec) REPRO_LAUNCH(true, true);
    REPRO_LAUNCH(true, false);
  }
  if (vec) REPRO_LAUNCH(false, true);
  REPRO_LAUNCH(false, false);
#undef REPRO_LAUNCH
}
