// Device functions shared by the Huffman decode kernels.
//
// CUDA counterparts of src/repro_torch/kernels/common.py (itself the port of
// src/repro/kernels/common.py): the window rules, the per-lane unit row, the
// peek and the masked lane decode loop.  The plain torch versions there are
// the arithmetic these functions are held against.
//
// Coordinates: a lane owns a row of kRowUnits uint32 units starting at the
// subsequence its start falls in (192 bits >= 128 body + 24 codeword + 31
// alignment); bit positions are local to that row.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr int kRowUnits = 6;
constexpr int kRowBits = kRowUnits * 32;
constexpr int kMaxSyms = 128;      // a subsequence holds <= 128 codewords
constexpr int kSubseqBits = 128;

// ops._subseq_windows: row = subsequence of the start (floor division; the
// arithmetic shift floors negative starts as the reference does), end
// clamped to total_bits and to the row.
__device__ __forceinline__ void subseq_window(int start_abs, int end_abs,
                                              int total_bits, int* row,
                                              int* start_local,
                                              int* end_local) {
  const int id = start_abs >> 7;
  const int base = id * kSubseqBits;
  *row = id;
  *start_local = start_abs - base;
  *end_local = min(max(min(end_abs, total_bits) - base, 0), kRowBits);
}

// common.gather_subseq_rows: units[4*id + i]; reads past the stream are 0
// and a negative index reads unit 0, exactly as the reference's clip does.
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ units,
                                         long long n_units, int id,
                                         uint32_t row[kRowUnits]) {
#pragma unroll
  for (int i = 0; i < kRowUnits; ++i) {
    const long long idx = static_cast<long long>(id) * 4 + i;
    row[i] = idx < n_units ? __ldg(units + (idx < 0 ? 0 : idx)) : 0u;
  }
}

// Register-resident select: row[u] without indexing into local memory.
__device__ __forceinline__ uint32_t row_unit(const uint32_t row[kRowUnits],
                                             int u) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < kRowUnits; ++i) w = (i == u) ? row[i] : w;
  return w;
}

// common.peek_rows: the next max_len bits at row-local position pos.  The
// reference masks `w1 >> (32 - sh)` at sh == 0 (a shift by 32 is undefined
// in C); one 64-bit window shifted by sh gives the same bits with no
// undefined shift.
__device__ __forceinline__ int peek_row(const uint32_t row[kRowUnits],
                                        int pos, int max_len) {
  const int u = min(max(pos >> 5, 0), kRowUnits - 1);
  const int sh = pos & 31;
  const uint32_t w0 = row_unit(row, u);
  const uint32_t w1 = (u + 1 < kRowUnits) ? row_unit(row, u + 1) : 0u;
  const uint64_t w = (static_cast<uint64_t>(w0) << 32) | w1;
  const uint32_t window = static_cast<uint32_t>((w << sh) >> 32);
  return static_cast<int>(window >> (32 - max_len));
}

// One LUT entry.  kGlobalLut: the table stays in device memory and is read
// through the read-only data path (a merged LUT too large to stage);
// otherwise sym/len point to the copy a block staged in shared memory.
template <bool kGlobalLut>
__device__ __forceinline__ void lut_entry(const uint16_t* sym,
                                          const uint8_t* len, int win,
                                          int* s, int* l) {
  if constexpr (kGlobalLut) {
    *s = __ldg(sym + win);
    *l = __ldg(len + win);
  } else {
    *s = sym[win];
    *l = len[win];
  }
}

// common.decode_window for one lane: decode [start, end), calling
// emit(k, sym) for the k-th codeword; emit returns false to stop early
// (the lane's remaining symbols are known to be unwanted).  The LUT index
// is clamped into the table and a zero-length entry advances one bit, so a
// corrupt table can neither read outside it nor loop forever.  Returns the
// count; *landing gets the final position.
template <bool kGlobalLut = false, typename Emit>
__device__ __forceinline__ int decode_lane(const uint32_t row[kRowUnits],
                                           int start, int end,
                                           const uint16_t* sym,
                                           const uint8_t* len, int lut_size,
                                           int lut_base, int max_len,
                                           int* landing, Emit emit) {
  int pos = max(min(start, end), 0);
  int count = 0;
  while (pos < end) {
    const int win =
        min(max(peek_row(row, pos, max_len) + lut_base, 0), lut_size - 1);
    int s, l;
    lut_entry<kGlobalLut>(sym, len, win, &s, &l);
    if (!emit(count, s)) break;
    ++count;
    pos += max(l, 1);
  }
  *landing = pos;
  return count;
}

// ---------------------------------------------------------------------------
// The bit-buffer lane decoder (count_subseq, decode_tiles).
//
// decode_lane_buf has decode_lane's contract, with the same result for any
// window inside the row (end <= kRowBits, as subseq_window gives).  The lane
// keeps the bits from its position on in a 64-bit buffer, left-aligned, with
// a count of valid bits; the row's units not yet in the buffer wait in a
// queue of registers whose front is always q[0], so a refill reads a fixed
// register (no per-unit select).  Units past the row enter as 0, as
// peek_row reads them.  Invariant: pos + nbits is the first bit of q[0],
// and the buffer's bits below its valid ones are 0.
// ---------------------------------------------------------------------------

// q[0] leaves the queue; a zero unit enters at the back.
__device__ __forceinline__ void pop_unit(uint32_t q[kRowUnits]) {
#pragma unroll
  for (int i = 0; i + 1 < kRowUnits; ++i) q[i] = q[i + 1];
  q[kRowUnits - 1] = 0u;
}

// Point the buffer at the bit `skip` (>= 0) past the front of the queue:
// whole units leave the queue, and the next two fill the buffer.
__device__ __forceinline__ void seek_buf(uint32_t q[kRowUnits], int skip,
                                         uint64_t* buf, int* nbits) {
  for (; skip >= 32; skip -= 32) pop_unit(q);
  *buf = ((static_cast<uint64_t>(q[0]) << 32) | q[1]) << skip;
  *nbits = 64 - skip;
  pop_unit(q);
  pop_unit(q);
}

// decode_lane through the bit buffer.  A peek is the buffer's top max_len
// bits (at least 32 are valid at every peek, and max_len <= 24 <= 32); a
// step shifts the buffer left by max(l, 1), and fewer than 32 valid bits
// take one unit from the queue.  A step as long as the valid bits or
// longer (a corrupt LUT length, up to 255) never shifts the buffer: it
// re-seeks it from the queue at the new position, if that is still inside
// the window.  The position follows decode_lane's arithmetic exactly, so
// the count, the landing and every symbol are decode_lane's.  With kSyms
// false the symbol table is never read (sym may be null) and emit sees 0.
template <bool kGlobalLut = false, bool kSyms = true, typename Emit>
__device__ __forceinline__ int decode_lane_buf(
    const uint32_t row[kRowUnits], int start, int end, const uint16_t* sym,
    const uint8_t* len, int lut_size, int lut_base, int max_len,
    int* landing, Emit emit) {
  int pos = max(min(start, end), 0);
  int count = 0;
  uint32_t q[kRowUnits];
#pragma unroll
  for (int i = 0; i < kRowUnits; ++i) q[i] = row[i];
  uint64_t buf = 0;
  int nbits = 0;
  if (pos < end) seek_buf(q, pos, &buf, &nbits);
  const int rsh = 32 - max_len;
  while (pos < end) {
    if (nbits < 32) {
      buf |= static_cast<uint64_t>(q[0]) << (32 - nbits);
      nbits += 32;
      pop_unit(q);
    }
    // Codewords until the buffer runs low or the window ends.
    do {
      const int peek =
          static_cast<int>(static_cast<uint32_t>(buf >> 32) >> rsh);
      const int win = min(max(peek + lut_base, 0), lut_size - 1);
      int s = 0, l;
      if constexpr (kSyms) {
        lut_entry<kGlobalLut>(sym, len, win, &s, &l);
      } else if constexpr (kGlobalLut) {
        l = __ldg(len + win);
      } else {
        l = len[win];
      }
      if (!emit(count, s)) {
        *landing = pos;
        return count;
      }
      ++count;
      const int step = max(l, 1);
      pos += step;
      if (step < nbits) {
        buf <<= step;
        nbits -= step;
      } else {
        if (pos < end) seek_buf(q, step - nbits, &buf, &nbits);
        break;
      }
    } while (nbits >= 32 && pos < end);
  }
  *landing = pos;
  return count;
}

// Copy nbytes from device memory to shared memory, 16 bytes a load where
// both pointers are 16-byte aligned, the rest byte by byte.
__device__ __forceinline__ void stage_bytes(void* dst, const void* src,
                                            int nbytes) {
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) |
                     reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const int done = vec ? nbytes & ~15 : 0;
  if (vec) {
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < done / 16; i += blockDim.x)
      d[i] = __ldg(s + i);
  }
  const uint8_t* s8 = static_cast<const uint8_t*>(src);
  uint8_t* d8 = static_cast<uint8_t*>(dst);
  for (int i = done + threadIdx.x; i < nbytes; i += blockDim.x)
    d8[i] = __ldg(s8 + i);
}

// Stage the decode LUT (u16 symbol + u8 length per entry) in shared memory.
__device__ __forceinline__ void stage_lut(const uint16_t* __restrict__ dec_sym,
                                          const uint8_t* __restrict__ dec_len,
                                          int lut_size, uint16_t* s_sym,
                                          uint8_t* s_len) {
  for (int i = threadIdx.x; i < lut_size; i += blockDim.x) {
    s_sym[i] = dec_sym[i];
    s_len[i] = dec_len[i];
  }
}

}  // namespace repro_torch
