"""Huffman encoder (torch) with subsequence metadata and gap arrays.

Port of ``src/repro/core/huffman/encode.py``.  The stream format is the
reference's, byte for byte:

  * MSB-first bit packing into 32-bit *units* (the paper's unit).
  * A *subsequence* is ``SUBSEQ_UNITS = 4`` units = 128 bits -- the work item
    of one decoder lane.
  * A *sequence* is ``subseqs_per_seq`` subsequences.  Codewords cross
    subsequence and sequence boundaries freely; only the tail is padded.

Alongside the packed units the encoder emits ``gaps`` (uint8: bit offset of
the first codeword start at-or-after each subsequence boundary), ``counts``
(int32: codeword starts per subsequence, ground truth for tests) and
``seq_counts`` (int32: symbols per sequence).

Tensors carry the reference's dtypes (``units`` is ``torch.uint32``, ``gaps``
``torch.uint8``).  PyTorch has no shifts or sums on unsigned 32-bit tensors,
so the arithmetic runs in int64 and only the results are stored unsigned.
"""

from __future__ import annotations

import dataclasses

import torch

SUBSEQ_UNITS = 4
UNIT_BITS = 32
SUBSEQ_BITS = SUBSEQ_UNITS * UNIT_BITS  # 128
DEFAULT_SUBSEQS_PER_SEQ = 32            # 4096-bit sequences

#: Units packed per step of :func:`_encode_padded`; bounds the int64
#: temporaries to a few hundred MiB whatever the stream size.
PACK_CHUNK_UNITS = 1 << 18


@dataclasses.dataclass
class EncodedStream:
    """A Huffman-coded bitstream plus decoding metadata."""

    units: torch.Tensor        # uint32[n_units], padded to a whole sequence
    gaps: torch.Tensor         # uint8[n_subseq]
    counts: torch.Tensor       # int32[n_subseq] (ground truth / oracle only)
    seq_counts: torch.Tensor   # int32[n_seq]    symbols per sequence
    total_bits: int            # valid payload bits
    n_symbols: int             # total symbols encoded
    subseqs_per_seq: int = DEFAULT_SUBSEQS_PER_SEQ

    @property
    def n_subseq(self) -> int:
        return self.gaps.shape[0]

    @property
    def n_seq(self) -> int:
        return self.gaps.shape[0] // self.subseqs_per_seq

    @property
    def device(self) -> torch.device:
        return self.units.device

    def to(self, device) -> "EncodedStream":
        return dataclasses.replace(
            self, units=self.units.to(device), gaps=self.gaps.to(device),
            counts=self.counts.to(device),
            seq_counts=self.seq_counts.to(device))


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def units_for_bits(total_bits: int, subseqs_per_seq: int) -> int:
    """Padded unit count for a ``total_bits`` payload (whole sequences)."""
    n_units = _ceil_to(max(int(total_bits), 1), UNIT_BITS) // UNIT_BITS
    return _ceil_to(n_units, SUBSEQ_UNITS * subseqs_per_seq)


def stream_metadata(starts: torch.Tensor, total_bits: int,
                    n_units_padded: int, subseqs_per_seq: int):
    """Gap array + per-subsequence counts from codeword start positions.

    ``starts`` is the int64 exclusive prefix sum of the codeword lengths.
    Returns ``(gaps uint8, counts int32, seq_counts int32)``.
    """
    n_subseq = n_units_padded // SUBSEQ_UNITS
    boundaries = torch.arange(n_subseq, dtype=torch.int64,
                              device=starts.device) * SUBSEQ_BITS
    first = torch.searchsorted(starts, boundaries, side="left")
    n = starts.shape[0]
    first_start = torch.where(first < n, starts[first.clamp(max=n - 1)],
                              torch.full_like(first, total_bits))
    gaps = (first_start - boundaries).clamp(0, 255).to(torch.uint8)
    ends = torch.searchsorted(starts, boundaries + SUBSEQ_BITS, side="left")
    counts = (ends - first).to(torch.int32)
    seq_counts = counts.reshape(-1, subseqs_per_seq).sum(
        dim=1, dtype=torch.int32)
    return gaps, counts, seq_counts


def _pack_units(starts, lens, codes, unit_lo: int, unit_hi: int,
                lanes: int) -> torch.Tensor:
    """Units ``[unit_lo, unit_hi)`` of the packed stream, as int64.

    Each 32-bit unit gathers the <= ``lanes`` codewords that can overlap its
    window -- the last one starting at-or-before its first bit, then the ones
    starting inside it -- and adds up their hi/lo split contributions.  The
    codewords' bit ranges are disjoint, so the sum is the bitwise OR of the
    reference's ``_encode_gather_padded``.
    """
    n = starts.shape[0]
    base = torch.arange(unit_lo, unit_hi, dtype=torch.int64,
                        device=starts.device) * UNIT_BITS
    s0 = (torch.searchsorted(starts, base, side="right") - 1).clamp(0, n - 1)
    k = s0[:, None] + torch.arange(lanes, device=starts.device)[None, :]
    valid = k < n
    kc = k.clamp(max=n - 1)
    length = torch.where(valid, lens[kc], 0)
    code = codes[kc]
    p = starts[kc] - base[:, None]
    u = p >> 5
    o = p & 31
    shift = 64 - o - length
    hi = torch.where(shift >= 32, code << (shift - 32).clamp(0, 31),
                     code >> (32 - shift).clamp(0, 31))
    lo = torch.where(shift >= 32, 0,
                     (code << shift.clamp(0, 31)) & 0xFFFFFFFF)
    active = length > 0
    contrib = (torch.where(active & (u == 0), hi, 0)
               + torch.where(active & (u == -1), lo, 0))
    return contrib.sum(dim=1)


def pack_units(starts, lens, codes, n_units: int,
               min_len: int) -> torch.Tensor:
    """The ``n_units`` packed units of a stream, as int64.

    ``starts`` / ``lens`` / ``codes`` are each symbol's first bit, code
    length and right-aligned codeword (int64); ``min_len``, the shortest
    codeword, bounds the lanes a unit gathers.  Walks the units in chunks
    of ``PACK_CHUNK_UNITS``, so memory stays bounded at any stream size.
    """
    lanes = UNIT_BITS // max(min_len, 1) + 2
    units = torch.empty(n_units, dtype=torch.int64, device=starts.device)
    for lo in range(0, n_units, PACK_CHUNK_UNITS):
        hi = min(lo + PACK_CHUNK_UNITS, n_units)
        units[lo:hi] = _pack_units(starts, lens, codes, lo, hi, lanes)
    return units


def _gather_stream(sym, enc_code, enc_len, total_bits: "int | None",
                   n_units_padded: int, subseqs_per_seq: int,
                   min_len: int) -> EncodedStream:
    """Stream of the non-empty int64 symbol array ``sym``: placement, the
    per-unit pack and the metadata (``total_bits=None``: read back from
    the placement)."""
    lens = enc_len.to(torch.int64)[sym]
    codes = enc_code.to(torch.int64)[sym]
    starts = torch.cumsum(lens, 0) - lens
    if total_bits is None:
        total_bits = int(starts[-1] + lens[-1])
    units = pack_units(starts, lens, codes, n_units_padded, min_len)
    gaps, counts, seq_counts = stream_metadata(starts, total_bits,
                                               n_units_padded,
                                               subseqs_per_seq)
    return EncodedStream(
        units=units.to(torch.uint32), gaps=gaps, counts=counts,
        seq_counts=seq_counts, total_bits=int(total_bits),
        n_symbols=int(sym.shape[0]), subseqs_per_seq=subseqs_per_seq)


def _encode_padded(symbols: torch.Tensor, enc_code: torch.Tensor,
                   enc_len: torch.Tensor, n_units_padded: int,
                   subseqs_per_seq: int) -> EncodedStream:
    """Core encoder for a non-empty symbol array.

    Byte-identical with the reference's ``_encode_padded`` (whose
    ``pack_bits`` runs one ``searchsorted`` per output *bit*); this walks
    output *units* (:func:`pack_units`) instead.  Sizes come from the
    symbols: the bit total and the shortest codeword in the table.
    """
    used = enc_len[enc_len > 0]
    min_len = int(used.min()) if used.numel() else 1
    return _gather_stream(symbols.reshape(-1).to(torch.int64), enc_code,
                          enc_len, None, n_units_padded, subseqs_per_seq,
                          min_len)


def encode_gather(symbols: torch.Tensor, enc_code, enc_len,
                  total_bits: int,
                  subseqs_per_seq: int = DEFAULT_SUBSEQS_PER_SEQ,
                  min_len: int = 1) -> EncodedStream:
    """Device-path encode: the per-unit gather pack under a known bit total.

    Port of the reference's ``encode_gather``.  ``total_bits`` and
    ``min_len`` come from the ``EncoderPlan`` (the histogram and the
    codebook), so the symbol array is never read back to size the stream.
    The plain version of the ``pack_tiles`` kernel's stream
    (``kernels/ops.py:encode_bitpack``).
    """
    device = symbols.device
    if symbols.numel() == 0:
        return empty_stream(subseqs_per_seq, device=device)
    return _gather_stream(symbols.reshape(-1).to(torch.int64),
                          torch.as_tensor(enc_code).to(device),
                          torch.as_tensor(enc_len).to(device), total_bits,
                          units_for_bits(total_bits, subseqs_per_seq),
                          subseqs_per_seq, min_len)


def empty_stream(subseqs_per_seq: int = DEFAULT_SUBSEQS_PER_SEQ, *,
                 device) -> EncodedStream:
    """A valid zero-symbol stream (one zero-padded sequence)."""
    n_units_padded = units_for_bits(0, subseqs_per_seq)
    n_subseq = n_units_padded // SUBSEQ_UNITS
    return EncodedStream(
        units=torch.zeros(n_units_padded, dtype=torch.uint32, device=device),
        gaps=torch.zeros(n_subseq, dtype=torch.uint8, device=device),
        counts=torch.zeros(n_subseq, dtype=torch.int32, device=device),
        seq_counts=torch.zeros(n_subseq // subseqs_per_seq,
                               dtype=torch.int32, device=device),
        total_bits=0, n_symbols=0, subseqs_per_seq=subseqs_per_seq)


def encode(symbols: torch.Tensor, enc_code: torch.Tensor,
           enc_len: torch.Tensor,
           subseqs_per_seq: int = DEFAULT_SUBSEQS_PER_SEQ) -> EncodedStream:
    """Encode a symbol array on its own device.

    ``enc_code`` / ``enc_len`` are the codebook's encoder tables as tensors
    (or numpy arrays) indexed by symbol.
    """
    device = symbols.device
    enc_code = torch.as_tensor(enc_code).to(device)
    enc_len = torch.as_tensor(enc_len).to(device)
    if symbols.numel() == 0:
        return empty_stream(subseqs_per_seq, device=device)
    sym = symbols.reshape(-1).to(torch.int64)
    total_bits = int(enc_len.to(torch.int64)[sym].sum())
    return _encode_padded(sym, enc_code, enc_len,
                          units_for_bits(total_bits, subseqs_per_seq),
                          subseqs_per_seq)


def encode_chunked(symbols, enc_code, enc_len,
                   chunk_symbols: int = 16384) -> dict:
    """cuSZ-style *coarse-grained* chunked encoding (the paper's baseline).

    Port of the reference's ``encode_chunked``, with the same dict and the
    same bits.  Each fixed-size chunk of input symbols is encoded
    independently and padded to a unit boundary; the decoder runs one
    sequential thread per chunk (``decode.decode_chunked``).  The per-chunk
    padding is the compression-ratio cost the paper mentions for small
    chunks.

    The reference packs chunk by chunk in a host loop, one element a bit;
    this packs every chunk in one pass of :func:`pack_units` on the input's
    device: each codeword's start is its start within its chunk plus its
    chunk's first bit in the padded ``[n_chunks, max_units]`` rows, so the
    rows are one stream whose chunks never share a unit.

    Returns ``units`` uint32[n_chunks, max_units], ``chunk_bits`` int64 and
    ``chunk_syms`` int32 [n_chunks], ``chunk_symbols``, ``n_symbols`` and
    ``stored_bytes`` (the real per-chunk unit counts, unit-aligned padding,
    as cuSZ accounts chunked storage).
    """
    if chunk_symbols < 1:
        raise ValueError(f"chunk_symbols must be >= 1, got {chunk_symbols}")
    symbols = torch.as_tensor(symbols)
    device = symbols.device
    sym = symbols.reshape(-1).to(torch.int64)
    enc_code = torch.as_tensor(enc_code).to(device).to(torch.int64)
    enc_len = torch.as_tensor(enc_len).to(device).to(torch.int64)
    n = sym.shape[0]
    n_chunks = (n + chunk_symbols - 1) // chunk_symbols
    if n == 0:
        return {"units": torch.zeros((0, 0), dtype=torch.uint32,
                                     device=device),
                "chunk_bits": torch.zeros(0, dtype=torch.int64,
                                          device=device),
                "chunk_syms": torch.zeros(0, dtype=torch.int32,
                                          device=device),
                "chunk_symbols": chunk_symbols, "n_symbols": 0,
                "stored_bytes": 0}
    lens = enc_len[sym]
    codes = enc_code[sym]
    rows = torch.zeros(n_chunks * chunk_symbols, dtype=torch.int64,
                       device=device)
    rows[:n] = lens
    rows = rows.reshape(n_chunks, chunk_symbols)
    chunk_bits = rows.sum(dim=1)
    within = (torch.cumsum(rows, dim=1) - rows).reshape(-1)[:n]
    n_units = ((chunk_bits + UNIT_BITS - 1) // UNIT_BITS).clamp(min=1)
    max_units = int(n_units.max())
    chunk_of = torch.arange(n, device=device) // chunk_symbols
    starts = within + chunk_of * (max_units * UNIT_BITS)
    used = enc_len[enc_len > 0]
    min_len = int(used.min()) if used.numel() else 1
    units = pack_units(starts, lens, codes, n_chunks * max_units, min_len)
    chunk_syms = torch.full((n_chunks,), chunk_symbols, dtype=torch.int32,
                            device=device)
    chunk_syms[-1] = n - (n_chunks - 1) * chunk_symbols
    stored = int(((chunk_bits + UNIT_BITS - 1) // UNIT_BITS).sum()) * 4
    return {
        "units": units.to(torch.uint32).reshape(n_chunks, max_units),
        "chunk_bits": chunk_bits,
        "chunk_syms": chunk_syms,
        "chunk_symbols": chunk_symbols,
        "n_symbols": n,
        "stored_bytes": stored,
    }
