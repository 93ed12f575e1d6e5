"""Canonical, length-limited Huffman codebooks (numpy; host side).

Port of ``src/repro/core/huffman/codebook.py``, kept as a copy of its own
so the port imports nothing of the JAX package.

cuSZ builds its codebook on the GPU (Tian et al. 2021); codebook construction
is O(K log K) for K symbols (K = 1024 quantization bins by default) and is a
negligible fraction of (de)coding time, so we build it host-side in numpy and
ship the resulting lookup tables to the device as plain arrays.

Design decisions:
  * Codes are *canonical*: sorted by (length, symbol), assigned sequentially.
    Canonical codes admit compact decode tables and make encode/decode
    round-trips reproducible bit-for-bit.
  * Codes are *length-limited* to ``max_len`` (default 12) via the
    package-merge algorithm [Larmore & Hirschberg 1990].  A hard length cap
    lets the decoder use a flat ``2**max_len``-entry LUT that fits in shared
    memory (4096 x (uint16 sym + uint8 len) = 12 KiB) beside the staging
    tile of the CUDA decode kernels.
  * A 128-bit subsequence therefore contains at least
    ``floor((SUBSEQ_BITS - max_len) / max_len) + 1 >= 9`` codeword starts,
    which upper-bounds the number of subsequences overlapping an output tile
    -- the static lane budget of the tile decode kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_MAX_LEN = 12


@dataclasses.dataclass(frozen=True)
class Codebook:
    """Encode + decode tables for one canonical Huffman code."""

    n_symbols: int
    max_len: int
    # Encoder tables, indexed by symbol.
    enc_code: np.ndarray  # uint32[K]  codeword bits, right-aligned
    enc_len: np.ndarray   # uint8[K]   codeword length; 0 => symbol unused
    # Decoder tables, indexed by the next ``max_len`` bits of the stream.
    dec_sym: np.ndarray   # uint16[2**max_len]
    dec_len: np.ndarray   # uint8[2**max_len]

    @property
    def min_len(self) -> int:
        used = self.enc_len[self.enc_len > 0]
        return int(used.min()) if used.size else 0


def code_lengths_package_merge(freq: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal length-limited code lengths via package-merge.

    Args:
      freq: int64[K] symbol frequencies (zeros allowed -> unused symbols).
      max_len: maximum codeword length L; requires 2**L >= #nonzero symbols.

    Returns:
      uint8[K] code lengths (0 for unused symbols).
    """
    freq = np.asarray(freq, dtype=np.int64)
    k = freq.shape[0]
    sym = np.nonzero(freq > 0)[0]
    n = sym.size
    lengths = np.zeros(k, dtype=np.uint8)
    if n == 0:
        return lengths
    if n == 1:
        lengths[sym[0]] = 1
        return lengths
    if (1 << max_len) < n:
        raise ValueError(f"max_len={max_len} cannot code {n} symbols")

    # Leaf items sorted by weight.  Each item carries a per-symbol count
    # vector implicitly: we track, for every package, the multiset of leaves
    # it contains via index lists (n is small -- <= 2**16 -- so this is fine).
    order = np.argsort(freq[sym], kind="stable")
    leaves_w = freq[sym][order]            # ascending weights
    leaves_id = np.arange(n)[order]        # position in `sym`

    # packages: list of (weight, leaf_count_vector) built level by level.
    counts = np.zeros(n, dtype=np.int64)

    prev_w: list[int] = []
    prev_c: list[np.ndarray] = []
    for _level in range(max_len):
        # Merge leaves with packaged pairs from the previous level.
        cur_w: list[int] = []
        cur_c: list[np.ndarray] = []
        li, pi = 0, 0
        while li < n or pi < len(prev_w):
            take_leaf = pi >= len(prev_w) or (
                li < n and leaves_w[li] <= prev_w[pi]
            )
            if take_leaf:
                vec = np.zeros(n, dtype=np.int64)
                vec[leaves_id[li]] = 1
                cur_w.append(int(leaves_w[li]))
                cur_c.append(vec)
                li += 1
            else:
                cur_w.append(prev_w[pi])
                cur_c.append(prev_c[pi])
                pi += 1
        # Package adjacent pairs for the next level.
        nxt_w, nxt_c = [], []
        for i in range(0, len(cur_w) - 1, 2):
            nxt_w.append(cur_w[i] + cur_w[i + 1])
            nxt_c.append(cur_c[i] + cur_c[i + 1])
        prev_w, prev_c = nxt_w, nxt_c
        last_w, last_c = cur_w, cur_c

    # The optimal length-L code corresponds to the first 2n-2 items of the
    # final (unpackaged) list; a symbol's code length is the number of
    # selected items containing it.
    for i in range(2 * n - 2):
        counts += last_c[i]
    lengths[sym] = counts.astype(np.uint8)
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codewords given code lengths.

    Symbols are ranked by (length, symbol index); codes count upward, shifted
    left at each length increase (RFC1951-style).
    """
    lengths = np.asarray(lengths)
    k = lengths.shape[0]
    codes = np.zeros(k, dtype=np.uint32)
    used = np.nonzero(lengths > 0)[0]
    if used.size == 0:
        return codes
    order = sorted(used, key=lambda s: (lengths[s], s))
    code = 0
    prev_len = int(lengths[order[0]])
    for s in order:
        length = int(lengths[s])
        code <<= length - prev_len
        codes[s] = code
        code += 1
        prev_len = length
    return codes


def build_decode_lut(
    codes: np.ndarray, lengths: np.ndarray, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Flat decode LUT: index by the next ``max_len`` stream bits."""
    size = 1 << max_len
    dec_sym = np.zeros(size, dtype=np.uint16)
    dec_len = np.zeros(size, dtype=np.uint8)
    for s in np.nonzero(lengths > 0)[0]:
        length = int(lengths[s])
        lo = int(codes[s]) << (max_len - length)
        hi = lo + (1 << (max_len - length))
        dec_sym[lo:hi] = s
        dec_len[lo:hi] = length
    return dec_sym, dec_len


def build_codebook(freq: np.ndarray, max_len: int = DEFAULT_MAX_LEN) -> Codebook:
    """End-to-end: frequencies -> canonical length-limited codebook."""
    freq = np.asarray(freq, dtype=np.int64)
    lengths = code_lengths_package_merge(freq, max_len)
    codes = canonical_codes(lengths)
    dec_sym, dec_len = build_decode_lut(codes, lengths, max_len)
    return Codebook(
        n_symbols=int(freq.shape[0]),
        max_len=max_len,
        enc_code=codes,
        enc_len=lengths,
        dec_sym=dec_sym,
        dec_len=dec_len,
    )


def validate_codebook(codebook, max_len: "int | None" = None) -> list:
    """Integrity problems of a (possibly corrupt) codebook, as strings.

    Checks the canonical-code invariants that the decode LUTs rely on:
    every used codeword length lies in ``[1, max_len]``, the lengths
    satisfy the Kraft inequality (``sum 2**-len <= 1`` -- a corrupted
    length table that overfills the code space makes the LUT decode
    ambiguous garbage), and the decode tables have the ``2**max_len``
    shape with entries bounded by ``max_len``.  Returns ``[]`` for a
    healthy codebook; ``pipeline.build_plan`` raises ``DecodeGuardError``
    on anything else.  Works on ``Codebook`` and on LUT-only views
    (encoder tables are checked only when present).
    """
    problems: list = []
    L = int(max_len if max_len is not None else codebook.max_len)
    if not (1 <= L <= 24):
        return [f"max_len {L} outside [1, 24]"]

    enc_len = getattr(codebook, "enc_len", None)
    if enc_len is not None:
        lens = np.asarray(enc_len, dtype=np.int64)
        used = lens[lens > 0]
        if used.size:
            if int(used.max()) > L:
                problems.append(
                    f"codeword length {int(used.max())} exceeds "
                    f"max_len={L}")
            else:
                kraft = float(np.sum(2.0 ** -used.astype(np.float64)))
                if kraft > 1.0 + 1e-9:
                    problems.append(
                        f"Kraft inequality violated (sum 2^-len = "
                        f"{kraft:.6f} > 1)")
        elif lens.size:
            problems.append("no symbol has a nonzero codeword length")

    size = 1 << L
    for name in ("dec_sym", "dec_len"):
        tab = getattr(codebook, name, None)
        if tab is not None and tab.shape != (size,):
            problems.append(f"{name} shape {tuple(tab.shape)} != ({size},)")
    dec_len = getattr(codebook, "dec_len", None)
    if dec_len is not None and dec_len.shape == (size,) and size:
        dmax = int(np.asarray(dec_len, dtype=np.int64).max())
        if dmax > L:
            problems.append(f"decode-LUT length {dmax} exceeds max_len={L}")
    return problems


def expected_bits_per_symbol(freq: np.ndarray, lengths: np.ndarray) -> float:
    freq = np.asarray(freq, dtype=np.float64)
    total = freq.sum()
    if total == 0:
        return 0.0
    return float((freq * lengths).sum() / total)
