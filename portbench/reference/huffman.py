"""A plain Huffman coder for the cuSZ-style stream the port writes.

The stream, as the paper and the port's ``docs/format.md`` define it:
codewords packed MSB-first into 32-bit units; every 128-bit subsequence
has one byte of gap, the offset of the first codeword that starts at or
after its first bit; ``total_bits`` valid bits hold ``n_symbols``
codewords of a canonical, prefix-free code given by its encoder tables
(``enc_code`` right-aligned, ``enc_len``; length 0 = unused symbol).

:func:`decode` reads a stream the way a sequential decoder does, with
every subsequence walked at once: a lane starts at its subsequence's gap
and decodes every codeword that starts inside its 128 bits.  The gaps are
only taken as hints: each lane must end exactly where the next one starts,
the first must start at bit 0 and the last end at ``total_bits``, so the
lanes together are the one sequential decode from bit 0.  Any break, an
unknown codeword or a wrong count is reported as a fault.

:func:`encode` and :func:`canonical_code` build such streams for tests.
Plain torch on the stream's device; nothing comes from the program.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

UNIT_BITS = 32
SUBSEQ_BITS = 128
#: Subsequences decoded together, which bounds the decoder's temporaries.
LANES = 1 << 22


def lookup_table(enc_code, enc_len, max_len: int):
    """``(symbol, length)`` of every ``max_len``-bit window, as int64 numpy
    arrays, and the number of faults in the tables: a codeword longer
    than ``max_len``, one that does not fit its length, or two that share
    a window (the code is not prefix-free)."""
    code = np.asarray(enc_code, np.int64)
    length = np.asarray(enc_len, np.int64)
    sym = np.zeros(1 << max_len, np.int64)
    size = np.zeros(1 << max_len, np.int64)
    faults = 0
    for s in np.nonzero(length > 0)[0]:
        n = int(length[s])
        if n > max_len or int(code[s]) >> n:
            faults += 1
            continue
        lo = int(code[s]) << (max_len - n)
        hi = lo + (1 << (max_len - n))
        faults += int(np.count_nonzero(size[lo:hi]))
        sym[lo:hi] = s
        size[lo:hi] = n
    return sym, size, faults


def _peek(units: torch.Tensor, pos: torch.Tensor, max_len: int):
    """The ``max_len`` bits at each bit position (zeros past the end)."""
    u = pos >> 5
    sh = pos & 31
    n = units.shape[0]
    w0 = torch.where(u < n, units[u.clamp(max=n - 1)], 0)
    w1 = torch.where(u + 1 < n, units[(u + 1).clamp(max=n - 1)], 0)
    window = ((w0 << sh) & 0xFFFFFFFF) | (w1 >> (32 - sh))
    return window >> (32 - max_len)


def decode(units: torch.Tensor, gaps: torch.Tensor, total_bits: int,
           n_symbols: int, enc_code, enc_len, max_len: int,
           lanes: int = LANES):
    """Decode a stream: ``(symbols int64[...], faults)``.

    ``faults`` counts the table faults of :func:`lookup_table`, unknown
    codewords, lanes that do not end where the next one starts, a first
    lane that does not start at bit 0 or a last that does not end at
    ``total_bits``, and a symbol count other than ``n_symbols``.  A stream
    with no fault is exactly the sequential decode from bit 0.
    """
    device = units.device
    sym_np, len_np, faults = lookup_table(enc_code, enc_len, max_len)
    used = len_np[len_np > 0]
    step_bits = int(used.min()) if used.size else 1
    lut_sym = torch.from_numpy(sym_np).to(device)
    lut_len = torch.from_numpy(len_np).to(device)
    words = units.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    if total_bits > words.numel() * UNIT_BITS or total_bits < 0:
        return torch.zeros(0, dtype=torch.int64, device=device), faults + 1
    n_sub = gaps.numel()
    base = torch.arange(n_sub, dtype=torch.int64, device=device) * SUBSEQ_BITS
    start = base + gaps.reshape(-1).to(torch.int64)
    end = torch.clamp(base + SUBSEQ_BITS, max=total_bits)
    # Where lane i must end: where lane i + 1 starts, or at the last bit.
    follow = torch.cat([start[1:], torch.tensor([total_bits], device=device)])
    follow = torch.clamp(follow, max=total_bits)
    if n_sub == 0 or (total_bits > 0 and int(start[0]) != 0):
        faults += 1
    steps = -(-SUBSEQ_BITS // step_bits) + 1
    pieces = []
    for lo in range(0, n_sub, lanes):
        hi = min(lo + lanes, n_sub)
        pos = start[lo:hi].clone()
        stop = end[lo:hi]
        syms = torch.zeros((hi - lo, steps), dtype=torch.int16, device=device)
        live = torch.zeros((hi - lo, steps), dtype=torch.bool, device=device)
        for k in range(steps):
            act = pos < stop
            if not bool(act.any()):
                break
            window = _peek(words, pos, max_len)
            n = lut_len[window]
            faults += int((act & (n == 0)).sum())
            syms[:, k] = lut_sym[window].to(torch.int16)
            live[:, k] = act
            pos = torch.where(act, pos + n.clamp(min=1), pos)
        faults += int((pos < stop).sum())       # more codewords than steps
        ended = stop > start[lo:hi]
        faults += int((ended & (pos != follow[lo:hi])).sum())
        pieces.append(syms[live].to(torch.int64) & 0xFFFF)
    out = (torch.cat(pieces) if pieces
           else torch.zeros(0, dtype=torch.int64, device=device))
    if out.numel() != n_symbols:
        faults += 1
    return out, faults


def canonical_code(freq, max_len: int = 24):
    """A canonical Huffman code of ``freq``: ``(enc_code uint32, enc_len
    uint8)``.  Plain heap Huffman; raises when a codeword would be longer
    than ``max_len`` (the tests' alphabets never need a length limit)."""
    freq = np.asarray(freq, np.int64)
    length = np.zeros(freq.shape[0], np.int64)
    used = [int(s) for s in np.nonzero(freq > 0)[0]]
    if len(used) == 1:
        length[used[0]] = 1
    heap = [(int(freq[s]), s, [s]) for s in used]
    heapq.heapify(heap)
    while len(heap) > 1:
        fa, ta, a = heapq.heappop(heap)
        fb, tb, b = heapq.heappop(heap)
        for s in a + b:
            length[s] += 1
        heapq.heappush(heap, (fa + fb, min(ta, tb), a + b))
    if length.max(initial=0) > max_len:
        raise ValueError(f"a codeword needs {int(length.max())} bits, more "
                         f"than max_len={max_len}")
    code = np.zeros(freq.shape[0], np.uint32)
    nxt, prev = 0, 0
    for s in sorted(used, key=lambda s: (length[s], s)):
        nxt <<= int(length[s]) - prev
        code[s] = nxt
        nxt += 1
        prev = int(length[s])
    return code, length.astype(np.uint8)


def encode(symbols: torch.Tensor, enc_code, enc_len, subseqs_per_seq: int = 32):
    """Pack ``symbols`` into a stream: ``(units uint32-valued int64, gaps
    uint8, total_bits)``, padded to whole sequences of ``subseqs_per_seq``
    subsequences as the port pads them."""
    device = symbols.device
    sym = symbols.reshape(-1).to(torch.int64)
    code = torch.as_tensor(np.asarray(enc_code, np.int64), device=device)[sym]
    n = torch.as_tensor(np.asarray(enc_len, np.int64), device=device)[sym]
    start = torch.cumsum(n, 0) - n
    total_bits = int(n.sum())
    seq_bits = SUBSEQ_BITS * subseqs_per_seq
    padded = max(-(-max(total_bits, 1) // seq_bits), 1) * seq_bits
    units = torch.zeros(padded // UNIT_BITS + 1, dtype=torch.int64,
                        device=device)
    spill = (start & 31) + n - UNIT_BITS       # bits that reach the next unit
    hi = torch.where(spill > 0, code >> spill.clamp(min=0),
                     code << (-spill).clamp(min=0))
    lo = torch.where(spill > 0, (code << (UNIT_BITS - spill).clamp(max=31))
                     & 0xFFFFFFFF, 0)
    units.index_add_(0, start >> 5, hi)
    units.index_add_(0, (start >> 5) + 1, lo)
    units = units[:-1]
    base = torch.arange(padded // SUBSEQ_BITS, dtype=torch.int64,
                        device=device) * SUBSEQ_BITS
    first = torch.searchsorted(start, base)
    at = torch.where(first < sym.numel(),
                     start[first.clamp(max=max(sym.numel() - 1, 0))],
                     total_bits)
    gaps = (at - base).clamp(0, 255).to(torch.uint8)
    return units, gaps, total_bits
