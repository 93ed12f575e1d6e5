"""Plain torch versions of the shared in-kernel decode helpers.

Port of ``src/repro/kernels/common.py``.  The CUDA kernels' counterparts
of these functions are the device functions in ``csrc/common.cuh``; the
functions here are the arithmetic those kernels are held against.

Coordinate system: every decoder lane owns a private row of ``ROW_UNITS``
uint32 units covering its 128-bit subsequence plus overhang
(128 + max_len + 31 < 192 bits -> 6 units).  Bit positions are local to the
row: the subsequence body is [0, 128), decode may run to < 192.  The row is
the one of the subsequence the lane's *start* falls in.

Units are carried as int64 here (PyTorch has no shifts on ``torch.uint32``).
"""

from __future__ import annotations

import torch

from repro_torch.core.huffman.encode import SUBSEQ_BITS

ROW_UNITS = 6           # 192 bits >= 128 (body) + 24 (max codeword) + 31 (align)
MAX_SYMS = 128          # worst case: 128 one-bit codewords per subsequence


def subseq_windows(start_abs, end_abs, total_bits: int):
    """Absolute bit windows -> (row subsequence id, row-local start/end).

    Port of ``ops._subseq_windows``: the row is chosen by the subsequence the
    start falls in, and the end is clamped to ``total_bits`` and to the row's
    ``ROW_UNITS * 32`` bits.  int64 results.
    """
    start = start_abs.to(torch.int64)
    ids = start >> 7                       # floor division by SUBSEQ_BITS
    base = ids * SUBSEQ_BITS
    end = torch.clamp(end_abs.to(torch.int64), max=int(total_bits))
    return ids, start - base, (end - base).clamp(0, ROW_UNITS * 32)


def gather_subseq_rows(units, subseq_ids):
    """Per-subsequence unit rows: ``row[s] = units[4*s : 4*s + ROW_UNITS]``.

    Reads past the stream are zero (the encoder's tail padding); int64 rows.
    """
    units = units.to(torch.int64)
    n = units.shape[0]
    idx = (subseq_ids.to(torch.int64)[..., None] * 4
           + torch.arange(ROW_UNITS, device=units.device))
    return torch.where(idx < n, units[idx.clamp(0, n - 1)], 0)


def peek_rows(rows, pos, max_len: int):
    """Per-lane peek: rows (L, ROW_UNITS) int64, pos (L,) local bits.

    Returns (L,) int64 LUT indices (the next ``max_len`` bits of each lane).
    """
    r = rows.shape[1]
    u = (pos >> 5).clamp(0, r - 1)
    sh = pos & 31
    w0 = rows.gather(1, u[:, None])[:, 0]
    w1 = torch.where(u + 1 < r,
                     rows.gather(1, (u + 1).clamp(max=r - 1)[:, None])[:, 0],
                     0)
    hi = (w0 << sh) & 0xFFFFFFFF
    lo = torch.where(sh == 0, 0, w1 >> (32 - sh))
    return (hi | lo) >> (32 - max_len)


def _run_lanes(rows, start, end, dec_sym, dec_len, max_len: int,
               lut_base=None, emit=None):
    """The masked lane loop shared by :func:`decode_window` and
    :func:`stage_tile`.

    Each lane decodes from ``max(min(start, end), 0)`` while its position is
    below ``end``; the loop ends when no lane is active.  The LUT index is
    clamped into the table and a zero-length entry still advances one bit,
    so corrupt input can neither read outside the table nor loop forever.
    ``emit(active, count, sym)`` sees every decoded symbol.
    """
    ds = dec_sym.to(torch.int64)
    dl = dec_len.to(torch.int64)
    lut_max = ds.shape[0] - 1
    end = end.to(torch.int64)
    pos = torch.minimum(start.to(torch.int64), end).clamp(min=0)
    count = torch.zeros_like(pos)
    lb = None if lut_base is None else lut_base.to(torch.int64)
    while True:
        active = pos < end
        if not bool(active.any()):
            break
        win = peek_rows(rows, pos, max_len)
        if lb is not None:
            win = win + lb
        win = win.clamp(0, lut_max)
        if emit is not None:
            emit(active, count, ds[win])
        count = torch.where(active, count + 1, count)
        pos = torch.where(active, pos + dl[win].clamp(min=1), pos)
    return pos, count


def decode_window(rows, start, end, dec_sym, dec_len, max_len: int,
                  lut_base=None, collect: bool = False):
    """Masked decode of per-lane windows [start, end) (local bit coords).

    Returns int32 (landing_pos, counts): the row-local position of the first
    codeword at-or-after ``end`` and the number of codewords decoded; with
    ``collect=True`` also uint16 (L, MAX_SYMS) padded symbols, the k-th
    symbol of a lane at slot ``min(k, MAX_SYMS - 1)`` and zeros past it.
    """
    emit = padded = None
    if collect:
        lanes = start.shape[0]
        padded = torch.zeros((lanes, MAX_SYMS), dtype=torch.int32,
                             device=start.device)
        lane = torch.arange(lanes, device=start.device)

        def emit(active, count, sym):
            idx = count.clamp(max=MAX_SYMS - 1)
            padded[lane, idx] = torch.where(active, sym.to(torch.int32),
                                            padded[lane, idx])

    pos, count = _run_lanes(rows, start, end, dec_sym, dec_len, max_len,
                            lut_base, emit)
    if collect:
        return (pos.to(torch.int32), count.to(torch.int32),
                padded.to(torch.uint16))
    return pos.to(torch.int32), count.to(torch.int32)


def stage_tile(rows, start, end, off, lut_base, dec_sym, dec_len,
               max_len: int, tile_syms: int):
    """Decode the lanes overlapping each output tile into a dense tile.

    ``rows`` is (T, L, ROW_UNITS); ``start`` / ``end`` / ``off`` /
    ``lut_base`` are (T, L).  Lane ``l`` of tile ``t`` writes its ``k``-th
    symbol at tile position ``off + min(k, MAX_SYMS - 1)`` when that lies in
    ``[0, tile_syms)``; ``off`` is the lane's output offset minus the tile
    base.  Returns uint16 (T, tile_syms), zero where no lane wrote.
    """
    n_tiles, lanes = start.shape
    device = start.device
    tiles = torch.zeros(n_tiles * tile_syms + 1, dtype=torch.int32,
                        device=device)
    dump = n_tiles * tile_syms
    off = off.reshape(-1).to(torch.int64)
    lane_base = torch.arange(n_tiles, device=device).repeat_interleave(
        lanes) * tile_syms

    def emit(active, count, sym):
        local = off + count.clamp(max=MAX_SYMS - 1)
        ok = active & (local >= 0) & (local < tile_syms)
        tiles[torch.where(ok, lane_base + local, dump)] = sym.to(torch.int32)

    _run_lanes(rows.reshape(-1, rows.shape[-1]), start.reshape(-1),
               end.reshape(-1), dec_sym, dec_len, max_len,
               lut_base.reshape(-1), emit)
    return tiles[:dump].reshape(n_tiles, tile_syms).to(torch.uint16)
