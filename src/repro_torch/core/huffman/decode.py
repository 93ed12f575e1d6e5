"""Reference Huffman decoders (plain torch): the "ref" backend's phases.

Port of ``src/repro/core/huffman/decode.py``, the decoders' phases:

  self-sync (Weissenberger & Schmidt, optimized per paper §IV-A):
    1. intra-sequence synchronization    -> :func:`selfsync_intra`
    2. inter-sequence synchronization    -> :func:`selfsync_inter`
    3. output-index prefix sum           -> :func:`output_offsets`
    4. decode + write                    -> as below

  gap-array (Yamamoto et al.):
    1. count decode ("get output idx.")  -> :func:`subseq_scan` from
                                            :func:`gap_starts`
    2. prefix sum                        -> :func:`output_offsets`
    3. tile-staged decode + write        -> :func:`decode_write_tiles`
       (or the padded baseline layout    -> :func:`decode_write`)

:func:`decode_gap_array` and :func:`decode_selfsync` chain the phases of
each.  These work in absolute stream coordinates (:func:`bits.peek`) and are
the oracles of the CUDA kernels in ``repro_torch.kernels``.
:func:`decode_sequential` is the ground-truth oracle for small streams on
the CPU; no decode path of the port calls it.  :func:`decode_chunked` is
cuSZ's coarse-grained decoder over ``encode.encode_chunked``'s rows, the
paper's yardstick: the ``decode_chunked`` CUDA kernel on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.huffman.bits import SUBSEQ_BITS, peek
from repro_torch.core.huffman.encode import EncodedStream  # noqa: F401

# Worst-case codewords per 128-bit subsequence (min codeword length 1).
MAX_SYMS_PER_SUBSEQ = SUBSEQ_BITS


def decode_sequential(units, dec_sym, dec_len, n_symbols: int,
                      max_len: int) -> torch.Tensor:
    """Decode the whole stream with a single sequential scan (oracle).

    A host loop over Python integers: meant for test-sized streams only,
    so it takes CPU tensors and raises for any other device.
    """
    for name, t in (("units", units), ("dec_sym", dec_sym),
                    ("dec_len", dec_len)):
        if t.device.type != "cpu":
            raise ValueError(f"decode_sequential is a host-loop test oracle: "
                             f"{name} must be a CPU tensor, got {t.device}")
    words = [int(w) for w in units.to(torch.int64).tolist()]
    syms_lut = dec_sym.to(torch.int64).tolist()
    lens_lut = dec_len.to(torch.int64).tolist()
    n = len(words)
    out = []
    pos = 0
    for _ in range(n_symbols):
        u, sh = pos >> 5, pos & 31
        w0 = words[min(max(u, 0), n - 1)]
        w1 = words[u + 1] if u + 1 < n else 0
        window = ((w0 << sh) & 0xFFFFFFFF) | (0 if sh == 0 else w1 >> (32 - sh))
        win = window >> (32 - max_len)
        out.append(syms_lut[win])
        pos += lens_lut[win]
    return torch.tensor(out, dtype=torch.int32).to(torch.uint16)


def subseq_scan(units, dec_sym, dec_len, start_bits, end_bits,
                total_bits: int, max_len: int, collect: bool = False,
                lut_base=None):
    """Decode each subsequence window ``[start_bits[i], end_bits[i])``.

    Returns ``(landing_pos, counts[, symbols])``: the absolute bit position of
    the first codeword at-or-after the window end, the number of codewords
    starting inside the window (clipped at ``total_bits``) and, with
    ``collect=True``, int32[n, MAX_SYMS_PER_SUBSEQ] padded symbols.  The loop
    runs until every lane has crossed its window end; a zero-length LUT
    entry still advances one bit, and the LUT index is clamped into the
    table, so a corrupt stream can neither loop forever nor read outside it.
    """
    units = units.to(torch.int64)
    ds = dec_sym.to(torch.int64)
    dl = dec_len.to(torch.int64)
    lut_max = ds.shape[0] - 1
    end = torch.clamp(end_bits.to(torch.int64), max=int(total_bits))
    pos = torch.minimum(start_bits.to(torch.int64), end)
    n = pos.shape[0]
    count = torch.zeros(n, dtype=torch.int64, device=pos.device)
    syms = (torch.zeros((n, MAX_SYMS_PER_SUBSEQ), dtype=torch.int32,
                        device=pos.device) if collect else None)
    rows = torch.arange(n, device=pos.device)
    while True:
        active = pos < end
        if not bool(active.any()):
            break
        win = peek(units, pos, max_len)
        if lut_base is not None:
            win = win + lut_base.to(torch.int64)
        win = win.clamp(0, lut_max)
        sym = ds[win]
        length = dl[win]
        if collect:
            idx = count.clamp(0, MAX_SYMS_PER_SUBSEQ - 1)
            upd = torch.where(active, sym.to(torch.int32), syms[rows, idx])
            syms[rows, idx] = upd
        count = torch.where(active, count + 1, count)
        pos = torch.where(active, pos + length.clamp(min=1), pos)
    pos, count = pos.to(torch.int32), count.to(torch.int32)
    if collect:
        return pos, count, syms
    return pos, count


# ---------------------------------------------------------------------------
# Self-synchronization phases
# ---------------------------------------------------------------------------
# Host loops: each round ends in one host sync on "did any start change".


def _boundaries(n_subseq: int, device) -> torch.Tensor:
    return torch.arange(n_subseq, dtype=torch.int32,
                        device=device) * SUBSEQ_BITS


def selfsync_intra(units, dec_sym, dec_len, total_bits: int, n_subseq: int,
                   max_len: int, subseqs_per_seq: int,
                   early_exit: bool = True):
    """Phase 1: per-sequence sync-point discovery.

    Every subsequence starts with a candidate offset 0 at its boundary; each
    round decodes all windows and hands the landing position to the next
    subsequence *within the same sequence* (a synchronous round: every
    window decodes from the previous round's starts).  ``early_exit=True``
    stops at the fixed point (the paper's `__all_sync` optimization) or
    after ``subseqs_per_seq`` rounds; ``early_exit=False`` always runs the
    worst-case ``subseqs_per_seq`` rounds.  Returns ``(start_bits int32,
    rounds)`` with ``rounds`` the rounds executed.
    """
    boundaries = _boundaries(n_subseq, units.device)
    ends = boundaries + SUBSEQ_BITS
    is_head = (torch.arange(n_subseq, device=units.device)
               % subseqs_per_seq) == 0
    start, rounds, changed = boundaries, 0, True
    while (changed or not early_exit) and rounds < subseqs_per_seq:
        landing, _ = subseq_scan(units, dec_sym, dec_len, start, ends,
                                 total_bits, max_len)
        # landing[i] becomes the start of subsequence i+1, except across
        # sequence boundaries (handled by selfsync_inter).
        new_start = torch.where(is_head, start, torch.roll(landing, 1))
        changed = bool((new_start != start).any())
        start, rounds = new_start, rounds + 1
    return start, rounds


def selfsync_inter(units, dec_sym, dec_len, start_bits, total_bits: int,
                   max_len: int, subseqs_per_seq: int, max_rounds: int = 8):
    """Phase 2: propagate sync points across sequence boundaries.

    Each round decodes every window from the current starts and hands every
    landing position on, sequence heads included (subsequence 0 starts at
    0), until no start changes -- at most ``max_rounds * subseqs_per_seq``
    rounds, the reference's bound (it stops there without raising, as the
    reference does).  Returns ``(start_bits int32, rounds)``.
    """
    n_subseq = start_bits.shape[0]
    ends = _boundaries(n_subseq, start_bits.device) + SUBSEQ_BITS
    start, rounds = start_bits.to(torch.int32), 0
    while rounds < max_rounds * subseqs_per_seq:
        landing, _ = subseq_scan(units, dec_sym, dec_len, start, ends,
                                 total_bits, max_len)
        new_start = torch.roll(landing, 1)
        new_start[:1] = 0
        changed = bool((new_start != start).any())
        start, rounds = new_start, rounds + 1
        if not changed:
            break
    return start, rounds


def output_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Phase 3: exclusive prefix sum of per-subsequence symbol counts."""
    out = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                      device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=out[1:])
    return out


def decode_write(units, dec_sym, dec_len, start_bits, total_bits: int,
                 max_len: int, n_out: int):
    """Phase 4 (baseline layout): padded per-subsequence decode + compaction.

    The *original* decoders' write behaviour: each subsequence produces its
    symbols into its own padded row of ``MAX_SYMS_PER_SUBSEQ`` slots, which
    are then gather-compacted into the output.  Windows run from each start
    to the next subsequence boundary.  Returns ``(uint16[n_out], counts)``.
    """
    device = start_bits.device
    n_subseq = start_bits.shape[0]
    ends = (torch.arange(n_subseq, dtype=torch.int32, device=device)
            * SUBSEQ_BITS + SUBSEQ_BITS)
    _, counts, padded = subseq_scan(units, dec_sym, dec_len, start_bits, ends,
                                    total_bits, max_len, collect=True)
    if n_subseq == 0 or n_out == 0:
        return torch.zeros(n_out, dtype=torch.uint16, device=device), counts
    offsets = output_offsets(counts)
    out_pos = torch.arange(n_out, dtype=torch.int32, device=device)
    owner = (torch.searchsorted(offsets, out_pos, right=True) - 1).clamp(
        0, n_subseq - 1)
    within = (out_pos - offsets[owner]).clamp(0, MAX_SYMS_PER_SUBSEQ - 1)
    return padded[owner, within].to(torch.uint16), counts


def decode_write_tiles(units, dec_sym, dec_len, start_bits, end_bits, offsets,
                       total_bits: int, max_len: int, n_out: int,
                       tile_syms: int, ss_max: int, lut_base=None):
    """Phase 4 (paper Alg. 1 analogue): output-tile-centric decode.

    The output is cut into tiles of ``tile_syms`` symbols.  Each tile decodes
    the ``ss_max`` subsequences from the first one whose output range meets
    it, and keeps only the symbols that land inside it.  ``ss_max`` must be
    >= ``pipeline.ss_max_for_tile(tile_syms, max_len)``.  Returns
    uint16[n_out].
    """
    device = start_bits.device
    n_subseq = start_bits.shape[0]
    n_tiles = (n_out + tile_syms - 1) // tile_syms
    if n_tiles == 0:
        return torch.zeros(0, dtype=torch.uint16, device=device)
    offsets = offsets.to(torch.int64)
    tile_base = torch.arange(n_tiles, dtype=torch.int64,
                             device=device) * tile_syms
    s0 = (torch.searchsorted(offsets, tile_base, right=True) - 1).clamp(
        0, n_subseq - 1)
    lane = torch.arange(ss_max, dtype=torch.int64, device=device)
    subs_raw = s0[:, None] + lane[None, :]
    subs = subs_raw.clamp(0, n_subseq - 1)
    flat = subs.reshape(-1)
    lb = None if lut_base is None else lut_base[flat]
    _, counts, padded = subseq_scan(units, dec_sym, dec_len,
                                    start_bits[flat], end_bits[flat],
                                    total_bits, max_len, collect=True,
                                    lut_base=lb)
    k = torch.arange(MAX_SYMS_PER_SUBSEQ, dtype=torch.int64, device=device)
    local = (offsets[flat][:, None] + k[None, :]
             - tile_base.repeat_interleave(ss_max)[:, None])
    valid = ((k[None, :] < counts.to(torch.int64)[:, None])
             & (local >= 0) & (local < tile_syms)
             # guard duplicated (clipped) subsequence rows
             & (subs == subs_raw).reshape(-1)[:, None])
    tile_id = torch.arange(n_tiles, device=device).repeat_interleave(ss_max)
    dest = tile_id[:, None] * tile_syms + local
    tiles = torch.zeros(n_tiles * tile_syms, dtype=torch.int32,
                        device=device)
    tiles[dest[valid]] = padded[valid]
    return tiles[:n_out].to(torch.uint16)


# ---------------------------------------------------------------------------
# Full-pipeline reference decoders
# ---------------------------------------------------------------------------


def gap_starts(stream) -> torch.Tensor:
    """Absolute sync starts from the stored gap array (int32[n_subseq])."""
    return _boundaries(stream.n_subseq, stream.units.device) + \
        stream.gaps.to(torch.int32)


def _count_and_write(stream, dec_sym, dec_len, start, max_len: int,
                     n_out: int, tile_syms: int, use_tiles: bool):
    """Phases 1-4 from known sync starts: counts, offsets, decode-write."""
    from repro_torch.core.huffman.pipeline import ss_max_for_tile

    ends = _boundaries(start.shape[0], start.device) + SUBSEQ_BITS
    if not use_tiles:
        out, _ = decode_write(stream.units, dec_sym, dec_len, start,
                              stream.total_bits, max_len, n_out)
        return out
    _, counts = subseq_scan(stream.units, dec_sym, dec_len, start, ends,
                            stream.total_bits, max_len)
    return decode_write_tiles(stream.units, dec_sym, dec_len, start, ends,
                              output_offsets(counts), stream.total_bits,
                              max_len, n_out, tile_syms,
                              ss_max_for_tile(tile_syms, max_len))


def decode_gap_array(stream, dec_sym, dec_len, max_len: int, n_out: int,
                     tile_syms: int = 4096, use_tiles: bool = True):
    """Gap-array decoder: counts from gap starts, prefix sum, decode+write.
    Returns uint16[n_out]."""
    return _count_and_write(stream, dec_sym, dec_len, gap_starts(stream),
                            max_len, n_out, tile_syms, use_tiles)


def decode_selfsync(stream, dec_sym, dec_len, max_len: int, n_out: int,
                    tile_syms: int = 4096, use_tiles: bool = True,
                    early_exit: bool = True):
    """Self-synchronization decoder (no gap array consumed): intra- then
    inter-sequence sync, then counts, prefix sum and decode+write.
    Returns uint16[n_out]."""
    sps = stream.subseqs_per_seq
    start, _ = selfsync_intra(stream.units, dec_sym, dec_len,
                              stream.total_bits, stream.n_subseq, max_len,
                              sps, early_exit=early_exit)
    start, _ = selfsync_inter(stream.units, dec_sym, dec_len, start,
                              stream.total_bits, max_len, sps)
    return _count_and_write(stream, dec_sym, dec_len, start, max_len, n_out,
                            tile_syms, use_tiles)


def decode_chunked(units_rows, chunk_bits, chunk_syms, dec_sym, dec_len,
                   max_len: int, chunk_symbols: int) -> torch.Tensor:
    """cuSZ's naive coarse-grained decoder: one sequential scan per chunk.

    Port of the reference's ``decode_chunked``: ``chunk_symbols`` steps of
    peek, LUT lookup, emit (0 once a row's ``chunk_bits`` are spent) and
    advance by ``max(len, 1)`` on every row of ``units_rows``
    (``encode_chunked``'s ``units``).  Returns uint16[n_chunks,
    chunk_symbols].  CUDA tensors run the ``decode_chunked`` kernel
    (``kernels/huffman_chunked.py``, one thread a chunk), CPU tensors its
    plain version; ``chunk_bits`` is taken as int64 and the LUT as the
    ``Codebook``'s tables on the rows' device.
    """
    # Imported here: the kernels package imports this one's modules.
    from repro_torch.kernels import huffman_chunked

    device = units_rows.device
    return huffman_chunked.decode_chunked(
        units_rows, torch.as_tensor(chunk_bits).to(device, torch.int64),
        torch.as_tensor(chunk_syms).to(device, torch.int32),
        torch.as_tensor(dec_sym).to(device, torch.uint16),
        torch.as_tensor(dec_len).to(device, torch.uint8), max_len,
        chunk_symbols)
