"""Reference Huffman decoders (plain torch): the "ref" backend's phases.

Port of the gap-array half of ``src/repro/core/huffman/decode.py``:

  1. count decode ("get output idx.")    -> :func:`subseq_scan`
  2. prefix sum                          -> :func:`output_offsets`
  3. tile-staged decode + write          -> :func:`decode_write_tiles`
     (or the padded baseline layout      -> :func:`decode_write`)

These work in absolute stream coordinates (:func:`bits.peek`) and are the
oracles of the CUDA kernels in ``repro_torch.kernels``.
:func:`decode_sequential` is the ground-truth oracle for small streams on
the CPU; no decode path of the port calls it.
"""

from __future__ import annotations

import torch

from repro_torch.core.huffman.bits import SUBSEQ_BITS, peek

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
