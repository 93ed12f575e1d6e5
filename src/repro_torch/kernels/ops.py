"""Kernel-backed phases: the "cuda" backends' entry points.

Port of ``src/repro/kernels/ops.py``.  The decode half (``subseq_counts``,
``_tile_inputs``, ``decode_write_tiles``, ``decode_write_tiles_fused`` with
its helpers ``_two_eb_f32``, ``fused_squeeze`` and ``fused_tile_rows``, and
the padded baseline ``decode_padded_compact`` / ``decode_padded_fused``),
signature-compatible with the reference decoders in
``core/huffman/decode.py``, and the self-sync discovery
``selfsync_sync`` (the ``selfsync_intra`` kernel, then the chaining of
sequence heads).  The window rules of the
reference's ``_subseq_windows`` run inside the kernels here
(``common.subseq_windows`` in the plain versions), so the per-lane metadata
never round-trips through device memory.  The encode half
(``encode_bitpack``, ``histogram``, ``lorenzo_quantize``,
``lorenzo_reconstruct``) serves the write path's "cuda" backend.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.huffman import encode as he
from repro_torch.core.huffman.encode import SUBSEQ_BITS
from repro_torch.core.huffman.pipeline import (DecodeGuardError,
                                               ss_max_for_tile)
from repro_torch.kernels import fused_decode as _fus
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels import huffman_decode as _dec
from repro_torch.kernels import huffman_encode as _enc
from repro_torch.kernels import huffman_selfsync as _sync
from repro_torch.kernels import lorenzo as _lor


def subseq_counts(units, dec_sym, dec_len, start_abs, end_abs,
                  total_bits: int, max_len: int):
    """Phase 1 on the kernel: ``(counts, landing)`` int32 per window."""
    return _dec.count_subseq(units, start_abs.to(torch.int32).contiguous(),
                             end_abs.to(torch.int32).contiguous(),
                             total_bits, dec_sym, dec_len, max_len)


def _tile_inputs(offsets, n_subseq: int, n_out: int, tile_syms: int):
    """First subsequence whose output range meets each tile (int32[n_tiles]):
    ``searchsorted(offsets, tile_base, right) - 1``, clipped."""
    n_tiles = (n_out + tile_syms - 1) // tile_syms
    tile_base = torch.arange(n_tiles, dtype=torch.int32,
                             device=offsets.device) * tile_syms
    s0 = torch.searchsorted(offsets, tile_base, right=True) - 1
    return s0.clamp(0, n_subseq - 1).to(torch.int32)


def decode_write_tiles(units, dec_sym, dec_len, start_bits, end_bits, offsets,
                       total_bits: int, max_len: int, n_out: int,
                       tile_syms: int, ss_max: int, lut_base=None):
    """Kernel-backed phase 4; signature-compatible with the reference
    ``core.huffman.decode.decode_write_tiles``.  Returns uint16[n_out]."""
    offsets = offsets.to(torch.int32).contiguous()
    s0 = _tile_inputs(offsets, start_bits.shape[0], n_out, tile_syms)
    return _dec.decode_tiles(units, start_bits.to(torch.int32).contiguous(),
                             end_bits.to(torch.int32).contiguous(), offsets,
                             s0, total_bits, dec_sym, dec_len, max_len,
                             tile_syms, ss_max, n_out, lut_base)


# ---------------------------------------------------------------------------
# Self-sync discovery: intra-sequence kernel + inter-sequence head chaining
# ---------------------------------------------------------------------------


def selfsync_sync(units, dec_sym, dec_len, total_bits: int, n_subseq: int,
                  subseqs_per_seq: int, max_len: int,
                  early_exit: bool = True):
    """Kernel-backed sync discovery (phases 1+2).

    Each pass is one ``selfsync_intra`` launch over every sequence; the
    landing of each sequence's last lane, minus 128, is the next head of the
    sequence after it (sequence 0's head is 0), and passes repeat until no
    head moves, one host sync a pass.  A correct head makes its sequence
    exact, so pass ``p`` fixes sequence ``p`` at the latest: more than
    ``n_seq + 1`` passes means corrupt input and raises
    ``DecodeGuardError`` (the caller counts the trip).  Returns
    ``(start_abs int32[n_subseq], counts int32[n_subseq], total_rounds
    int32[n_seq, 1])``, the rounds summed over the passes.
    """
    sps = subseqs_per_seq
    if n_subseq % sps:
        raise ValueError(f"n_subseq {n_subseq} is not a whole number of "
                         f"{sps}-subsequence sequences")
    n_seq = n_subseq // sps
    device = units.device
    heads = torch.zeros((n_seq, 1), dtype=torch.int32, device=device)
    total_rounds = torch.zeros_like(heads)
    for _ in range(n_seq + 1):
        start, counts, landing, rounds = _sync.selfsync_intra(
            units, heads, total_bits, dec_sym, dec_len, max_len, sps,
            early_exit)
        total_rounds += rounds
        new_heads = torch.cat([torch.zeros_like(heads[:1]),
                               landing[:-1, -1:] - 128])
        if torch.equal(new_heads, heads):
            break
        heads = new_heads
    else:
        raise DecodeGuardError(
            f"self-sync heads still moving after {n_seq + 1} passes over "
            f"{n_seq} sequences: corrupt stream")
    boundaries = torch.arange(n_subseq, dtype=torch.int32,
                              device=device) * SUBSEQ_BITS
    return boundaries + start.reshape(-1), counts.reshape(-1), total_rounds


# ---------------------------------------------------------------------------
# Fused phase 4: decode + dequantize + inverse Lorenzo
# ---------------------------------------------------------------------------


def _two_eb_f32(eb) -> float:
    """The reconstruction scale ``float32(eb) * 2`` as a Python float.

    Doubling commutes with float32 rounding (power-of-two scaling), so this
    is bit-identical to the ``2 * eb`` inside ``lorenzo.dequantize``.
    """
    return float(np.float32(eb) * np.float32(2))


def fused_squeeze(shape):
    """Canonical fused-path view of ``shape``: unit axes dropped.

    Cumsum along a unit axis is the identity, so reconstruction over the
    squeezed shape is bitwise the reconstruction over the full shape.
    Returns ``None`` when at most one axis is left (the 1-D kernel), as the
    reference does; the eligibility check (``compressor.
    fused_unsupported_reason``) and the dispatch below agree on this rule.
    """
    if shape is None:
        return None
    sq = tuple(int(s) for s in shape if s != 1)
    return sq if len(sq) > 1 else None


def fused_tile_rows(shape, tile_syms: int) -> int:
    """Rows per tile for the N-D fused kernel: ~``tile_syms`` codes rounded
    to whole rows; for 3-D the row count divides the plane height, so no
    tile crosses a plane (the row carry resets between tiles)."""
    plane_rows, cols = shape[-2], shape[-1]
    w = max(1, tile_syms // cols)
    w = min(w, plane_rows)
    if len(shape) == 3:
        while plane_rows % w:
            w -= 1
    return w


def _outlier_bounds(opos, n_tiles: int, block: int):
    """Each tile's slice ``[b[t], b[t + 1])`` of the outlier side list
    (int32[n_tiles + 1]).  Assumes the positions ascend with the ``-1``
    padding at the tail, as both packages' ``compress`` write them."""
    key = torch.where(opos >= 0, opos.to(torch.int64),
                      torch.iinfo(torch.int64).max)
    edges = torch.arange(n_tiles + 1, dtype=torch.int64,
                         device=opos.device) * block
    return torch.searchsorted(key, edges).to(torch.int32)


def fused_tile_inputs(units, dec_sym, dec_len, start_bits, end_bits,
                      offsets, total_bits: int, max_len: int, n_out: int,
                      tile_syms: int, ss_max: int, opos, oval, eb,
                      radius: int, lut_base=None, shape=None,
                      out_dtype=torch.float32):
    """The fused kernel :func:`decode_write_tiles_fused` launches, its plain
    version, and the arguments it gives them: ``(kernel, plain, args)``."""
    sq = fused_squeeze(shape)
    offsets = offsets.to(torch.int32).contiguous()
    starts = start_bits.to(torch.int32).contiguous()
    ends = end_bits.to(torch.int32).contiguous()
    opos = opos.to(device=units.device, dtype=torch.int32).contiguous()
    oval = oval.to(device=units.device, dtype=torch.int32).contiguous()
    two_eb = _two_eb_f32(eb)
    n_subseq = starts.shape[0]
    if sq is None:
        n_tiles = (n_out + tile_syms - 1) // tile_syms
        s0 = _tile_inputs(offsets, n_subseq, n_out, tile_syms)
        return _fus.decode_tiles_fused, _fus.decode_tiles_fused_plain, (
            units, starts, ends, offsets, s0, total_bits, dec_sym, dec_len,
            max_len, tile_syms, ss_max, n_out, opos, oval,
            _outlier_bounds(opos, n_tiles, tile_syms), two_eb, radius,
            out_dtype, lut_base)
    if int(np.prod(sq)) != n_out:
        raise ValueError(f"n_out {n_out} differs from the size of shape "
                         f"{tuple(shape)}")
    # N-D: re-tile along whole rows; the lane budget follows the new tile.
    rows_per_tile = fused_tile_rows(sq, tile_syms)
    block = rows_per_tile * sq[-1]
    n_tiles = (n_out + block - 1) // block
    s0 = _tile_inputs(offsets, n_subseq, n_out, block)
    return _fus.decode_tiles_fused_nd, _fus.decode_tiles_fused_nd_plain, (
        units, starts, ends, offsets, s0, total_bits, dec_sym, dec_len,
        max_len, rows_per_tile, sq, ss_max_for_tile(block, max_len), opos,
        oval, _outlier_bounds(opos, n_tiles, block), two_eb, radius,
        out_dtype, lut_base)


def decode_write_tiles_fused(units, dec_sym, dec_len, start_bits, end_bits,
                             offsets, total_bits: int, max_len: int,
                             n_out: int, tile_syms: int, ss_max: int, opos,
                             oval, eb, radius: int, lut_base=None,
                             shape=None, out_dtype=torch.float32):
    """Fused phase 4: tile decode + dequantize + inverse-Lorenzo epilogue.

    Same tile mapping as :func:`decode_write_tiles` for a flat field; the
    kernel carries the decoded symbols through ``2*eb*cumsum(code -
    radius)`` (outlier side list ``opos``/``oval`` scattered in) without
    writing the quant-code array.  ``shape`` selects the 2-D/3-D epilogue
    after its unit axes are squeezed, so ``(1, n)`` still takes the 1-D
    kernel; the N-D kernel re-tiles to whole rows and re-derives the lane
    budget for that tile.  Returns ``out_dtype[n_out]`` (flat, C order).
    """
    kernel, _, args = fused_tile_inputs(
        units, dec_sym, dec_len, start_bits, end_bits, offsets, total_bits,
        max_len, n_out, tile_syms, ss_max, opos, oval, eb, radius, lut_base,
        shape, out_dtype)
    return kernel(*args)


# ---------------------------------------------------------------------------
# Padded baseline: padded rows + compaction, and its fused epilogue
# ---------------------------------------------------------------------------

#: Codes a tile of the padded path's epilogue holds (1-D), and the tile
#: size whose whole rows make an N-D epilogue tile: the reference's fixed
#: block.
PADDED_EPILOGUE_BLOCK = 4096


def decode_padded_compact(units, dec_sym, dec_len, start_abs, end_abs,
                          total_bits: int, max_len: int, n_out: int):
    """Kernel-backed baseline phase 4: the padded ``(n_subseq, 128)`` rows
    of ``huffman_decode.decode_padded``, then the compaction the reference
    does outside its kernel (output offsets, ``searchsorted`` owner of each
    output position, gather).  Returns ``(uint16[n_out], counts)``."""
    padded, counts = _dec.decode_padded(
        units, start_abs.to(torch.int32).contiguous(),
        end_abs.to(torch.int32).contiguous(), total_bits, dec_sym, dec_len,
        max_len)
    n = counts.shape[0]
    if n == 0 or n_out == 0:
        return torch.zeros(n_out, dtype=torch.uint16,
                           device=units.device), counts
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=units.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
    out_pos = torch.arange(n_out, dtype=torch.int32, device=units.device)
    owner = (torch.searchsorted(offsets, out_pos, right=True) - 1).clamp(
        0, n - 1)
    within = (out_pos - offsets[owner]).clamp(0, padded.shape[1] - 1)
    # uint16 has no gather on every build: gather the int16 view.
    flat = padded.view(torch.int16).reshape(-1)
    return flat[owner * padded.shape[1] + within].view(torch.uint16), counts


def padded_epilogue_inputs(codes, n_out: int, opos, oval, eb, radius: int,
                           shape=None, out_dtype=torch.float32):
    """The epilogue kernel :func:`decode_padded_fused` launches on the
    compacted ``codes`` (uint16[n_out]), its plain version, and the
    arguments it gives them: ``(kernel, plain, args)``.

    As in the reference, the codes are padded with zeros to whole tiles:
    ``PADDED_EPILOGUE_BLOCK`` codes (1-D, whose kernel returns the padded
    length) or ``fused_tile_rows(shape, PADDED_EPILOGUE_BLOCK)`` rows
    (2-D/3-D), and each tile gets its slice of the outlier side list.
    """
    sq = fused_squeeze(shape)
    opos = opos.to(device=codes.device, dtype=torch.int32).contiguous()
    oval = oval.to(device=codes.device, dtype=torch.int32).contiguous()
    two_eb = _two_eb_f32(eb)
    if sq is None:
        block = PADDED_EPILOGUE_BLOCK
    else:
        if int(np.prod(sq)) != n_out:
            raise ValueError(f"n_out {n_out} differs from the size of shape "
                             f"{tuple(shape)}")
        rows_per_tile = fused_tile_rows(sq, PADDED_EPILOGUE_BLOCK)
        block = rows_per_tile * sq[-1]
    pad = (-n_out) % block
    if pad:
        codes = torch.cat([codes, torch.zeros(pad, dtype=codes.dtype,
                                              device=codes.device)])
    obounds = _outlier_bounds(opos, (n_out + pad) // block, block)
    if sq is None:
        return _fus.dequant_reconstruct, _fus.dequant_reconstruct_plain, (
            codes, opos, oval, obounds, two_eb, radius, block, out_dtype)
    return _fus.dequant_reconstruct_nd, _fus.dequant_reconstruct_nd_plain, (
        codes, opos, oval, obounds, two_eb, radius, sq, rows_per_tile,
        out_dtype)


def decode_padded_fused(units, dec_sym, dec_len, start_abs, end_abs,
                        total_bits: int, max_len: int, n_out: int, opos,
                        oval, eb, radius: int, shape=None,
                        out_dtype=torch.float32):
    """Fused baseline phase 4: :func:`decode_padded_compact`, then the
    epilogue kernel over the codes (``dequant_reconstruct`` for a flat
    field, ``dequant_reconstruct_nd`` for 2-D/3-D after the unit axes are
    squeezed).  Returns ``out_dtype[n_out]`` (flat, C order)."""
    codes, _ = decode_padded_compact(units, dec_sym, dec_len, start_abs,
                                     end_abs, total_bits, max_len, n_out)
    kernel, _, args = padded_epilogue_inputs(codes, n_out, opos, oval, eb,
                                             radius, shape, out_dtype)
    return kernel(*args)[:n_out]


# ---------------------------------------------------------------------------
# Encode bit-pack (write-path phase 4)
# ---------------------------------------------------------------------------

def code_starts(symbols, enc_len):
    """int32 exclusive scan of the symbols' code lengths: each codeword's
    first bit, the ``starts`` input of ``pack_tiles``."""
    lens = enc_len.to(torch.int32)[symbols.to(torch.int32)]
    return torch.cumsum(lens, 0, dtype=torch.int32) - lens


def encode_bitpack(symbols, enc_code, enc_len, total_bits: int,
                   subseqs_per_seq: int, min_len: int = 1,
                   tile_units: int | None = None
                   ) -> he.EncodedStream:
    """Kernel-backed Huffman encode: the int32 exclusive scan of the code
    lengths (torch glue), the ``pack_tiles`` kernel and the stream metadata.

    ``total_bits`` is the exact payload size (the ``EncoderPlan`` derives it
    from the histogram, so the symbol array never round-trips to host).
    ``min_len`` only sizes the reference's lane budget, which the kernel
    does not need; ``tile_units`` None takes the kernel's tile from
    ``huffman_encode.pack_tiles_geometry``.  Layout bit-identical to
    ``core.huffman.encode.encode``.
    """
    del min_len
    device = symbols.device
    if symbols.numel() == 0:
        return he.empty_stream(subseqs_per_seq, device=device)
    n_units_padded = he.units_for_bits(total_bits, subseqs_per_seq)
    sym = symbols.reshape(-1)
    enc_code = torch.as_tensor(enc_code).to(device)
    enc_len = torch.as_tensor(enc_len).to(device)
    starts = code_starts(sym, enc_len)
    units = _enc.pack_tiles(sym.to(torch.uint16).contiguous(), starts,
                            enc_code.contiguous(), enc_len.contiguous(),
                            n_units_padded, tile_units)
    gaps, counts, seq_counts = he.stream_metadata(
        starts, total_bits, n_units_padded, subseqs_per_seq)
    return he.EncodedStream(
        units=units, gaps=gaps, counts=counts, seq_counts=seq_counts,
        total_bits=int(total_bits), n_symbols=int(sym.shape[0]),
        subseqs_per_seq=subseqs_per_seq)


# ---------------------------------------------------------------------------
# Histogram + Lorenzo wrappers
# ---------------------------------------------------------------------------

histogram = _hist.histogram


def lorenzo_quantize(x, eb, radius: int = 512):
    """Dual-quant Lorenzo quantize of a float32 tensor on the kernel: one
    launch for any shape of at most ``lorenzo.MAX_AXES`` non-unit axes
    (the reference's Pallas backend ran its kernel for 1-D inputs only).
    Returns ``(codes uint16, outlier bool, residual int32)`` shaped like
    ``x``, bit-identical to ``core/sz/lorenzo.py:quantize``."""
    return _lor.lorenzo_quantize(x.contiguous(), _two_eb_f32(eb), radius)


def lorenzo_reconstruct(d, eb, shape=None):
    """Inverse Lorenzo; 1-D (``shape`` None or 1-D) on the
    ``reconstruct1d`` kernel, N-D as a per-axis int32 cumsum in torch ops,
    as in the reference.  Returns float32, flat for 1-D, else ``shape``."""
    two_eb = _two_eb_f32(eb)
    if shape is None or len(shape) == 1:
        return _lor.reconstruct1d(d.reshape(-1).to(torch.int32).contiguous(),
                                  two_eb)
    q = d.reshape(shape)
    for axis in range(len(shape)):
        q = torch.cumsum(q, dim=axis, dtype=torch.int32)
    scale = torch.tensor(two_eb, dtype=torch.float32, device=d.device)
    return q.to(torch.float32) * scale
