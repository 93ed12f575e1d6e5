"""Kernel-backed decode phases: the "cuda" backend's entry points.

Port of the decode half of ``src/repro/kernels/ops.py`` (``subseq_counts``,
``_tile_inputs``, ``decode_write_tiles``, ``decode_write_tiles_fused`` with
its helpers ``_two_eb_f32``, ``fused_squeeze`` and ``fused_tile_rows``, and
the padded baseline ``decode_padded_compact`` / ``decode_padded_fused``),
signature-compatible with the reference decoders in
``core/huffman/decode.py``.  The window rules of the
reference's ``_subseq_windows`` run inside the kernels here
(``common.subseq_windows`` in the plain versions), so the per-lane metadata
never round-trips through device memory.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.huffman.pipeline import ss_max_for_tile
from repro_torch.kernels import fused_decode as _fus
from repro_torch.kernels import huffman_decode as _dec


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
