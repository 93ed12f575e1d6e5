"""Kernel-backed decode phases: the "cuda" backend's entry points.

Port of the decode half of ``src/repro/kernels/ops.py`` (``subseq_counts``,
``_tile_inputs``, ``decode_write_tiles``), signature-compatible with the
reference decoders in ``core/huffman/decode.py``.  The window rules of the
reference's ``_subseq_windows`` run inside the kernels here
(``common.subseq_windows`` in the plain versions), so the per-lane metadata
never round-trips through device memory.
"""

from __future__ import annotations

import torch

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
