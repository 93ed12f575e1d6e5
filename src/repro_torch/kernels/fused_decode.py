"""Fused decode -> dequantize -> inverse Lorenzo: CUDA wrappers and plain
versions.

Port of ``src/repro/kernels/fused_decode.py``:

  * :func:`decode_tiles_fused` -- phase 4 for flat fields: the tile decode
    of ``decode_tiles``, ``d = code - radius`` with the outlier side list
    scattered in, the 1-D inverse Lorenzo (an int32 cumsum carried across
    tiles by decoupled look-back) and ``cast(float(q) * 2eb)``
    (``csrc/decode_tiles_fused.cu``).
  * :func:`decode_tiles_fused_nd` -- the same for 2-D/3-D fields, with
    whole-row tiles, a chained ``(cols,)`` row carry and a ``(rows, cols)``
    plane carry handed on through global memory as tagged words
    (``csrc/decode_tiles_fused_nd.cu``).
  * :func:`dequant_reconstruct` / :func:`dequant_reconstruct_nd` -- the
    same epilogues alone, over a uint16 code array: the fused form of the
    padded decoder (``csrc/dequant_reconstruct.cu``,
    ``csrc/dequant_reconstruct_nd.cu``; carries as above, shared through
    ``csrc/fused.cuh``).

The decode kernels write no quant-code array: every wrapper allocates only
the output and the carry scratch, zeroed on the current stream for every
launch.  The wrappers follow ``huffman_decode``'s rules: input checks, the
kernel for CUDA tensors, the plain version (``*_plain``) for CPU tensors,
any other device raises, and each launch is counted (``kernels/launches``).

The plain versions are the monolithic dequantize of
``core/sz/lorenzo.py:dequantize`` (int32 cumsum along every axis of the
squeezed shape, one f32 multiply, one cast), after ``decode_tiles_plain``
for the decode kernels.  They use no carry at all, so they are an oracle
for the kernels' carry design.

Outlier ranges: the kernels read only the slice ``[obounds[t],
obounds[t + 1])`` of the side list for tile ``t``.  ``ops`` finds the
slices by ``searchsorted``, which assumes the side list's positions ascend
with the ``-1`` padding at the tail, as both packages' ``compress`` write it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

#: Output dtypes the fused kernels write, and their code in the C interface.
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Shared scratch bytes of a fused block beside its tile and LUT (80 words:
#: warp partials of the block scan, the ticket, the carry).
SCRATCH_BYTES = 320
#: Most whole tiles one block of the 2-D kernel takes, to shorten the chain.
MAX_GROUP = 8



def decode_tiles_fused_smem(tile_syms: int, lut: int) -> int:
    """Shared memory of one ``decode_tiles_fused`` block: the int32
    residual tile, the scan scratch and the LUT (u16 symbol + u8 length)."""
    return 4 * tile_syms + SCRATCH_BYTES + 3 * lut


def decode_tiles_fused_nd_smem(block: int, lut: int) -> int:
    """Shared memory of one ``decode_tiles_fused_nd`` block of ``block =
    rows_per_tile * cols`` codes (the carries live in global memory)."""
    return decode_tiles_fused_smem(block, lut)


def dequant_reconstruct_smem(block: int) -> int:
    """Shared memory of one epilogue block (either geometry) of ``block``
    codes: the int32 residual tile and the scan scratch; no LUT."""
    return decode_tiles_fused_smem(block, 0)


def tile_group(shape, block: int, n_tiles: int, lut: int) -> int:
    """Tiles one block of an N-D kernel takes: for 2-D as many whole tiles
    as shared memory holds beside a ``lut``-entry LUT (0 for the epilogue),
    at most ``MAX_GROUP``, so the one row-carry chain has ``group`` times
    fewer steps; 1 for 3-D, whose chains run side by side."""
    if len(shape) == 3:
        return 1
    fit = (K.SMEM_LIMIT - decode_tiles_fused_nd_smem(0, lut)) // (4 * block)
    return max(1, min(MAX_GROUP, n_tiles, fit))


def ring_slots(shape, rows_per_tile: int) -> int:
    """Row-carry ring vectors of the N-D kernel: 1 for 2-D; for 3-D
    ``min(planes, tiles a plane)``, which keeps every wait of the kernel's
    diagonal tile order on an earlier diagonal and the ring no larger than
    the plane carry."""
    if len(shape) == 2:
        return 1
    return min(shape[0], shape[1] // rows_per_tile)


def _reconstruct_plain(codes, opos, oval, two_eb: float, radius: int, shape,
                       out_dtype):
    """``lorenzo.dequantize`` over ``shape`` with the scale given as the
    float32 value ``two_eb``; flat result."""
    n = codes.numel()
    flat = torch.empty(n + 1, dtype=torch.int32, device=codes.device)
    torch.sub(codes.reshape(-1).to(torch.int32), radius, out=flat[:n])
    pos = opos.to(torch.int64)
    safe = torch.where((pos >= 0) & (pos < n), pos, n)
    flat[safe] = oval.to(torch.int32)
    q = flat[:n].reshape(shape)
    for axis in range(q.ndim):
        q = torch.cumsum(q, dim=axis, dtype=torch.int32)
    scale = torch.tensor(two_eb, dtype=torch.float32, device=codes.device)
    return (q.to(torch.float32) * scale).to(out_dtype).reshape(-1)


def _check_fused(opos, oval, obounds, n_tiles, two_eb, radius, out_dtype,
                 device):
    K._expect("opos", opos, torch.int32)
    if opos.ndim != 1:
        raise ValueError("opos must be 1-D")
    K._expect("oval", oval, torch.int32, opos.shape)
    K._expect("obounds", obounds, torch.int32, (n_tiles + 1,))
    for name, t in (("opos", opos), ("oval", oval), ("obounds", obounds)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, units on {device}: "
                             f"all inputs must share a device")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"out_dtype must be one of {list(OUT_KINDS)}, got "
                        f"{out_dtype}")
    K._check_two_eb(two_eb)
    if not 1 <= radius <= 1 << 15:
        raise ValueError(f"radius must be in [1, 32768], got {radius}")


def _check_tiles(units, start_abs, end_abs, offsets, s0, lut_base, n_tiles,
                 dec_sym, dec_len, max_len, total_bits, ss_max):
    K._check_stream(units, dec_sym, dec_len, max_len, total_bits,
                    {"start_abs": start_abs, "end_abs": end_abs,
                     "offsets": offsets, "s0": s0, "lut_base": lut_base})
    K._expect("start_abs", start_abs, torch.int32)
    if start_abs.ndim != 1 or start_abs.numel() < 1:
        raise ValueError("start_abs must be a non-empty 1-D tensor")
    n_subseq = start_abs.shape[0]
    K._expect("end_abs", end_abs, torch.int32, (n_subseq,))
    K._expect("offsets", offsets, torch.int32, (n_subseq + 1,))
    K._expect("s0", s0, torch.int32, (n_tiles,))
    if lut_base is not None:
        K._expect("lut_base", lut_base, torch.int32, (n_subseq,))
    if ss_max < 1:
        raise ValueError(f"ss_max must be >= 1, got {ss_max}")


# ---------------------------------------------------------------------------
# 1-D
# ---------------------------------------------------------------------------


def decode_tiles_fused_plain(units, start_abs, end_abs, offsets, s0,
                             total_bits: int, dec_sym, dec_len, max_len: int,
                             tile_syms: int, ss_max: int, n_out: int, opos,
                             oval, obounds, two_eb: float, radius: int,
                             out_dtype=torch.float32, lut_base=None):
    """Plain version of :func:`decode_tiles_fused` (any device; ``obounds``
    is not needed: the whole side list is scattered at once)."""
    del obounds
    codes = K.decode_tiles_plain(units, start_abs, end_abs, offsets, s0,
                                 total_bits, dec_sym, dec_len, max_len,
                                 tile_syms, ss_max, n_out, lut_base)
    return _reconstruct_plain(codes, opos, oval, two_eb, radius, (n_out,),
                              out_dtype)


@launches.counted
def decode_tiles_fused(units, start_abs, end_abs, offsets, s0,
                       total_bits: int, dec_sym, dec_len, max_len: int,
                       tile_syms: int, ss_max: int, n_out: int, opos, oval,
                       obounds, two_eb: float, radius: int,
                       out_dtype=torch.float32, lut_base=None):
    """Fused phase 4 of a flat field: ``out_dtype[n_out]`` reconstructed
    values, ``2eb * cumsum(code - radius)`` with the outliers scattered in.

    The stream inputs are :func:`huffman_decode.decode_tiles`'s.  ``opos`` /
    ``oval`` are the ``-1``-padded outlier side list (int32[m]),
    ``obounds`` int32[n_tiles + 1] each tile's slice of it, ``two_eb`` the
    float32 scale as a Python float (``ops._two_eb_f32``).
    """
    if tile_syms < 1 or n_out < 0:
        raise ValueError(f"bad tiling: tile_syms={tile_syms}, n_out={n_out}")
    n_tiles = (n_out + tile_syms - 1) // tile_syms
    _check_tiles(units, start_abs, end_abs, offsets, s0, lut_base, n_tiles,
                 dec_sym, dec_len, max_len, total_bits, ss_max)
    _check_fused(opos, oval, obounds, n_tiles, two_eb, radius, out_dtype,
                 units.device)
    if units.device.type == "cpu":
        return decode_tiles_fused_plain(
            units, start_abs, end_abs, offsets, s0, total_bits, dec_sym,
            dec_len, max_len, tile_syms, ss_max, n_out, opos, oval, obounds,
            two_eb, radius, out_dtype, lut_base)
    lut = dec_sym.numel()
    K._check_smem("decode_tiles_fused", decode_tiles_fused_smem(tile_syms,
                                                                lut))
    out = torch.empty(n_out, dtype=out_dtype, device=units.device)
    if n_tiles == 0:
        return out
    # ticket (uint32, padded to 8 B), then one uint64 status word per tile
    scratch = torch.zeros(2 + 2 * n_tiles, dtype=torch.int32,
                          device=units.device)
    launch = _build.load("decode_tiles_fused")
    rc = launch(units.data_ptr(), units.numel(), start_abs.data_ptr(),
                end_abs.data_ptr(), offsets.data_ptr(), s0.data_ptr(),
                None if lut_base is None else lut_base.data_ptr(),
                start_abs.shape[0], int(total_bits), dec_sym.data_ptr(),
                dec_len.data_ptr(), lut, max_len, tile_syms, ss_max, n_out,
                n_tiles, opos.data_ptr(), oval.data_ptr(), obounds.data_ptr(),
                radius, two_eb, scratch.data_ptr(), scratch.data_ptr() + 8,
                OUT_KINDS[out_dtype], out.data_ptr(),
                K._stream_ptr(units.device))
    if rc != 0:
        raise RuntimeError(f"decode_tiles_fused kernel launch failed: CUDA "
                           f"error {rc}")
    launches.launched(decode_tiles_fused)
    return out


# ---------------------------------------------------------------------------
# 2-D / 3-D
# ---------------------------------------------------------------------------


def _nd_geometry(shape, rows_per_tile: int):
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"shape must be a 2-D or 3-D shape of positive "
                         f"sizes, got {shape}")
    rows, cols = shape[-2], shape[-1]
    if not 1 <= rows_per_tile <= rows:
        raise ValueError(f"rows_per_tile {rows_per_tile} outside [1, {rows}]")
    if len(shape) == 3 and rows % rows_per_tile:
        raise ValueError(f"rows_per_tile {rows_per_tile} must divide the "
                         f"plane height {rows} of a 3-D field")
    return shape, rows_per_tile * cols, math.prod(shape)


class _NdLaunch:
    """Grid and carry scratch of one N-D kernel launch: ``group`` tiles a
    unit (:func:`tile_group`), ``units_per_plane`` units a plane, the ring
    of ``slots`` row-carry vectors (:func:`ring_slots`), and one zeroed
    int64 buffer holding the ticket (8 B), the ring (slots x cols tagged
    words) and, for 3-D, the plane carry (rows x cols tagged words)."""

    def __init__(self, shape, rows_per_tile: int, n_tiles: int, lut: int,
                 device):
        rows, self.cols = shape[-2], shape[-1]
        self.planes = shape[0] if len(shape) == 3 else 1
        block = rows_per_tile * self.cols
        self.group = tile_group(shape, block, n_tiles, lut)
        self.units_per_plane = (rows // rows_per_tile if self.planes > 1
                                else (n_tiles + self.group - 1) // self.group)
        self.slots = ring_slots(shape, rows_per_tile)
        n_plane = rows * self.cols if self.planes > 1 else 0
        self.scratch = torch.zeros(1 + self.slots * self.cols + n_plane,
                                   dtype=torch.int64, device=device)
        self.ticket = self.scratch.data_ptr()
        self.row_carry = self.ticket + 8
        self.plane_carry = (self.row_carry + 8 * self.slots * self.cols
                            if self.planes > 1 else None)


def decode_tiles_fused_nd_plain(units, start_abs, end_abs, offsets, s0,
                                total_bits: int, dec_sym, dec_len,
                                max_len: int, rows_per_tile: int, shape,
                                ss_max: int, opos, oval, obounds,
                                two_eb: float, radius: int,
                                out_dtype=torch.float32, lut_base=None):
    """Plain version of :func:`decode_tiles_fused_nd` (any device)."""
    del obounds
    shape, block, n_out = _nd_geometry(shape, rows_per_tile)
    codes = K.decode_tiles_plain(units, start_abs, end_abs, offsets, s0,
                                 total_bits, dec_sym, dec_len, max_len,
                                 block, ss_max, n_out, lut_base)
    return _reconstruct_plain(codes, opos, oval, two_eb, radius, shape,
                              out_dtype)


@launches.counted
def decode_tiles_fused_nd(units, start_abs, end_abs, offsets, s0,
                          total_bits: int, dec_sym, dec_len, max_len: int,
                          rows_per_tile: int, shape, ss_max: int, opos, oval,
                          obounds, two_eb: float, radius: int,
                          out_dtype=torch.float32, lut_base=None):
    """:func:`decode_tiles_fused` with the 2-D/3-D inverse Lorenzo.

    ``shape`` is the squeezed shape, ``(rows, cols)`` or ``(planes, rows,
    cols)``; a tile is ``rows_per_tile`` whole rows (``ops.fused_tile_rows``,
    which divides ``rows`` for 3-D), so ``s0`` and ``obounds`` are over
    tiles of ``rows_per_tile * cols`` codes.  Returns ``out_dtype[prod(
    shape)]``, flat in C order.
    """
    shape, block, n_out = _nd_geometry(shape, rows_per_tile)
    n_tiles = (n_out + block - 1) // block
    _check_tiles(units, start_abs, end_abs, offsets, s0, lut_base, n_tiles,
                 dec_sym, dec_len, max_len, total_bits, ss_max)
    _check_fused(opos, oval, obounds, n_tiles, two_eb, radius, out_dtype,
                 units.device)
    if units.device.type == "cpu":
        return decode_tiles_fused_nd_plain(
            units, start_abs, end_abs, offsets, s0, total_bits, dec_sym,
            dec_len, max_len, rows_per_tile, shape, ss_max, opos, oval,
            obounds, two_eb, radius, out_dtype, lut_base)
    lut = dec_sym.numel()
    K._check_smem("decode_tiles_fused_nd",
                  decode_tiles_fused_nd_smem(block, lut))
    out = torch.empty(n_out, dtype=out_dtype, device=units.device)
    g = _NdLaunch(shape, rows_per_tile, n_tiles, lut, units.device)
    launch = _build.load("decode_tiles_fused_nd")
    rc = launch(units.data_ptr(), units.numel(), start_abs.data_ptr(),
                end_abs.data_ptr(), offsets.data_ptr(), s0.data_ptr(),
                None if lut_base is None else lut_base.data_ptr(),
                start_abs.shape[0], int(total_bits), dec_sym.data_ptr(),
                dec_len.data_ptr(), lut, max_len, rows_per_tile, g.cols,
                g.planes, g.units_per_plane, g.group, g.slots, ss_max, n_out,
                n_tiles, opos.data_ptr(), oval.data_ptr(), obounds.data_ptr(),
                radius, two_eb, g.ticket, g.row_carry, g.plane_carry,
                OUT_KINDS[out_dtype], out.data_ptr(),
                K._stream_ptr(units.device))
    if rc != 0:
        raise RuntimeError(f"decode_tiles_fused_nd kernel launch failed: "
                           f"CUDA error {rc}")
    launches.launched(decode_tiles_fused_nd)
    return out


# ---------------------------------------------------------------------------
# The epilogues alone, over a code array (the padded decoder's fused form)
# ---------------------------------------------------------------------------


def _check_codes(codes, block: int):
    K._expect("codes", codes, torch.uint16)
    if codes.ndim != 1:
        raise ValueError(f"codes must be 1-D, got shape {tuple(codes.shape)}")
    if block < 1 or codes.numel() % block:
        raise ValueError(f"codes ({codes.numel()}) must be padded to a whole "
                         f"number of {block}-code tiles")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain path for device "
                         f"{codes.device}")


def dequant_reconstruct_plain(codes, opos, oval, obounds, two_eb: float,
                              radius: int, block: int = 4096,
                              out_dtype=torch.float32):
    """Plain version of :func:`dequant_reconstruct` (any device)."""
    del obounds, block
    return _reconstruct_plain(codes, opos, oval, two_eb, radius,
                              (codes.numel(),), out_dtype)


@launches.counted
def dequant_reconstruct(codes, opos, oval, obounds, two_eb: float,
                        radius: int, block: int = 4096,
                        out_dtype=torch.float32):
    """The 1-D epilogue over a code array: ``out_dtype[n]`` reconstructed
    values, ``2eb * cumsum(code - radius)`` with the outliers scattered in.

    ``codes`` is uint16[n], padded to a whole number of ``block``-code tiles
    (pad codes decode past the real output and only pollute the final
    tile's tail); ``opos`` / ``oval`` the ``-1``-padded outlier side list,
    ``obounds`` int32[n / block + 1] each tile's slice of it, ``two_eb``
    the float32 scale as a Python float (``ops._two_eb_f32``).
    """
    _check_codes(codes, block)
    n_tiles = codes.numel() // block
    _check_fused(opos, oval, obounds, n_tiles, two_eb, radius, out_dtype,
                 codes.device)
    if codes.device.type == "cpu":
        return dequant_reconstruct_plain(codes, opos, oval, obounds, two_eb,
                                         radius, block, out_dtype)
    K._check_smem("dequant_reconstruct", dequant_reconstruct_smem(block))
    out = torch.empty(codes.numel(), dtype=out_dtype, device=codes.device)
    if n_tiles == 0:
        return out
    # ticket (uint32, padded to 8 B), then one uint64 status word per tile
    scratch = torch.zeros(2 + 2 * n_tiles, dtype=torch.int32,
                          device=codes.device)
    launch = _build.load("dequant_reconstruct")
    rc = launch(codes.data_ptr(), block, n_tiles, opos.data_ptr(),
                oval.data_ptr(), obounds.data_ptr(), radius, two_eb,
                scratch.data_ptr(), scratch.data_ptr() + 8,
                OUT_KINDS[out_dtype], out.data_ptr(),
                K._stream_ptr(codes.device))
    if rc != 0:
        raise RuntimeError(f"dequant_reconstruct kernel launch failed: CUDA "
                           f"error {rc}")
    launches.launched(dequant_reconstruct)
    return out


def dequant_reconstruct_nd_plain(codes, opos, oval, obounds, two_eb: float,
                                 radius: int, shape, rows_per_tile: int,
                                 out_dtype=torch.float32):
    """Plain version of :func:`dequant_reconstruct_nd` (any device)."""
    del obounds
    shape, _, n_out = _nd_geometry(shape, rows_per_tile)
    return _reconstruct_plain(codes[:n_out], opos, oval, two_eb, radius,
                              shape, out_dtype)


@launches.counted
def dequant_reconstruct_nd(codes, opos, oval, obounds, two_eb: float,
                           radius: int, shape, rows_per_tile: int,
                           out_dtype=torch.float32):
    """:func:`dequant_reconstruct` with the 2-D/3-D inverse Lorenzo.

    ``shape`` is the squeezed shape; a tile is ``rows_per_tile`` whole rows
    (``ops.fused_tile_rows``), and ``codes`` is padded to a whole number of
    tiles (pad rows sit after the last row).  Returns ``out_dtype[prod(
    shape)]``, flat in C order.
    """
    shape, block, n_out = _nd_geometry(shape, rows_per_tile)
    _check_codes(codes, block)
    n_tiles = codes.numel() // block
    if n_tiles != -(-n_out // block):
        raise ValueError(f"codes hold {n_tiles} tiles of {block}; shape "
                         f"{shape} needs {-(-n_out // block)}")
    _check_fused(opos, oval, obounds, n_tiles, two_eb, radius, out_dtype,
                 codes.device)
    if codes.device.type == "cpu":
        return dequant_reconstruct_nd_plain(codes, opos, oval, obounds,
                                            two_eb, radius, shape,
                                            rows_per_tile, out_dtype)
    K._check_smem("dequant_reconstruct_nd", dequant_reconstruct_smem(block))
    out = torch.empty(n_out, dtype=out_dtype, device=codes.device)
    g = _NdLaunch(shape, rows_per_tile, n_tiles, 0, codes.device)
    launch = _build.load("dequant_reconstruct_nd")
    rc = launch(codes.data_ptr(), rows_per_tile, g.cols, g.planes,
                g.units_per_plane, g.group, g.slots, n_out, n_tiles,
                opos.data_ptr(), oval.data_ptr(), obounds.data_ptr(), radius,
                two_eb, g.ticket, g.row_carry, g.plane_carry,
                OUT_KINDS[out_dtype], out.data_ptr(),
                K._stream_ptr(codes.device))
    if rc != 0:
        raise RuntimeError(f"dequant_reconstruct_nd kernel launch failed: "
                           f"CUDA error {rc}")
    launches.launched(dequant_reconstruct_nd)
    return out
