"""Fused decode -> dequantize -> inverse Lorenzo: CUDA wrappers and plain
versions.

Port of ``src/repro/kernels/fused_decode.py``:

  * :func:`decode_tiles_fused` -- phase 4 for flat fields: the tile decode
    of ``decode_tiles``, ``d = code - radius`` with the outlier side list
    scattered in, the 1-D inverse Lorenzo (an int32 cumsum carried across
    units of consecutive tiles by a warp-wide decoupled look-back) and
    ``cast(float(q) * 2eb)``, over a persistent grid
    (``csrc/decode_tiles_fused.cu``; the geometry from
    :func:`fused_geometry`).
  * :func:`decode_tiles_fused_nd` -- the same for 2-D/3-D fields, with
    whole-row tiles taken a unit of tiles a block, and the ``(cols,)`` row
    carry and the plane carry found by decoupled look-back over a ring of
    flagged statuses in global memory (``csrc/decode_tiles_fused_nd.cu``;
    the geometry from :func:`nd_geometry`).
  * :func:`dequant_reconstruct` / :func:`dequant_reconstruct_nd` -- the
    same epilogues alone, over a uint16 code array: the fused form of the
    padded decoder (``csrc/dequant_reconstruct.cu``, on persistent blocks
    that read the next unit of codes by bulk copy while they write the
    last, the geometry from :func:`epilogue_geometry`;
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

import functools
import math
import typing

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

#: Output dtypes the fused kernels write, and their code in the C interface.
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Shared scratch bytes of a fused block beside its tile and LUT (80 words:
#: warp partials of the block scan, the ticket, the carry).
SCRATCH_BYTES = 320
#: Most whole tiles one unit (block) of a fused kernel takes.
MAX_GROUP = 8
#: The 1-D kernel's block width, the blocks an SM holds at that width and
#: the register bound that follows (its __launch_bounds__(512, 3):
#: csrc/decode_tiles_fused.cu, kFusedMaxThreads, kFusedMinBlocks), and the
#: units its look-back reads at once (a warp's lanes).  On the H100 at
#: hacc1d's shape, blocks of 512 ran faster than of 256 or 384.
FUSED_MAX_THREADS = 512
FUSED_MIN_BLOCKS = 3
FUSED_REGS = 40
LOOKBACK_WINDOW = 32
#: The 1-D epilogues' block width and the register bound that their
#: __launch_bounds__(512, 3) sets (csrc/fused.cuh, kEpilogueThreads,
#: kEpilogueMinBlocks); the stages of a unit a block keeps in shared memory
#: (kEpilogueStages: the unit it reads, the one it sums, the one it
#: writes); and the input bytes a unit aims for.  On the H100 at hacc1d's
#: shape, units of 32 KiB (2 blocks an SM) ran faster than of 16 KiB (3)
#: or 64 KiB (1).
EPILOGUE_THREADS = 512
EPILOGUE_MIN_BLOCKS = 3
EPILOGUE_REGS = 40
EPILOGUE_STAGES = 3
EPILOGUE_UNIT_BYTES = 32768
#: Most chain predecessors an N-D unit's look-back reads before it waits
#: for the last of them to publish its inclusive prefix (at most 32, the
#: lanes of the warp that reads their flags): deep for 2-D, whose one row
#: chain holds every unit in flight, shallow for 3-D, whose many short
#: chains rarely hold more than a few, which keeps its ring small.
LOOKBACK_DEPTH_2D = 32
LOOKBACK_DEPTH_3D = 8
#: Widest block of the N-D kernels and their register bound: the kernels'
#: __launch_bounds__(512, 2) (csrc/fused.cuh: kNdMaxThreads, kNdMinBlocks).
#: A unit of at least ``ND_WIDE_UNIT`` codes (a 2-D unit of wide rows)
#: takes a block of 512 threads, any other 256.
ND_MAX_THREADS = 512
ND_REGS = 64
ND_WIDE_UNIT = 16384


def _residual_tile_smem(block: int, lut: int) -> int:
    """Shared memory of a block of ``block`` codes staged as int32
    residuals (the N-D kernels and the epilogues), the scan scratch and the
    LUT (u16 symbol + u8 length)."""
    return 4 * block + SCRATCH_BYTES + 3 * lut


#: Bytes of a 1-D block's unit slot (csrc/fused.cuh: kSlotWords), and of
#: the fused kernel's two.
SLOT_BYTES = 20 * 4
UNIT_SLOT_BYTES = 2 * SLOT_BYTES


def fused_unit_smem(unit_syms: int, lut: int) -> int:
    """Shared memory of one ``decode_tiles_fused`` block: two stages of a
    unit of ``unit_syms`` uint16 codes, each to a 16-byte boundary, the
    scan scratch, two unit slots and the LUT (u16 symbol + u8 length)."""
    return (2 * K._round16(2 * unit_syms) + SCRATCH_BYTES + UNIT_SLOT_BYTES
            + 3 * lut)


def decode_tiles_fused_nd_smem(block: int, lut: int) -> int:
    """Shared memory of one ``decode_tiles_fused_nd`` block of ``block``
    codes (a unit's tiles; the carries live in global memory)."""
    return _residual_tile_smem(block, lut)


def dequant_reconstruct_smem(block: int) -> int:
    """Shared memory of one ``dequant_reconstruct_nd`` block of ``block``
    codes: the int32 residual tile and the scan scratch; no LUT."""
    return _residual_tile_smem(block, 0)


def epilogue_smem(unit_bytes: int) -> int:
    """Shared memory of one 1-D epilogue block (``dequant_reconstruct``,
    ``lorenzo.reconstruct1d``): ``EPILOGUE_STAGES`` stages of a unit of
    ``unit_bytes``, each to a 16-byte boundary, an 8-byte mbarrier a
    stage, the scan scratch and a unit slot a stage."""
    return (EPILOGUE_STAGES * (K._round16(unit_bytes) + 8 + SLOT_BYTES)
            + SCRATCH_BYTES)


# ---------------------------------------------------------------------------
# N-D units, tickets and the look-back ring (csrc/fused.cuh, "N-D carries")
# ---------------------------------------------------------------------------


def diagonal_first(d: int, rows: int, cols: int) -> int:
    """Tickets before anti-diagonal ``d``: the first ticket on it."""
    a, b = min(rows, cols), max(rows, cols)
    if d <= a - 1:
        return d * (d + 1) // 2
    if d <= b:
        return a * (a - 1) // 2 + (d - a + 1) * a
    r = rows + cols - 1 - d
    return rows * cols - r * (r + 1) // 2


def diagonal_unit(t: int, rows: int, cols: int):
    """The unit ``(g, k)`` that ticket ``t`` names: tickets go by
    anti-diagonal ``d = g + k``, and by ``g`` within one."""
    lo, hi = 0, rows + cols - 2
    while lo < hi:                       # last d with diagonal_first <= t
        mid = (lo + hi + 1) // 2
        if diagonal_first(mid, rows, cols) <= t:
            lo = mid
        else:
            hi = mid - 1
    g = max(0, lo - (cols - 1)) + t - diagonal_first(lo, rows, cols)
    return g, lo - g


def diagonal_ticket(g: int, k: int, rows: int, cols: int) -> int:
    """The ticket of unit ``(g, k)`` (the inverse of :func:`diagonal_unit`)."""
    d = g + k
    return diagonal_first(d, rows, cols) + g - max(0, d - (cols - 1))


class NdGeometry(typing.NamedTuple):
    """Launch geometry of an N-D kernel (:func:`nd_geometry`).

    A unit, one block's work, is ``unit_planes`` planes x ``unit_tiles``
    consecutive tiles of a plane (2-D: 1 x up to ``MAX_GROUP``; 3-D: up to
    ``MAX_GROUP`` x 1); the units form a ``units_p`` x ``units_k`` grid
    whose row chains carry along k and whose column chains carry along the
    planes.  ``slots`` ring slots hold the statuses of the units in
    flight, each chain's aggregate and inclusive prefix: ``row_words``
    values for the row carry (one (cols,) vector a plane of the unit) and
    ``plane_words`` for the plane carry (the unit's rows of one plane),
    with a flag each and a done word.  ``depth`` bounds a look-back;
    ``resident`` is what the card holds at once."""
    rows_per_tile: int
    cols: int
    planes: int
    tiles_per_plane: int
    unit_planes: int
    unit_tiles: int
    units_p: int
    units_k: int
    threads: int
    smem: int
    resident: int
    depth: int
    slots: int
    row_words: int
    plane_words: int

    @property
    def units(self) -> int:
        return self.units_p * self.units_k

    @property
    def slot_words(self) -> int:
        return self.row_words + self.plane_words

    @property
    def scratch_words(self) -> int:
        """uint32 words of the zeroed scratch: the ticket, and three words
        a slot (its done word, its row and plane status flags)."""
        return 1 + 3 * self.slots

    @property
    def value_words(self) -> int:
        """uint32 words of the ring's values (any contents): a slot holds
        each chain's aggregate and inclusive prefix."""
        return 2 * self.slots * self.slot_words


def _nd_unit_geometry(shape, rows_per_tile: int, n_tiles: int, lut: int,
                      sm_count: int, group: int):
    rows, cols = shape[-2], shape[-1]
    planes = shape[0] if len(shape) == 3 else 1
    block = rows_per_tile * cols
    tiles_per_plane = rows // rows_per_tile if planes > 1 else n_tiles
    gp, gk = (group, 1) if planes > 1 else (1, group)
    units_p, units_k = -(-planes // gp), -(-tiles_per_plane // gk)
    threads = ND_MAX_THREADS if group * block >= ND_WIDE_UNIT else 256
    smem = decode_tiles_fused_nd_smem(group * block, lut)
    resident = sm_count * K.resident_blocks(threads, smem, ND_REGS)
    depth = LOOKBACK_DEPTH_3D if planes > 1 else LOOKBACK_DEPTH_2D
    a = min(units_p, units_k)
    slots = min(units_p * units_k, (depth + 1) * a + resident)
    return NdGeometry(
        rows_per_tile=rows_per_tile, cols=cols, planes=planes,
        tiles_per_plane=tiles_per_plane,
        unit_planes=gp, unit_tiles=gk, units_p=units_p, units_k=units_k,
        threads=threads, smem=smem, resident=resident, depth=depth,
        slots=slots, row_words=gp * cols if units_k > 1 else 0,
        plane_words=gk * block if units_p > 1 else 0)


@functools.lru_cache(maxsize=256)
def nd_geometry(shape, rows_per_tile: int, n_tiles: int, lut: int,
                sm_count: int) -> NdGeometry:
    """Launch geometry of ``decode_tiles_fused_nd`` (a ``lut``-entry LUT)
    or of ``dequant_reconstruct_nd`` (``lut`` 0) for ``n_tiles`` tiles
    of ``rows_per_tile`` rows of the squeezed ``shape``, on a card of
    ``sm_count`` SMs.

    The group (tiles a unit: along k for 2-D, along the planes for 3-D) is
    at most ``MAX_GROUP``, the tiles along that axis and what shared memory
    holds beside the LUT.  A 2-D field takes the largest: its one row chain
    is as short as it can be.  A 3-D field takes the one with the fewest
    waves of resident blocks times tiles a unit plus one (a unit's fixed
    cost of its look-backs), the larger on a tie: fewer, larger units
    write fewer statuses.  The block is 512 threads wide for a unit of
    ``ND_WIDE_UNIT`` codes or more, else 256; the decode lanes and the
    elements of the scans and carries loop over it.  The ring holds
    ``(depth + 1) x`` (the longest anti-diagonal) slots beyond the resident
    blocks (see csrc/fused.cuh for why), or one a unit if that is fewer.
    """
    block = rows_per_tile * shape[-1]
    along = shape[0] if len(shape) == 3 else n_tiles
    fit = (K.SMEM_LIMIT - decode_tiles_fused_nd_smem(0, lut)) // (4 * block)
    top = max(1, min(MAX_GROUP, along, fit))
    if len(shape) == 2:
        return _nd_unit_geometry(shape, rows_per_tile, n_tiles, lut,
                                 sm_count, top)
    best = None
    for group in range(1, top + 1):
        geo = _nd_unit_geometry(shape, rows_per_tile, n_tiles, lut,
                                sm_count, group)
        cost = -(-geo.units // max(geo.resident, 1)) * (group + 1)
        if best is None or cost <= best[0]:
            best = (cost, geo)
    return best[1]


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


class FusedGeometry(typing.NamedTuple):
    """Launch geometry of :func:`decode_tiles_fused`
    (:func:`fused_geometry`) or of a 1-D epilogue
    (:func:`epilogue_geometry`): units of ``unit_tiles`` consecutive tiles,
    ``units`` of them, taken by ``blocks`` persistent blocks of
    ``FUSED_MAX_THREADS`` (``EPILOGUE_THREADS``) threads and ``smem`` bytes
    of shared memory; the look-back reads ``window`` statuses at once."""
    unit_tiles: int
    units: int
    blocks: int
    smem: int
    window: int

    @property
    def scratch_words(self) -> int:
        """int32 words of the zeroed scratch: the ticket, padded to 8 B,
        then one uint64 status a unit."""
        return 2 + 2 * self.units


def fused_unit_geometry(k: int, n_tiles: int, tile_syms: int, lut: int,
                        sm_count: int) -> FusedGeometry:
    """:func:`fused_geometry`'s grid at ``k`` tiles a unit."""
    smem = fused_unit_smem(k * tile_syms, lut)
    units = -(-n_tiles // k)
    blocks = min(units, sm_count * max(
        K.resident_blocks(FUSED_MAX_THREADS, smem, FUSED_REGS), 1))
    return FusedGeometry(unit_tiles=k, units=units, blocks=blocks,
                         smem=smem, window=LOOKBACK_WINDOW)


@functools.lru_cache(maxsize=256)
def epilogue_geometry(n_tiles: int, tile: int, itemsize: int,
                      sm_count: int) -> FusedGeometry:
    """Launch geometry of a 1-D epilogue (``dequant_reconstruct`` over
    uint16 codes, ``itemsize`` 2; ``lorenzo.reconstruct1d`` over int32
    residuals, ``itemsize`` 4) for ``n_tiles`` tiles of ``tile`` values, on
    a card of ``sm_count`` SMs.

    A unit is the most whole tiles (1 to ``MAX_GROUP``, at most the tiles
    there are) whose values fill no more than ``EPILOGUE_UNIT_BYTES``; a
    block of ``EPILOGUE_THREADS`` threads keeps ``EPILOGUE_STAGES`` stages
    of it.  The grid is the blocks the SMs hold at once, or one a unit if
    there are fewer units.
    """
    k = max(1, min(MAX_GROUP, n_tiles,
                   EPILOGUE_UNIT_BYTES // (tile * itemsize)))
    smem = epilogue_smem(k * tile * itemsize)
    units = -(-n_tiles // k)
    blocks = min(units, sm_count * max(
        K.resident_blocks(EPILOGUE_THREADS, smem, EPILOGUE_REGS), 1))
    return FusedGeometry(unit_tiles=k, units=units, blocks=blocks,
                         smem=smem, window=LOOKBACK_WINDOW)


@functools.lru_cache(maxsize=256)
def fused_geometry(n_tiles: int, n_subseq: int, tile_syms: int, ss_max: int,
                   lut: int, sm_count: int) -> FusedGeometry:
    """Launch geometry of :func:`decode_tiles_fused` for ``n_tiles`` tiles of
    ``tile_syms`` codes over ``n_subseq`` subsequences, a lane budget of
    ``ss_max`` and a ``lut``-entry LUT, on a card of ``sm_count`` SMs.

    A block is ``FUSED_MAX_THREADS`` wide: its scan and its write use every
    warp, and its lanes decode on as many threads.  A tile's lanes are the
    subsequences its output can come from, about ``span = n_subseq /
    n_tiles + 2`` of them (capped at ``ss_max``), as
    ``huffman_decode.decode_tiles_geometry`` counts them.  A unit takes the
    most tiles (up to ``MAX_GROUP``) such that its lanes, ``k * span``, fit
    the block, the block's two stages still let ``FUSED_MIN_BLOCKS``
    blocks share an SM (the blocks its register bound allows), and the
    units still fill those blocks on every SM; at least one tile.  The grid
    is the blocks the SMs hold at once, or one a unit if there are fewer
    units.  On the H100 at hacc1d's shape (82 lanes a tile) that is 3
    tiles a unit, which ran faster than 1-2 or 4-8 tiles.
    """
    span = min(-(-n_subseq // max(n_tiles, 1)) + 2, ss_max)
    most = min(MAX_GROUP, -(-n_tiles // (sm_count * FUSED_MIN_BLOCKS)))
    k = 1
    while (k < most and (k + 1) * span <= FUSED_MAX_THREADS
           and K.resident_blocks(FUSED_MAX_THREADS,
                                 fused_unit_smem((k + 1) * tile_syms, lut),
                                 FUSED_REGS) >= FUSED_MIN_BLOCKS):
        k += 1
    return fused_unit_geometry(k, n_tiles, tile_syms, lut, sm_count)


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
    K._check_smem("decode_tiles_fused", fused_unit_smem(tile_syms, lut))
    out = torch.empty(n_out, dtype=out_dtype, device=units.device)
    if n_tiles == 0:
        return out
    geo = fused_geometry(n_tiles, start_abs.shape[0], tile_syms, ss_max, lut,
                         K.sm_count(units.device.index))
    scratch = torch.zeros(geo.scratch_words, dtype=torch.int32,
                          device=units.device)
    launch = _build.load("decode_tiles_fused")
    rc = launch(units.data_ptr(), units.numel(), start_abs.data_ptr(),
                end_abs.data_ptr(), offsets.data_ptr(), s0.data_ptr(),
                None if lut_base is None else lut_base.data_ptr(),
                start_abs.shape[0], int(total_bits), dec_sym.data_ptr(),
                dec_len.data_ptr(), lut, max_len, tile_syms, ss_max, n_out,
                n_tiles, geo.unit_tiles, geo.window, geo.blocks, geo.smem,
                opos.data_ptr(), oval.data_ptr(), obounds.data_ptr(), radius,
                two_eb, scratch.data_ptr(),
                scratch.data_ptr() + 8, OUT_KINDS[out_dtype], out.data_ptr(),
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
    """One N-D kernel launch: its geometry (:func:`nd_geometry`), one zeroed
    int32 buffer holding the ticket and the ring's done words and status
    flags, and the ring's values."""

    def __init__(self, shape, rows_per_tile: int, n_tiles: int, lut: int,
                 device):
        self.geo = nd_geometry(shape, rows_per_tile, n_tiles, lut,
                               K.sm_count(device.index))
        self.scratch = torch.zeros(self.geo.scratch_words, dtype=torch.int32,
                                   device=device)
        self.values = torch.empty(self.geo.value_words, dtype=torch.int32,
                                  device=device)
        self.ticket = self.scratch.data_ptr()
        self.done = self.ticket + 4
        self.flags = self.done + 4 * self.geo.slots
        self.vals = self.values.data_ptr()

    def grid_args(self):
        """The C entry points' grid arguments, rows_per_tile to
        plane_words."""
        g = self.geo
        return (g.rows_per_tile, g.cols, g.planes, g.tiles_per_plane,
                g.unit_planes, g.unit_tiles, g.units_p, g.units_k, g.slots,
                g.depth, g.row_words, g.plane_words)


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
                dec_len.data_ptr(), lut, max_len, *g.grid_args(), ss_max,
                n_out, n_tiles,
                opos.data_ptr(), oval.data_ptr(), obounds.data_ptr(), radius,
                two_eb, g.geo.threads, g.geo.smem, g.ticket, g.done, g.flags,
                g.vals, OUT_KINDS[out_dtype], out.data_ptr(),
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
    K._check_smem("dequant_reconstruct", epilogue_smem(2 * block))
    out = torch.empty(codes.numel(), dtype=out_dtype, device=codes.device)
    if n_tiles == 0:
        return out
    geo = epilogue_geometry(n_tiles, block, 2, K.sm_count(codes.device.index))
    scratch = torch.zeros(geo.scratch_words, dtype=torch.int32,
                          device=codes.device)
    launch = _build.load("dequant_reconstruct")
    rc = launch(codes.data_ptr(), block, n_tiles, geo.unit_tiles, geo.window,
                geo.blocks, geo.smem, opos.data_ptr(),
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
    rc = launch(codes.data_ptr(), *g.grid_args(), n_out,
                opos.data_ptr(), oval.data_ptr(), obounds.data_ptr(), radius,
                two_eb, g.geo.threads, g.geo.smem, g.ticket, g.done, g.flags,
                g.vals, OUT_KINDS[out_dtype], out.data_ptr(),
                K._stream_ptr(codes.device))
    if rc != 0:
        raise RuntimeError(f"dequant_reconstruct_nd kernel launch failed: "
                           f"CUDA error {rc}")
    launches.launched(dequant_reconstruct_nd)
    return out
