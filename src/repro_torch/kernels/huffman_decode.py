"""Gap-array Huffman decode kernels: CUDA wrappers and plain versions.

Port of ``src/repro/kernels/huffman_decode.py``:

  * :func:`count_subseq` -- phase 1 ("get output idx."): codewords and
    landing position per subsequence window (``csrc/count_subseq.cu``).
  * :func:`decode_tiles` -- phase 4 (paper Alg. 1): tile-staged decode and
    dense write of the quant codes (``csrc/decode_tiles.cu``).
  * :func:`decode_padded` -- phase 4 of the padded baseline: each
    subsequence decodes into its own row of a ``(n_subseq, 128)`` array,
    the original decoders' scattered writes (``csrc/decode_padded.cu``).

Each kernel stages its LUT in shared memory when it fits, and otherwise
(a merged multi-tensor LUT, or ``max_len`` 17-24) launches a variant that
reads it from device memory; the wrapper chooses by size, before the
launch (:func:`count_subseq_lut_in_smem`, :func:`decode_tiles_lut_in_smem`,
:func:`decode_padded_lut_in_smem`).

Each wrapper checks its inputs, then launches its CUDA kernel for CUDA
tensors and runs its plain version (``*_plain``, beside it) for CPU
tensors.  The launch geometry of ``count_subseq`` and ``decode_tiles``
(grid, block width, shared memory) is computed here
(:func:`count_subseq_geometry`, :func:`decode_tiles_geometry`) and handed
to their C entry points.  Any other device raises.  Each wrapper counts its kernel launches
in its ``launches`` attribute (``kernels/launches.py`` holds the counters of
every kernel).  The plain versions run on any device, so a
check on the card can hold a kernel against its plain version on the same
inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import launches

#: Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
#: What one H100 SM holds at once (compute capability 9.0): shared memory
#: (bytes) and what each resident block reserves of it, warps, blocks and
#: 32-bit registers.
SM_SMEM = 233472
BLOCK_SMEM_RESERVED = 1024
SM_WARPS = 64
SM_BLOCKS = 32
SM_REGS = 65536
#: count_subseq's block width and register bound, and decode_tiles' widest
#: block and register bound: the kernels' __launch_bounds__
#: (csrc/count_subseq.cu, csrc/decode_tiles.cu).
COUNT_THREADS = 256
COUNT_REGS = 32
TILE_MAX_THREADS = 256
TILE_REGS = 40


def _expect(name, t, dtype, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_two_eb(two_eb):
    """The Lorenzo kernels take the scale ``2 * eb`` as a float32 value
    given as a Python float (``ops._two_eb_f32``)."""
    if not isinstance(two_eb, float) or float(np.float32(two_eb)) != two_eb:
        raise ValueError(f"two_eb must be a float32 value as a Python float "
                         f"(ops._two_eb_f32), got {two_eb!r}")


def _check_stream(units, dec_sym, dec_len, max_len, total_bits, extra):
    _expect("units", units, torch.uint32)
    if units.ndim != 1:
        raise ValueError(f"units must be 1-D, got shape {tuple(units.shape)}")
    if not 1 <= max_len <= 24:
        raise ValueError(f"max_len must be in [1, 24], got {max_len}")
    _expect("dec_sym", dec_sym, torch.uint16)
    if dec_sym.ndim != 1 or dec_sym.numel() < 1:
        raise ValueError("dec_sym must be a non-empty 1-D LUT")
    _expect("dec_len", dec_len, torch.uint8, dec_sym.shape)
    if not 0 <= int(total_bits) < 2**31:
        raise ValueError(f"total_bits {total_bits} outside the int32 range")
    for name, t in {"dec_sym": dec_sym, "dec_len": dec_len,
                    **extra}.items():
        if t is not None and t.device != units.device:
            raise ValueError(f"{name} is on {t.device}, units on "
                             f"{units.device}: all inputs must share a "
                             f"device")
    if units.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain path for device "
                         f"{units.device}")


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def decode_tiles_smem(tile_syms: int, lut: int) -> int:
    """Shared memory of one ``decode_tiles`` block: the uint16 staging tile,
    then the LUT's uint16 symbols and uint8 lengths (``lut`` 0 for the
    variant that reads the LUT from device memory), each from a 16-byte
    boundary."""
    return _round16(2 * tile_syms) + _round16(2 * lut) + _round16(lut)


def decode_tiles_lut_in_smem(tile_syms: int, lut: int) -> bool:
    """Whether ``decode_tiles`` stages its ``lut``-entry LUT in shared
    memory (it fits beside the tile) or launches the variant that reads it
    from device memory.  Chosen by size, before the launch."""
    return decode_tiles_smem(tile_syms, lut) <= SMEM_LIMIT


def resident_blocks(threads: int, smem: int, regs: int) -> int:
    """Blocks of ``threads`` threads, ``smem`` bytes of shared memory and
    at most ``regs`` registers a thread that one H100 SM holds at once
    (registers are granted 256 a warp at a time)."""
    warps = -(-threads // 32)
    warp_regs = -(-regs * 32 // 256) * 256
    return min(SM_WARPS // warps, SM_BLOCKS, SM_REGS // (warp_regs * warps),
               SM_SMEM // (smem + BLOCK_SMEM_RESERVED))


def _balanced_grid(work: int, resident: int) -> int:
    """Blocks for ``work`` units over at most ``resident`` blocks, each
    block taking the same number of units (a grid stride): the fewest
    rounds, then the fewest blocks that fill them."""
    if work <= 0:
        return 0
    rounds = -(-work // max(resident, 1))
    return -(-work // rounds)


def count_subseq_lut_in_smem(lut: int) -> bool:
    """Whether ``count_subseq`` stages its ``lut``-entry length table in
    shared memory (up to max_len 17) or launches the variant that reads it
    from device memory.  Chosen by size, before the launch."""
    return _round16(lut) <= SMEM_LIMIT


def count_subseq_geometry(n: int, lut: int, sm_count: int):
    """Launch geometry of :func:`count_subseq` for ``n`` windows and a
    ``lut``-entry LUT on a card of ``sm_count`` SMs: ``(blocks, threads,
    shared memory bytes a block)``.

    A block stages the uint8 length table alone, or nothing when the table
    does not fit shared memory (:func:`count_subseq_lut_in_smem`: the
    variant that reads it from device memory).  The grid holds at most
    as many blocks as the SMs hold resident and never more than
    ``ceil(n / threads)``; each thread takes the same number of windows
    (a grid stride), so no partial wave of blocks is left at the end.
    """
    smem = _round16(lut) if count_subseq_lut_in_smem(lut) else 0
    resident = sm_count * resident_blocks(COUNT_THREADS, smem, COUNT_REGS)
    return (_balanced_grid(-(-n // COUNT_THREADS), resident), COUNT_THREADS,
            smem)


def decode_tiles_geometry(n_tiles: int, n_subseq: int, tile_syms: int,
                          ss_max: int, lut: int, sm_count: int):
    """Launch geometry of :func:`decode_tiles`: ``(blocks, threads, shared
    memory bytes a block)`` for ``n_tiles`` tiles of ``tile_syms`` codes
    over ``n_subseq`` subsequences, a lane budget of ``ss_max`` and a
    ``lut``-entry LUT, on a card of ``sm_count`` SMs.

    A tile's lanes are the subsequences its output can come from, on
    average ``n_subseq / n_tiles + 1`` of them.  The block is that mean
    plus one lane of headroom, rounded up to a warp and capped at
    ``ss_max`` and at 256 threads; a tile that spans more lanes loops.  So most
    threads decode: 128 at the default 4,096-code tile and ~2.5 to 3 bits
    a code, 160 at the tuned classes' tiles (~130 lanes a tile by their
    design).  The block stages the LUT once (unless it reads it from
    device memory, :func:`decode_tiles_lut_in_smem`) and loops over tiles,
    at most as many blocks as the SMs hold resident, each taking the same
    number of tiles.
    """
    lut_in_smem = decode_tiles_lut_in_smem(tile_syms, lut)
    smem = decode_tiles_smem(tile_syms, lut if lut_in_smem else 0)
    span = -(-n_subseq // max(n_tiles, 1)) + 2
    threads = min(-(-min(span, ss_max) // 32) * 32, TILE_MAX_THREADS)
    resident = sm_count * resident_blocks(threads, smem, TILE_REGS)
    return _balanced_grid(n_tiles, resident), threads, smem


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_padded_smem(lut: int) -> int:
    """Shared memory of one ``decode_padded`` block: the LUT alone (``lut``
    0 for the variant that reads it from device memory)."""
    return 3 * lut


def decode_padded_lut_in_smem(lut: int) -> bool:
    """Whether ``decode_padded`` stages its ``lut``-entry LUT in shared
    memory (up to max_len 16) or launches the variant that reads it from
    device memory.  Chosen by size, before the launch."""
    return decode_padded_smem(lut) <= SMEM_LIMIT


def _check_smem(name, nbytes):
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{name} needs {nbytes} B of shared memory per "
                         f"block; Hopper allows {SMEM_LIMIT}")


def _stream_ptr(device):
    """The raw handle of ``device``'s current stream, read through
    ``torch._C`` (``torch.cuda.current_stream(device).cuda_stream`` builds
    a Stream object a call: a share of a small launch's host time)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# Phase 1: per-subsequence counts
# ---------------------------------------------------------------------------


def count_subseq_plain(units, start_abs, end_abs, total_bits: int, dec_sym,
                       dec_len, max_len: int):
    """Plain version of :func:`count_subseq` (any device)."""
    ids, start, end = C.subseq_windows(start_abs, end_abs, total_bits)
    rows = C.gather_subseq_rows(units, ids)
    landing, counts = C.decode_window(rows, start, end, dec_sym, dec_len,
                                      max_len)
    return counts, landing


@launches.counted
def count_subseq(units, start_abs, end_abs, total_bits: int, dec_sym,
                 dec_len, max_len: int):
    """Codewords per absolute window ``[start_abs[i], end_abs[i])``.

    units: uint32[n_units]; start_abs/end_abs: int32[n]; dec_sym:
    uint16[lut]; dec_len: uint8[lut].  Returns ``(counts, landing)``
    int32[n], ``landing`` row-local as in the reference.  A length table
    too large for shared memory (:func:`count_subseq_lut_in_smem`) is read
    from device memory.
    """
    _check_stream(units, dec_sym, dec_len, max_len, total_bits,
                  {"start_abs": start_abs, "end_abs": end_abs})
    _expect("start_abs", start_abs, torch.int32)
    if start_abs.ndim != 1:
        raise ValueError("start_abs must be 1-D")
    _expect("end_abs", end_abs, torch.int32, start_abs.shape)
    if units.device.type == "cpu":
        return count_subseq_plain(units, start_abs, end_abs, total_bits,
                                  dec_sym, dec_len, max_len)
    lut = dec_sym.numel()
    n = start_abs.shape[0]
    blocks, threads, smem = count_subseq_geometry(
        n, lut, sm_count(units.device.index))
    _check_smem("count_subseq", smem)
    counts = torch.empty(n, dtype=torch.int32, device=units.device)
    landing = torch.empty_like(counts)
    if n == 0:
        return counts, landing
    launch = _build.load("count_subseq")
    rc = launch(units.data_ptr(), units.numel(), start_abs.data_ptr(),
                end_abs.data_ptr(), n, int(total_bits), dec_len.data_ptr(),
                lut, max_len, 0 if count_subseq_lut_in_smem(lut) else 1,
                blocks, threads, smem, counts.data_ptr(),
                landing.data_ptr(), _stream_ptr(units.device))
    if rc != 0:
        raise RuntimeError(f"count_subseq kernel launch failed: CUDA error "
                           f"{rc}")
    launches.launched(count_subseq)
    return counts, landing


# ---------------------------------------------------------------------------
# Phase 4: tile-staged decode + write
# ---------------------------------------------------------------------------


def decode_tiles_plain(units, start_abs, end_abs, offsets, s0,
                       total_bits: int, dec_sym, dec_len, max_len: int,
                       tile_syms: int, ss_max: int, n_out: int,
                       lut_base=None):
    """Plain version of :func:`decode_tiles` (any device).

    Lane ``j`` of tile ``t`` is subsequence ``s0[t] + j``; lanes past the
    last subsequence do no work (``ops._tile_inputs`` in the reference).
    """
    device = units.device
    n_subseq = start_abs.shape[0]
    n_tiles = s0.shape[0]
    tile_base = torch.arange(n_tiles, dtype=torch.int64,
                             device=device) * tile_syms
    subs_raw = (s0.to(torch.int64)[:, None]
                + torch.arange(ss_max, device=device)[None, :])
    valid = subs_raw < n_subseq
    subs = subs_raw.clamp(max=n_subseq - 1)
    ids, start, end = C.subseq_windows(start_abs[subs], end_abs[subs],
                                       total_bits)
    start = torch.where(valid, start, 0)
    end = torch.where(valid, end, 0)
    off = torch.where(valid, offsets[subs].to(torch.int64)
                      - tile_base[:, None], tile_syms)
    lb = (torch.zeros_like(off) if lut_base is None
          else torch.where(valid, lut_base[subs].to(torch.int64), 0))
    rows = C.gather_subseq_rows(units, ids)
    tiles = C.stage_tile(rows, start, end, off, lb, dec_sym, dec_len,
                         max_len, tile_syms)
    return tiles.reshape(-1)[:n_out]


@launches.counted
def decode_tiles(units, start_abs, end_abs, offsets, s0, total_bits: int,
                 dec_sym, dec_len, max_len: int, tile_syms: int, ss_max: int,
                 n_out: int, lut_base=None):
    """Tile-centric decode + write of ``n_out`` quant codes.

    units:      uint32[n_units]
    start_abs:  int32[n_subseq]   absolute window starts
    end_abs:    int32[n_subseq]   absolute window ends
    offsets:    int32[n_subseq+1] exclusive prefix sum of the counts
    s0:         int32[n_tiles]    first subsequence overlapping each tile
    lut_base:   optional int32[n_subseq] per-subsequence offset into a
                merged decode LUT (``None`` for one codebook)
    Returns uint16[n_out].  A LUT too large to sit in shared memory beside
    the tile (:func:`decode_tiles_lut_in_smem`) is read from device memory.
    """
    _check_stream(units, dec_sym, dec_len, max_len, total_bits,
                  {"start_abs": start_abs, "end_abs": end_abs,
                   "offsets": offsets, "s0": s0, "lut_base": lut_base})
    _expect("start_abs", start_abs, torch.int32)
    if start_abs.ndim != 1 or start_abs.numel() < 1:
        raise ValueError("start_abs must be a non-empty 1-D tensor")
    n_subseq = start_abs.shape[0]
    _expect("end_abs", end_abs, torch.int32, (n_subseq,))
    _expect("offsets", offsets, torch.int32, (n_subseq + 1,))
    if tile_syms < 1 or ss_max < 1 or n_out < 0:
        raise ValueError(f"bad tiling: tile_syms={tile_syms}, "
                         f"ss_max={ss_max}, n_out={n_out}")
    n_tiles = (n_out + tile_syms - 1) // tile_syms
    _expect("s0", s0, torch.int32, (n_tiles,))
    if lut_base is not None:
        _expect("lut_base", lut_base, torch.int32, (n_subseq,))
    if units.device.type == "cpu":
        return decode_tiles_plain(units, start_abs, end_abs, offsets, s0,
                                  total_bits, dec_sym, dec_len, max_len,
                                  tile_syms, ss_max, n_out, lut_base)
    lut = dec_sym.numel()
    lut_in_smem = decode_tiles_lut_in_smem(tile_syms, lut)
    blocks, threads, smem = decode_tiles_geometry(
        n_tiles, n_subseq, tile_syms, ss_max, lut,
        sm_count(units.device.index))
    _check_smem("decode_tiles", smem)
    out = torch.empty(n_out, dtype=torch.uint16, device=units.device)
    if n_tiles == 0:
        return out
    launch = _build.load("decode_tiles")
    rc = launch(units.data_ptr(), units.numel(), start_abs.data_ptr(),
                end_abs.data_ptr(), offsets.data_ptr(), s0.data_ptr(),
                None if lut_base is None else lut_base.data_ptr(), n_subseq,
                int(total_bits), dec_sym.data_ptr(), dec_len.data_ptr(), lut,
                max_len, tile_syms, ss_max, n_out, n_tiles,
                0 if lut_in_smem else 1, blocks, threads, smem,
                out.data_ptr(), _stream_ptr(units.device))
    if rc != 0:
        raise RuntimeError(f"decode_tiles kernel launch failed: CUDA error "
                           f"{rc}")
    launches.launched(decode_tiles)
    return out


# ---------------------------------------------------------------------------
# Phase 4, padded baseline: one padded row per subsequence
# ---------------------------------------------------------------------------


def decode_padded_plain(units, start_abs, end_abs, total_bits: int, dec_sym,
                        dec_len, max_len: int):
    """Plain version of :func:`decode_padded` (any device)."""
    ids, start, end = C.subseq_windows(start_abs, end_abs, total_bits)
    rows = C.gather_subseq_rows(units, ids)
    _, counts, padded = C.decode_window(rows, start, end, dec_sym, dec_len,
                                        max_len, collect=True)
    return padded, counts


@launches.counted
def decode_padded(units, start_abs, end_abs, total_bits: int, dec_sym,
                  dec_len, max_len: int):
    """Padded per-subsequence decode of windows ``[start_abs[i],
    end_abs[i])``.

    units: uint32[n_units]; start_abs/end_abs: int32[n]; dec_sym:
    uint16[lut]; dec_len: uint8[lut].  Returns ``(padded, counts)``:
    uint16[n, 128], the k-th code of subsequence i at ``padded[i, min(k,
    127)]`` and zeros past its count, and int32[n] counts.  A LUT too
    large for shared memory (:func:`decode_padded_lut_in_smem`) is read
    from device memory.
    """
    _check_stream(units, dec_sym, dec_len, max_len, total_bits,
                  {"start_abs": start_abs, "end_abs": end_abs})
    _expect("start_abs", start_abs, torch.int32)
    if start_abs.ndim != 1:
        raise ValueError("start_abs must be 1-D")
    _expect("end_abs", end_abs, torch.int32, start_abs.shape)
    if units.device.type == "cpu":
        return decode_padded_plain(units, start_abs, end_abs, total_bits,
                                   dec_sym, dec_len, max_len)
    lut = dec_sym.numel()
    lut_in_smem = decode_padded_lut_in_smem(lut)
    n = start_abs.shape[0]
    padded = torch.empty((n, C.MAX_SYMS), dtype=torch.uint16,
                         device=units.device)
    counts = torch.empty(n, dtype=torch.int32, device=units.device)
    if n == 0:
        return padded, counts
    launch = _build.load("decode_padded")
    rc = launch(units.data_ptr(), units.numel(), start_abs.data_ptr(),
                end_abs.data_ptr(), n, int(total_bits), dec_sym.data_ptr(),
                dec_len.data_ptr(), lut, max_len, 0 if lut_in_smem else 1,
                padded.data_ptr(), counts.data_ptr(),
                _stream_ptr(units.device))
    if rc != 0:
        raise RuntimeError(f"decode_padded kernel launch failed: CUDA error "
                           f"{rc}")
    launches.launched(decode_padded)
    return padded, counts
