"""cuSZ's coarse-grained chunked Huffman decoder: CUDA wrapper and plain
version.

Not a TPU kernel's port: the paper's yardstick.  The reference runs
``decode_chunked`` (``src/repro/core/huffman/decode.py:372``) as a
``vmap`` of a ``lax.scan`` over the rows that ``encode_chunked`` pads; a
scan in torch ops would launch once a symbol, so on the card it is the
hand-written ``csrc/decode_chunked.cu``, one thread a chunk as cuSZ runs
it.

* :func:`decode_chunked` -- the wrapper: checks its inputs, launches the
  kernel for CUDA tensors and runs :func:`decode_chunked_plain` for CPU
  tensors; any other device raises.  It counts its launches in its
  ``launches`` attribute (``kernels/launches.py``).
* :func:`decode_chunked_plain` -- the same function in torch ops (one
  vectorized step over the chunks a symbol), for the tests and for holding
  the kernel against it on the card.

The kernel stages the LUT in shared memory when its ``2**max_len``
entries fit (:func:`decode_chunked_lut_in_smem`, up to max_len 16) and
otherwise launches the variant that reads it from device memory, chosen
before the launch as ``decode_tiles`` chooses.  Its grid is a thread a
chunk in the narrowest blocks that fit the card in one wave
(:func:`decode_chunked_geometry`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import launches
from repro_torch.kernels.huffman_decode import (SMEM_LIMIT, _expect, _round16,
                                                _stream_ptr, resident_blocks,
                                                sm_count)

#: The block widths the kernel takes, narrowest first (its
#: __launch_bounds__ is the last), and the registers a thread is granted
#: for the residency count (csrc/decode_chunked.cu).
CHUNK_WIDTHS = (32, 64, 128, 256)
CHUNK_REGS = 32


def decode_chunked_smem(lut: int) -> int:
    """Shared memory of one block of the shared-memory LUT variant: the
    uint16 symbols, then the uint8 lengths from a 16-byte boundary."""
    return _round16(2 * lut) + lut


def decode_chunked_lut_in_smem(lut: int) -> bool:
    """Whether the kernel stages its ``lut``-entry LUT in shared memory (up
    to max_len 16) or launches the variant that reads it from device
    memory.  Chosen by size, before the launch."""
    return decode_chunked_smem(lut) <= SMEM_LIMIT


def decode_chunked_geometry(n_chunks: int, lut: int, sm_count: int):
    """Launch geometry of :func:`decode_chunked`: ``(blocks, threads,
    shared memory bytes a block)`` for ``n_chunks`` chunks (a thread each)
    and a ``lut``-entry LUT on a card of ``sm_count`` SMs.

    The block is the narrowest of ``CHUNK_WIDTHS`` whose grid the card
    holds resident at once, so the threads spread over as many SMs as
    they can: a warp's step touches 32 rows, 32 lines its SM serves one at
    a time, and an SM holding fewer warps steps faster.  When no width
    fits one wave (a LUT that fills shared memory, very many chunks), the
    widest.
    """
    smem = decode_chunked_smem(lut) if decode_chunked_lut_in_smem(lut) else 0
    for threads in CHUNK_WIDTHS:
        blocks = -(-n_chunks // threads)
        if blocks <= sm_count * resident_blocks(threads, smem, CHUNK_REGS):
            break
    return blocks, threads, smem


def _check(units_rows, chunk_bits, chunk_syms, dec_sym, dec_len,
           max_len: int, chunk_symbols: int):
    _expect("units_rows", units_rows, torch.uint32)
    if units_rows.ndim != 2:
        raise ValueError(f"units_rows must be 2-D [n_chunks, max_units], got "
                         f"shape {tuple(units_rows.shape)}")
    n_chunks = units_rows.shape[0]
    _expect("chunk_bits", chunk_bits, torch.int64, (n_chunks,))
    _expect("chunk_syms", chunk_syms, torch.int32, (n_chunks,))
    if not 1 <= max_len <= 24:
        raise ValueError(f"max_len must be in [1, 24], got {max_len}")
    if chunk_symbols < 1:
        raise ValueError(f"chunk_symbols must be >= 1, got {chunk_symbols}")
    _expect("dec_sym", dec_sym, torch.uint16)
    if dec_sym.ndim != 1 or dec_sym.numel() < (1 << max_len):
        raise ValueError(f"dec_sym must be a 1-D LUT of at least "
                         f"2**max_len = {1 << max_len} entries, got shape "
                         f"{tuple(dec_sym.shape)}")
    _expect("dec_len", dec_len, torch.uint8, dec_sym.shape)
    device = units_rows.device
    for name, t in (("chunk_bits", chunk_bits), ("chunk_syms", chunk_syms),
                    ("dec_sym", dec_sym), ("dec_len", dec_len)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, units_rows on "
                             f"{device}: all inputs must share a device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain path for device {device}")


def decode_chunked_plain(units_rows, chunk_bits, chunk_syms, dec_sym,
                         dec_len, max_len: int, chunk_symbols: int):
    """Plain version of :func:`decode_chunked` (any device): the
    reference's scan, one step over every chunk a symbol.  It stops once
    every chunk is past its bits (checked every 256 steps), leaving the
    zeros the reference emits there."""
    device = units_rows.device
    n_chunks, max_units = units_rows.shape
    out = torch.zeros((n_chunks, chunk_symbols), dtype=torch.int64,
                      device=device)
    if n_chunks == 0:
        return out.to(torch.uint16)
    rows = units_rows.to(torch.int64)
    n_bits = chunk_bits.to(torch.int64)
    ds = dec_sym.to(torch.int64)
    dl = dec_len.to(torch.int64)
    ids = torch.arange(n_chunks, device=device)
    pos = torch.zeros(n_chunks, dtype=torch.int64, device=device)
    for k in range(chunk_symbols):
        u = pos >> 5
        sh = pos & 31
        w0 = rows[ids, u.clamp(0, max_units - 1)]
        w1 = torch.where(u + 1 < max_units,
                         rows[ids, (u + 1).clamp(0, max_units - 1)], 0)
        window = ((w0 << sh) & 0xFFFFFFFF) | torch.where(
            sh == 0, 0, w1 >> (32 - sh))
        win = window >> (32 - max_len)
        valid = pos < n_bits
        out[:, k] = torch.where(valid, ds[win], 0)
        pos = pos + dl[win].clamp(min=1)
        if k % 256 == 255 and not bool((pos < n_bits).any()):
            break
    return out.to(torch.uint16)


@launches.counted
def decode_chunked(units_rows, chunk_bits, chunk_syms, dec_sym, dec_len,
                   max_len: int, chunk_symbols: int):
    """Decode every chunk row sequentially, one thread a chunk.

    units_rows: uint32[n_chunks, max_units] (``encode_chunked``'s padded
    rows); chunk_bits: int64[n_chunks] valid bits a row; chunk_syms:
    int32[n_chunks] (checked, not read: the reference decodes by bits);
    dec_sym: uint16[>= 2**max_len]; dec_len: uint8, the same shape.
    Returns uint16[n_chunks, chunk_symbols], zeros once a row's bits are
    spent.  A LUT too large for shared memory
    (:func:`decode_chunked_lut_in_smem`) is read from device memory.
    """
    _check(units_rows, chunk_bits, chunk_syms, dec_sym, dec_len, max_len,
           chunk_symbols)
    if units_rows.device.type == "cpu":
        return decode_chunked_plain(units_rows, chunk_bits, chunk_syms,
                                    dec_sym, dec_len, max_len, chunk_symbols)
    n_chunks, max_units = units_rows.shape
    out = torch.empty((n_chunks, chunk_symbols), dtype=torch.uint16,
                      device=units_rows.device)
    if n_chunks == 0:
        return out
    lut = 1 << max_len
    blocks, threads, smem = decode_chunked_geometry(
        n_chunks, lut, sm_count(units_rows.device.index))
    launch = _build.load("decode_chunked")
    rc = launch(units_rows.data_ptr(), n_chunks, max_units,
                chunk_bits.data_ptr(), dec_sym.data_ptr(), dec_len.data_ptr(),
                max_len, chunk_symbols,
                0 if decode_chunked_lut_in_smem(lut) else 1, blocks, threads,
                smem, out.data_ptr(), _stream_ptr(units_rows.device))
    if rc != 0:
        raise RuntimeError(f"decode_chunked kernel launch failed: CUDA error "
                           f"{rc}")
    launches.launched(decode_chunked)
    return out
