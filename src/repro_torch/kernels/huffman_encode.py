"""Huffman bit-pack, the write-path twin of the decode kernels: CUDA wrapper
and plain version.

Port of ``src/repro/kernels/huffman_encode.py``: :func:`pack_tiles` emits
the MSB-first uint32 units of an encoded stream from the symbols, the int32
exclusive scan of their code lengths (``starts``) and the encoder tables
(``csrc/pack_tiles.cu``).  Unlike the reference, which gathers
``(n_tiles, sym_max)`` code, length and start arrays before its kernel, the
kernel finds each tile's symbols itself by a search over ``starts``, so
nothing but ``starts`` is built around it.  Its tile, block width and
table placement come from the stream's size (:func:`pack_tiles_geometry`).
Its plain version is the per-unit gather of ``core/huffman/encode.py``
(``pack_units``).

The wrapper follows ``huffman_decode``'s rules: input checks, the kernel for
CUDA tensors, the plain version for CPU tensors, any other device raises,
and each launch is counted (``kernels/launches``).
"""

from __future__ import annotations

import torch

from repro_torch.core.huffman import encode as he
from repro_torch.kernels import _build
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

#: The largest tile :func:`pack_tiles_geometry` picks: output units one
#: block owns (the reference's TPU tile was 8 units; a CUDA block takes a
#: larger tile on a large stream, so that its symbol search and its edge
#: codewords are a small share of its work).
MAX_TILE_UNITS = 1024
#: Symbols a thread packs at once (one 16-byte load of uint16 symbols) and
#: the block widths the kernel takes (csrc/pack_tiles.cu).
PACK_RUN = 8
PACK_MIN_THREADS = 64
PACK_MAX_THREADS = 256
#: Blocks an SM the default tile aims for where the stream allows.
PACK_BLOCKS_PER_SM = 2


def pack_tiles_smem(tile_units: int, n_codes: int) -> int:
    """Shared memory of one ``pack_tiles`` block: the uint32 tile, then the
    uint32 codes and uint8 lengths of an ``n_codes``-entry encoder table
    (``n_codes`` 0 for the variant that reads the tables from device
    memory), each from a 16-byte boundary."""
    return (K._round16(4 * tile_units) + K._round16(4 * n_codes)
            + K._round16(n_codes))


def pack_tables_in_smem(tile_units: int, n_codes: int) -> bool:
    """Whether ``pack_tiles`` stages its encoder tables in shared memory
    (they fit beside the tile: up to radius 2**14 at the largest default
    tile) or launches the variant that reads them from device memory.
    Chosen by size, before the launch."""
    return pack_tiles_smem(tile_units, n_codes) <= K.SMEM_LIMIT


def pack_tiles_geometry(n: int, n_units: int, n_codes: int, sm_count: int,
                        tile_units: int | None = None):
    """Launch geometry of :func:`pack_tiles` for ``n`` symbols packed into
    ``n_units`` units with an ``n_codes``-entry table on a card of
    ``sm_count`` SMs: ``(tile_units, blocks, threads, tables_in_smem,
    shared memory bytes a block)``.

    The default tile splits the stream over ``PACK_BLOCKS_PER_SM`` blocks
    an SM, at most ``MAX_TILE_UNITS`` units a tile (one block a tile), so
    the grid fills the card at every stream size.  A block is as wide as
    the tile's symbols need at ``PACK_RUN`` a thread (the stream's mean
    symbols a unit), rounded up to a warp, within ``PACK_MIN_THREADS``
    (the two searching warps) and ``PACK_MAX_THREADS``; a tile with more
    symbols loops.
    """
    if tile_units is None:
        tile_units = min(MAX_TILE_UNITS,
                         -(-n_units // (PACK_BLOCKS_PER_SM * sm_count)))
    syms = -(-tile_units * n // n_units) + 1
    threads = min(max(-(-syms // (32 * PACK_RUN)) * 32, PACK_MIN_THREADS),
                  PACK_MAX_THREADS)
    in_smem = pack_tables_in_smem(tile_units, n_codes)
    return (tile_units, -(-n_units // tile_units), threads, in_smem,
            pack_tiles_smem(tile_units, n_codes if in_smem else 0))


def pack_tiles_plain(symbols, starts, enc_code, enc_len, n_units: int):
    """Plain version of :func:`pack_tiles` (any device): the per-unit
    gather under the lane budget of the table's shortest codeword."""
    used = enc_len[enc_len > 0]
    min_len = int(used.min()) if used.numel() else 1
    sym = symbols.to(torch.int64).clamp(max=enc_code.numel() - 1)
    lens = enc_len.to(torch.int64)[sym]
    codes = enc_code.to(torch.int64)[sym]
    return he.pack_units(starts.to(torch.int64), lens, codes, n_units,
                         min_len).to(torch.uint32)


@launches.counted
def pack_tiles(symbols, starts, enc_code, enc_len, n_units: int,
               tile_units: int | None = None):
    """Bit-pack ``symbols`` into uint32[n_units].

    symbols:  uint16[n]   codebook symbols (clamped into the table)
    starts:   int32[n]    exclusive scan of the symbols' code lengths
    enc_code: uint32[K], enc_len: uint8[K]   the encoder tables
    Every unit is written; bits past the last codeword are zero.  The
    last bit must stay below 2**31 (``n_units * 32 <= 2**31``).
    ``tile_units``: units a block owns, None for the geometry's
    (:func:`pack_tiles_geometry`).
    """
    K._expect("symbols", symbols, torch.uint16)
    if symbols.ndim != 1 or symbols.numel() < 1:
        raise ValueError("symbols must be a non-empty 1-D tensor")
    K._expect("starts", starts, torch.int32, symbols.shape)
    K._expect("enc_code", enc_code, torch.uint32)
    if enc_code.ndim != 1 or enc_code.numel() < 1:
        raise ValueError("enc_code must be a non-empty 1-D table")
    K._expect("enc_len", enc_len, torch.uint8, enc_code.shape)
    if not 1 <= n_units <= 1 << 26:
        raise ValueError(f"n_units must be in [1, 2**26] (bit positions "
                         f"below 2**31), got {n_units}")
    if tile_units is not None and not 1 <= tile_units <= 1 << 15:
        raise ValueError(f"tile_units must be in [1, 2**15], got "
                         f"{tile_units}")
    for name, t in (("starts", starts), ("enc_code", enc_code),
                    ("enc_len", enc_len)):
        if t.device != symbols.device:
            raise ValueError(f"{name} is on {t.device}, symbols on "
                             f"{symbols.device}: all inputs must share a "
                             f"device")
    if symbols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain path for device "
                         f"{symbols.device}")
    if symbols.device.type == "cpu":
        return pack_tiles_plain(symbols, starts, enc_code, enc_len, n_units)
    n_codes = enc_code.numel()
    tile_units, _, threads, in_smem, _ = pack_tiles_geometry(
        symbols.numel(), n_units, n_codes,
        K.sm_count(symbols.device.index), tile_units)
    units = torch.empty(n_units, dtype=torch.uint32, device=symbols.device)
    launch = _build.load("pack_tiles")
    rc = launch(symbols.data_ptr(), starts.data_ptr(), symbols.numel(),
                enc_code.data_ptr(), enc_len.data_ptr(), n_codes, n_units,
                tile_units, threads, int(in_smem), units.data_ptr(),
                K._stream_ptr(symbols.device))
    if rc != 0:
        raise RuntimeError(f"pack_tiles kernel launch failed: CUDA error "
                           f"{rc}")
    launches.launched(pack_tiles)
    return units
