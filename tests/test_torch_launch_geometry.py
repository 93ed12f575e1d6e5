"""Launch geometry of the count_subseq and decode_tiles kernels.

The geometry is computed in Python (``kernels/huffman_decode.py``) and
handed to the CUDA entry points, so these CPU tests reach it: the grid never
exceeds the work or what the SMs hold resident, every unit of work is
covered, and shared memory fits a block.  The kernels themselves are held
against their plain versions on the card (``tests/test_torch_cuda.py``).
"""

import pytest

from repro_torch.core.huffman import pipeline as hp
from repro_torch.kernels import huffman_decode as K

SM_COUNTS = (1, 2, 132)


def _rounds(work, blocks):
    return -(-work // blocks)


@pytest.mark.parametrize("lut", [2, 16, 4096, 1 << 16])
@pytest.mark.parametrize("n", [1, 100, 255, 256, 257, 2255, 577148,
                               3 * 270336 + 17])
def test_count_subseq_geometry(n, lut):
    for sm in SM_COUNTS:
        blocks, threads, smem = K.count_subseq_geometry(n, lut, sm)
        need = -(-n // threads)
        resident = sm * K.resident_blocks(threads, smem, K.COUNT_REGS)
        assert threads == K.COUNT_THREADS
        assert 1 <= blocks <= min(need, resident)
        # a grid stride covers every window, each block the same rounds
        rounds = _rounds(need, blocks)
        assert blocks * threads * rounds >= n
        assert (blocks - 1) * rounds < need
        assert smem == -(-lut // 16) * 16 and smem <= K.SMEM_LIMIT


def test_count_subseq_geometry_at_isabel3d():
    """577,152 windows on 132 SMs: 8 blocks of 256 an SM, three rounds,
    752 blocks (not 2,255, nor a partial wave of 1,056), 4 KB of lengths."""
    assert K.resident_blocks(256, 4096, K.COUNT_REGS) == 8
    assert K.count_subseq_geometry(577152, 4096, 132) == (752, 256, 4096)
    assert K.count_subseq_geometry(0, 4096, 132)[0] == 0
    # a KV page of the batch: as many blocks as a block-a-256 grid
    assert K.count_subseq_geometry(760, 4096, 132)[0] == 3


@pytest.mark.parametrize("max_len", [4, 12, 16])
@pytest.mark.parametrize("tile", [64, 512, 1000, 3584, 4096, 8192, 20000])
@pytest.mark.parametrize("codes_per_subseq", [1, 8, 43, 52, 128])
def test_decode_tiles_geometry(tile, max_len, codes_per_subseq):
    ss_max = hp.ss_max_for_tile(tile, max_len)
    lut = 1 << max_len
    for n_out in (1, tile - 1, 40 * tile + 3, 6104 * tile):
        n_tiles = -(-n_out // tile)
        n_subseq = max(1, n_out // codes_per_subseq)
        for sm in SM_COUNTS:
            blocks, threads, smem = K.decode_tiles_geometry(
                n_tiles, n_subseq, tile, ss_max, lut, sm)
            assert threads % 32 == 0 and 32 <= threads <= K.TILE_MAX_THREADS
            assert threads <= -(-ss_max // 32) * 32
            resident = sm * K.resident_blocks(threads, smem, K.TILE_REGS)
            assert 1 <= blocks <= min(n_tiles, resident)
            assert (blocks - 1) * _rounds(n_tiles, blocks) < n_tiles
            assert smem <= K.SMEM_LIMIT
            in_smem = K.decode_tiles_lut_in_smem(tile, lut)
            assert smem == K.decode_tiles_smem(tile, lut if in_smem else 0)


def test_decode_tiles_geometry_at_isabel3d():
    """The default tile on isabel3d (6,104 tiles over 577,152 subsequences,
    ~95 a tile): 128 threads, 10 blocks an SM (shared memory bounds it),
    5 tiles a block; a tuned class tile spans ~130: 160 threads."""
    ss_max = hp.ss_max_for_tile(4096, 12)
    assert ss_max == 411
    assert K.decode_tiles_smem(4096, 4096) == 20480
    assert K.resident_blocks(128, 20480, K.TILE_REGS) == 10
    assert K.decode_tiles_geometry(6104, 577152, 4096, ss_max, 4096,
                                   132) == (1221, 128, 20480)
    blocks, threads, _ = K.decode_tiles_geometry(
        100, 100 * 129, 8192, hp.ss_max_for_tile(8192, 12), 4096, 132)
    assert (blocks, threads) == (100, 160)


def test_decode_tiles_geometry_merged_lut():
    """A merged LUT past shared memory: the block holds the tile alone."""
    lut = 259 * 4096
    assert not K.decode_tiles_lut_in_smem(hp.OVERFLOW_TILE, lut)
    blocks, threads, smem = K.decode_tiles_geometry(
        50, 6400, hp.OVERFLOW_TILE, hp.ss_max_for_tile(hp.OVERFLOW_TILE, 12),
        lut, 132)
    assert smem == 2 * hp.OVERFLOW_TILE and blocks == 50 and threads == 160


@pytest.mark.parametrize("tile,lut", [(4096, 4096), (8192, 65536),
                                      (67072, 32768), (3584, 1 << 12),
                                      (4096, 0)])
def test_decode_tiles_smem_is_the_old_sum_on_aligned_sizes(tile, lut):
    """Each part starts on a 16-byte boundary; for the codec's tiles and
    LUTs that adds nothing to the tile plus 3 B a LUT entry."""
    assert K.decode_tiles_smem(tile, lut) == 2 * tile + 3 * lut
    assert K.decode_tiles_smem(7, 3) == 16 + 16 + 16


def test_resident_blocks_limits():
    """Each of the SM's limits bounds in turn: warps, blocks, registers and
    shared memory."""
    assert K.resident_blocks(1024, 0, 32) == 2            # warps
    assert K.resident_blocks(32, 0, 32) == 32             # blocks
    assert K.resident_blocks(256, 0, 64) == 4             # registers
    assert K.resident_blocks(256, 65536, 32) == 3         # shared memory
    assert K.resident_blocks(256, K.SMEM_LIMIT, 32) == 1
