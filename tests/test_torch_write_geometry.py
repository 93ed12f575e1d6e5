"""Launch geometry of the write-path kernels, and CPU models of their plans.

``lorenzo_quantize``'s tiled kernel and ``pack_tiles`` take their geometry
from Python (``kernels/lorenzo.py:quantize_geometry``,
``kernels/huffman_encode.py:pack_tiles_geometry``), so these CPU tests reach
it: tile counts, halos, ragged edges and runs of planes at the smoke run's
shapes and one off a tile; the pack grid from 1 unit to the 2**26 cap, every
unit covered once, the encoder tables in shared memory or device memory.
Two models play the kernels' plans in numpy and Python on small inputs and
are held against the plain versions: the quantizer's plane walk (tiles with
a low-side halo, P = q - q_W - q_N + q_NW, d = P(z) - P(z - 1) carried
across a run of planes, uint32 wrap) against ``lorenzo.quantize``, and the
bit-pack's runs (the 33-way symbol search, runs of 8 symbols, plain stores
to the units a run owns whole, atomics only on its edge units) against
``pack_tiles_plain``.  The kernels themselves are held against their plain
versions on the card (``tests/test_torch_cuda.py``).
"""

import bisect
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.core.huffman import codebook
from repro_torch.core.sz import lorenzo
from repro_torch.kernels import _build
from repro_torch.kernels import histogram as H
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import huffman_encode as E
from repro_torch.kernels import lorenzo as L

SM_COUNTS = (1, 2, 132)

# ---------------------------------------------------------------------------
# lorenzo_quantize: the tiled kernel's geometry
# ---------------------------------------------------------------------------


def _zrc(dims):
    return (1,) * (3 - len(dims)) + tuple(dims)


def _check_quantize_geometry(dims, sm):
    tile, z_run, blocks = L.quantize_geometry(dims, sm)
    n = math.prod(dims)
    if len(dims) > 3:
        assert (tile, z_run) == (0, 0)
        assert blocks == min(-(-n // L.QUANT_THREADS), 1 << 20)
        return
    if len(dims) <= 1:
        # the row kernel: a grid stride of QUANT_ROW_BLOCK values a block
        assert (tile, z_run) == (1, 1)
        assert 1 <= blocks <= L.QUANT_ROW_MAX_BLOCKS
        assert blocks * L.QUANT_ROW_BLOCK >= n or (
            blocks == L.QUANT_ROW_MAX_BLOCKS)
        assert (blocks - 1) * L.QUANT_ROW_BLOCK < n
        return
    assert tile == 2
    z, r, c = _zrc(dims)
    rows, cols = L.QUANT_TILE
    tiles_c, tiles_r = -(-c // cols), -(-r // rows)
    runs = -(-z // z_run)
    assert blocks == tiles_c * tiles_r * runs
    # the tiles cover the plane with less than one tile to spare an axis
    assert tiles_c * cols >= c > (tiles_c - 1) * cols
    assert tiles_r * rows >= r > (tiles_r - 1) * rows
    # the runs cover the planes, the last one not empty
    assert 1 <= z_run <= z and (runs - 1) * z_run < z <= runs * z_run
    # no run shorter than QUANT_MIN_Z_RUN planes unless the axis is
    if runs > 1:
        assert z_run >= L.QUANT_MIN_Z_RUN
        # several runs only until the grid holds QUANT_WAVES waves
        wave = sm * L.QUANT_BLOCKS_PER_SM
        assert (runs - 1) * tiles_c * tiles_r < L.QUANT_WAVES * wave


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("dims", [
    (), (1,), (5,), (1023,), (1024,), (1025,), (1 << 24,), (1 << 30,),
    (2, 3), (7, 127), (8, 128), (9, 129), (15, 127), (16, 128), (17, 129),
    (5, 3600), (1800, 3600),
    (2, 2, 2), (3, 15, 127), (3, 16, 128), (13, 17, 129), (100, 500, 500),
    (2, 8, 16, 128), (2, 3, 2, 3, 2, 3, 2, 3)], ids=str)
def test_quantize_geometry(dims, sm):
    _check_quantize_geometry(dims, sm)


def test_quantize_geometry_at_the_smoke_shapes():
    """isabel3d: 4 x 63 tiles a plane, 25 runs of 4 planes (6,300 blocks,
    ~8 waves of 6 an SM; a quarter of the planes staged twice); cesm2d:
    one plane of 29 x 225 tiles; hacc1d: the row kernel, 16,384 blocks of
    1,024 values; a KV page (4 axes): the corner sum."""
    assert L.quantize_geometry((100, 500, 500), 132) == (2, 4, 6300)
    assert L.quantize_geometry((1800, 3600), 132) == (2, 1, 6525)
    assert L.quantize_geometry((1 << 24,), 132) == (1, 1, 16384)
    assert L.quantize_geometry((2, 8, 16, 128), 132) == (0, 0, 128)
    assert L.quantize_geometry(L.squeezed_dims((1, 40, 1, 300)), 132)[0] == 2


def _lattice(x, two_eb):
    """q as the kernel computes it: a float32 division rounded half to even
    (numpy's float32 divide is IEEE), as uint32."""
    q = np.rint(np.float32(x) / np.float32(two_eb)).astype(np.int64)
    return (q & 0xFFFFFFFF).astype(np.uint32)


def _model_row_quantize(q, blocks):
    """The row kernel's plan: grid-stride steps of QUANT_ROW_BLOCK values a
    block, a warp 128 values, a lane 4; the west value of a warp's first
    lane from its own division (the same q).  Returns (resid, times each
    value was stored)."""
    n = q.size
    resid = np.zeros(n, np.uint32)
    stored = np.zeros(n, np.int64)
    step = blocks * L.QUANT_ROW_BLOCK
    for b in range(blocks):
        for w0 in range(b * L.QUANT_ROW_BLOCK, n, step):
            for i in range(w0, min(w0 + L.QUANT_ROW_BLOCK, n), 4):
                west = q[i - 1] if i > 0 else np.uint32(0)
                grp = q[i:i + 4]
                resid[i:i + 4] = grp - np.concatenate([[west], grp[:-1]])
                stored[i:i + 4] += 1
    return resid, stored


def _model_tiled_quantize(x, two_eb, radius, sm):
    """The plan of the kernel ``quantize_geometry`` picks, in numpy: the row
    kernel at one axis; the tiled kernel at two or three, every block
    staging its tile of each plane with the low-side halo (zero outside
    the domain), forming P and d = P - P(previous plane) in uint32 and
    storing its in-domain values.  Returns (codes, outlier, resid, times
    each value was stored)."""
    dims = L.squeezed_dims(x.shape)
    tile, z_run, blocks = L.quantize_geometry(dims, sm)
    z, r, c = _zrc(dims)
    q = _lattice(x.reshape(z, r, c), two_eb)
    if tile == 1:
        resid, stored = _model_row_quantize(q.reshape(-1), blocks)
        return _outputs(resid, radius, x.shape) + (stored,)
    assert tile == 2
    rows, cols = L.QUANT_TILE
    tiles_c, tiles_r = -(-c // cols), -(-r // rows)
    resid = np.zeros((z, r, c), np.uint32)
    stored = np.zeros((z, r, c), np.int64)
    for b in range(blocks):
        c0 = (b % tiles_c) * cols
        r0 = ((b // tiles_c) % tiles_r) * rows
        zb = (b // tiles_c // tiles_r) * z_run
        ze = min(zb + z_run, z)
        prev = np.zeros((rows, cols), np.uint32)
        for zz in range(max(zb - 1, 0), ze):
            s = np.zeros((rows + 1, cols + 1), np.uint32)   # halo row, col 0
            rr = slice(max(r0 - 1, 0), min(r0 + rows, r))
            cc = slice(max(c0 - 1, 0), min(c0 + cols, c))
            s[rr.start - (r0 - 1):rr.stop - (r0 - 1),
              cc.start - (c0 - 1):cc.stop - (c0 - 1)] = q[zz, rr, cc]
            p = s[1:, 1:] - s[1:, :-1] - s[:-1, 1:] + s[:-1, :-1]
            d = p - prev
            prev = p
            if zz < zb:
                continue
            hr, hc = min(rows, r - r0), min(cols, c - c0)
            resid[zz, r0:r0 + hr, c0:c0 + hc] = d[:hr, :hc]
            stored[zz, r0:r0 + hr, c0:c0 + hc] += 1
    return _outputs(resid, radius, x.shape) + (stored,)


def _outputs(resid, radius, shape):
    """(codes, outlier, int32 residual) from the uint32 residuals."""
    d = resid.astype(np.int64)
    d = np.where(d >= 1 << 31, d - (1 << 32), d)
    code = d + radius
    outlier = (code < 0) | (code >= 2 * radius)
    codes = np.where(outlier, 0, code).astype(np.uint16)
    return (codes.reshape(shape), outlier.reshape(shape),
            d.astype(np.int32).reshape(shape))


@pytest.mark.parametrize("sm", [1, 132])
@pytest.mark.parametrize("shape", [
    (1,), (5,), (1023,), (1025,), (4100,), (7, 127), (8, 128), (9, 129),
    (17, 129),
    (33, 260), (3, 3600), (1, 17, 129), (9, 17, 129), (13, 5, 7),
    (10, 1, 3, 1, 5), (37, 20, 30), (40, 1, 3, 5)], ids=str)
def test_tiled_quantize_model_matches_plain(shape, sm):
    """Every value stored once, and codes, mask and residual those of
    lorenzo.quantize: ragged edges, one off a block or tile, unit axes,
    and runs of planes (few tiles a plane want several runs)."""
    rng = np.random.default_rng(len(shape) + sum(shape))
    x = (np.cumsum(rng.standard_normal(shape), axis=-1) * 0.05).astype(
        np.float32)
    two_eb = 2e-3
    codes, outlier, resid, stored = _model_tiled_quantize(x, two_eb, 4, sm)
    assert (stored == 1).all()
    want = lorenzo.quantize(torch.from_numpy(x), two_eb / 2, radius=4)
    assert np.array_equal(codes, want[0].numpy())
    assert np.array_equal(outlier, want[1].numpy())
    assert np.array_equal(resid, want[2].numpy())


def test_tiled_quantize_model_wraps_as_int32():
    """Lattice indices of +-2**30 make partial sums past int32: the uint32
    plane walk wraps to the same residual as the int32 differences."""
    rng = np.random.default_rng(11)
    k = rng.choice([-(1 << 30), 1 << 30, 3], size=(6, 7, 9))
    x = (k * 2.0 ** -10).astype(np.float32)
    two_eb = 2.0 ** -10
    _, _, resid, stored = _model_tiled_quantize(x, two_eb, 512, 1)
    want = lorenzo.quantize(torch.from_numpy(x), two_eb / 2, radius=512)[2]
    assert (stored == 1).all()
    assert np.array_equal(resid, want.numpy())
    assert (np.abs(resid.astype(np.int64)) > 1 << 30).any()


# ---------------------------------------------------------------------------
# pack_tiles: geometry
# ---------------------------------------------------------------------------

#: Stream sizes (units): 1, 31, a KV page's, isabel3d's, the 2**26 cap.
PACK_UNITS = (1, 31, 5760, 2_305_000, 1 << 26)


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("n_units", PACK_UNITS)
@pytest.mark.parametrize("bits_per_code", [1, 2.955, 5.62, 24])
def test_pack_tiles_geometry(n_units, bits_per_code, sm):
    n = max(1, int(n_units * 32 / bits_per_code) - 7)
    tile, blocks, threads, in_smem, smem = E.pack_tiles_geometry(
        n, n_units, 1024, sm)
    # every unit in exactly one tile, the last tile not empty
    assert 1 <= tile <= E.MAX_TILE_UNITS
    assert (blocks - 1) * tile < n_units <= blocks * tile
    # the grid fills the card (PACK_BLOCKS_PER_SM an SM) where the stream
    # allows, and takes the largest tile past that
    if n_units >= E.PACK_BLOCKS_PER_SM * sm * E.MAX_TILE_UNITS:
        assert tile == E.MAX_TILE_UNITS
    else:
        assert tile == -(-n_units // (E.PACK_BLOCKS_PER_SM * sm))
        assert blocks >= min(n_units, sm)
    assert blocks < 1 << 31
    # a block: whole warps, the two searching warps, enough runs of
    # PACK_RUN symbols for the tile's share of the stream (or the widest)
    assert threads % 32 == 0
    assert E.PACK_MIN_THREADS <= threads <= E.PACK_MAX_THREADS
    syms = -(-tile * n // n_units) + 1
    assert threads * E.PACK_RUN >= syms or threads == E.PACK_MAX_THREADS
    assert in_smem and smem == E.pack_tiles_smem(tile, 1024)
    assert smem <= K.SMEM_LIMIT


def test_pack_tiles_geometry_at_the_smoke_streams():
    """A KV page (32,768 codes, ~5,760 units): 22-unit tiles, 262 blocks on
    132 SMs, not 6; isabel3d (~2.3 M units): 1,024-unit tiles, 256
    threads."""
    assert E.pack_tiles_geometry(32768, 5760, 1024, 132)[:3] == (22, 262, 64)
    tile, blocks, threads, _, _ = E.pack_tiles_geometry(
        25_000_000, 2_305_000, 1024, 132)
    assert (tile, blocks, threads) == (1024, 2251, 256)
    # an explicit tile is kept
    assert E.pack_tiles_geometry(32768, 5760, 1024, 132, 7)[:2] == (7, 823)


@pytest.mark.parametrize("radius,in_smem", [(512, True), (1 << 13, True),
                                            (1 << 14, True),
                                            (1 << 15, False),
                                            (40000, False)])
def test_pack_tables_placement(radius, in_smem):
    """The encoder tables (5 B an entry, 2 * radius entries) go to shared
    memory beside the tile while they fit (5 KB at radius 512, 80 KB at
    2**13); past that the variant that reads them from device memory."""
    n_codes = 2 * radius
    for n_units in PACK_UNITS:
        tile, _, _, got, smem = E.pack_tiles_geometry(
            n_units * 5, n_units, n_codes, 132)
        assert got == in_smem == E.pack_tables_in_smem(tile, n_codes)
        assert smem == E.pack_tiles_smem(tile, n_codes if got else 0)
        assert smem <= K.SMEM_LIMIT
    assert E.pack_tiles_smem(1024, 1024) == 4096 + 4096 + 1024


# ---------------------------------------------------------------------------
# pack_tiles: a model of the kernel's plan
# ---------------------------------------------------------------------------


def _warp_search(starts, n, bit, upper):
    """csrc/pack_tiles.cu:warp_search: 32 probes cut [lo, hi) into 33
    parts, the first true probe closes the part kept; a range of at most
    32 is probed whole.  Returns (index, steps)."""
    lo, hi, steps = 0, n, 0
    while lo < hi:
        steps += 1
        length = hi - lo
        whole = length <= 32
        idx = [lo + lane if whole else lo + ((lane + 1) * length) // 33
               for lane in range(32)]
        past = [i >= hi or (starts[i] > bit if upper else starts[i] >= bit)
                for i in idx]
        f = past.index(True) if True in past else None
        if whole:
            return (hi if f is None else lo + f), steps
        if f is None:
            lo = lo + (32 * length) // 33 + 1
        else:
            hi = lo + ((f + 1) * length) // 33
            if f > 0:
                lo = lo + (f * length) // 33 + 1
    return lo, steps


@pytest.mark.parametrize("seed", range(4))
def test_warp_search_is_a_bisection(seed):
    """Upper and lower bounds of a non-decreasing array with runs of equal
    values (zero-length codes), at every probe outcome; at most
    ceil(log_33(n)) + 1 steps."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    starts = np.cumsum(rng.choice([0, 0, 1, 3, 24], size=n)) - 1
    starts[0] = 0
    starts = np.maximum.accumulate(starts).tolist()
    for bit in list(range(-1, starts[-1] + 3)) + [10**9]:
        got, steps = _warp_search(starts, n, bit, True)
        assert got == bisect.bisect_right(starts, bit)
        got, steps2 = _warp_search(starts, n, bit, False)
        assert got == bisect.bisect_left(starts, bit)
        assert max(steps, steps2) <= math.ceil(math.log(max(n, 2), 33)) + 1


def _model_pack(sym, starts, enc_code, enc_len, n_units, tile, threads):
    """The kernel's plan in Python: each tile's symbol range by the warp
    search, runs of PACK_RUN symbols, a unit's codewords ORed in a
    register, plain stores to the units a run owns whole and atomics on
    its edge units.  Returns the units and fails if a plain store meets a
    unit another run writes."""
    n, n_codes = len(sym), len(enc_code)
    out = np.zeros(n_units, np.uint32)
    run_len = E.PACK_RUN
    for b in range(-(-n_units // tile)):
        bit0 = b * tile * 32
        first = max(_warp_search(starts, n, bit0, True)[0] - 1, 0)
        end = _warp_search(starts, n, bit0 + tile * 32, False)[0]
        t = np.zeros(tile, np.uint32)
        writers = [set() for _ in range(tile)]
        plain = {}

        def flush(u, word, shared, run):
            if word == 0 or not 0 <= u < tile:
                return
            writers[u].add(run)
            if shared:
                t[u] |= word
            else:
                assert u not in plain, "two plain stores to one unit"
                plain[u] = run
                t[u] = word

        for i0 in range(first // run_len * run_len, end, run_len):
            run = i0 // run_len
            cur = nxt = 0
            cu, started, first_flush = 0, False, True
            for i in range(i0, i0 + run_len):
                if i < first or i >= end:
                    continue
                s = min(int(sym[i]), n_codes - 1)
                ln = int(enc_len[s])
                if not 1 <= ln <= 32:
                    continue
                p = int(starts[i]) - bit0
                if p <= -32:
                    continue
                u = p // 32 if p >= 0 else -1
                o = p - 32 * u
                v = (int(enc_code[s]) << (64 - o - ln)) & (2**64 - 1)
                if not started:
                    cu, started = u, True
                elif u != cu:
                    flush(cu, cur, first_flush, run)
                    first_flush = False
                    if u == cu + 1:
                        cur = nxt
                    else:
                        flush(cu + 1, nxt, False, run)
                        cur = 0
                    nxt = 0
                    cu = u
                cur |= v >> 32
                nxt |= v & 0xFFFFFFFF
            if started:
                flush(cu, cur, True, run)
                flush(cu + 1, nxt, True, run)
        for u, run in plain.items():
            assert writers[u] == {run}, "a run's whole unit met another run"
        lo = b * tile
        out[lo:lo + tile] = t[:min(tile, n_units - lo)]
    return out


@pytest.mark.parametrize("tile", [None, 1, 3, 7, 64])
@pytest.mark.parametrize("name", ["one-bit", "flat", "deep", "clamped"])
def test_pack_model_matches_plain(name, tile):
    """min_len 1 (one-bit, deep: a unit holds up to 32 codewords), 10-bit
    codes (flat), codes up to 16 bits (deep), and symbols past the table
    (clamped into it), at the default tile and tiles of 1 to 64 units."""
    rng = np.random.default_rng(len(name))
    freq = {"one-bit": np.array([10**6, 3, 2, 1]),
            "flat": np.full(1024, 5),
            "deep": (2.0 ** -np.arange(40) * 2**30).astype(np.int64) + 1,
            "clamped": np.arange(1, 17)}[name]
    book = codebook.build_codebook(freq, max_len=16)
    enc_code, enc_len = book.enc_code, book.enc_len
    n = 3001
    sym = rng.choice(len(freq), size=n, p=freq / freq.sum())
    if name == "clamped":
        sym[::5] = len(freq) + 3
    lens = enc_len[np.minimum(sym, len(freq) - 1)].astype(np.int64)
    starts = np.cumsum(lens) - lens
    n_units = max(1, -(-int(lens.sum()) // 32) + 3)
    tile_units, _, threads, _, _ = E.pack_tiles_geometry(
        n, n_units, len(enc_code), 132, tile)
    got = _model_pack(sym, starts.tolist(), enc_code, enc_len, n_units,
                      tile_units, threads)
    want = E.pack_tiles_plain(
        torch.from_numpy(sym.astype(np.uint16)),
        torch.from_numpy(starts.astype(np.int32)),
        torch.from_numpy(enc_code), torch.from_numpy(enc_len), n_units)
    assert np.array_equal(got, want.numpy())


# ---------------------------------------------------------------------------
# histogram: geometry, and a model of the kernel's counting
# ---------------------------------------------------------------------------

#: Input sizes: the edges of a load (8 uint16, 4 int32) and of a block, the
#: single-block threshold, a KV page and the smoke fields.
HIST_SIZES = (1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 1023, 1024, 1025, 8191,
              8192, 8193, 32768, H.HIST_SINGLE_MAX, H.HIST_SINGLE_MAX + 1,
              6_480_000, 1 << 24, 25_000_000)


def _hist_unroll():
    src = (_build.CSRC / "histogram.cu").read_text()
    return int(re.search(r"constexpr int kUnroll = (\d+);", src).group(1))


def _hist_order(geo, n, per, gtid, step, unroll):
    """The elements thread ``gtid`` of the grid reads, in its order: its
    vectors over the grid stride, ``unroll`` at a time, then its head and
    tail values (csrc/histogram.cu)."""
    order = []
    v0 = gtid
    while v0 < geo.vectors:
        for u in range(unroll):
            v = v0 + u * step
            if v < geo.vectors:
                order += range(geo.head + v * per, geo.head + (v + 1) * per)
        v0 += unroll * step
    tail0 = geo.head + geo.vectors * per
    if gtid < geo.head:
        order.append(gtid)
    if gtid < n - tail0:
        order.append(tail0 + gtid)
    return order


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("n", HIST_SIZES)
def test_histogram_geometry_covers_every_value_once(n, offset, itemsize):
    """The head, the 16-byte body and the tail cover every value once, for
    every offset of x from a 16-byte boundary; the body starts on one."""
    ptr = (1 << 40) + offset
    if offset % itemsize:
        with pytest.raises(ValueError, match="aligned"):
            H.histogram_geometry(ptr, n, itemsize, 1024, 132)
        return
    geo = H.histogram_geometry(ptr, n, itemsize, 1024, 132)
    per = H.HIST_VEC_BYTES // itemsize
    assert 0 <= geo.head < per and 0 <= geo.tail < per
    assert geo.head + geo.vectors * per + geo.tail == n
    if geo.vectors:
        assert (ptr + geo.head * itemsize) % H.HIST_VEC_BYTES == 0
    if geo.head < n:
        assert geo.head == (-ptr % H.HIST_VEC_BYTES) // itemsize
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= H.HIST_THREADS
    assert geo.head < geo.threads and geo.tail < geo.threads
    if n <= 20_000:
        # the grid's threads read each value exactly once
        step = geo.blocks * geo.threads
        seen = np.zeros(n, np.int64)
        for gtid in range(step):
            np.add.at(seen, _hist_order(geo, n, per, gtid, step,
                                        _hist_unroll()), 1)
        assert (seen == 1).all()


@pytest.mark.parametrize("nbins", [1, 16, 1024, 1 << 15, 58112, 58113,
                                   80000])
@pytest.mark.parametrize("n", [1, 32768, H.HIST_SINGLE_MAX,
                               H.HIST_SINGLE_MAX + 1, 25_000_000])
def test_histogram_geometry_grid(n, nbins):
    """One block stores every bin up to HIST_SINGLE_MAX values (if the
    counters fit shared memory); past it a wave of blocks, each a share of
    at least HIST_SHARE_PER_BIN x nbins values; past shared memory global
    atomics, one wave, never a single block."""
    geo = H.histogram_geometry(1 << 40, n, 2, nbins, 132)
    assert geo.shared == H.histogram_in_smem(nbins) == (
        4 * nbins <= K.SMEM_LIMIT)
    assert geo.single == (geo.shared and geo.blocks == 1)
    wave = 132 * H.HIST_BLOCKS_PER_SM
    if not geo.shared:
        assert 1 <= geo.blocks <= wave
    elif n <= H.HIST_SINGLE_MAX:
        assert geo.blocks == 1 and geo.single
        assert geo.threads == min(H.HIST_THREADS,
                                  max(32, -(-max(geo.vectors, 1) // 32) * 32))
    else:
        assert geo.blocks == max(1, min(wave,
                                        n // (H.HIST_SHARE_PER_BIN * nbins)))
        assert geo.blocks == 1 or n // geo.blocks >= (
            H.HIST_SHARE_PER_BIN * nbins)


def test_histogram_geometry_at_the_smoke_shapes():
    """A KV page (32,768 codes) is one block of 1,024 threads, 4 loads a
    thread; the fields one wave of 132 blocks on 132 SMs."""
    page = H.histogram_geometry(1 << 40, 32768, 2, 1024, 132)
    assert (page.blocks, page.threads, page.vectors, page.single) == (
        1, 1024, 4096, True)
    for n in (25_000_000, 6_480_000, 1 << 24):
        geo = H.histogram_geometry(1 << 40, n, 2, 1024, 132)
        assert (geo.blocks, geo.threads, geo.single) == (132, 1024, False)


def _model_histogram(x, nbins, geo):
    """csrc/histogram.cu in numpy and Python: each thread's values in its
    order, clipped, added into its block's sub-histogram (or into the
    output); one block's bins stored, several blocks' added."""
    n, per = x.size, H.HIST_VEC_BYTES // x.itemsize
    vals = np.clip(x.astype(np.int64), 0, nbins - 1)
    sub = np.zeros((geo.blocks, nbins), np.int64)
    out = np.zeros(nbins, np.int64)
    step = geo.blocks * geo.threads
    for b in range(geo.blocks):
        for t in range(geo.threads):
            dst = sub[b] if geo.shared else out
            for i in _hist_order(geo, n, per, b * geo.threads + t, step,
                                 _hist_unroll()):
                dst[vals[i]] += 1
    if geo.shared:
        out = sub[0] if geo.single else out + sub.sum(axis=0)
    return out


def _hist_input(dist, n, nbins, dtype, seed):
    rng = np.random.default_rng(seed)
    if dist == "one-bin":
        v = np.full(n, nbins // 2)
    elif dist == "uniform":
        v = rng.integers(-3 if dtype == np.int32 else 0, nbins + 3, n)
    else:                               # a smooth field's codes
        v = nbins // 2 + np.rint(rng.standard_normal(n) * 1.5).astype(int)
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
@pytest.mark.parametrize("dist", ["skewed", "uniform", "one-bin"])
@pytest.mark.parametrize("n,nbins,sm,knobs", [
    (20_000, 64, 2, dict(threads=64)),               # one block
    (20_000, 16, 2, dict(threads=32)),               # one narrow block
    (9_000, 16, 3, dict(threads=32, blocks=3, single=False)),  # a grid
    (5_003, 60000, 2, dict(threads=64)),             # global atomics
])
def test_histogram_model_matches_plain(n, nbins, sm, knobs, dist, dtype):
    """The model of the kernel's plan (its head, vectors and tail, the
    sub-histograms and the flush) equals histogram_plain on skewed,
    uniform and all-one-bin inputs, at an unaligned start, with the
    geometry's blocks narrowed (``knobs``) so that the model stays small
    and a small input also runs as a grid of blocks."""
    x = _hist_input(dist, n, nbins, dtype, n + nbins)
    ptr = (1 << 40) + (2 if dtype == np.uint16 else 4)
    geo = H.histogram_geometry(ptr, n, x.itemsize, nbins, sm)._replace(
        **knobs)
    assert geo.head > 0
    assert geo.shared == (nbins != 60000)
    want = H.histogram_plain(torch.from_numpy(x.astype(np.int64)), nbins)
    assert np.array_equal(_model_histogram(x, nbins, geo), want.numpy())
