"""Launch geometry and CPU models of the 1-D epilogues.

``dequant_reconstruct`` (uint16 codes) and ``lorenzo.reconstruct1d`` (int32
residuals) run persistent blocks over units of tiles
(``csrc/fused.cuh``, "1-D epilogues"), with the geometry from
``fused_decode.epilogue_geometry``.  These CPU tests reach what surrounds
the kernels: the geometry at hacc1d's shape and at edge sizes, a model of
the two scan passes over an int32 unit, a model of the look-back in the
order the epilogues run it on random schedules, and the C entries' checks
of a geometry before they launch.  The kernels themselves are held against
their plain versions on the card (``tests/test_torch_cuda.py``).
"""

import random
import re

import numpy as np
import pytest

from repro_torch.kernels import _build
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import lorenzo as L

SM_COUNTS = (1, 2, 132)
MASK = (1 << 32) - 1


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("n,tile,itemsize", [
    (1 << 24, 4096, 2), (1 << 24, 4096, 4),     # hacc1d: rows 6 and 9
    (1, 4096, 4), (1, 32, 4), (4097, 4096, 4),  # one value, a ragged unit
    ((1 << 24) + 3, 4096, 4), (100000, 64, 4), (300001, 3001, 4),
    (4096, 4096, 2), (65536, 64, 2), (20000 * 4096, 4096, 2),
    (16384, 16384, 4), (3 * 16384, 16384, 2)])
def test_epilogue_geometry(n, tile, itemsize, sm):
    """Units of 1 to MAX_GROUP whole tiles, every tile in one unit, no more
    than EPILOGUE_UNIT_BYTES unless one tile is more, and one tile more
    would pass it; the unit's stages fit shared memory; a grid of the
    resident blocks or one a unit; one uint64 status a unit."""
    n_tiles = -(-n // tile)
    geo = fd.epilogue_geometry(n_tiles, tile, itemsize, sm)
    k = geo.unit_tiles
    unit_bytes = k * tile * itemsize
    assert 1 <= k <= min(fd.MAX_GROUP, n_tiles)
    assert (geo.units - 1) * k < n_tiles <= geo.units * k
    assert k == 1 or unit_bytes <= fd.EPILOGUE_UNIT_BYTES
    assert (k == min(fd.MAX_GROUP, n_tiles)
            or unit_bytes + tile * itemsize > fd.EPILOGUE_UNIT_BYTES)
    assert geo.smem == fd.epilogue_smem(unit_bytes) == (
        fd.EPILOGUE_STAGES * (K._round16(unit_bytes) + 8 + fd.SLOT_BYTES)
        + fd.SCRATCH_BYTES)
    assert geo.smem <= K.SMEM_LIMIT
    resident = sm * K.resident_blocks(fd.EPILOGUE_THREADS, geo.smem,
                                      fd.EPILOGUE_REGS)
    assert 1 <= geo.blocks == min(geo.units, resident)
    assert geo.window == fd.LOOKBACK_WINDOW == 32
    assert geo.scratch_words == 2 + 2 * geo.units


def test_epilogue_geometry_at_hacc1d():
    """hacc1d (2**24 values, 4,096 tiles of 4,096) on 132 SMs: row 6's
    uint16 units are 4 tiles (32 KiB), 1,024 of them; row 9's int32 units
    2 tiles (32 KiB), 2,048 of them; both in blocks of 512 threads, whose
    three stages let 2 share an SM: 264 blocks."""
    six = fd.epilogue_geometry(4096, 4096, 2, 132)
    nine = fd.epilogue_geometry(4096, 4096, 4, 132)
    smem = fd.epilogue_smem(32768)
    assert smem == 3 * (32768 + 8 + 80) + 320
    assert six == fd.FusedGeometry(unit_tiles=4, units=1024, blocks=264,
                                   smem=smem, window=32)
    assert nine == fd.FusedGeometry(unit_tiles=2, units=2048, blocks=264,
                                    smem=smem, window=32)
    assert K.resident_blocks(512, smem, fd.EPILOGUE_REGS) == 2


@pytest.mark.parametrize("tile", [32, 4096, 16384])
def test_reconstruct1d_widest_tile_fits(tile):
    """Every tile the reconstruct1d wrapper takes ([32, 16384]) gives a
    unit whose stages fit a block's shared memory."""
    geo = fd.epilogue_geometry(7, tile, 4, 132)
    assert geo.smem <= K.SMEM_LIMIT


# ---------------------------------------------------------------------------
# The two scan passes over an int32 unit (UnitValues)
# ---------------------------------------------------------------------------


def _unit_chunk(n, warps):
    """fused.cuh:unit_chunk: a warp's values, ceil(n / warps) rounded up to
    a row of 128."""
    return (-(-n // warps) + 127) // 128 * 128


def _lanes(vals, row, hi):
    """UnitValues::load4 for the 32 lanes of the row at ``row`` of a warp's
    chunk [.., hi): 4 values a lane, 0 at or past ``hi``."""
    return [[int(vals[e + i]) & MASK if e + i < hi else 0 for i in range(4)]
            for e in range(row, row + 128, 4)]


def _unit_scan(vals, prefix, warps):
    """csrc/fused.cuh's passes over one unit of int32 values in Python,
    mod 2**32: pass 1 (unit_chunk_totals) sums each warp's chunk a row of
    128 at a time; warp 0 (unit_chunk_offsets) turns the totals into each
    chunk's exclusive offset and the unit's aggregate; pass 2 (write_unit)
    gives each row's inclusive sums, 4 in a lane and then a scan of the
    lanes' totals, plus the chunk's running offset and the unit's
    exclusive prefix.  Returns the aggregate and the unit's inclusive
    prefix sums q (uint32)."""
    n = len(vals)
    chunk = _unit_chunk(n, warps)
    totals = []
    for w in range(warps):
        lo, hi = w * chunk, min((w + 1) * chunk, n)
        acc = 0
        for row in range(lo, hi, 128):
            acc += sum(sum(r) for r in _lanes(vals, row, hi))
        totals.append(acc & MASK)
    offs = [sum(totals[:w]) & MASK for w in range(warps)]
    aggregate = sum(totals) & MASK
    q = np.zeros(n, np.uint32)
    for w in range(warps):
        lo, hi = w * chunk, min((w + 1) * chunk, n)
        carry = (prefix + offs[w]) & MASK
        for row in range(lo, hi, 128):
            x = _lanes(vals, row, hi)
            s = [[sum(r[:i + 1]) & MASK for i in range(4)] for r in x]
            incl = np.cumsum([t[3] for t in s], dtype=np.uint64) & MASK
            for lane in range(32):
                ex = (carry + int(incl[lane]) - s[lane][3]) & MASK
                for i in range(4):
                    e = row + 4 * lane + i
                    if e < hi:
                        q[e] = (ex + s[lane][i]) & MASK
            carry = (carry + int(incl[31])) & MASK
    return aggregate, q


@pytest.mark.parametrize("warps", [16, 1])
@pytest.mark.parametrize("n,unit", [(1, 4096), (127, 4096), (129, 64),
                                    (4097, 4096), (3 * 512 + 5, 512),
                                    (20000, 4096), (1001, 1001)])
def test_unit_passes_are_an_int32_cumsum(n, unit, warps):
    """Units of ``unit`` values, the last ragged, scanned one after another
    with each unit's exclusive prefix the aggregates before it: the
    outputs are np.cumsum's in int32, which wraps, for residuals near
    +-2**31 and for small ones."""
    rng = np.random.default_rng(n + unit + warps)
    for vals in (rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
                 rng.integers(-600, 600, n).astype(np.int32)):
        prefix, got = 0, []
        for base in range(0, n, unit):
            aggregate, q = _unit_scan(vals[base:base + unit], prefix, warps)
            got.append(q)
            prefix = (prefix + aggregate) & MASK
        with np.errstate(over="ignore"):
            want = np.cumsum(vals, dtype=np.int32)
        assert np.array_equal(np.concatenate(got).view(np.int32), want)


# ---------------------------------------------------------------------------
# The look-back in the epilogues' order
# ---------------------------------------------------------------------------


def _play_epilogue(aggs, window, resident, rng):
    """csrc/fused.cuh:epilogue_units and unit_lookback on a random
    schedule.  ``resident`` blocks each take a ticket u and start its read,
    then loop: take the next ticket (and start its read); once u's read has
    landed, publish u's aggregate (unit 0: its prefix); then look back for
    the unit taken before u; stop when the tickets run out.  A look-back's lanes read the
    window in a random order, other blocks acting between the reads; then
    it is done, slides or reads again, and publishes the unit's inclusive
    prefix.  Each step one random block does one thing.  Returns each
    unit's exclusive prefix and the slides."""
    status = [(0, 0)] * len(aggs)
    result, slides, ticket = [None] * len(aggs), [0], [0]

    def lookback(u):
        prefix, hi = 0, u - 1
        while u > 0:
            seen = [(1, 0)] * 32            # lanes past the window
            order = list(range(window))
            rng.shuffle(order)
            for lane in order:
                j = hi - lane
                seen[lane] = status[j] if j >= 0 else (2, 0)
                yield
            none = [lane for lane in range(32) if seen[lane][0] == 0]
            pre = [lane for lane in range(32) if seen[lane][0] == 2]
            if pre and (not none or pre[0] < none[0]):
                prefix += sum(v for _, v in seen[:pre[0] + 1])
                break
            if not none:
                prefix += sum(v for _, v in seen)
                hi -= window
                slides[0] += 1
        prefix &= MASK
        result[u] = prefix
        if u > 0:
            status[u] = (2, (prefix + aggs[u]) & MASK)
        yield

    def take():
        u = ticket[0]
        ticket[0] += 1
        return u

    def block():
        u, prev = take(), None
        yield
        while True:
            nxt = take()
            yield
            if u < len(aggs):
                status[u] = (2 if u == 0 else 1, aggs[u])
                yield
            if prev is not None:
                yield from lookback(prev)
            if u >= len(aggs):
                return
            prev, u = u, nxt

    running = [block() for _ in range(resident)]
    steps = 0
    while running:
        steps += 1
        assert steps < 10_000_000, "the look-back did not finish"
        i = rng.randrange(len(running))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
    return result, slides[0]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_units,window,resident", [
    (1, 32, 4), (2, 32, 1), (7, 32, 3), (200, 32, 16), (200, 1, 8),
    (300, 2, 50), (400, 32, 400), (150, 5, 150), (500, 1, 500)])
def test_epilogue_lookback_model_is_a_cumsum(n_units, window, resident,
                                             seed):
    """Blocks that hold two units' tickets while they look back for a
    third, in random orders, windows that slide: every unit's exclusive
    prefix is np.cumsum's, mod 2**32, and every block finishes (no wait
    points at a unit whose aggregate waits on the waiter)."""
    rng = random.Random(seed * 1000 + n_units)
    aggs = [rng.randrange(1 << 20) for _ in range(n_units)]
    got, slides = _play_epilogue(aggs, window, resident, rng)
    want = np.concatenate([[0], np.cumsum(aggs)[:-1]]) & MASK
    assert got == [int(w) for w in want]
    if window <= 2 and n_units > 100:
        assert slides > 0


@pytest.mark.parametrize("window", [1, 3, 32])
def test_epilogue_lookback_model_wraps_as_int32(window):
    """Aggregates near 2**31 (negative residual sums as uint32 too): the
    prefixes, cast to int32, are np.cumsum's in int32, which wraps."""
    rng = random.Random(window)
    signed = [rng.choice([1, -1]) * rng.randrange(1 << 30, 1 << 31)
              for _ in range(120)]
    aggs = [v & MASK for v in signed]
    got, _ = _play_epilogue(aggs, window, 40, rng)
    with np.errstate(over="ignore"):
        want = np.concatenate([[0], np.cumsum(np.array(signed, np.int32),
                                              dtype=np.int32)[:-1]])
    assert np.array_equal(np.array(got, np.uint32).view(np.int32), want)


# ---------------------------------------------------------------------------
# The C entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,terms", [
    ("dequant_reconstruct", ("tile < 1", "n_tiles < 1", "unit_tiles < 1",
                             "unit_tiles > 8", "window < 1", "window > 32",
                             "blocks < 1", "epilogue_smem(2ll * unit_tiles")),
    ("reconstruct1d", ("n < 1", "tile < 32", "tile > 16384",
                       "unit_tiles < 1", "unit_tiles > 8", "window < 1",
                       "window > 32", "blocks < 1",
                       "epilogue_smem(4ll * unit_tiles", "(1ll << 31)"))])
def test_epilogue_entries_check_the_geometry_first(name, terms):
    """Each 1-D epilogue's C entry refuses (-1) a geometry it cannot run
    before it launches anything: no work, a unit past MAX_GROUP tiles, a
    window past a warp's lanes, no blocks, too little shared memory for its
    stages (the card test test_epilogue_entries_refuse_bad_geometry drives
    the refusals), and launches blocks of the width its register bound
    assumes."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    symbol = _build.SIGNATURES[name][0]
    body = src[src.index(f'extern "C" int {symbol}('):]
    checks = body[:re.search(r"\blaunch(<\w+>)?\(", body).start()]
    for term in terms:
        assert term in checks, term
    assert "return -1;" in checks
    assert "<<<blocks, kEpilogueThreads, smem," in src
    assert "__launch_bounds__(kEpilogueThreads, kEpilogueMinBlocks)" in src


def test_epilogue_constants_are_the_kernels():
    """The Python geometry's block width, blocks an SM and register bound
    are fused.cuh's, and its unit slot and scratch words are those the
    kernels lay out."""
    header = (_build.CSRC / "fused.cuh").read_text()
    threads = int(re.search(r"kEpilogueThreads = (\d+);", header).group(1))
    blocks = int(re.search(r"kEpilogueMinBlocks = (\d+);", header).group(1))
    assert (threads, blocks) == (fd.EPILOGUE_THREADS,
                                 fd.EPILOGUE_MIN_BLOCKS)
    # registers go 8 a thread at a time
    assert fd.EPILOGUE_REGS == 65536 // (blocks * threads) // 8 * 8
    words = int(re.search(r"kSlotWords = (\d+);", header).group(1))
    scratch = int(re.search(r"kFusedScratchWords = (\d+);", header).group(1))
    assert (4 * words, 4 * scratch) == (fd.SLOT_BYTES, fd.SCRATCH_BYTES)
    assert L.RECONSTRUCT_BLOCK == 4096
    # one 1-D scan and look-back: the one-tile-a-block helpers are gone
    assert not re.search(r"\b(lookback_prefix|write_out|load_residuals)\b",
                         header)
