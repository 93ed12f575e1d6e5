"""Launch geometry of the decode kernels, and the N-D kernels' ring.

The geometry is computed in Python (``kernels/huffman_decode.py``,
``huffman_selfsync.py``, ``fused_decode.py``) and handed to the CUDA entry
points, so these CPU tests reach it: the grid never exceeds the work or what
the SMs hold resident, every unit of work is covered, shared memory fits a
block, a LUT too large for it is read from device memory, and the N-D
kernels' look-back over a ring of status words never reads a slot that was
reused (a pure-Python model of the protocol on random schedules).  The
kernels themselves are held against their plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import bisect
import ctypes
import math
import random
import re

import numpy as np
import pytest

from repro_torch.core.huffman import pipeline as hp
from repro_torch.kernels import _build
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import huffman_selfsync as S
from repro_torch.kernels import ops

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


@pytest.mark.parametrize("max_len", [12, 16, 17, 18, 20, 24])
def test_lut_placement_by_max_len(max_len):
    """Each decode kernel stages its table in shared memory while it fits
    and reads it from device memory past that, chosen before the launch:
    count_subseq (lengths alone, 1 B an entry) up to max_len 17,
    decode_padded and selfsync_intra's warp kernel (3 B an entry) up to
    16.  The device-memory variants take no shared memory for the table."""
    lut = 1 << max_len
    assert K.count_subseq_lut_in_smem(lut) == (max_len <= 17)
    assert K.decode_padded_lut_in_smem(lut) == (max_len <= 16)
    assert S.selfsync_lut_in_smem(32, lut) == (max_len <= 16)
    for sm in SM_COUNTS:
        blocks, threads, smem = K.count_subseq_geometry(577152, lut, sm)
        assert smem == (lut if max_len <= 17 else 0)
        resident = sm * K.resident_blocks(threads, smem, K.COUNT_REGS)
        assert 1 <= blocks <= resident
    seqs, threads, smem = S.selfsync_geometry(32, lut)
    assert smem == (3 * lut if max_len <= 16 else 0) and threads == 32 * seqs
    _, _, smem = S.selfsync_geometry(64, lut)
    assert smem == 16 * 64 + (3 * lut if max_len <= 16 else 0)


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


# ---------------------------------------------------------------------------
# The N-D kernels' units, ring and look-back (csrc/fused.cuh, "N-D carries")
# ---------------------------------------------------------------------------

ND_CASES = {
    # the smoke run's fields at the default tile
    "isabel3d": ((100, 500, 500), 4096, 12),
    "cesm2d": ((1800, 3600), 4096, 12),
    # the card tests' carry-heavy shapes
    "2d-row-per-tile": ((20000, 64), 64, 12),
    "3d-200-planes": ((200, 32, 48), 512, 12),
    "3d-4-planes": ((4, 600, 40), 512, 12),
    "3d-one-plane-tile": ((50, 8, 300), 4096, 12),
    "2d-one-unit": ((7, 9), 4096, 12),
    "2d-wide-row": ((3, 54960), 4096, 12),
}


def _nd_case(name, lut=True):
    shape, tile, max_len = ND_CASES[name]
    w = ops.fused_tile_rows(shape, tile)
    n = math.prod(shape)
    n_tiles = -(-n // (w * shape[-1]))
    return shape, w, n_tiles, (1 << max_len) if lut else 0


def _cuda_diagonal_unit(t, rows, cols):
    """csrc/fused.cuh:diagonal_unit, line for line (tri_root in floats)."""
    def tri_root(x):
        d = int((math.sqrt(8.0 * x + 1.0) - 1.0) / 2.0)
        while (d + 1) * (d + 2) // 2 <= x:
            d += 1
        while d * (d + 1) // 2 > x:
            d -= 1
        return d
    a, b = min(rows, cols), max(rows, cols)
    t1, t2 = a * (a - 1) // 2, (b - a + 1) * a
    if t < t1:
        d = tri_root(t)
        off = t - d * (d + 1) // 2
    elif t < t1 + t2:
        d, off = (a - 1) + (t - t1) // a, (t - t1) % a
    else:
        r = rows * cols - 1 - t
        e = tri_root(r)
        d = rows + cols - 2 - e
        off = e - (r - e * (e + 1) // 2)
    g = max(0, d - (cols - 1)) + off
    return g, d - g


@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 9), (9, 1), (3, 5),
                                       (5, 3), (13, 100), (34, 100),
                                       (100, 100), (2, 2500)])
def test_diagonal_tickets(rows, cols):
    """Tickets name every unit once, by anti-diagonal then plane group; the
    kernel's float tri_root mapping, the inverse (diagonal_ticket) and the
    diagonals' first tickets agree."""
    seen = set()
    for t in range(rows * cols):
        g, k = fd.diagonal_unit(t, rows, cols)
        assert (g, k) == _cuda_diagonal_unit(t, rows, cols)
        assert 0 <= g < rows and 0 <= k < cols
        assert fd.diagonal_ticket(g, k, rows, cols) == t
        d = g + k
        assert fd.diagonal_first(d, rows, cols) <= t < \
            fd.diagonal_first(d + 1, rows, cols)
        seen.add((g, k))
    assert len(seen) == rows * cols
    assert fd.diagonal_first(rows + cols - 1, rows, cols) == rows * cols


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("lut", [True, False])
@pytest.mark.parametrize("case", list(ND_CASES))
def test_nd_geometry(case, lut, sm):
    """The unit grid covers every tile; a unit fits shared memory beside
    the LUT and one block's width; the ring holds (depth + 1) x the longest
    diagonal beyond nothing (so a gate waits only for lower tickets) and
    never more slots than units; the status words hold what the chains
    carry."""
    shape, w, n_tiles, lut_n = _nd_case(case, lut)
    g = fd.nd_geometry(shape, w, n_tiles, lut_n, sm)
    group = g.unit_planes * g.unit_tiles
    assert 1 <= group <= fd.MAX_GROUP
    assert g.unit_planes == 1 or g.unit_tiles == 1
    assert 1 <= g.depth <= 32
    assert g.units_p * g.unit_planes >= g.planes > (g.units_p - 1) * \
        g.unit_planes
    assert g.units_k * g.unit_tiles >= g.tiles_per_plane > \
        (g.units_k - 1) * g.unit_tiles
    assert g.planes * g.tiles_per_plane == n_tiles
    if len(shape) == 2:
        assert g.unit_planes == 1
    block = w * shape[-1]
    assert g.smem == fd.decode_tiles_fused_nd_smem(group * block, lut_n)
    assert g.smem <= K.SMEM_LIMIT
    assert g.threads == (512 if group * w * shape[-1] >= fd.ND_WIDE_UNIT
                         else 256) <= fd.ND_MAX_THREADS
    # what the C entries' nd_launch_ok asks of a launch
    assert g.threads >= 32 and g.threads >= 2 * g.depth + 1
    assert g.resident == sm * K.resident_blocks(g.threads, g.smem, fd.ND_REGS)
    a = min(g.units_p, g.units_k)
    assert g.slots == g.units or g.slots >= (g.depth + 1) * a + g.resident
    assert 1 <= g.slots <= g.units
    assert g.row_words == (g.unit_planes * g.cols if g.units_k > 1 else 0)
    assert g.plane_words == (g.unit_tiles * block if g.units_p > 1 else 0)
    assert g.scratch_words == 1 + 3 * g.slots
    assert g.value_words == 2 * g.slots * g.slot_words < 2**32


def test_nd_geometry_at_the_smoke_fields():
    """isabel3d: 5-row tiles of 500 columns; the fused decode takes 4 planes
    a unit (2,500 units), the epilogue 5 (2,000), blocks of 256 threads, 4
    an SM (registers), look-backs of up to 8; cesm2d: one-row tiles of
    3,600 columns, eight a unit (the most), 225 units in one row chain,
    blocks of 512 threads, look-backs of up to 32."""
    shape, w, n_tiles, lut = _nd_case("isabel3d")
    g = fd.nd_geometry(shape, w, n_tiles, lut, 132)
    assert (w, g.unit_planes, g.unit_tiles, g.units_p, g.units_k) == \
        (5, 4, 1, 25, 100)
    assert (g.threads, g.resident, g.depth) == (256, 528, 8)
    assert fd.nd_geometry(shape, w, n_tiles, 0, 132).unit_planes == 5
    shape, w, n_tiles, lut = _nd_case("cesm2d")
    g = fd.nd_geometry(shape, w, n_tiles, lut, 132)
    assert (w, g.unit_planes, g.unit_tiles, g.units_p, g.units_k) == \
        (1, 1, 8, 1, 225)
    assert (g.threads, g.depth) == (512, fd.LOOKBACK_DEPTH_2D) == (512, 32)


class _Overwritten(AssertionError):
    pass


def _play_nd(d, geo, rows_per_tile, resident, rng, gate=True):
    """Play the N-D kernels' carry protocol (fused.cuh: nd_carries,
    ring_gate, publish_status, lookback_depth, lookback_sum) on residuals
    ``d`` (the squeezed field, uint32) under a random schedule of at most
    ``resident`` blocks: blocks take tickets in order, and at each step one
    random running block makes one access to the ring or a done count (or
    starts).  Every read of a predecessor's flag or values asserts that its
    slot still holds that predecessor; returns q, flat.  ``gate=False``
    drops ring_gate, to show what it prevents.
    """
    planes = d.shape[0] if d.ndim == 3 else 1
    cols = d.shape[-1]
    w = rows_per_tile
    field = d.reshape(planes, -1, cols)
    rows = field.shape[1]
    # a 2-D field's last tile holds fake rows past the last row
    pad_rows = geo.tiles_per_plane * w - rows
    field = np.concatenate(
        [field, np.zeros((planes, pad_rows, cols), np.uint32)], 1)
    P, Kt = geo.units_p, geo.units_k
    S, L = geo.slots, geo.depth
    flags = np.zeros((S, 2), np.int64)
    owner = np.full((S, 2), -1)        # the ticket whose values a slot holds
    vals = {}                              # (slot, chain, prefix) -> values
    done = np.zeros(S, np.int64)            # a slot's done word: ticket + 1
    q = np.zeros_like(field)

    def flag(tp, plane):
        v, want = int(flags[tp % S, plane]), 2 * tp + 2
        if v > want + 1:
            raise _Overwritten(f"flag of ticket {tp} overwritten: {v}")
        return v - want                    # < 0 not yet, 0 aggregate, 1 prefix

    def value(tp, plane, prefix, e):
        if owner[tp % S, plane] != tp:
            raise _Overwritten(f"values of ticket {tp} overwritten by "
                               f"{owner[tp % S, plane]}")
        return int(vals[tp % S, plane, prefix][e])

    def store(t, plane, prefix, values):
        slot = t % S
        owner[slot, plane] = t
        vals[slot, plane, prefix] = values.astype(np.uint64) % 2**32

    def chain(t, g, k, plane, agg, has_next, excl):
        pos = g if plane else k
        plane = int(plane)
        if has_next:
            store(t, plane, pos == 0, agg)
            yield
            flags[t % S, plane] = 2 * t + (3 if pos == 0 else 2)
            yield
        if pos == 0:
            return
        n_pred = min(pos, L)
        preds = [fd.diagonal_ticket(g - h, k, P, Kt) if plane
                 else fd.diagonal_ticket(g, k - h, P, Kt)
                 for h in range(1, n_pred + 1)]
        while True:                                  # lookback_depth
            states = []
            for tp in preds:
                states.append(flag(tp, plane))
                yield
            first = next((h for h, st in enumerate(states) if st != 0),
                         n_pred)
            if first < n_pred and states[first] == 1:
                depth = first + 1
                break
        order = list(range(agg.size))                # lookback_sum
        rng.shuffle(order)
        for e in order:
            total = 0
            for h in range(depth):
                total += value(preds[h], plane, h + 1 == depth, e)
                yield
            excl[e] = total % 2**32
        if has_next:
            store(t, plane, True, excl + agg)
            yield
            flags[t % S, plane] = 2 * t + 3
            yield

    def unit(t):
        g, k = fd.diagonal_unit(t, P, Kt)
        p0, k0 = g * geo.unit_planes, k * geo.unit_tiles * w
        np_ = min(geo.unit_planes, planes - p0)
        nrows = min(geo.unit_tiles, geo.tiles_per_plane - k * geo.unit_tiles)\
            * w
        x = field[p0:p0 + np_, k0:k0 + nrows].astype(np.uint64)
        x = np.cumsum(np.cumsum(x, 2), 1) % 2**32          # e, then F
        yield
        if gate and t >= S:                              # ring_gate
            j = t - S
            gj, kj = fd.diagonal_unit(j, P, Kt)
            waits = [j] + [fd.diagonal_ticket(gj, kj + h, P, Kt)
                           for h in range(1, L + 1) if kj + h < Kt] + [
                fd.diagonal_ticket(gj + h, kj, P, Kt)
                for h in range(1, L + 1) if gj + h < P]
            for r in waits:
                assert r < t                             # lower tickets only
                while done[r % S] < r + 1:
                    yield
        if Kt > 1:
            agg = x[:, -1, :].reshape(-1).copy()
            excl = np.zeros(np_ * cols, np.uint64)
            yield from chain(t, g, k, False, agg, k + 1 < Kt, excl)
            x = (x + excl.reshape(np_, 1, cols)) % 2**32
        if planes > 1:
            x = np.cumsum(x, 0) % 2**32
            agg = x[-1].reshape(-1).copy()
            excl = np.zeros(agg.size, np.uint64)
            yield from chain(t, g, k, True, agg, g + 1 < P, excl)
            x = (x + excl.reshape(1, nrows, cols)) % 2**32
        done[t % S] = t + 1
        q[p0:p0 + np_, k0:k0 + nrows] = x.astype(np.uint32)

    running, next_ticket, steps = [], 0, 0
    while running or next_ticket < geo.units:
        if next_ticket < geo.units and len(running) < resident and (
                not running or rng.random() < 0.3):
            running.append(unit(next_ticket))
            next_ticket += 1
            continue
        i = rng.randrange(len(running))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
        steps += 1
        assert steps < 10**7, "the protocol did not finish"
    return q[:, :rows].reshape(-1)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shape,w,group,resident,depth", [
    ((6, 3, 5), 1, 1, 3, 1),        # 6 x 3 units, the tightest ring
    ((7, 4, 3), 2, 2, 5, 2),        # partial plane group, 2-row tiles
    ((40, 3), 1, 3, 4, 2),          # 2-D: one chain of 14 units
    ((40, 3), 1, 1, 7, 3),
    ((2, 12, 4), 3, 2, 6, 1),       # one plane group: row chains only
    ((9, 2, 6), 2, 1, 4, 2),        # one tile a plane: plane chains only
])
def test_nd_ring_never_overwrites_a_needed_slot(shape, w, group, resident,
                                                depth, seed):
    """A pure-Python model of the kernels' look-back over the ring, with
    the ring at its smallest legal size ((depth + 1) x the longest
    diagonal) and random schedules of at most ``resident`` blocks: no read
    finds its slot overwritten, every wait ends, and q is the cumsum along
    every axis mod 2^32."""
    rng = random.Random(seed)
    d = np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                             dtype=np.uint64).astype(
                                                 np.uint32)
    n_tiles = math.prod(shape) // (w * shape[-1]) + (
        len(shape) == 2 and shape[0] % w != 0)
    geo = fd._nd_unit_geometry(shape, w, n_tiles, 0, 1, group)
    a = min(geo.units_p, geo.units_k)
    geo = geo._replace(depth=depth, slots=min(geo.units, (depth + 1) * a))
    got = _play_nd(d, geo, w, resident, rng)
    want = d.astype(np.uint64)
    for axis in range(d.ndim):
        want = np.cumsum(want, axis) % 2**32
    assert np.array_equal(got, want.reshape(-1).astype(np.uint32))


def test_nd_ring_model_needs_the_gate():
    """The model's check has teeth: without ring_gate, the same protocol on
    the same smallest legal ring reads an overwritten slot on some random
    schedule (a reader falls behind while later units reuse its slot)."""
    shape, w = (8, 4, 3), 1
    geo = fd._nd_unit_geometry(shape, w, 32, 0, 1, 1)
    a = min(geo.units_p, geo.units_k)
    geo = geo._replace(depth=1, slots=2 * a)
    caught = 0
    for seed in range(20):
        try:
            _play_nd(np.ones(shape, np.uint32), geo, w, 8,
                     random.Random(seed), gate=False)
        except _Overwritten:
            caught += 1
    assert caught > 0


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entry_points_match_signatures(name):
    """Each kernel library's C entry point takes, in order, the argument
    types its ctypes signature passes (a mismatch would shift every later
    argument of a launch)."""
    symbol, argtypes = _build.SIGNATURES[name]
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", src, re.S)
    assert m, f"no C entry point {symbol} in {name}.cu"
    kinds = []
    for param in m.group(1).split(","):
        ctype = " ".join(param.split()[:-1])
        kinds.append(ctypes.c_void_p if ctype.endswith("*") else
                     {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                      "float": ctypes.c_float}[ctype])
    assert kinds == list(argtypes)


@pytest.mark.parametrize("name", ["decode_tiles_fused_nd",
                                  "dequant_reconstruct_nd"])
def test_nd_entries_check_the_launch_first(name):
    """Both N-D C entries refuse (-1) a block width and look-back depth the
    protocol cannot run before they launch anything: nd_launch_ok asks for
    a whole warp (lookback_depth's lanes), depth 1 to 32 and 2 x depth + 1
    threads (ring_gate's units).  The card test
    test_nd_entries_refuse_what_the_protocol_cannot_run drives each
    refusal."""
    header = (_build.CSRC / "fused.cuh").read_text()
    m = re.search(r"inline bool nd_launch_ok\(const NdGrid& grid, int "
                  r"threads\) \{(.*?)\}", header, re.S)
    assert m, "no nd_launch_ok in fused.cuh"
    terms = {" ".join(t.split()) for t in m.group(1).replace(
        "return", "").replace(";", "").split("&&")}
    assert terms == {"threads >= 32", "threads <= kNdMaxThreads",
                     "grid.depth >= 1", "grid.depth <= 32",
                     "threads >= 2 * grid.depth + 1", "grid.slots >= 1"}
    src = (_build.CSRC / f"{name}.cu").read_text()
    symbol = _build.SIGNATURES[name][0]
    body = src[src.index(f'extern "C" int {symbol}('):]
    check = body.index("if (!nd_launch_ok(grid, threads)) return -1;")
    assert check < body.index("REPRO_LAUNCH(float)")


# ---------------------------------------------------------------------------
# decode_tiles_fused: persistent units of tiles, a warp-wide look-back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("ss_max", [1, 2, 31, 32, 33, 100, 411, 1024])
@pytest.mark.parametrize("codes_per_subseq", [1, 8, 52, 128])
@pytest.mark.parametrize("tile,n_tiles", [(64, 15625), (1001, 250),
                                          (4096, 1), (4096, 7),
                                          (4096, 4096), (20000, 50)])
def test_fused_geometry(tile, n_tiles, codes_per_subseq, ss_max, sm):
    """Units of 1 to MAX_GROUP tiles, every tile in one unit; blocks of
    FUSED_MAX_THREADS; a unit's lanes fit its block, FUSED_MIN_BLOCKS
    blocks fit an SM and the units fill them, unless the unit is one tile,
    and one tile more would break one of the three; a grid of the resident
    blocks or one a unit."""
    lut = 4096
    n_subseq = max(1, n_tiles * tile // codes_per_subseq)
    geo = fd.fused_geometry(n_tiles, n_subseq, tile, ss_max, lut, sm)
    k = geo.unit_tiles
    assert 1 <= k <= min(fd.MAX_GROUP, n_tiles)
    assert (geo.units - 1) * k < n_tiles <= geo.units * k
    assert geo.smem == fd.fused_unit_smem(k * tile, lut) <= K.SMEM_LIMIT
    span = min(-(-n_subseq // n_tiles) + 2, ss_max)

    def fits(j):
        return (j * span <= fd.FUSED_MAX_THREADS
                and K.resident_blocks(fd.FUSED_MAX_THREADS,
                                      fd.fused_unit_smem(j * tile, lut),
                                      fd.FUSED_REGS) >= fd.FUSED_MIN_BLOCKS
                and (j - 1) * sm * fd.FUSED_MIN_BLOCKS < n_tiles)

    assert k == 1 or fits(k)
    assert k == min(fd.MAX_GROUP, n_tiles) or not fits(k + 1)
    resident = sm * K.resident_blocks(fd.FUSED_MAX_THREADS, geo.smem,
                                      fd.FUSED_REGS)
    assert 1 <= geo.blocks == min(geo.units, resident)
    assert geo.window == fd.LOOKBACK_WINDOW == 32
    assert geo.scratch_words == 2 + 2 * geo.units


def test_fused_geometry_at_hacc1d():
    """hacc1d (2**24 codes at 2.452 bits, 4,096 tiles of 4,096, max_len 12)
    on 132 SMs: units of 3 tiles, ~246 lanes, in blocks of 512 threads, 3 an
    SM (4 tiles' two stages let only 2 fit): 1,366 units over 396 blocks."""
    n_subseq = -(-int(2.452 * (1 << 24)) // 128)
    ss_max = hp.ss_max_for_tile(4096, 12)
    geo = fd.fused_geometry(4096, n_subseq, 4096, ss_max, 4096, 132)
    assert geo == fd.FusedGeometry(unit_tiles=3, units=1366, blocks=396,
                                   smem=61920, window=32)
    assert K.resident_blocks(512, fd.fused_unit_smem(4 * 4096, 4096),
                             fd.FUSED_REGS) == 2


def test_fused_1d_tile_bound_is_the_kernels():
    """The codec takes a flat field's fused path for the widest tile whose
    block (fused_unit_smem: two uint16 stages) fits shared memory beside
    the LUT, and falls back, with a reason, one tile wider, so the wrapper
    never refuses a tile the codec hands it."""
    import torch

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.sz import compressor

    c = Codec(CodecConfig(device="cpu")).compress(
        torch.linspace(0, 1, 5000, dtype=torch.float32))
    lut = 1 << c.codebook.max_len
    widest = max(t for t in range(54000, 56000)
                 if fd.fused_unit_smem(t, lut) <= K.SMEM_LIMIT)
    assert compressor.fused_unsupported_reason(
        c, "ref", "gap", "tile", tile_syms=widest) is None
    why = compressor.fused_unsupported_reason(c, "ref", "gap", "tile",
                                              tile_syms=widest + 1)
    assert "shared memory" in why


def _play_lookback(aggs, window, resident, rng):
    """csrc/decode_tiles_fused.cu's units and csrc/fused.cuh:unit_lookback
    on a random schedule.  ``resident`` blocks each loop: take a ticket u;
    publish u's aggregate (unit 0: its prefix); then look back for the
    unit it took before (its warp's lanes read the window in a random
    order, other blocks acting between the reads; then it is done, slides
    or reads again) and publish that unit's inclusive prefix; stop when the
    tickets run out.  Each step one random block does one thing.  Returns
    each unit's exclusive prefix and the slides."""
    mask = (1 << 32) - 1
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
        prefix &= mask
        result[u] = prefix
        if u > 0:
            status[u] = (2, (prefix + aggs[u]) & mask)
        yield

    def block():
        prev = None
        while True:
            u = ticket[0]
            ticket[0] += 1
            yield
            if u < len(aggs):
                status[u] = (2 if u == 0 else 1, aggs[u])
                yield
            if prev is not None:
                yield from lookback(prev)
            if u >= len(aggs):
                return
            prev = u

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


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_units,window,resident", [
    (1, 32, 4), (7, 32, 3), (200, 32, 16), (200, 1, 8), (300, 2, 50),
    (400, 32, 400), (150, 5, 150)])
def test_fused_lookback_model_is_a_cumsum(n_units, window, resident, seed):
    """Units publishing in random orders, each block two units in flight,
    windows that slide: every unit's exclusive prefix is np.cumsum's, mod
    2**32."""
    rng = random.Random(seed)
    aggs = [rng.randrange(1 << 20) for _ in range(n_units)]
    got, slides = _play_lookback(aggs, window, resident, rng)
    want = np.concatenate([[0], np.cumsum(aggs)[:-1]]) & ((1 << 32) - 1)
    assert got == [int(w) for w in want]
    if window <= 2 and n_units > 100:
        assert slides > 0


@pytest.mark.parametrize("window", [1, 3, 32])
def test_fused_lookback_model_wraps_as_int32(window):
    """Aggregates near 2**31 (negative residual sums as uint32 too): the
    prefixes, cast to int32, are np.cumsum's in int32, which wraps."""
    rng = random.Random(window)
    signed = [rng.choice([1, -1]) * rng.randrange(1 << 30, 1 << 31)
              for _ in range(120)]
    aggs = [v & ((1 << 32) - 1) for v in signed]
    got, _ = _play_lookback(aggs, window, 40, rng)
    with np.errstate(over="ignore"):
        want = np.concatenate([[0], np.cumsum(np.array(signed, np.int32),
                                              dtype=np.int32)[:-1]])
    assert np.array_equal(np.array(got, np.uint32).view(np.int32), want)


def _unit_chunks(n, warps):
    """fused.cuh:unit_chunk: a warp's codes, ceil(n / warps) rounded up to a
    row of 128."""
    return (-(-n // warps) + 127) // 128 * 128


def _walk_residuals(codes, opos, oval, base, lo, hi, radius, warps):
    """Pass 2 of csrc/fused.cuh's 1-D units in Python (write_unit through
    UnitResiduals::row4): each warp's chunk a row of 128 codes at a time,
    code - radius, and the outliers of the slice [lo, hi) patched in by the
    warp's walk (walk_from; then, while the walk is inside the row, the
    positions of the next 32 outliers, one a lane, of which those inside
    the row are a prefix: up to kBroadcastMax broadcast one at a time,
    more found by each lane's binary search over the lanes and its next 4
    fetched).  Returns the residuals and how often each outlier of the
    slice was patched in."""
    n = len(codes)
    chunk = _unit_chunks(n, warps)
    big = (1 << 31) - 1

    def place(o):
        return opos[o] - base if o < hi else big

    out = np.zeros(n, np.int64)
    used = np.zeros(len(opos), np.int64)
    for w in range(warps):
        c0, c1 = w * chunk, min((w + 1) * chunk, n)
        o = bisect.bisect_left(opos, base + c0, lo, hi)
        at = place(o)
        for row in range(c0, c1, 128):
            stop = min(row + 128, c1)
            r = [int(codes[e]) - radius if e < stop else 0
                 for e in range(row, row + 128)]
            while at < stop:
                p = [place(o + lane) for lane in range(32)]
                ins = [q < stop for q in p]
                m = sum(ins)
                assert ins == [True] * m + [False] * (32 - m)
                for lane in range(32):
                    e = row + 4 * lane
                    if m <= 4:                   # broadcast
                        srcs = range(m)
                    else:                        # lower bound, then 4
                        j = 0
                        for step in (16, 8, 4, 2, 1):
                            if p[j + step - 1] < e:
                                j += step
                        srcs = [t for t in range(j, j + 4) if t < m]
                    for t in srcs:
                        if 0 <= p[t] - e < 4:
                            r[p[t] - row] = oval[o + t]
                            used[o + t] += 1
                o += m
                at = place(o)
            out[row:stop] = r[:stop - row]
    return out, used[lo:hi]


def _chunk_totals(codes, opos, oval, base, lo, hi, radius, warps):
    """Pass 1 (unit_chunk_totals) in Python: each chunk's sum of code -
    radius, then each outlier of the slice adds the difference between its
    residual and its code's to the chunk of its place."""
    n = len(codes)
    chunk = _unit_chunks(n, warps)
    tot = [int((codes[w * chunk:(w + 1) * chunk].astype(np.int64)
                - radius).sum()) for w in range(warps)]
    for o in range(lo, hi):
        p = opos[o] - base
        if 0 <= p < n:
            tot[p // chunk] += oval[o] - (int(codes[p]) - radius)
    return tot


@pytest.mark.parametrize("n", [1, 127, 129, 1001, 3 * 4096])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.05, 0.3, 1.0])
def test_fused_outlier_walk_matches_a_scatter(n, density):
    """Both passes see the residuals a scatter of the unit's outliers
    gives: the walk gives each unit position its residual and patches
    each outlier of the slice exactly once, and the chunk totals with the
    outliers' differences are the scattered residuals' sums; the
    neighbouring units' outliers around the slice are ignored; for 16
    warps and for 1, at densities up to every code an outlier, with runs
    of outliers longer than a warp's 32 lanes."""
    rng = np.random.default_rng(n * 7 + int(density * 100))
    base, radius = 40_000, 4
    codes = rng.integers(0, 2 * radius, n)
    mine = np.flatnonzero(rng.random(n) < density)
    if density:                                 # a run past 32 lanes
        mine = np.union1d(mine, np.arange(min(n, 40)))
    opos = np.concatenate([[base - 3, base - 1], base + mine,
                           [base + n, base + n + 5]]).tolist()
    oval = rng.integers(-(1 << 31), 1 << 31, len(opos)).tolist()
    lo, hi = 2, 2 + len(mine)
    want = codes.astype(np.int64) - radius
    want[mine] = oval[lo:hi]
    for warps in (16, 1):
        got, used = _walk_residuals(codes, opos, oval, base, lo, hi, radius,
                                    warps)
        assert np.array_equal(got, want)
        assert (used == 1).all()
        chunk = _unit_chunks(n, warps)
        assert _chunk_totals(codes, opos, oval, base, lo, hi, radius,
                             warps) == [int(want[w * chunk:(w + 1) * chunk]
                                            .sum()) for w in range(warps)]


def test_fused_entry_checks_the_geometry_first():
    """The 1-D C entry refuses (-1) a unit past stage_unit_residuals' 8
    slots, a window past a warp's lanes and too little shared memory,
    before it launches anything, and launches blocks of the width its
    register bound assumes (the card test
    test_fused_1d_entry_refuses_bad_geometry drives the refusals)."""
    src = (_build.CSRC / "decode_tiles_fused.cu").read_text()
    body = src[src.index('extern "C" int repro_decode_tiles_fused('):]
    check = body[:body.index("return -1;")]
    for term in ("unit_tiles < 1", "unit_tiles > 8", "window < 1",
                 "window > 32", "blocks < 1", "fused_unit_smem("):
        assert term in check
    assert body.index("return -1;") < body.index("REPRO_LAUNCH(float)")
    assert "kernel<<<blocks, kFusedMaxThreads, smem," in src
    assert re.search(r"kFusedMaxThreads = (\d+);", src).group(1) == str(
        fd.FUSED_MAX_THREADS)
    assert "__launch_bounds__(kFusedMaxThreads, kFusedMinBlocks)" in src
    min_blocks = int(re.search(r"kFusedMinBlocks = (\d+);", src).group(1))
    # registers go 8 a thread at a time
    regs = 65536 // (min_blocks * fd.FUSED_MAX_THREADS) // 8 * 8
    assert fd.FUSED_REGS == regs
    assert fd.FUSED_MIN_BLOCKS == min_blocks
