"""The port's decode phases against the JAX package's.

The kernel wrappers of ``repro_torch.kernels.huffman_decode`` take CPU
tensors through their plain versions; those are held here, bit for bit,
against the Pallas kernels in interpret mode (``repro.kernels.ops``), and
the port's reference decoders against ``repro.core.huffman.decode``.
Streams come from the JAX encoder over skewed codebooks, with tails that
leave the last sequence mostly zero padding.  The CUDA kernels themselves
are held against these plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.huffman import decode as jhd
from repro.core.huffman.pipeline import ss_max_for_tile
from repro.kernels import ops as jops

from repro_torch.core.huffman import decode as hd
from repro_torch.kernels import common as C
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches
from repro_torch.kernels import ops

from conftest import make_book_and_stream


def _t(stream):
    """Port-side tensors of a JAX-encoded stream (via numpy)."""
    return (torch.from_numpy(np.array(stream.units)),
            torch.from_numpy(np.array(stream.gaps)))


def _windows(stream):
    nss = stream.gaps.shape[0]
    bnds = np.arange(nss, dtype=np.int32) * 128
    return bnds + np.asarray(stream.gaps).astype(np.int32), bnds + 128


def _luts(book):
    return (torch.from_numpy(book.dec_sym), torch.from_numpy(book.dec_len))


def _tail_stream(rng, zipf):
    """A stream whose last sequence holds only a little payload."""
    for n in range(900, 2000, 7):
        book, syms, stream = make_book_and_stream(rng, n_syms=n, zipf=zipf)
        if 0 < int(stream.total_bits) % 4096 < 400:
            return book, syms, stream
    raise AssertionError("no mostly-padding tail found")


STREAMS = {
    "zipf1.2": lambda rng: make_book_and_stream(rng, n_syms=3000, zipf=1.2),
    "zipf2.0": lambda rng: make_book_and_stream(rng, n_syms=4096, zipf=2.0),
    "zipf3.0": lambda rng: make_book_and_stream(rng, n_syms=2500, zipf=3.0),
    "sps4": lambda rng: make_book_and_stream(rng, n_syms=2000, zipf=1.4,
                                             subseqs_per_seq=4),
    "tail": lambda rng: _tail_stream(rng, 1.5),
}


@pytest.fixture(params=list(STREAMS))
def case(request):
    rng = np.random.default_rng(list(STREAMS).index(request.param))
    return STREAMS[request.param](rng)


def test_count_subseq_matches_pallas(case):
    book, syms, stream = case
    starts, ends = _windows(stream)
    ds, dl = jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len)
    jc, jl = jops.subseq_counts(stream.units, ds, dl, jnp.asarray(starts),
                                jnp.asarray(ends), stream.total_bits,
                                book.max_len)
    units, _ = _t(stream)
    launches.reset()
    tc, tl = ops.subseq_counts(units, *_luts(book), torch.from_numpy(starts),
                               torch.from_numpy(ends),
                               int(stream.total_bits), book.max_len)
    assert K.count_subseq.launches == 0     # CPU tensors: the plain version
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert int(tc.sum()) == syms.shape[0]


@pytest.mark.parametrize("tile", [512, 1024])
def test_decode_tiles_matches_pallas(case, tile):
    book, syms, stream = case
    n = syms.shape[0]
    starts, ends = _windows(stream)
    ds, dl = jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len)
    _, counts = jhd.subseq_scan(jnp.asarray(stream.units), ds, dl,
                                jnp.asarray(starts), jnp.asarray(ends),
                                stream.total_bits, book.max_len)
    offsets = np.asarray(jhd.output_offsets(counts))
    ss_max = ss_max_for_tile(tile, book.max_len)
    want = np.asarray(jops.decode_write_tiles(
        stream.units, ds, dl, jnp.asarray(starts), jnp.asarray(ends),
        jnp.asarray(offsets), stream.total_bits, book.max_len, n, tile,
        ss_max))
    units, _ = _t(stream)
    got = ops.decode_write_tiles(units, *_luts(book),
                                 torch.from_numpy(starts),
                                 torch.from_numpy(ends),
                                 torch.from_numpy(offsets),
                                 int(stream.total_bits), book.max_len, n,
                                 tile, ss_max)
    assert got.dtype == torch.uint16
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(syms, got.numpy())


def test_reference_decoders_match_jax(case):
    """The "ref" backend's oracles equal the JAX reference decoders."""
    book, syms, stream = case
    n = syms.shape[0]
    starts, ends = _windows(stream)
    ds, dl = jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len)
    units, _ = _t(stream)
    tds, tdl = _luts(book)
    jl, jc = jhd.subseq_scan(jnp.asarray(stream.units), ds, dl,
                             jnp.asarray(starts), jnp.asarray(ends),
                             stream.total_bits, book.max_len)
    tl, tc = hd.subseq_scan(units, tds, tdl, torch.from_numpy(starts),
                            torch.from_numpy(ends), int(stream.total_bits),
                            book.max_len)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    offsets = hd.output_offsets(tc)
    assert np.array_equal(np.asarray(jhd.output_offsets(jc)),
                          offsets.numpy())
    tile = 512
    got = hd.decode_write_tiles(units, tds, tdl, torch.from_numpy(starts),
                                torch.from_numpy(ends), offsets,
                                int(stream.total_bits), book.max_len, n,
                                tile, ss_max_for_tile(tile, book.max_len))
    assert np.array_equal(syms, got.numpy())
    seq = hd.decode_sequential(units, tds, tdl, n, book.max_len)
    assert np.array_equal(syms, seq.numpy())


def test_merged_lut_base_matches_pallas():
    """A per-subsequence ``lut_base`` selects a codebook in a merged LUT."""
    rng = np.random.default_rng(7)
    book, syms, stream = make_book_and_stream(rng, n_syms=2000, zipf=1.6)
    other, _, _ = make_book_and_stream(rng, n_syms=10, zipf=2.5)
    n = syms.shape[0]
    starts, ends = _windows(stream)
    ms = np.concatenate([other.dec_sym, book.dec_sym])
    ml = np.concatenate([other.dec_len, book.dec_len])
    base = np.full(starts.shape, 1 << book.max_len, np.int32)
    counts = np.asarray(jops.subseq_counts(
        stream.units, jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len),
        jnp.asarray(starts), jnp.asarray(ends), stream.total_bits,
        book.max_len)[0])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    tile = 512
    ss_max = ss_max_for_tile(tile, book.max_len)
    want = np.asarray(jops.decode_write_tiles(
        stream.units, jnp.asarray(ms), jnp.asarray(ml), jnp.asarray(starts),
        jnp.asarray(ends), jnp.asarray(offsets), stream.total_bits,
        book.max_len, n, tile, ss_max, lut_base=jnp.asarray(base)))
    units, _ = _t(stream)
    got = ops.decode_write_tiles(
        units, torch.from_numpy(ms), torch.from_numpy(ml),
        torch.from_numpy(starts), torch.from_numpy(ends),
        torch.from_numpy(offsets), int(stream.total_bits), book.max_len, n,
        tile, ss_max, lut_base=torch.from_numpy(base))
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(syms, got.numpy())


def test_corrupt_windows_match_pallas():
    """Inverted, overlong and out-of-stream windows follow the reference's
    rules (row of the start, end clamps, zero reads past the stream)."""
    rng = np.random.default_rng(11)
    book, _, stream = make_book_and_stream(rng, n_syms=1500, zipf=1.3)
    nbits = int(np.asarray(stream.units).shape[0]) * 32
    starts = rng.integers(-40, nbits + 300, size=300).astype(np.int32)
    ends = (starts + rng.integers(-50, 400, size=300)).astype(np.int32)
    jc, jl = jops.subseq_counts(stream.units, jnp.asarray(book.dec_sym),
                                jnp.asarray(book.dec_len),
                                jnp.asarray(starts), jnp.asarray(ends),
                                stream.total_bits, book.max_len)
    units, _ = _t(stream)
    tc, tl = ops.subseq_counts(units, *_luts(book), torch.from_numpy(starts),
                               torch.from_numpy(ends),
                               int(stream.total_bits), book.max_len)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())


def test_common_helpers():
    """The row helpers read zeros past the stream and peek like bits.peek."""
    units = torch.tensor([0xDEADBEEF, 0x01234567, 0x89ABCDEF, 0xFFFFFFFF,
                          0x00000001], dtype=torch.int64).to(torch.uint32)
    rows = C.gather_subseq_rows(units, torch.tensor([0, 1]))
    assert rows.shape == (2, C.ROW_UNITS)
    assert rows[1].tolist() == [1, 0, 0, 0, 0, 0]
    pos = torch.tensor([0, 5, 31, 33])
    idx = C.peek_rows(rows[:1].expand(4, -1), pos, 12)
    from repro_torch.core.huffman import bits

    assert torch.equal(idx, bits.peek(units.to(torch.int64), pos, 12))


class TestWrapperChecks:
    def _args(self):
        units = torch.zeros(128, dtype=torch.uint32)
        s = torch.zeros(32, dtype=torch.int32)
        return units, s, s + 128, 0, torch.zeros(16, dtype=torch.uint16), \
            torch.zeros(16, dtype=torch.uint8), 4

    def test_dtype(self):
        units, s, e, tb, ds, dl, ml = self._args()
        with pytest.raises(TypeError, match="uint32"):
            K.count_subseq(units.to(torch.int64), s, e, tb, ds, dl, ml)
        with pytest.raises(TypeError, match="int32"):
            K.count_subseq(units, s.to(torch.int64), e, tb, ds, dl, ml)

    def test_shape_and_layout(self):
        units, s, e, tb, ds, dl, ml = self._args()
        with pytest.raises(ValueError, match="shape"):
            K.count_subseq(units, s, e[:5], tb, ds, dl, ml)
        with pytest.raises(ValueError, match="contiguous"):
            K.count_subseq(units, s, torch.zeros(64, dtype=torch.int32)[::2],
                           tb, ds, dl, ml)
        with pytest.raises(ValueError, match="max_len"):
            K.count_subseq(units, s, e, tb, ds, dl, 30)

    def test_device(self):
        units, s, e, tb, ds, dl, ml = self._args()
        meta = [t.to("meta") for t in (units, s, e, ds, dl)]
        with pytest.raises(ValueError, match="device"):
            K.count_subseq(meta[0], meta[1], meta[2], tb, meta[3], meta[4],
                           ml)

    def test_decode_tiles_s0_shape(self):
        units, s, e, tb, ds, dl, ml = self._args()
        off = torch.zeros(33, dtype=torch.int32)
        with pytest.raises(ValueError, match="s0"):
            K.decode_tiles(units, s, e, off, torch.zeros(3, dtype=torch.int32),
                           tb, ds, dl, ml, 512, 10, 100)
