"""The port's write path and stream containers against the JAX package.

Same inputs, made with numpy from a seed, go through both packages; the
tolerance is bit-exact everywhere (integer arithmetic, float64
prequantization with half-to-even rounding, one float32 multiply and one
cast).  Also home of the small helpers the other ``test_torch_*`` files
share: the spiky test field and the JAX ``Compressed`` -> dict bridge.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.api import Codec as JCodec, CodecConfig as JConfig
from repro.core.cache import compressed_digest as jax_digest
from repro.core.huffman import bits as jbits
from repro.core.huffman import codebook as jcb
from repro.core.huffman import encode as jhe
from repro.core.sz import lorenzo as jlor

from repro_torch.core.cache import compressed_digest
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import bits, codebook, encode
from repro_torch.core.sz import compressor, lorenzo
from repro_torch.data.pipeline import smooth_field

SHAPES = {1: (3000,), 2: (40, 56), 3: (5, 20, 30)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
RADIUS = 128      # small radius so the forced spikes overflow it
TILE_SYMS = 512


def spiky_field(shape, seed):
    """Lorenzo-friendly float32 field with spikes past the radius; the spike
    count is capped at the field's size so tiny fields work too."""
    x = np.asarray(smooth_field(shape, seed=seed)).copy()
    flat = x.reshape(-1)
    rng = np.random.default_rng(seed + 1000)
    n = min(max(4, flat.size // 400), flat.size)
    idx = rng.choice(flat.size, size=n, replace=False)
    flat[idx] += np.float32(40.0) * (x.max() - x.min() + 1.0) * \
        rng.choice(np.asarray([-1.0, 1.0], np.float32), size=idx.size)
    return x


def both(x_np, dtype_key):
    """The same field as a JAX array and a torch tensor of one dtype (both
    cast from float32 with round-to-nearest-even)."""
    jdt, tdt = DTYPES[dtype_key]
    return jnp.asarray(x_np).astype(jdt), torch.from_numpy(x_np).to(tdt)


def jax_arrays(c) -> dict:
    """A JAX ``Compressed`` as the plain dict ``compressed_from_arrays``
    takes (numpy on this side: the port never sees a JAX object)."""
    s = c.stream
    return {
        "units": np.asarray(s.units), "gaps": np.asarray(s.gaps),
        "counts": np.asarray(s.counts), "seq_counts": np.asarray(s.seq_counts),
        "total_bits": int(s.total_bits), "n_symbols": int(s.n_symbols),
        "subseqs_per_seq": int(s.subseqs_per_seq),
        "enc_code": np.asarray(c.codebook.enc_code),
        "enc_len": np.asarray(c.codebook.enc_len),
        "max_len": int(c.codebook.max_len),
        "outlier_pos": np.asarray(c.outlier_pos),
        "outlier_val": np.asarray(c.outlier_val), "shape": tuple(c.shape),
        "dtype": np.dtype(c.dtype).name, "eb": float(c.eb),
        "radius": int(c.radius), "rel_range": float(c.rel_range),
        "max_abs": float(c.max_abs)}


def as_bytes(t: torch.Tensor) -> bytes:
    """Raw bytes of a tensor (bf16 has no numpy dtype; go through ints)."""
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(signed[t.element_size()]).numpy().tobytes()


def assert_same_stream(js, ts):
    assert np.array_equal(np.asarray(js.units), ts.units.numpy())
    assert np.array_equal(np.asarray(js.gaps), ts.gaps.numpy())
    assert np.array_equal(np.asarray(js.counts), ts.counts.numpy())
    assert np.array_equal(np.asarray(js.seq_counts), ts.seq_counts.numpy())
    assert int(js.total_bits) == ts.total_bits
    assert int(js.n_symbols) == ts.n_symbols
    assert ts.units.dtype == torch.uint32 and ts.gaps.dtype == torch.uint8


# ---------------------------------------------------------------------------
# (a) compress: the whole payload, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,eb", [("rel", 1e-4), ("abs", 1e-3)])
@pytest.mark.parametrize("dtype_key", list(DTYPES))
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_compress_payload_matches_jax(ndim, dtype_key, mode, eb):
    xj, xt = both(spiky_field(SHAPES[ndim], seed=10 + ndim), dtype_key)
    cj = JCodec(JConfig(eb=eb, mode=mode, radius=RADIUS,
                        encode_backend="ref")).compress(xj)
    ct = Codec(CodecConfig(eb=eb, mode=mode, radius=RADIUS,
                           device="cpu")).compress(xt)
    assert_same_stream(cj.stream, ct.stream)
    for name in ("enc_code", "enc_len", "dec_sym", "dec_len"):
        assert np.array_equal(getattr(cj.codebook, name),
                              getattr(ct.codebook, name)), name
    assert np.array_equal(np.asarray(cj.outlier_pos), ct.outlier_pos.numpy())
    assert np.array_equal(np.asarray(cj.outlier_val), ct.outlier_val.numpy())
    assert int((ct.outlier_pos >= 0).sum()) > 0, "case must force outliers"
    assert (cj.eb, cj.rel_range, cj.max_abs) == (ct.eb, ct.rel_range,
                                                 ct.max_abs)
    assert tuple(cj.shape) == ct.shape and ct.dtype == DTYPES[dtype_key][1]
    assert cj.compressed_bytes == ct.compressed_bytes
    assert cj.eb_effective == ct.eb_effective
    assert jax_digest(cj) == compressed_digest(ct)


def test_arrays_round_trip():
    """compressed_to_arrays / compressed_from_arrays are inverse, and a
    JAX-written payload enters the port with the same digest."""
    xj, xt = both(spiky_field((1500,), seed=4), "f32")
    cj = JCodec(JConfig(radius=RADIUS)).compress(xj)
    ct = compressor.compressed_from_arrays(jax_arrays(cj), "cpu")
    assert compressed_digest(ct) == jax_digest(cj)
    back = compressor.compressed_to_arrays(ct)
    again = compressor.compressed_from_arrays(back, "cpu")
    assert compressed_digest(again) == jax_digest(cj)
    assert set(back) == set(compressor.ARRAY_FIELDS)
    with pytest.raises(KeyError, match="missing fields"):
        compressor.compressed_from_arrays({"units": back["units"]}, "cpu")


# ---------------------------------------------------------------------------
# Encoder, codebook, bits
# ---------------------------------------------------------------------------


def _skewed(rng, n, vocab=1024, zipf=1.4, max_len=12):
    freq = np.bincount(np.clip(rng.zipf(zipf, 30000), 0, vocab - 1),
                       minlength=vocab)
    book = jcb.build_codebook(freq, max_len=max_len)
    syms = rng.choice(vocab, size=n, p=freq / freq.sum()).astype(np.uint16)
    return book, syms


@pytest.mark.parametrize("n,zipf,sps", [(1, 1.4, 32), (777, 1.2, 32),
                                        (5000, 2.0, 32), (4000, 1.4, 4),
                                        (3000, 3.0, 8)])
def test_encode_matches_jax(n, zipf, sps):
    rng = np.random.default_rng(n + sps)
    book, syms = _skewed(rng, n, zipf=zipf)
    js = jhe.encode(syms, book.enc_code, book.enc_len, subseqs_per_seq=sps)
    ts = encode.encode(torch.from_numpy(syms.astype(np.int64)),
                       torch.from_numpy(book.enc_code),
                       torch.from_numpy(book.enc_len), subseqs_per_seq=sps)
    assert_same_stream(js, ts)
    assert encode.units_for_bits(ts.total_bits, sps) == ts.units.shape[0]


def test_encode_in_chunks(monkeypatch):
    """The chunked unit pack equals the one-shot pack."""
    rng = np.random.default_rng(3)
    book, syms = _skewed(rng, 6000, zipf=1.3)
    args = (torch.from_numpy(syms.astype(np.int64)),
            torch.from_numpy(book.enc_code), torch.from_numpy(book.enc_len))
    whole = encode.encode(*args)
    monkeypatch.setattr(encode, "PACK_CHUNK_UNITS", 7)
    chunked = encode.encode(*args)
    assert torch.equal(whole.units.to(torch.int64),
                       chunked.units.to(torch.int64))


def test_empty_stream_matches_jax():
    js, ts = jhe.empty_stream(8), encode.empty_stream(8, device="cpu")
    assert_same_stream(js, ts)
    ts2 = encode.encode(torch.zeros(0, dtype=torch.int64),
                        torch.zeros(4, dtype=torch.uint32),
                        torch.zeros(4, dtype=torch.uint8),
                        subseqs_per_seq=8)
    assert_same_stream(js, ts2)


@pytest.mark.parametrize("max_len", [4, 8, 12, 16])
def test_codebook_matches_jax(max_len):
    rng = np.random.default_rng(max_len)
    freq = np.bincount(np.clip(rng.zipf(1.3, 20000), 0, 255), minlength=256)
    freq[rng.choice(256, 20)] = 0
    if max_len == 4:
        freq[16:] = 0
    jb = jcb.build_codebook(freq, max_len=max_len)
    tb = codebook.build_codebook(freq, max_len=max_len)
    for name in ("enc_code", "enc_len", "dec_sym", "dec_len"):
        assert np.array_equal(getattr(jb, name), getattr(tb, name)), name
    assert jb.min_len == tb.min_len
    assert codebook.validate_codebook(tb) == []


def test_validate_codebook_matches_jax():
    freq = np.arange(1, 65)
    good = codebook.build_codebook(freq, max_len=8)
    import dataclasses

    bad_len = good.enc_len.copy()
    bad_len[:4] = 1                      # overfills the code space
    for book in (dataclasses.replace(good, enc_len=bad_len),
                 dataclasses.replace(good, dec_sym=good.dec_sym[:10])):
        want = jcb.validate_codebook(book)
        assert want and codebook.validate_codebook(book) == want


def test_peek_matches_jax():
    rng = np.random.default_rng(0)
    units = rng.integers(0, 2**32, size=37, dtype=np.uint64).astype(np.uint32)
    pos = rng.integers(0, 37 * 32, size=500).astype(np.int32)
    pos[:3] = [0, 37 * 32 - 1, 36 * 32]
    for max_len in (1, 7, 12, 24):
        want = np.asarray(jbits.peek(jnp.asarray(units), jnp.asarray(pos),
                                     max_len))
        got = bits.peek(torch.from_numpy(units.astype(np.int64)),
                        torch.from_numpy(pos), max_len)
        assert np.array_equal(want, got.numpy())


# ---------------------------------------------------------------------------
# Lorenzo quantize / dequantize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_key", list(DTYPES))
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_quantize_host_matches_jax(ndim, dtype_key):
    xj, xt = both(spiky_field(SHAPES[ndim], seed=ndim), dtype_key)
    eb = 2e-3 * float(jnp.max(xj) - jnp.min(xj))
    codes, outlier, resid = jlor.quantize_host(np.asarray(xj), eb, RADIUS)
    tc, to, tr = lorenzo.quantize_host(xt, eb, RADIUS)
    assert tc.dtype == torch.uint16 and to.dtype == torch.bool
    assert np.array_equal(codes, tc.numpy())
    assert np.array_equal(outlier, to.numpy())
    assert np.array_equal(resid, tr.numpy())


def test_quantize_rounds_ties_to_even():
    """x / (2 eb) exactly k + 0.5 rounds half to even, as numpy does."""
    eb = 2.0 ** -8
    k = np.arange(-40, 40)
    x = ((k + 0.5) * 2 * eb).astype(np.float32)
    codes, _, resid = jlor.quantize_host(x, eb, 512)
    tc, _, tr = lorenzo.quantize_host(torch.from_numpy(x), eb, 512)
    assert np.array_equal(codes, tc.numpy())
    assert np.array_equal(resid, tr.numpy())


def test_quantize_lattice_guard():
    with pytest.raises(ValueError, match="int32 lattice"):
        lorenzo.quantize_host(torch.tensor([1.0e6]), 1e-6)


@pytest.mark.parametrize("dtype_key", list(DTYPES))
@pytest.mark.parametrize("shape", [(700,), (20, 33), (4, 9, 11)])
def test_dequantize_matches_jax(shape, dtype_key):
    rng = np.random.default_rng(len(shape))
    n = int(np.prod(shape))
    codes = rng.integers(0, 2 * RADIUS, size=n).astype(np.uint16)
    pos = np.full(16, -1, np.int32)
    pos[:9] = np.sort(rng.choice(n, 9, replace=False))
    pos[9] = n + 5                       # out of range: dropped
    val = rng.integers(-5000, 5000, size=16).astype(np.int32)
    eb = 3.7e-3
    jdt, tdt = DTYPES[dtype_key]
    want = jlor.dequantize(jnp.asarray(codes).reshape(shape),
                           jnp.asarray(pos), jnp.asarray(val), eb, shape,
                           radius=RADIUS, dtype=jdt)
    got = lorenzo.dequantize(torch.from_numpy(codes).reshape(shape),
                             torch.from_numpy(pos), torch.from_numpy(val),
                             eb, shape, radius=RADIUS, dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == shape
    assert as_bytes(got) == np.asarray(want).tobytes()
