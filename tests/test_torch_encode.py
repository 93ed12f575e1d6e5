"""The port's device write path (``encode_backend="cuda"``) against the JAX
package's ("jnp" and "pallas").

The same inputs, made with numpy from a seed, go through both packages.
Here on the CPU each kernel wrapper of the write path runs its plain
version (``kernels/lorenzo.py``, ``kernels/histogram.py``,
``kernels/huffman_encode.py``); the CUDA kernels are held against those
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: bit-exact everywhere (float32 true division rounded half to
even, integer arithmetic, one float32 multiply), with two stated
exceptions of the reference itself:
  * the Pallas quantizer (``kernels/lorenzo.py:quantize1d``) flips one
    lattice tie on the seed-0 field of ``tests/test_kernels.py`` (ROADMAP.md
    queue C); the port matches ``core/sz/lorenzo.py:quantize`` there;
  * ``reconstruct1d`` is bit-exact against ``kernels/ref.lorenzo_reconstruct``;
    against the interpret-mode Pallas ``ops.lorenzo_reconstruct`` it is
    bit-exact too on every case here (asserted, so a difference would show).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.huffman import encode as jhe
from repro.core.huffman import pipeline as jpp
from repro.core.sz import compressor as jcomp
from repro.core.sz import lorenzo as jlor
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import encode as he
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor, lorenzo
from repro_torch.kernels import histogram as H
from repro_torch.kernels import huffman_encode as E
from repro_torch.kernels import launches, ops
from repro_torch.kernels import lorenzo as L

from conftest import make_book_and_stream
from test_torch_stream import RADIUS, SHAPES, assert_same_stream, \
    spiky_field


def _walk(shape, seed, scale=0.1):
    """A random-walk float32 field along the last axis (Lorenzo-friendly)."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    return x * np.float32(scale)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_triple(got, want):
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


# ---------------------------------------------------------------------------
# Quantize
# ---------------------------------------------------------------------------

QUANT_SHAPES = [(3000,), (40, 56), (5, 20, 30), (2, 3, 4, 5), (1, 3000),
                (40, 1, 56), (1, 5, 1, 20, 30)]


@pytest.mark.parametrize("radius", [512, 4])
@pytest.mark.parametrize("eb", [1e-2, 1e-3])
@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=str)
def test_quantize_matches_jax(shape, eb, radius):
    x = _walk(shape, seed=len(shape) * 7 + shape[-1])
    want = jlor.quantize(jnp.asarray(x), eb, radius=radius)
    got = lorenzo.quantize(torch.from_numpy(x), eb, radius=radius)
    assert got[0].dtype == torch.uint16 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32
    _same_triple(got, want)
    # the kernel wrapper (its plain version here) and the ops entry
    _same_triple(L.lorenzo_quantize(torch.from_numpy(x),
                                    ops._two_eb_f32(eb), radius), want)
    _same_triple(ops.lorenzo_quantize(torch.from_numpy(x), eb, radius),
                 want)
    if radius == 4:
        assert bool(got[1].any()), "case must force outliers"


def _check_against_pallas(x, eb, got):
    """The port's quantizer against the Pallas one (interpret mode).

    The Pallas kernel divides by a trace-time constant, which XLA turns into
    a multiply by its reciprocal (ROADMAP.md queue C).  The two lattices
    then differ exactly where ``round(x / 2eb)`` and ``round(x * (1 /
    2eb))`` differ in float32; the port takes the true division there, as
    ``core/sz/lorenzo.py:quantize`` does.  Returns the differing residuals.
    """
    pallas = jops.lorenzo_quantize(jnp.asarray(x), eb, radius=512,
                                   interpret=True)
    two_eb = np.float32(eb) * np.float32(2)
    q_div = np.round(x / two_eb).astype(np.int64)
    q_mul = np.round(x * (np.float32(1) / two_eb)).astype(np.int64)
    q_port = np.cumsum(got[2].numpy().astype(np.int64))
    q_pallas = np.cumsum(np.asarray(pallas[2]).astype(np.int64))
    assert np.array_equal(q_port, q_div)
    assert np.array_equal(q_pallas, q_mul)
    flipped = np.nonzero(q_div != q_mul)[0]
    for i in flipped:   # near-ties of x / 2eb only
        assert abs(abs(float(x[i]) / float(two_eb) % 1) - 0.5) < 1e-3
    same = np.ones(x.shape, bool)
    same[flipped] = False
    same[np.minimum(flipped + 1, x.size - 1)] = False
    for g, p in zip(got, pallas):
        assert np.array_equal(g.numpy().astype(np.int64)[same],
                              np.asarray(p).astype(np.int64)[same])
    return int((got[2].numpy() != np.asarray(pallas[2])).sum())


@pytest.mark.parametrize("n", [4096, 4097, 8192])
def test_quantize_wrapper_matches_pallas(n):
    x = _walk((n,), seed=n)
    got = ops.lorenzo_quantize(torch.from_numpy(x), 1e-3, 512)
    _same_triple(got, jlor.quantize(jnp.asarray(x), 1e-3, radius=512))
    _check_against_pallas(x, 1e-3, got)


def test_quantize_tie_field_follows_lorenzo_quantize():
    # tests/test_kernels.py's seed-0 field at n=20480, eb=1e-3: x/(2eb) is
    # -3117.5 at index 2286.  core/sz/lorenzo.quantize rounds it to -3118
    # by true division; the Pallas quantizer's reciprocal multiply gives
    # -3117 there (ROADMAP.md queue C).  The port follows lorenzo.quantize.
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal(20480)).astype(np.float32) * 0.1
    got = ops.lorenzo_quantize(torch.from_numpy(x), 1e-3, 512)
    _same_triple(got, jlor.quantize(jnp.asarray(x), 1e-3, radius=512))
    two_eb = np.float32(1e-3) * np.float32(2)
    assert x[2286] / two_eb == np.float32(-3117.5)
    assert int(got[2][2286]) == int(np.round(x[2286] / two_eb)) - int(
        np.round(x[2285] / two_eb))
    # the tie and the residual after it
    assert _check_against_pallas(x, 1e-3, got) == 2


def test_quantize_axis_cap():
    x8 = _walk((2,) * 8, seed=1)
    _same_triple(ops.lorenzo_quantize(torch.from_numpy(x8), 1e-2, 4),
                 jlor.quantize(jnp.asarray(x8), 1e-2, radius=4))
    # unit axes do not count towards the cap
    x = _walk((2,) * 8 + (1, 1), seed=2)
    _same_triple(ops.lorenzo_quantize(torch.from_numpy(x), 1e-2, 4),
                 jlor.quantize(jnp.asarray(x), 1e-2, radius=4))
    with pytest.raises(ValueError, match="at most 8 non-unit axes"):
        ops.lorenzo_quantize(torch.from_numpy(_walk((2,) * 9, seed=3)),
                             1e-2, 4)


def test_quantize_wrapper_checks():
    x = torch.zeros(16)
    with pytest.raises(TypeError, match="float32"):
        L.lorenzo_quantize(x.double(), 0.002, 4)
    with pytest.raises(ValueError, match="two_eb"):
        L.lorenzo_quantize(x, 0.1, 4)          # not a float32 value
    with pytest.raises(ValueError, match="radius"):
        L.lorenzo_quantize(x, 0.5, 0)
    with pytest.raises(ValueError, match="contiguous"):
        L.lorenzo_quantize(torch.zeros(4, 4).t(), 0.5, 4)


# ---------------------------------------------------------------------------
# Reconstruct
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [100, 4096, 12288, 5000])
def test_reconstruct1d_matches_jax(n):
    rng = np.random.default_rng(n)
    d = rng.integers(-3, 4, size=n).astype(np.int32)
    got = ops.lorenzo_reconstruct(torch.from_numpy(d), 1e-3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    want = jref.lorenzo_reconstruct(jnp.asarray(d), 1e-3, shape=(n,))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the interpret-mode Pallas kernel gives the same bits here
    pallas = jops.lorenzo_reconstruct(jnp.asarray(d), 1e-3, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    assert np.array_equal(
        L.reconstruct1d(torch.from_numpy(d), ops._two_eb_f32(1e-3)).numpy(),
        np.asarray(want))


def test_reconstruct_nd_matches_jax():
    rng = np.random.default_rng(5)
    d = rng.integers(-3, 4, size=(6, 7, 8)).astype(np.int32)
    got = ops.lorenzo_reconstruct(torch.from_numpy(d), 1e-3, shape=d.shape)
    want = jops.lorenzo_reconstruct(jnp.asarray(d), 1e-3, shape=d.shape)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_quantize_reconstruct_roundtrip():
    n, eb = 8192, 1e-3
    x = _walk((n,), seed=11)
    _, _, resid = ops.lorenzo_quantize(torch.from_numpy(x), eb, 512)
    xr = ops.lorenzo_reconstruct(resid, eb).numpy()
    assert np.abs(xr - x).max() <= eb + np.spacing(
        np.float32(np.abs(x).max()))


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbins", [16, 1024])
@pytest.mark.parametrize("n", [100, 65536, 70000])
def test_histogram_matches_jax(n, nbins):
    rng = np.random.default_rng(n + nbins)
    # out-of-range values on both sides are clipped into the end bins
    x = rng.integers(-5, nbins + 5, size=n).astype(np.int32)
    want = np.asarray(jops.histogram(jnp.asarray(x), nbins, interpret=True))
    got = ops.histogram(torch.from_numpy(x), nbins)
    assert got.dtype == torch.int32 and tuple(got.shape) == (nbins,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          np.asarray(jref.histogram(jnp.asarray(x), nbins)))
    u16 = np.clip(x, 0, None).astype(np.uint16)
    assert np.array_equal(
        H.histogram(torch.from_numpy(u16), nbins).numpy(),
        np.asarray(jops.histogram(jnp.asarray(u16), nbins, interpret=True)))


def test_histogram_checks():
    with pytest.raises(TypeError, match="integer"):
        H.histogram(torch.zeros(4), 4)
    with pytest.raises(ValueError, match="nbins"):
        H.histogram(torch.zeros(4, dtype=torch.int32), 0)
    assert H.histogram_in_smem(1024) and not H.histogram_in_smem(1 << 16)


# ---------------------------------------------------------------------------
# Bit-pack
# ---------------------------------------------------------------------------


def _plans(freq, max_len, sps):
    jplan = jpp.build_encoder_plan(freq, max_len=max_len,
                                   subseqs_per_seq=sps, backend="pallas")
    tplan = hp.build_encoder_plan(freq, max_len=max_len,
                                  subseqs_per_seq=sps, backend="cuda",
                                  device="cpu")
    for name in ("enc_code", "enc_len", "dec_sym", "dec_len"):
        assert np.array_equal(getattr(jplan.codebook, name),
                              getattr(tplan.codebook, name)), name
    assert (jplan.total_bits, jplan.min_len) == (tplan.total_bits,
                                                 tplan.min_len)
    return jplan, tplan


@pytest.mark.parametrize("n_syms,max_len,sps", [
    (4000, 12, 32),    # default framing
    (4097, 12, 32),    # crosses a sequence boundary by one symbol
    (129, 8, 4),       # short stream, small sequences
    (777, 16, 32),     # deep codebook
    (50, 4, 32),       # codebook shallower than a unit
    (1, 12, 32),       # single symbol
])
def test_pack_matches_pallas(n_syms, max_len, sps):
    rng = np.random.default_rng(n_syms + max_len)
    vocab = min(1024, 1 << max_len)
    _, syms, _ = make_book_and_stream(rng, n_syms=n_syms, vocab=vocab,
                                      max_len=max_len, subseqs_per_seq=sps)
    freq = np.bincount(syms, minlength=vocab)
    jplan, tplan = _plans(freq, max_len, sps)
    want = jpp.encode_with_plan(jnp.asarray(syms), jplan, backend="pallas")
    t = torch.from_numpy(syms)
    assert_same_stream(want, hp.encode_with_plan(t, tplan, backend="cuda"))
    assert_same_stream(want, hp.encode_with_plan(t, tplan, backend="ref"))
    assert_same_stream(
        jhe.encode_gather(jnp.asarray(syms), jplan.enc_code, jplan.enc_len,
                          jplan.total_bits, subseqs_per_seq=sps,
                          min_len=jplan.min_len),
        he.encode_gather(t, tplan.enc_code, tplan.enc_len, tplan.total_bits,
                         subseqs_per_seq=sps, min_len=tplan.min_len))


def test_pack_single_used_symbol():
    freq = np.zeros(16, np.int64)
    freq[3] = 500
    syms = np.full(500, 3, np.uint16)
    jplan, tplan = _plans(freq, 8, 32)
    assert tplan.min_len == 1
    want = jpp.encode_with_plan(jnp.asarray(syms), jplan, backend="pallas")
    assert_same_stream(want, hp.encode_with_plan(torch.from_numpy(syms),
                                                 tplan, backend="cuda"))


def test_pack_empty_input():
    freq = np.zeros(16, np.int64)
    freq[0] = 1   # the codebook needs one symbol; the stream holds none
    jplan, tplan = _plans(freq, 8, 32)
    jplan = jpp.EncoderPlan(codebook=jplan.codebook, enc_code=jplan.enc_code,
                            enc_len=jplan.enc_len, total_bits=0,
                            subseqs_per_seq=32)
    tplan = hp.EncoderPlan(codebook=tplan.codebook, enc_code=tplan.enc_code,
                           enc_len=tplan.enc_len, total_bits=0,
                           subseqs_per_seq=32)
    want = jpp.encode_with_plan(jnp.zeros((0,), jnp.uint16), jplan,
                                backend="pallas")
    got = hp.encode_with_plan(torch.zeros(0, dtype=torch.uint16), tplan,
                              backend="cuda")
    assert_same_stream(want, got)
    assert got.n_symbols == 0 and got.total_bits == 0


def test_pack_tiles_plain_and_checks():
    rng = np.random.default_rng(4)
    book, syms, stream = make_book_and_stream(rng, n_syms=3000)
    enc_code = torch.from_numpy(book.enc_code)
    enc_len = torch.from_numpy(book.enc_len)
    sym = torch.from_numpy(syms)
    lens = enc_len.to(torch.int32)[sym.to(torch.int32)]
    starts = torch.cumsum(lens, 0, dtype=torch.int32) - lens
    n_units = int(np.asarray(stream.units).shape[0])
    units = E.pack_tiles(sym, starts, enc_code, enc_len, n_units)
    assert units.dtype == torch.uint32
    assert np.array_equal(units.numpy(), np.asarray(stream.units))
    with pytest.raises(TypeError, match="uint16"):
        E.pack_tiles(sym.to(torch.int32), starts, enc_code, enc_len, n_units)
    with pytest.raises(ValueError, match="shape"):
        E.pack_tiles(sym, starts[1:], enc_code, enc_len, n_units)
    with pytest.raises(ValueError, match="n_units"):
        E.pack_tiles(sym, starts, enc_code, enc_len, 0)


# ---------------------------------------------------------------------------
# End to end: compress(encode_backend="cuda") against the JAX package
# ---------------------------------------------------------------------------


def _assert_same_payload(cj, ct):
    assert_same_stream(cj.stream, ct.stream)
    for name in ("enc_code", "enc_len", "dec_sym", "dec_len"):
        assert np.array_equal(getattr(cj.codebook, name),
                              getattr(ct.codebook, name)), name
    assert np.array_equal(np.asarray(cj.outlier_pos), ct.outlier_pos.numpy())
    assert np.array_equal(np.asarray(cj.outlier_val), ct.outlier_val.numpy())
    assert (cj.eb, cj.rel_range, cj.max_abs) == (ct.eb, ct.rel_range,
                                                 ct.max_abs)
    assert tuple(cj.shape) == ct.shape


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("mode,eb", [("rel", 1e-4), ("abs", 1e-3)])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_compress_matches_jax(ndim, mode, eb, jax_backend):
    x = spiky_field(SHAPES[ndim], seed=20 + ndim)
    cj = jcomp.compress(jnp.asarray(x), eb=eb, mode=mode, radius=RADIUS,
                        encode_backend=jax_backend)
    be = hp.get_encode_backend("cuda")
    be.reset_stats()
    ct = compressor.compress(torch.from_numpy(x), eb=eb, mode=mode,
                             radius=RADIUS, encode_backend="cuda",
                             device="cpu")
    _assert_same_payload(cj, ct)
    assert int((ct.outlier_pos >= 0).sum()) > 0, "case must force outliers"
    assert be.stats == {"encode_dispatches": 1, "encode_fallbacks": 0,
                        "encoder_plan_builds": 1}


def _lattice(shape, seed, eb=0.0078125):
    """Values exactly k * 2eb (eb a power of two): the float32 and float64
    quantizers agree, so every encode backend writes the same bytes."""
    rng = np.random.default_rng(seed)
    k = np.rint(np.asarray(_walk(shape, seed)) * 40).astype(np.int32)
    k.reshape(-1)[rng.choice(k.size, size=5, replace=False)] += 3000
    return k.astype(np.float32) * np.float32(2 * eb), eb


@pytest.mark.parametrize("shape", [(6000,), (50, 60), (6, 20, 25)],
                         ids=str)
def test_lattice_byte_identical_to_ref(shape):
    x, eb = _lattice(shape, seed=sum(shape))
    t = torch.from_numpy(x)
    ref = compressor.compress(t, eb=eb, mode="abs", encode_backend="ref",
                              device="cpu")
    dev = compressor.compress(t, eb=eb, mode="abs", encode_backend="cuda",
                              device="cpu")
    assert int((ref.outlier_pos >= 0).sum()) > 0
    assert_same_stream(ref.stream, dev.stream)
    for name in ("enc_code", "enc_len"):
        assert np.array_equal(getattr(ref.codebook, name),
                              getattr(dev.codebook, name))
    assert torch.equal(ref.outlier_pos, dev.outlier_pos)
    assert torch.equal(ref.outlier_val, dev.outlier_val)
    cj = jcomp.compress(jnp.asarray(x), eb=eb, mode="abs",
                        encode_backend="ref")
    _assert_same_payload(cj, dev)


@pytest.mark.parametrize("n", [31, 4096, 4097, 8191])
def test_tail_padding_sizes(n):
    x, eb = _lattice((n,), seed=n)
    cj = jcomp.compress(jnp.asarray(x), eb=eb, mode="abs",
                        encode_backend="jnp")
    ct = compressor.compress(torch.from_numpy(x), eb=eb, mode="abs",
                             encode_backend="cuda", device="cpu")
    _assert_same_payload(cj, ct)


def test_float16_falls_back_and_counts():
    x = spiky_field(SHAPES[2], seed=3).astype(np.float16)
    codec = Codec(CodecConfig(encode_backend="cuda", radius=RADIUS,
                              device="cpu"))
    codec.reset_stats()
    ref = hp.get_encode_backend("ref")
    ref.reset_stats()
    assert "float16" in compressor.encode_unsupported_reason(
        torch.from_numpy(x), "cuda")
    assert "host path" in compressor.encode_unsupported_reason(
        torch.from_numpy(x), "ref")
    assert compressor.encode_unsupported_reason(
        torch.zeros(4), "cuda") is None
    launches.reset()
    c = codec.compress(torch.from_numpy(x))
    assert codec.stats["encode_fallbacks"] == 1
    assert codec.stats["encode_dispatches"] == 0
    assert ref.stats["encode_dispatches"] == 1
    want = compressor.compress(torch.from_numpy(x), radius=RADIUS,
                               encode_backend="ref", device="cpu")
    assert_same_stream(c.stream, want.stream)
    assert launches.counts()["lorenzo_quantize"] == 0


def test_codec_stats_counters():
    codec = Codec(CodecConfig(encode_backend="cuda", device="cpu"))
    codec.reset_stats()
    x = torch.from_numpy(_walk((2000,), seed=9))
    codec.compress(x)
    codec.compress(x)
    stats = codec.stats
    assert stats["encode_dispatches"] == 2
    assert stats["encoder_plan_builds"] == 2
    assert stats["encode_fallbacks"] == 0
    # on the CPU the wrappers run their plain versions and launch nothing
    launches.reset()
    codec.compress(x)
    assert all(n == 0 for n in launches.counts().values())


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("mode", ["rel", "abs"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_roundtrip_within_bound(ndim, mode, backend):
    x = spiky_field(SHAPES[ndim], seed=30 + ndim)
    codec = Codec(CodecConfig(eb=1e-3, mode=mode, radius=RADIUS,
                              encode_backend="cuda", backend=backend,
                              device="cpu"))
    c = codec.compress(torch.from_numpy(x))
    y = codec.decompress(c)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    assert float((y.double() - torch.from_numpy(x).double()).abs().max()) \
        <= c.eb_effective
    # the decoder reads back exactly the codes the device quantizer made
    codes = lorenzo.quantize(torch.from_numpy(x), c.eb, c.radius)[0]
    assert torch.equal(codec.decode(c.stream, c.codebook,
                                    c.n_symbols).to(torch.int32),
                       codes.reshape(-1).to(torch.int32))


def test_nine_axes_fall_back_and_count():
    """A tensor with more non-unit axes than the quantize kernel takes
    (``kernels/lorenzo.py:MAX_AXES``) is compressed by the host path, as the
    reference compresses it, and counts one encode fallback."""
    x = _walk((2,) * 9, seed=4)
    assert "9 non-unit axes" in compressor.encode_unsupported_reason(
        torch.from_numpy(x), "cuda")
    assert compressor.encode_unsupported_reason(
        torch.from_numpy(_walk((2,) * 8 + (1,), seed=4)), "cuda") is None
    codec = Codec(CodecConfig(encode_backend="cuda", radius=RADIUS,
                              device="cpu"))
    codec.reset_stats()
    launches.reset()
    c = codec.compress(torch.from_numpy(x))
    assert codec.stats["encode_fallbacks"] == 1
    assert codec.stats["encode_dispatches"] == 0
    assert launches.counts()["lorenzo_quantize"] == 0
    want = compressor.compress(torch.from_numpy(x), radius=RADIUS,
                               encode_backend="ref", device="cpu")
    assert_same_stream(c.stream, want.stream)
    assert torch.equal(c.outlier_pos, want.outlier_pos)
    assert torch.equal(c.outlier_val, want.outlier_val)
    cj = jcomp.compress(jnp.asarray(x), radius=RADIUS, encode_backend="jnp")
    assert_same_stream(cj.stream, c.stream)
    y = codec.decompress(c)
    assert tuple(y.shape) == x.shape
    assert float((y.double() - torch.from_numpy(x).double()).abs().max()) \
        <= c.eb_effective


@pytest.mark.parametrize("mode", ["rel", "abs"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_empty_tensor_raises_value_error(backend, mode):
    x = np.zeros((0, 4), np.float32)
    with pytest.raises(ValueError):
        jcomp.compress(jnp.asarray(x), mode=mode,
                       encode_backend="jnp" if backend == "cuda" else "ref")
    with pytest.raises(ValueError, match=r"empty tensor of shape \(0, 4\)"):
        compressor.compress(torch.from_numpy(x), mode=mode,
                            encode_backend=backend, device="cpu")
