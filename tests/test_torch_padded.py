"""The port's padded strategy (two-pass and ``fused=True``) against the JAX
package's.

The padded decoder's plain version (``huffman_decode.decode_padded_plain``,
which the kernel wrapper runs for CPU tensors) and its compaction
(``ops.decode_padded_compact``) are held bit for bit against the Pallas
kernel of ``repro.kernels.ops.decode_padded_compact`` in interpret mode, on
streams the JAX package wrote; the epilogues' plain versions
(``fused_decode.dequant_reconstruct*_plain``) against the Pallas epilogue
kernels in interpret mode; ``Codec(strategy="padded", fused=False|True,
device="cpu")`` on the port's "cuda" and "ref" backends against the JAX
``Codec``, on payloads either package wrote, and against the golden
digests.  Also: the fused padded path's row bound, derived for Hopper, at
its edge.  The CUDA kernels are held against the same plain versions on
the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.api import Codec as JCodec, CodecConfig as JConfig
from repro.core.huffman import decode as jhd
from repro.core.sz import compressor as jcomp
from repro.kernels import common as jC
from repro.kernels import fused_decode as jfus
from repro.kernels import huffman_decode as jdec
from repro.kernels import ops as jops

from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import decode as hd
from repro_torch.core.sz import compressor
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches, ops

from test_torch_decode import STREAMS, _luts, _t, _windows
from test_torch_fused import KERNEL_SHAPES, _jax_payload
from test_torch_stream import DTYPES, RADIUS, as_bytes, both, jax_arrays, \
    spiky_field

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fused_nd_golden.json")


@pytest.fixture(params=list(STREAMS))
def case(request):
    rng = np.random.default_rng(list(STREAMS).index(request.param))
    return STREAMS[request.param](rng)


def _jax_padded_rows(stream, book, starts, ends):
    """The Pallas padded kernel (interpret mode) over the windows."""
    ids, sl, el = jops._subseq_windows(jnp.asarray(starts), jnp.asarray(ends),
                                       stream.total_bits)
    n = ids.shape[0]
    pad = (-n) % jdec.DEFAULT_SS_BLOCK
    z = jnp.zeros(pad, jnp.int32)
    rows = jC.gather_subseq_rows(jnp.asarray(stream.units),
                                 jnp.concatenate([ids, z]))
    padded, counts = jdec.decode_padded(
        rows, jnp.concatenate([sl, z]), jnp.concatenate([el, z]),
        jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len), book.max_len)
    return np.asarray(padded)[:n], np.asarray(counts)[:n]


def test_decode_padded_matches_pallas(case):
    book, syms, stream = case
    n = syms.shape[0]
    starts, ends = _windows(stream)
    want_rows, want_counts = _jax_padded_rows(stream, book, starts, ends)
    units, _ = _t(stream)
    args = (units, torch.from_numpy(starts), torch.from_numpy(ends),
            int(stream.total_bits), *_luts(book), book.max_len)
    launches.reset()
    rows, counts = K.decode_padded(*args)      # CPU tensors: plain version
    assert K.decode_padded.launches == 0
    assert rows.dtype == torch.uint16 and rows.shape == (starts.shape[0], 128)
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(counts.numpy(), want_counts)
    prow, pcnt = K.decode_padded_plain(*args)
    assert torch.equal(prow.to(torch.int32), rows.to(torch.int32))
    assert torch.equal(pcnt, counts)

    want, want_c = jops.decode_padded_compact(
        stream.units, jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len),
        jnp.asarray(starts), jnp.asarray(ends), stream.total_bits,
        book.max_len, n)
    got, got_c = ops.decode_padded_compact(
        units, *_luts(book), torch.from_numpy(starts),
        torch.from_numpy(ends), int(stream.total_bits), book.max_len, n)
    assert got.dtype == torch.uint16
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got.numpy(), syms)


def test_reference_padded_decoder_matches_jax(case):
    """The "ref" backend's padded oracle equals the JAX reference's."""
    book, syms, stream = case
    n = syms.shape[0]
    starts, _ = _windows(stream)
    want, want_c = jhd.decode_write(
        jnp.asarray(stream.units), jnp.asarray(book.dec_sym),
        jnp.asarray(book.dec_len), jnp.asarray(starts), stream.total_bits,
        book.max_len, n)
    units, _ = _t(stream)
    got, got_c = hd.decode_write(units, *_luts(book),
                                 torch.from_numpy(starts),
                                 int(stream.total_bits), book.max_len, n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got.numpy(), syms)


def test_padded_slot_127_clamp():
    """Past 127 codewords a lane keeps overwriting its last slot, as in the
    reference: a one-bit code over a window longer than 128 bits."""
    units = torch.zeros(16, dtype=torch.uint32)
    ds = torch.tensor([7, 9], dtype=torch.uint16)
    dl = torch.tensor([1, 1], dtype=torch.uint8)
    start = torch.tensor([0, 130], dtype=torch.int32)
    end = torch.tensor([180, 140], dtype=torch.int32)
    rows, counts = K.decode_padded(units, start, end, 512, ds, dl, 1)
    assert counts.tolist() == [180, 10]
    assert (rows[0].to(torch.int32) == 7).all()
    assert rows[1, :10].tolist() == [7] * 10
    assert (rows[1, 10:].to(torch.int32) == 0).all()


# ---------------------------------------------------------------------------
# The epilogues alone: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _codes(cj):
    """The quant codes of a JAX payload, decoded by the JAX package."""
    return np.asarray(JCodec(JConfig(radius=RADIUS)).decode(
        cj.stream, cj.codebook, cj.n_symbols))


@pytest.mark.parametrize("tile", [4096, 512])
@pytest.mark.parametrize("dtype_key", list(DTYPES))
@pytest.mark.parametrize("shape_key", list(KERNEL_SHAPES))
def test_epilogue_plain_matches_pallas(shape_key, dtype_key, tile):
    """``tile`` 4096 is the padded path's block; 512 gives the small
    shapes several tiles, so the carries cross tiles."""
    _, cj, _ = _jax_payload(shape_key, dtype_key)
    codes = _codes(cj)
    n = cj.n_symbols
    sq = jops.fused_squeeze(cj.shape)
    two_eb = jops._two_eb_f32(cj.eb)
    out_dtype = DTYPES[dtype_key][0]
    block = tile if sq is None else jops.fused_tile_rows(sq, tile) * sq[-1]
    pad = (-n) % block
    jcodes = jnp.asarray(np.concatenate([codes, np.zeros(pad, np.uint16)]))
    if sq is None:
        want = jfus.dequant_reconstruct(
            jcodes, cj.outlier_pos, cj.outlier_val, two_eb, cj.radius,
            block=block, out_dtype=out_dtype, interpret=True)[:n]
    else:
        want = jfus.dequant_reconstruct_nd(
            jcodes, cj.outlier_pos, cj.outlier_val, two_eb, cj.radius, sq,
            block // sq[-1], out_dtype=out_dtype, interpret=True)
    want = np.asarray(want).tobytes()

    c = compressor.compressed_from_arrays(jax_arrays(cj), "cpu")
    assert int((c.outlier_pos >= 0).sum()) > 0
    tcodes = torch.from_numpy(codes.copy())
    if tile == ops.PADDED_EPILOGUE_BLOCK:
        kernel, plain, args = ops.padded_epilogue_inputs(
            tcodes, n, c.outlier_pos, c.outlier_val, c.eb, c.radius,
            shape=c.shape, out_dtype=c.dtype)
    else:
        tpad = torch.from_numpy(np.asarray(jcodes))
        ob = ops._outlier_bounds(c.outlier_pos, tpad.numel() // block, block)
        two = ops._two_eb_f32(c.eb)
        if sq is None:
            kernel, plain = fd.dequant_reconstruct, \
                fd.dequant_reconstruct_plain
            args = (tpad, c.outlier_pos, c.outlier_val, ob, two, c.radius,
                    block, c.dtype)
        else:
            kernel, plain = fd.dequant_reconstruct_nd, \
                fd.dequant_reconstruct_nd_plain
            args = (tpad, c.outlier_pos, c.outlier_val, ob, two, c.radius,
                    tuple(sq), block // sq[-1], c.dtype)
    assert kernel.__name__ == ("dequant_reconstruct" if sq is None
                               else "dequant_reconstruct_nd")
    assert as_bytes(plain(*args)[:n]) == want
    launches.reset()
    got = kernel(*args)[:n]           # CPU tensors: the plain version
    assert launches.counts()[kernel.__name__] == 0
    assert got.dtype == c.dtype and as_bytes(got) == want


def test_epilogue_wrappers_check_inputs():
    codes = torch.zeros(4096, dtype=torch.uint16)
    opos = torch.full((8,), -1, dtype=torch.int32)
    oval = torch.zeros(8, dtype=torch.int32)
    ob = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="padded"):
        fd.dequant_reconstruct(codes[:4000], opos, oval, ob[:1], 0.5, 8)
    with pytest.raises(TypeError, match="uint16"):
        fd.dequant_reconstruct(codes.to(torch.int32), opos, oval, ob, 0.5, 8)
    with pytest.raises(ValueError, match="obounds"):
        fd.dequant_reconstruct(codes, opos, oval, ob[:1], 0.5, 8)
    with pytest.raises(ValueError, match="tiles"):
        fd.dequant_reconstruct_nd(codes, opos, oval, ob, 0.5, 8, (10, 64), 2)
    got = fd.dequant_reconstruct_nd(codes, opos, oval,
                                    torch.zeros(3, dtype=torch.int32), 0.5,
                                    8, (64, 64), 32)
    assert got.shape == (4096,)


# ---------------------------------------------------------------------------
# Codec(strategy="padded") against the JAX Codec
# ---------------------------------------------------------------------------

_CASES: dict = {}


def _case(ndim, dtype_key, fused):
    """JAX payload, the JAX padded codec's bytes, and the port's payload of
    the same field (memoized)."""
    key = (ndim, dtype_key, fused)
    if key not in _CASES:
        shape = {1: (3000,), 2: (40, 56), 3: (5, 20, 30)}[ndim]
        xj, xt = both(spiky_field(shape, seed=7 * ndim + 13), dtype_key)
        cfg = JConfig(eb=1e-4, mode="rel", radius=RADIUS, strategy="padded",
                      fused=fused)
        jcodec = JCodec(cfg)
        cj = jcodec.compress(xj)
        want = np.asarray(jcodec.decompress(cj)).tobytes()
        ct = Codec(_config()).compress(xt)
        _CASES[key] = (xt, cj, ct, want)
    return _CASES[key]


def _config(**kw):
    return CodecConfig(eb=1e-4, mode="rel", radius=RADIUS, device="cpu",
                       **kw)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype_key", list(DTYPES))
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_codec_padded_matches_jax(backend, ndim, dtype_key, fused):
    xt, cj, ct, want = _case(ndim, dtype_key, fused)
    codec = Codec(_config(backend=backend, strategy="padded", fused=fused))
    codec.reset_stats()
    launches.reset()
    got = codec.decompress(ct)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(xt.shape)
    assert as_bytes(got) == want
    carried = compressor.compressed_from_arrays(jax_arrays(cj), "cpu")
    assert as_bytes(codec.decompress(carried)) == want
    s = codec.stats
    assert s["decode_write_dispatches"] == 2
    assert s["fused_dispatches"] == (2 if fused else 0)
    assert s["fused_fallbacks"] == 0
    assert sum(launches.counts().values()) == 0
    # bit-identical to the port's own tile two-pass output
    assert as_bytes(Codec(_config(backend=backend)).decompress(ct)) == want


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_golden_vectors_padded(backend, fused):
    """The four reconstruction sha256s of tests/golden/fused_nd_golden.json
    through the padded strategy."""
    with open(GOLDEN) as f:
        cases = json.load(f)["cases"]
    assert len(cases) == 4
    for entry in cases:
        spec = entry["spec"]
        _, xt = both(spiky_field(tuple(spec["shape"]), spec["seed"]),
                     spec["dtype"])
        codec = Codec(CodecConfig(eb=spec["eb"], mode=spec["mode"],
                                  radius=spec["radius"],
                                  tile_syms=spec["tile_syms"],
                                  backend=backend, device="cpu",
                                  strategy="padded", fused=fused))
        c = codec.compress(xt)
        codec.reset_stats()
        got = codec.decompress(c)
        assert codec.stats["fused_dispatches"] == int(fused), spec
        assert hashlib.sha256(as_bytes(got)).hexdigest() == \
            entry["reconstruction_sha256"], spec


# ---------------------------------------------------------------------------
# Eligibility of the fused padded path: the epilogue's bounds
# ---------------------------------------------------------------------------


def test_padded_row_bound_is_the_epilogue_block():
    """The epilogue block holds no LUT: a one-row tile of int32 residuals
    and the scan scratch fit Hopper's 232,448 B up to 58,032 columns, at
    any max_len; the "tile" strategy keeps its LUT-dependent bound."""
    cols = compressor.FUSED_PADDED_MAX_COLS
    assert cols == 58032
    assert fd.dequant_reconstruct_smem(cols) <= K.SMEM_LIMIT
    assert fd.dequant_reconstruct_smem(cols + 1) > K.SMEM_LIMIT
    assert compressor.fused_max_cols(12) == 54960 < cols


@pytest.mark.parametrize("max_len", [12, 16])
def test_padded_row_bound_at_the_edge(max_len):
    x = torch.from_numpy(spiky_field((3, 20), seed=5))
    c = Codec(CodecConfig(radius=RADIUS, device="cpu",
                          max_len=max_len)).compress(x)
    cols = compressor.FUSED_PADDED_MAX_COLS
    edge = dataclasses.replace(c, shape=(3, cols))
    wide = dataclasses.replace(c, shape=(3, cols + 1))
    for be in ("cuda", "ref"):
        assert compressor.fused_unsupported_reason(edge, be, "gap",
                                                   "padded") is None
        assert compressor.fused_unsupported_reason(wide, be, "gap",
                                                   "padded") == (
            f"fastest axis {cols + 1} exceeds the per-tile row bound {cols}")
        # the same row is past the tile strategy's bound
        tile_cols = compressor.fused_max_cols(max_len)
        assert compressor.fused_unsupported_reason(edge, be, "gap",
                                                   "tile") == (
            f"fastest axis {cols} exceeds the per-tile row bound "
            f"{tile_cols}")


def test_padded_fused_decodes_the_widest_row():
    """A field of rows at the padded bound decodes fused (one-row tiles),
    bit-identical to the two-pass output; one column more falls back."""
    cols = compressor.FUSED_PADDED_MAX_COLS
    x = torch.from_numpy(spiky_field((2, cols), seed=9))
    cfg = CodecConfig(radius=RADIUS, device="cpu", strategy="padded")
    c = Codec(cfg).compress(x)
    fused = Codec(cfg.replace(fused=True))
    fused.reset_stats()
    got = fused.decompress(c)
    assert fused.stats["fused_dispatches"] == 1
    assert fused.stats["fused_fallbacks"] == 0
    assert as_bytes(got) == as_bytes(Codec(cfg).decompress(c))
    kernel, _, args = ops.padded_epilogue_inputs(
        Codec(cfg).decode(c.stream, c.codebook, c.n_symbols), c.n_symbols,
        c.outlier_pos, c.outlier_val, c.eb, c.radius, c.shape, c.dtype)
    assert kernel is fd.dequant_reconstruct_nd and args[7] == 1


@pytest.mark.parametrize("case", ["float64", "4-D", "plane", "tuned"])
def test_padded_fallback_reasons_match_reference(case):
    """The reference's reason strings, in its order, for strategy padded."""
    _, cj, ct, _ = _case(1, "f32", True)
    changes = {"float64": ({"dtype": torch.float64},
                           {"dtype": np.dtype("float64")}),
               "4-D": ({"shape": (2, 3, 4, 5)}, {"shape": (2, 3, 4, 5)}),
               "plane": ({"shape": (2, 1100, 1000)},
                         {"shape": (2, 1100, 1000)}),
               "tuned": ({}, {})}[case]
    strategy = "tuned" if case == "tuned" else "padded"
    port = compressor.fused_unsupported_reason(
        dataclasses.replace(ct, **changes[0]), "cuda", "gap", strategy)
    ref = jcomp.fused_unsupported_reason(
        dataclasses.replace(cj, **changes[1]), "ref", "gap", strategy)
    assert port == ref and port is not None
