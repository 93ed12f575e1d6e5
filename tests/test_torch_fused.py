"""The port's fused decode (``fused=True``) against the JAX package's.

The fused kernels' plain versions (``repro_torch.kernels.fused_decode``,
reached through ``ops.fused_tile_inputs`` and the kernel wrappers, which
take CPU tensors through them) are held bit for bit against the Pallas
kernels of ``repro.kernels.ops.decode_write_tiles_fused`` in interpret
mode, on JAX-written payloads.  ``Codec(fused=True, device="cpu")`` on the
port's "cuda" and "ref" backends is held bit for bit against the JAX
``Codec(fused=True)`` for payloads either package wrote.  Also: the golden
reconstruction digests through the fused path, the fallback of ineligible
tensors with the reference's reasons, and the outlier-slice assumption.
The CUDA kernels are held against the same plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
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
from repro.core.huffman import pipeline as jhp
from repro.core.sz import compressor as jcomp
from repro.kernels import ops as jops

from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor
from repro_torch.kernels import launches, ops

from test_torch_stream import DTYPES, RADIUS, as_bytes, both, jax_arrays, \
    spiky_field

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fused_nd_golden.json")

#: Shapes of the kernel parity cases and what each exercises.
KERNEL_SHAPES = {
    # 6 tiles of 512, the last one partial
    "1d": (3000,),
    # 40 tiles of 512: a long chain of carries
    "1d-long": (20000,),
    # w = 512 // 56 = 9 rows a tile, which does not divide 40
    "2d": (40, 56),
    # w = 17 steps down to 10 so it divides the plane height 20
    "3d": (5, 20, 30),
    # unit axes squeeze to 1-D
    "1xN": (1, 2500),
    # unit axes squeeze to 2-D
    "Nx1xM": (24, 1, 70),
}
TILE = 512

_PAYLOADS: dict = {}


def _jax_payload(shape_key, dtype_key):
    """A JAX-written payload with forced outliers (memoized)."""
    key = (shape_key, dtype_key)
    if key not in _PAYLOADS:
        shape = KERNEL_SHAPES[shape_key]
        xj, xt = both(spiky_field(shape, seed=len(shape) * 31 + 5),
                      dtype_key)
        cfg = JConfig(eb=1e-4, mode="rel", radius=RADIUS, tile_syms=TILE)
        cj = JCodec(cfg).compress(xj)
        _PAYLOADS[key] = (xt, cj, cfg)
    return _PAYLOADS[key]


def _jax_fused_kernel(cj, dtype_key):
    """The Pallas fused kernel (interpret mode) on the JAX payload."""
    plan = jhp.build_plan(cj.stream, cj.codebook)
    book = cj.codebook
    out = jops.decode_write_tiles_fused(
        cj.stream.units, jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len),
        plan.start_bits, plan.end_bits, plan.offsets, cj.stream.total_bits,
        book.max_len, cj.n_symbols, TILE,
        jhp.ss_max_for_tile(TILE, book.max_len), cj.outlier_pos,
        cj.outlier_val, cj.eb, cj.radius, shape=tuple(cj.shape),
        out_dtype=DTYPES[dtype_key][0], interpret=True)
    return np.asarray(out).tobytes()


def _port_fused_call(c):
    plan = hp.build_plan(c.stream, c.codebook, backend="cuda")
    luts = hp._as_luts(c.codebook, c.device)
    return ops.fused_tile_inputs(
        c.stream.units, luts.dec_sym, luts.dec_len, plan.start_bits,
        plan.end_bits, plan.offsets, c.stream.total_bits, luts.max_len,
        c.n_symbols, TILE, hp.ss_max_for_tile(TILE, luts.max_len),
        c.outlier_pos, c.outlier_val, c.eb, c.radius, shape=c.shape,
        out_dtype=c.dtype)


@pytest.mark.parametrize("dtype_key", list(DTYPES))
@pytest.mark.parametrize("shape_key", list(KERNEL_SHAPES))
def test_plain_fused_matches_pallas(shape_key, dtype_key):
    xt, cj, _ = _jax_payload(shape_key, dtype_key)
    want = _jax_fused_kernel(cj, dtype_key)
    c = compressor.compressed_from_arrays(jax_arrays(cj), "cpu")
    assert int((c.outlier_pos >= 0).sum()) > 0
    kernel, plain, args = _port_fused_call(c)
    squeezed = [s for s in c.shape if s != 1]
    assert kernel.__name__ == ("decode_tiles_fused" if len(squeezed) == 1
                               else "decode_tiles_fused_nd")
    got = plain(*args)
    assert got.dtype == xt.dtype and got.shape == (c.n_symbols,)
    assert as_bytes(got) == want
    launches.reset()
    assert as_bytes(kernel(*args)) == want   # CPU tensors: the plain version
    assert launches.counts()[kernel.__name__] == 0


_CODEC_CASES: dict = {}


def _codec_case(ndim, dtype_key):
    """Port payload and JAX payload of one field, and the JAX fused bytes
    of each (memoized)."""
    key = (ndim, dtype_key)
    if key not in _CODEC_CASES:
        shape = {1: (3000,), 2: (40, 56), 3: (5, 20, 30)}[ndim]
        xj, xt = both(spiky_field(shape, seed=7 * ndim + 13), dtype_key)
        cfg = JConfig(eb=1e-4, mode="rel", radius=RADIUS, tile_syms=TILE,
                      fused=True)
        jcodec = JCodec(cfg)
        cj = jcodec.compress(xj)
        want_j = np.asarray(jcodec.decompress(cj)).tobytes()
        ct = Codec(_config()).compress(xt)
        # the same payload, compressed by the port, through the JAX codec
        assert compressor.compressed_to_arrays(ct)["units"].tobytes() == \
            np.asarray(cj.stream.units).tobytes()
        _CODEC_CASES[key] = (xt, cj, ct, want_j)
    return _CODEC_CASES[key]


def _config(**kw):
    return CodecConfig(eb=1e-4, mode="rel", radius=RADIUS, tile_syms=TILE,
                       device="cpu", **kw)


@pytest.mark.parametrize("dtype_key", list(DTYPES))
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_codec_fused_matches_jax(backend, ndim, dtype_key):
    xt, cj, ct, want = _codec_case(ndim, dtype_key)
    codec = Codec(_config(backend=backend, fused=True))
    codec.reset_stats()
    launches.reset()
    got = codec.decompress(ct)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(xt.shape)
    assert as_bytes(got) == want
    carried = compressor.compressed_from_arrays(jax_arrays(cj), "cpu")
    assert as_bytes(codec.decompress(carried)) == want
    s = codec.stats
    assert s["fused_dispatches"] == 2 and s["fused_fallbacks"] == 0
    assert s["decode_write_dispatches"] == 2
    assert sum(launches.counts().values()) == 0
    # bit-identical to the port's own two-pass output
    two_pass = Codec(_config(backend=backend)).decompress(ct)
    assert as_bytes(two_pass) == want


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_golden_vectors_fused(backend):
    """The four reconstruction sha256s of tests/golden/fused_nd_golden.json
    through the fused path."""
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
                                  backend=backend, device="cpu", fused=True))
        c = codec.compress(xt)
        codec.reset_stats()
        got = codec.decompress(c)
        assert codec.stats["fused_dispatches"] == 1, spec
        assert hashlib.sha256(as_bytes(got)).hexdigest() == \
            entry["reconstruction_sha256"], spec


# ---------------------------------------------------------------------------
# Eligibility: the reference's checks and reasons
# ---------------------------------------------------------------------------


def _both_reasons(ct, cj, **changes):
    """The port's and the JAX package's reason for the same tensor."""
    port = compressor.fused_unsupported_reason(
        dataclasses.replace(ct, **changes.get("port", changes)), "cuda",
        "gap", "tile")
    jchanges = changes.get("jax", changes)
    ref = jcomp.fused_unsupported_reason(
        dataclasses.replace(cj, **jchanges), "ref", "gap", "tile")
    return port, ref


@pytest.mark.parametrize("case", ["float64", "4-D", "row", "plane"])
def test_fallback_reasons_match_reference(case):
    _, cj, ct, _ = _codec_case(1, "f32")
    if case == "float64":
        port, ref = _both_reasons(ct, cj, port={"dtype": torch.float64},
                                  jax={"dtype": np.dtype("float64")})
        assert port == ref == ("dtype float64 not in fused set "
                               "('float32', 'bfloat16', 'float16')")
    elif case == "4-D":
        port, ref = _both_reasons(ct, cj, shape=(2, 3, 4, 5))
        assert port == ref == ("4-D Lorenzo reconstruction (fused epilogue "
                               "covers up to 3-D)")
    elif case == "row":
        port, ref = _both_reasons(ct, cj, shape=(2, 60000))
        # The reference's string; the bound is derived again for Hopper.
        assert ref == ("fastest axis 60000 exceeds the per-tile row bound "
                       "32768")
        assert port == ref.replace("32768", str(compressor.FUSED_MAX_COLS))
        assert compressor.FUSED_MAX_COLS == 54960
    else:
        port, ref = _both_reasons(ct, cj, shape=(2, 1100, 1000))
        assert port == ref == ("plane 1100x1000 exceeds the VMEM plane-carry "
                               "bound 1048576")
    # within every bound both packages serve the tensor
    assert _both_reasons(ct, cj, shape=(2, 30, 50)) == (None, None)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("shape,dtype", [
    ((6, 5, 4, 3), torch.float32), ((2, 60000), torch.float32),
    ((50, 60), torch.float64)])
def test_ineligible_tensors_fall_back(backend, shape, dtype):
    """Never raises: the two-pass output, one fallback, no fused dispatch."""
    x = torch.from_numpy(spiky_field(shape, seed=3)).to(dtype)
    cfg = CodecConfig(radius=RADIUS, backend=backend, device="cpu")
    c = Codec(cfg).compress(x)
    fused = Codec(cfg.replace(fused=True))
    fused.reset_stats()
    got = fused.decompress(c)
    assert fused.stats["fused_fallbacks"] == 1
    assert fused.stats["fused_dispatches"] == 0
    assert as_bytes(got) == as_bytes(Codec(cfg).decompress(c))


def test_row_bound_follows_max_len():
    """The row bound is what a one-row tile's block fits in shared memory
    at the tensor's max_len."""
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels import huffman_decode as K

    for max_len in (4, 8, 12, 16):
        cols = compressor.fused_max_cols(max_len)
        lut = 1 << max_len
        assert fd.decode_tiles_fused_nd_smem(cols, lut) <= K.SMEM_LIMIT
        assert fd.decode_tiles_fused_nd_smem(cols + 1, lut) > K.SMEM_LIMIT
    assert compressor.fused_max_cols(16) == 8880


def test_outlier_slices_on_a_jax_payload():
    """A JAX-written side list ascends with the -1 padding at the tail, so
    each tile's searchsorted slice holds exactly its outliers."""
    _, cj, _ = _jax_payload("2d", "f32")
    pos = np.array(cj.outlier_pos)
    m = int((pos >= 0).sum())
    assert m > 0 and (pos[m:] == -1).all()
    assert (np.diff(pos[:m]) > 0).all()
    for block in (56, 504, 512):
        n_tiles = -(-cj.n_symbols // block)
        bounds = ops._outlier_bounds(torch.from_numpy(pos), n_tiles,
                                     block).numpy()
        for t in range(n_tiles):
            want = np.flatnonzero((pos >= t * block) & (pos < (t + 1) * block))
            assert list(range(bounds[t], bounds[t + 1])) == list(want)


@pytest.mark.parametrize("shape,tile", [
    ((5, 20, 30), 512), ((40, 56), 512), ((100, 500, 500), 4096),
    ((1800, 3600), 4096), ((7, 13, 4), 100), ((3, 33000), 4096)])
def test_tile_geometry_matches_reference(shape, tile):
    assert ops.fused_tile_rows(shape, tile) == jops.fused_tile_rows(shape,
                                                                    tile)
    for s in (shape, (1,) + shape, shape + (1,), (1, shape[-1])):
        assert ops.fused_squeeze(s) == jops.fused_squeeze(s)


@pytest.mark.parametrize("eb", [1e-3, 3.3e-4, 0.1, 1.7e-7])
def test_two_eb_matches_reference(eb):
    assert np.float32(ops._two_eb_f32(eb)) == \
        np.asarray(jops._two_eb_f32(eb))[0]


def test_wrappers_check_inputs():
    _, _, ct, _ = _codec_case(2, "f32")
    kernel, _, args = _port_fused_call(ct)
    args = list(args)
    bad_dtype = args[:-2] + [torch.float64] + args[-1:]
    with pytest.raises(TypeError, match="out_dtype"):
        kernel(*bad_dtype)
    bad_eb = args[:15] + [0.1] + args[16:]
    with pytest.raises(ValueError, match="two_eb"):
        kernel(*bad_eb)
    bad_bounds = args[:14] + [args[14][:-1]] + args[15:]
    with pytest.raises(ValueError, match="obounds"):
        kernel(*bad_bounds)
    on_meta = args[:12] + [args[12].to("meta")] + args[13:]
    with pytest.raises(ValueError, match="share a device"):
        kernel(*on_meta)
