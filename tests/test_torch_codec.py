"""The port's codec sessions against the JAX package's.

``Codec.decompress`` of the port is held bit for bit against the JAX
``Codec.decompress`` on its "ref" and "pallas" (interpret-mode) backends
over {1-D, 2-D, 3-D} x {f32, bf16, f16} x {rel, abs} with forced outliers,
for payloads the port compressed and for payloads the JAX package wrote
(carried across with ``compressed_from_arrays``).  The port runs here on
the CPU by request (``device="cpu"``): the "cuda" backend's kernel
wrappers take CPU tensors through their plain versions.  Also: the golden
reconstruction digests, the counters, the import boundary and the errors
of unported options.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.api import Codec as JCodec, CodecConfig as JConfig

from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

from test_torch_stream import (DTYPES, RADIUS, SHAPES, TILE_SYMS, as_bytes,
                               both, jax_arrays, spiky_field)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fused_nd_golden.json")
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

_CASES: dict = {}


def _case(ndim, dtype_key, mode, eb):
    """JAX payload, its "ref" and "pallas" reconstructions, and the port's
    payload of the same field (memoized per lattice cell)."""
    key = (ndim, dtype_key, mode, eb)
    if key not in _CASES:
        xj, xt = both(spiky_field(SHAPES[ndim], seed=7 * ndim + 13),
                      dtype_key)
        cfg = JConfig(eb=eb, mode=mode, radius=RADIUS, tile_syms=TILE_SYMS)
        cj = JCodec(cfg).compress(xj)
        want = np.asarray(JCodec(cfg).decompress(cj)).tobytes()
        pallas = np.asarray(JCodec(cfg.replace(backend="pallas"))
                            .decompress(cj)).tobytes()
        assert pallas == want
        ct = Codec(_config(eb, mode)).compress(xt)
        _CASES[key] = (xt, cj, want, ct)
    return _CASES[key]


def _config(eb=1e-3, mode="rel", **kw):
    return CodecConfig(eb=eb, mode=mode, radius=RADIUS, tile_syms=TILE_SYMS,
                       device="cpu", **kw)


@pytest.mark.parametrize("mode,eb", [("rel", 1e-4), ("abs", 1e-3)])
@pytest.mark.parametrize("dtype_key", list(DTYPES))
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_decompress_matches_jax(backend, ndim, dtype_key, mode, eb):
    xt, cj, want, ct = _case(ndim, dtype_key, mode, eb)
    codec = Codec(_config(eb, mode, backend=backend))
    got = codec.decompress(ct)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(xt.shape)
    assert as_bytes(got) == want
    # The JAX-written payload decodes to the same bytes in the port.
    carried = compressor.compressed_from_arrays(jax_arrays(cj), "cpu")
    assert as_bytes(codec.decompress(carried)) == want
    err = (got.double() - xt.double()).abs().max().item()
    assert err <= ct.eb_effective


@pytest.mark.parametrize("dtype_key", list(DTYPES))
def test_decoded_codes_match_quantizer(dtype_key):
    """Codec.decode returns exactly the codes compress encoded."""
    from repro_torch.core.sz import lorenzo

    xt, _, _, ct = _case(2, dtype_key, "rel", 1e-4)
    codes = Codec(_config(1e-4)).decode(ct.stream, ct.codebook,
                                        ct.n_symbols)
    want = lorenzo.quantize_host(xt, ct.eb, ct.radius)[0].reshape(-1)
    assert torch.equal(codes.to(torch.int32), want.to(torch.int32))


def _golden_digest(c) -> str:
    """tests/test_fused_nd.py:_compressed_digest over the port's tensors."""
    h = hashlib.sha256()
    h.update(c.stream.units.numpy().tobytes())
    h.update(c.stream.gaps.numpy().tobytes())
    h.update(int(c.stream.total_bits).to_bytes(8, "little"))
    h.update(c.outlier_pos.numpy().tobytes())
    h.update(c.outlier_val.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_golden_vectors(backend):
    """The port reproduces the checked-in compressed and reconstruction
    sha256s of tests/golden/fused_nd_golden.json."""
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
                                  backend=backend, device="cpu"))
        c = codec.compress(xt)
        assert _golden_digest(c) == entry["compressed_sha256"], spec
        got = codec.decompress(c)
        assert hashlib.sha256(as_bytes(got)).hexdigest() == \
            entry["reconstruction_sha256"], spec
        assert int((c.outlier_pos >= 0).sum()) == entry["n_outliers"]
        assert c.compressed_bytes == entry["compressed_bytes"]


def test_tiny_field_spikes_capped():
    """Fields under 4 values compress and reconstruct (the spike count of
    the test field is capped at the field's size)."""
    for shape in [(1,), (3,), (1, 2), (1, 1, 3)]:
        xj, xt = both(spiky_field(shape, seed=1), "f32")
        cj = JCodec(JConfig(radius=RADIUS)).compress(xj)
        want = np.asarray(JCodec(JConfig(radius=RADIUS)).decompress(cj))
        got = Codec(CodecConfig(radius=RADIUS, device="cpu")).decompress(
            Codec(CodecConfig(radius=RADIUS, device="cpu")).compress(xt))
        assert as_bytes(got) == want.tobytes()


# ---------------------------------------------------------------------------
# (e) counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_counters(backend):
    _, _, want, ct = _case(1, "f32", "rel", 1e-4)
    codec = Codec(_config(1e-4, backend=backend))
    codec.reset_stats()
    launches.reset()
    assert as_bytes(codec.decompress(ct)) == want
    s = codec.stats
    assert (s["plan_builds"], s["decode_write_dispatches"]) == (1, 1)
    assert (s["plan_misses"], s["plan_hits"]) == (1, 0)
    assert s["fused_fallbacks"] == 0 and s["fused_dispatches"] == 0
    codec.decompress(ct)                  # plan served from the cache
    s = codec.stats
    assert (s["plan_builds"], s["decode_write_dispatches"]) == (1, 2)
    assert s["plan_hits"] == 1
    # CPU tensors never launch a kernel.
    assert K.count_subseq.launches == 0 and K.decode_tiles.launches == 0


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_fused_falls_back_two_pass(backend):
    """fused=True decodes two-pass, bit-exact, and counts one fallback per
    tensor where the fused path cannot serve it: on a backend without fused
    ops (where a transform raises, as in the reference) and for a tensor
    outside the fused bounds (4-D) on a backend with them."""
    import dataclasses

    _, _, want, ct = _case(2, "bf16", "rel", 1e-4)
    base = hp.get_backend(backend)
    two_pass_only = hp.DecodeBackend(name=f"{backend}-two-pass",
                                     count_fn=base.count_fn,
                                     tiles_fn=base.tiles_fn,
                                     padded_fn=base.padded_fn)
    assert base.supports_fused and not two_pass_only.supports_fused
    reason = compressor.fused_unsupported_reason(ct, two_pass_only, "gap",
                                                 "tile")
    assert reason == f"backend '{backend}-two-pass' registers no fused ops"
    for n in (1, 2):
        got = compressor.decompress(ct, tile_syms=TILE_SYMS,
                                    backend=two_pass_only, fused=True)
        assert as_bytes(got) == want
        assert two_pass_only.stats["fused_fallbacks"] == n
    assert two_pass_only.stats["fused_dispatches"] == 0
    with pytest.raises(ValueError, match="registers no fused ops"):
        hp.decode(ct.stream, ct.codebook, ct.n_symbols,
                  backend=two_pass_only,
                  transform=hp.OutputTransform(eb=ct.eb, radius=ct.radius,
                                               outlier_pos=ct.outlier_pos,
                                               outlier_val=ct.outlier_val))
    four_d = dataclasses.replace(ct, shape=(2, 4, 5, 56))
    codec = Codec(_config(1e-4, backend=backend, fused=True))
    codec.reset_stats()
    got = codec.decompress(four_d)
    assert as_bytes(got) == as_bytes(
        Codec(_config(1e-4, backend=backend)).decompress(four_d))
    assert codec.stats["fused_fallbacks"] == 1
    assert codec.stats["fused_dispatches"] == 0


def test_guards_count_trips():
    import dataclasses

    _, _, _, ct = _case(1, "f32", "abs", 1e-3)
    codec = Codec(_config())
    codec.reset_stats()
    short = dataclasses.replace(ct, shape=(ct.n_symbols - 1,))
    with pytest.raises(hp.DecodeGuardError, match="symbol-count"):
        codec.decompress(short)
    bad_len = ct.codebook.enc_len.copy()
    bad_len[:8] = 1
    corrupt = dataclasses.replace(
        ct, codebook=dataclasses.replace(ct.codebook, enc_len=bad_len))
    with pytest.raises(hp.DecodeGuardError, match="Kraft"):
        codec.decompress(corrupt)
    assert codec.stats["decode_guard_trips"] == 2


def test_naive_ref_method():
    """The reference's sequential oracle method is no decode path of the
    port; its oracle stays a CPU test helper that agrees with the codec."""
    from repro_torch.core.huffman import decode as hd

    _, _, _, ct = _case(3, "f16", "abs", 1e-3)
    with pytest.raises(ValueError, match="unknown method 'naive_ref'"):
        _config(method="naive_ref")
    with pytest.raises(ValueError, match="unknown method 'naive_ref'"):
        compressor.decompress(ct, method="naive_ref", backend="ref")
    codec = Codec(_config())
    luts = hp._as_luts(ct.codebook, "cpu")
    seq = hd.decode_sequential(ct.stream.units, luts.dec_sym, luts.dec_len,
                               ct.n_symbols, luts.max_len)
    got = codec.decode(ct.stream, ct.codebook, ct.n_symbols)
    assert torch.equal(seq.to(torch.int32), got.to(torch.int32))
    on_meta = torch.empty(4, dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="CPU tensor"):
        hd.decode_sequential(on_meta, luts.dec_sym, luts.dec_len, 4,
                             luts.max_len)


@pytest.mark.parametrize("max_len,tile_syms,ok", [
    (16, 4096, True), (17, 4096, True), (24, 116224, True),
    (24, 116225, False)])
def test_cuda_backend_shared_memory_bound(max_len, tile_syms, ok):
    """On "cuda", a decode_tiles block's staging tile must fit Hopper's
    shared memory (a LUT that does not fit beside it is read from device
    memory): the config refuses what the kernels would refuse."""
    smem = K.decode_tiles_smem(tile_syms, 0)
    assert (smem <= K.SMEM_LIMIT) == ok
    if ok:
        CodecConfig(max_len=max_len, tile_syms=tile_syms)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            CodecConfig(max_len=max_len, tile_syms=tile_syms)
    # The plain backend has no shared memory to fit.
    CodecConfig(backend="ref", max_len=max_len, tile_syms=tile_syms)


# ---------------------------------------------------------------------------
# (f) the import boundary, (g) device default and unported options
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "n = sum(m.startswith('repro_torch.') for m in sys.modules)\n"
        "assert n >= 15, n\n"
        "print('ok', n)\n")
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_codec_needs_the_card():
    cfg = CodecConfig()
    assert (cfg.backend, cfg.resolved_device().type) == ("cuda", "cuda")
    assert CodecConfig(backend="ref").resolved_device().type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default codec runs")
    with pytest.raises(RuntimeError, match="is_available"):
        Codec()
    with pytest.raises(RuntimeError, match="is_available"):
        Codec(CodecConfig(backend="ref", device="cuda"))


@pytest.mark.parametrize("field,value,item", [
    ("method", "selfsync", "item 3"),
    ("encode_backend", "jnp", "item 4"),
    ("encode_backend", "pallas", "item 4"),
])
def test_unported_options_raise(field, value, item):
    if field == "encode_backend":
        # Ported (queue A item 4): the port's device encode backend is
        # "cuda"; the reference's "jnp" and "pallas" are unknown names.
        with pytest.raises(ValueError, match=r"\['cuda', 'ref'\]"):
            CodecConfig(**{field: value})
        with pytest.raises(ValueError, match=r"\['cuda', 'ref'\]"):
            compressor.compress(torch.zeros(8), encode_backend=value,
                                device="cpu")
        return
    # Ported (queue A item 3): the self-sync method runs on both backends
    # and decodes the two-pass bytes.
    assert not hp.UNPORTED
    _, _, want, ct = _case(1, "f32", "abs", 1e-3)
    for backend in ("cuda", "ref"):
        codec = Codec(_config(1e-3, "abs", backend=backend,
                              **{field: value}))
        assert as_bytes(codec.decompress(ct)) == want
        assert as_bytes(compressor.decompress(
            ct, tile_syms=TILE_SYMS, backend=backend,
            **{field: value})) == want


@pytest.mark.parametrize("kw", [dict(eb=0), dict(mode="x"), dict(method="x"),
                                dict(strategy="x"), dict(backend="pallas"),
                                dict(encode_backend="x"), dict(max_len=0),
                                dict(radius=1), dict(max_len=25),
                                dict(tile_syms=0), dict(subseqs_per_seq=0),
                                dict(fused=1), dict(plan_cache_size=-1),
                                dict(device="nowhere")])
def test_config_validation(kw):
    with pytest.raises((ValueError, RuntimeError)):
        CodecConfig(**kw)


@pytest.mark.parametrize("max_len", [17, 20, 24])
@pytest.mark.parametrize("method", ["gap", "selfsync"])
def test_cuda_config_accepts_long_codes(max_len, method):
    """"cuda" accepts max_len 17-24, as the reference does on every
    backend: each kernel whose LUT outgrows shared memory reads it from
    device memory instead."""
    config = CodecConfig(max_len=max_len, method=method)
    assert config.backend == "cuda" and config.max_len == max_len
    lut = 1 << max_len
    assert not K.decode_padded_lut_in_smem(lut)
    assert K.count_subseq_lut_in_smem(lut) == (max_len == 17)
