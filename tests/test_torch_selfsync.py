"""The port's self-synchronization decoder (``method="selfsync"``) against
the JAX package's.

The same streams, made with numpy from a seed by ``conftest.
make_book_and_stream``, go through both packages: the core phases
(``decode.selfsync_intra`` / ``selfsync_inter``), the full reference
decoders, the kernel wrapper's plain version against the Pallas kernel in
interpret mode, the kernel-backed ``ops.selfsync_sync`` against the JAX one,
and every ``Codec`` path with ``method="selfsync"``.  Tolerance: exact
equality everywhere (integer decode).  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.api import Codec as JCodec, CodecConfig as JConfig
from repro.core.huffman import decode as jhd
from repro.kernels import common as JC
from repro.kernels import huffman_selfsync as jss
from repro.kernels import ops as jops

from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import decode as hd
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import huffman_selfsync as S
from repro_torch.kernels import launches, ops

from conftest import make_book_and_stream
from test_torch_stream import RADIUS, as_bytes, both, spiky_field

#: (n_syms, max_len, subseqs_per_seq, vocab): a multi-sequence stream, one
#: symbol past 4096, short 4-subsequence sequences at max_len 8 (a
#: 200-symbol vocabulary, so every symbol gets a code of at most 8 bits), a
#: 2**16-entry LUT, and a single symbol.
CASES = {"5000": (5000, 12, 32, 1024), "4097": (4097, 12, 32, 1024),
         "129-sps4": (129, 8, 4, 200), "777-len16": (777, 16, 32, 1024),
         "1": (1, 12, 32, 1024)}
_STREAMS: dict = {}


def _stream(name):
    """(JAX book, JAX stream, port units, port LUTs) of a case, memoized."""
    if name not in _STREAMS:
        n, max_len, sps, vocab = CASES[name]
        rng = np.random.default_rng(list(CASES).index(name) + 40)
        book, _, stream = make_book_and_stream(
            rng, n_syms=n, vocab=vocab, max_len=max_len,
            subseqs_per_seq=sps)
        _STREAMS[name] = (book, stream,
                          torch.from_numpy(np.array(stream.units)),
                          torch.from_numpy(book.dec_sym),
                          torch.from_numpy(book.dec_len))
    return _STREAMS[name]


def _port_stream(stream):
    from repro_torch.core.huffman.encode import EncodedStream

    def t(a):
        return torch.from_numpy(np.array(a))

    return EncodedStream(units=t(stream.units), gaps=t(stream.gaps),
                         counts=t(stream.counts),
                         seq_counts=t(stream.seq_counts),
                         total_bits=int(stream.total_bits),
                         n_symbols=int(stream.n_symbols),
                         subseqs_per_seq=int(stream.subseqs_per_seq))


def _jluts(book):
    return jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len)


@pytest.fixture(params=list(CASES))
def case(request):
    return _stream(request.param)


# ---------------------------------------------------------------------------
# (a) the core phases and the reference decoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("early_exit", [True, False])
def test_intra_and_inter_match_jax(case, early_exit):
    book, stream, units, ds, dl = case
    n_subseq, sps = stream.gaps.shape[0], stream.subseqs_per_seq
    tb = int(stream.total_bits)
    js, jr = jhd.selfsync_intra(jnp.asarray(stream.units), *_jluts(book),
                                stream.total_bits, n_subseq, book.max_len,
                                sps, early_exit=early_exit)
    ts, tr = hd.selfsync_intra(units, ds, dl, tb, n_subseq, book.max_len,
                               sps, early_exit=early_exit)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert int(jr) == tr
    assert early_exit or tr == sps
    ji, jr2 = jhd.selfsync_inter(jnp.asarray(stream.units), *_jluts(book),
                                 js, stream.total_bits, book.max_len, sps)
    ti, tr2 = hd.selfsync_inter(units, ds, dl, ts, tb, book.max_len, sps)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert int(jr2) == tr2


@pytest.mark.parametrize("use_tiles", [True, False])
def test_reference_decoders_match_jax(case, use_tiles):
    book, stream, _, ds, dl = case
    ps = _port_stream(stream)
    n = int(stream.n_symbols)
    assert np.array_equal(np.asarray(jhd.gap_starts(stream)),
                          hd.gap_starts(ps).numpy())
    want = np.asarray(jhd.decode_gap_array(stream, *_jluts(book),
                                           book.max_len, n, tile_syms=512,
                                           use_tiles=use_tiles))
    got = hd.decode_gap_array(ps, ds, dl, book.max_len, n, tile_syms=512,
                              use_tiles=use_tiles)
    assert np.array_equal(want, got.numpy())
    for early_exit in (True, False):
        jsync = np.asarray(jhd.decode_selfsync(
            stream, *_jluts(book), book.max_len, n, tile_syms=512,
            use_tiles=use_tiles, early_exit=early_exit))
        tsync = hd.decode_selfsync(ps, ds, dl, book.max_len, n,
                                   tile_syms=512, use_tiles=use_tiles,
                                   early_exit=early_exit)
        assert np.array_equal(jsync, tsync.numpy())
        assert np.array_equal(tsync.numpy(), want)


# ---------------------------------------------------------------------------
# (b) the kernel's plain version against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", ["zero", "random"])
@pytest.mark.parametrize("early_exit", [True, False])
def test_plain_kernel_matches_pallas(case, early_exit, heads):
    book, stream, units, ds, dl = case
    sps = stream.subseqs_per_seq
    n_subseq = stream.gaps.shape[0]
    n_seq = n_subseq // sps
    h = np.zeros((n_seq, 1), np.int32)
    if heads == "random":
        h = np.random.default_rng(n_subseq).integers(
            0, 128, size=(n_seq, 1)).astype(np.int32)
    # The Pallas kernel's inputs, as the JAX ops.selfsync_sync builds them.
    b = np.arange(n_subseq, dtype=np.int64) * 128
    end = np.clip(np.minimum(b + 128, int(stream.total_bits)) - b, 0,
                  192).astype(np.int32).reshape(n_seq, sps)
    rows = JC.gather_subseq_rows(jnp.asarray(stream.units),
                                 jnp.arange(n_subseq, dtype=jnp.int32))
    want = jss.selfsync_intra(rows.reshape(n_seq, sps, JC.ROW_UNITS),
                              jnp.asarray(h), jnp.asarray(end),
                              *_jluts(book), max_len=book.max_len,
                              subseqs_per_seq=sps, early_exit=early_exit,
                              interpret=True)
    launches.reset()
    got = S.selfsync_intra(units, torch.from_numpy(h), int(stream.total_bits),
                           ds, dl, book.max_len, sps, early_exit)
    assert S.selfsync_intra.launches == 0      # CPU tensors: plain version
    assert np.array_equal(S.end_local(n_seq, sps, int(stream.total_bits),
                                      "cpu").numpy(), end)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and tuple(g.shape) == tuple(w.shape)
        assert np.array_equal(np.asarray(w), g.numpy())


def test_wrapper_checks():
    _, stream, units, ds, dl = _stream("129-sps4")
    tb = int(stream.total_bits)
    heads = torch.zeros((stream.gaps.shape[0] // 4, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        S.selfsync_intra(units, heads.long(), tb, ds, dl, 8, 4)
    with pytest.raises(ValueError, match=r"\(n_seq, 1\)"):
        S.selfsync_intra(units, heads.reshape(-1), tb, ds, dl, 8, 4)
    with pytest.raises(ValueError, match="subseqs_per_seq"):
        S.selfsync_intra(units, heads, tb, ds, dl, 8, 0)
    with pytest.raises(TypeError, match="uint16"):
        S.selfsync_intra(units, heads, tb, ds.to(torch.int32), dl, 8, 4)
    with pytest.raises(ValueError, match="share a device"):
        S.selfsync_intra(units, heads.to("meta"), tb, ds, dl, 8, 4)
    with pytest.raises(ValueError, match="whole number"):
        ops.selfsync_sync(units, ds, dl, tb, 7, 4, 8)
    assert S.selfsync_smem(32, 1 << 12) == 3 * 4096


def _largest_sps(max_len):
    """The largest subseqs_per_seq whose block kernel stages the LUT at
    max_len: its starts, landings and counts beside the LUT.  Past it the
    LUT stays in device memory, up to SMEM_LIMIT // 16 lanes."""
    return (K.SMEM_LIMIT - 3 * (1 << max_len)) // 16


@pytest.mark.parametrize("max_len", [8, 12, 14, 16])
def test_launch_geometry(max_len):
    """Up to 32 lanes a sequence: warps of one sequence, 8 to 32 a block,
    the LUT alone in shared memory, enough blocks an SM by shared memory to
    fill its 64 warps.  Past 32: one block a sequence, within SMEM_LIMIT
    up to the largest sps the codec accepts."""
    lut = 1 << max_len
    for sps in (1, 3, 31, 32):
        seqs, threads, smem = S.selfsync_geometry(sps, lut)
        assert (threads, smem) == (32 * seqs, 3 * lut)
        assert 8 <= seqs <= 32 and smem <= K.SMEM_LIMIT
        fit = S.SM_SMEM // (smem + S.BLOCK_SMEM_RESERVED)
        assert fit * seqs >= S.SM_WARPS or seqs == 32
    assert S.selfsync_geometry(32, 1 << 12) == (8, 256, 3 * 4096)
    assert S.selfsync_geometry(32, 1 << 16) == (32, 1024, 3 * 65536)
    assert S.selfsync_geometry(64, lut) == (1, 64, 16 * 64 + 3 * lut)
    assert S.selfsync_geometry(33, lut) == (1, 64, 16 * 33 + 3 * lut)
    top = _largest_sps(max_len)
    seqs, threads, smem = S.selfsync_geometry(top, lut)
    assert (seqs, threads) == (1, 1024) and smem <= K.SMEM_LIMIT
    assert S.selfsync_lut_in_smem(top, lut)
    assert not S.selfsync_lut_in_smem(top + 1, lut)
    assert S.selfsync_geometry(top + 1, lut)[2] == 16 * (top + 1)


@pytest.mark.parametrize("max_len", [12, 16])
def test_cuda_selfsync_accepts_the_same_sps(max_len):
    """CodecConfig(method="selfsync") on "cuda" accepts every
    subseqs_per_seq whose lanes (16 B each) fit a block's shared memory,
    the LUT staged beside them or, past _largest_sps, read from device
    memory; each gets a launch geometry the kernel takes."""
    top = K.SMEM_LIMIT // 16
    for sps in (1, 3, 31, 32, 33, 64, 1024, _largest_sps(max_len),
                _largest_sps(max_len) + 1, top):
        CodecConfig(method="selfsync", subseqs_per_seq=sps, max_len=max_len)
        seqs, threads, smem = S.selfsync_geometry(sps, 1 << max_len)
        assert threads % 32 == 0 and 32 <= threads <= 1024
        assert smem <= K.SMEM_LIMIT
        assert threads == 32 * seqs if sps <= 32 else seqs == 1
    with pytest.raises(ValueError, match="shared memory"):
        CodecConfig(method="selfsync", subseqs_per_seq=top + 1,
                    max_len=max_len)
    CodecConfig(subseqs_per_seq=top + 1, max_len=max_len)      # gap
    CodecConfig(method="selfsync", backend="ref", subseqs_per_seq=top + 1,
                max_len=max_len)


# ---------------------------------------------------------------------------
# (c) the kernel-backed sync against the JAX one, and against the gap array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("early_exit", [True, False])
def test_sync_matches_jax(case, early_exit):
    book, stream, units, ds, dl = case
    n_subseq, sps = stream.gaps.shape[0], stream.subseqs_per_seq
    js, jc, jr = jops.selfsync_sync(stream.units, *_jluts(book),
                                    stream.total_bits, n_subseq, sps,
                                    book.max_len, early_exit=early_exit)
    ts, tc, tr = ops.selfsync_sync(units, ds, dl, int(stream.total_bits),
                                   n_subseq, sps, book.max_len,
                                   early_exit=early_exit)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert tr.dtype == torch.int32 and tuple(tr.shape) == (n_subseq // sps,
                                                           1)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_plan_agrees_with_gap_array(case, backend, early_exit):
    book, stream, _, _, _ = case
    ps = _port_stream(stream)
    gap = hp.build_plan(ps, book, method="gap", backend=backend)
    ss = hp.build_plan(ps, book, method="selfsync", backend=backend,
                       early_exit=early_exit)
    assert ss.method == "selfsync"
    assert torch.equal(ss.counts, gap.counts)
    assert torch.equal(ss.counts, ps.counts)
    assert torch.equal(ss.offsets, gap.offsets)
    assert np.array_equal(ss.seq_counts, gap.seq_counts)
    below = gap.start_bits < ps.total_bits
    assert torch.equal(ss.start_bits[below], gap.start_bits[below])


def test_chaining_guard_raises_and_counts(monkeypatch):
    """Heads that keep moving past n_seq + 1 passes (impossible for any
    stream, forced here) raise and count a guard trip, never truncate."""
    book, stream, _, _, _ = _stream("5000")
    real = S.selfsync_intra
    calls = []

    def moving(units, heads, *args):
        start, counts, landing, rounds = real(units, heads, *args)
        calls.append(1)
        return start, counts, landing + len(calls), rounds

    monkeypatch.setattr(ops._sync, "selfsync_intra", moving)
    be = hp.get_backend("cuda")
    be.reset_stats()
    with pytest.raises(hp.DecodeGuardError, match="still moving"):
        hp.build_plan(_port_stream(stream), book, method="selfsync",
                      backend=be)
    assert len(calls) == stream.gaps.shape[0] // 32 + 1
    assert be.stats["decode_guard_trips"] == 1


def test_backend_without_sync_serves_gap_only():
    book, stream, _, _, _ = _stream("4097")
    ref = hp.get_backend("ref")
    bare = hp.DecodeBackend(name="bare", count_fn=ref.count_fn,
                            tiles_fn=ref.tiles_fn, padded_fn=ref.padded_fn)
    ps = _port_stream(stream)
    hp.build_plan(ps, book, method="gap", backend=bare)
    with pytest.raises(ValueError, match="registers no sync_fn"):
        hp.build_plan(ps, book, method="selfsync", backend=bare)


# ---------------------------------------------------------------------------
# (d) every Codec path with method="selfsync", against the JAX Codec
# ---------------------------------------------------------------------------

FIELDS = {"2d-f32": ((40, 56), "f32", 21), "1d-bf16": ((3000,), "bf16", 22),
          "3d-f16": ((5, 20, 30), "f16", 23)}
_PAYLOADS: dict = {}


def _payload(name):
    """The field, its JAX payload and JAX self-sync reconstruction, and the
    port's payload (memoized)."""
    if name not in _PAYLOADS:
        shape, dtype_key, seed = FIELDS[name]
        xj, xt = both(spiky_field(shape, seed), dtype_key)
        cfg = JConfig(eb=1e-3, radius=RADIUS, tile_syms=512,
                      method="selfsync")
        cj = JCodec(cfg).compress(xj)
        want = np.asarray(JCodec(cfg).decompress(cj)).tobytes()
        ct = Codec(_config()).compress(xt)
        _PAYLOADS[name] = (xt, cj, want, ct)
    return _PAYLOADS[name]


_JAX_OUT: dict = {}


def _jax_out(field, strategy, fused):
    """The JAX Codec's self-sync reconstruction of a field under one
    strategy, as bytes (memoized; bit-exact across strategies there)."""
    key = (field, strategy, fused)
    if key not in _JAX_OUT:
        _, cj, _, _ = _payload(field)
        cfg = JConfig(eb=1e-3, radius=RADIUS, tile_syms=512,
                      method="selfsync", strategy=strategy, fused=fused)
        _JAX_OUT[key] = np.asarray(JCodec(cfg).decompress(cj)).tobytes()
    return _JAX_OUT[key]


def _config(**kw):
    return CodecConfig(eb=1e-3, radius=RADIUS, tile_syms=512, device="cpu",
                       **kw)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("strategy", ["tile", "padded", "tuned"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("field", list(FIELDS))
def test_codec_selfsync_matches_jax(field, backend, strategy, fused):
    xt, _, _, ct = _payload(field)
    want = _jax_out(field, strategy, fused)
    codec = Codec(_config(method="selfsync", backend=backend,
                          strategy=strategy, fused=fused))
    codec.reset_stats()
    got = codec.decompress(ct)
    assert as_bytes(got) == want
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(xt.shape)
    s = codec.stats
    assert s["plan_builds"] == 1
    fusable = fused and strategy != "tuned"
    assert s["fused_dispatches"] == int(fusable)
    assert s["fused_fallbacks"] == int(fused and not fusable)
    assert want == _payload(field)[2]
    err = (got.double() - xt.double()).abs().max().item()
    assert err <= ct.eb_effective


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_decompress_batch_selfsync_matches_jax(backend, fused):
    items = [_payload(name) for name in FIELDS]
    jcfg = JConfig(eb=1e-3, radius=RADIUS, tile_syms=512, method="selfsync",
                   fused=fused)
    wants = [np.asarray(y).tobytes()
             for y in JCodec(jcfg).decompress_batch([cj for _, cj, _, _
                                                     in items])]
    codec = Codec(_config(method="selfsync", backend=backend, fused=fused))
    codec.reset_stats()
    outs = codec.decompress_batch([ct for _, _, _, ct in items])
    assert [as_bytes(y) for y in outs] == wants
    assert wants == [w for _, _, w, _ in items]
    assert codec.stats["plan_builds"] == len(items)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("strategy", ["tile", "padded"])
def test_codec_decode_early_exit(backend, strategy):
    _, cj, _, ct = _payload("2d-f32")
    jcodec = JCodec(JConfig(eb=1e-3, radius=RADIUS, tile_syms=512,
                            method="selfsync", strategy=strategy))
    codec = Codec(_config(method="selfsync", backend=backend,
                          strategy=strategy))
    gap = Codec(_config()).decode(ct.stream, ct.codebook, ct.n_symbols)
    for early_exit in (True, False):
        want = np.asarray(jcodec.decode(cj.stream, cj.codebook, cj.n_symbols,
                                        early_exit=early_exit))
        got = codec.decode(ct.stream, ct.codebook, ct.n_symbols,
                           early_exit=early_exit)
        assert np.array_equal(want, got.numpy())
        assert torch.equal(got, gap)


def test_gap_and_selfsync_plans_stay_apart():
    """One payload decompressed with gap and then self-sync through one
    plan cache builds two plans (the cache key carries the method)."""
    _, _, want, ct = _payload("3d-f16")
    cache = PlanCache(16)
    gap = Codec(_config(backend="ref"), plan_cache=cache)
    ss = Codec(_config(backend="ref", method="selfsync"), plan_cache=cache)
    gap.reset_stats()
    assert as_bytes(gap.decompress(ct)) == want
    assert as_bytes(ss.decompress(ct)) == want
    assert as_bytes(ss.decompress(ct)) == want
    assert gap.stats["plan_builds"] == 2
    assert cache.stats["plan_hits"] == 1
    assert gap.plan_for(ct).method == "gap"
    assert ss.plan_for(ct).method == "selfsync"


def test_compressor_accepts_selfsync():
    _, _, want, ct = _payload("1d-bf16")
    for backend in ("ref", "cuda"):
        got = compressor.decompress(ct, method="selfsync", tile_syms=512,
                                    backend=backend)
        assert as_bytes(got) == want
        outs = compressor.decompress_batch([ct, ct], method="selfsync",
                                           tile_syms=512, backend=backend)
        assert [as_bytes(y) for y in outs] == [want, want]
