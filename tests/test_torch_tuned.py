"""The port's tuned strategy and class-batched decode against the JAX
package's.

The CR classification (``make_plan``), the tuned per-class decode
(``decode(strategy="tuned")``, ``execute_tuned``) and ``decode_batch`` of
the port's "cuda" backend (kernel wrappers on CPU tensors: their plain
versions) and "ref" backend are held bit for bit against the JAX package's
on streams the JAX package wrote.  The batch tests port
``tests/test_pipeline.py``'s: byte-identical to per-tensor decoding with
mixed ``max_len``, at most one decode-write dispatch per CR class, the
tail-padding regression, the ``MAX_BATCH_BITS`` split with its solo base
case, and the empty batch.  Also ``decompress_batch`` with its fused
routing, ``Codec.decompress_batch`` on JAX-written payloads, the plan
cache's ``t_high`` key and the lazily built classes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.api import Codec as JCodec, CodecConfig as JConfig
from repro.core.huffman import pipeline as jhp
from repro.core.sz import compressor as jcomp

from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import codebook as cb
from repro_torch.core.huffman import encode as he
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches, ops

from conftest import make_book_and_stream
from test_torch_decode import STREAMS
from test_torch_stream import RADIUS, as_bytes, both, jax_arrays, \
    spiky_field


def _port(book, stream):
    """A JAX-written codebook and stream as the port's objects."""
    def t(a):
        return torch.from_numpy(np.array(a))

    return (cb.Codebook(n_symbols=int(book.n_symbols),
                        max_len=int(book.max_len), enc_code=book.enc_code,
                        enc_len=book.enc_len, dec_sym=book.dec_sym,
                        dec_len=book.dec_len),
            he.EncodedStream(units=t(stream.units), gaps=t(stream.gaps),
                             counts=t(stream.counts),
                             seq_counts=t(stream.seq_counts),
                             total_bits=int(stream.total_bits),
                             n_symbols=int(stream.n_symbols),
                             subseqs_per_seq=int(stream.subseqs_per_seq)))


@pytest.fixture(params=list(STREAMS))
def case(request):
    rng = np.random.default_rng(list(STREAMS).index(request.param))
    return STREAMS[request.param](rng)


# ---------------------------------------------------------------------------
# CR classification and the tuned per-class decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_high", [1, 3, 8])
@pytest.mark.parametrize("sps", [4, 32])
def test_make_plan_matches_jax(sps, t_high):
    rng = np.random.default_rng(sps + t_high)
    # counts spanning every class, ties at exact class edges included
    edge = np.arange(0, 17) * (sps * 128 // 8 // 2)
    seq_counts = np.concatenate([rng.integers(0, sps * 128, size=300),
                                 edge]).astype(np.int64)
    want = jhp.make_plan(None, seq_counts, sps, t_high)
    got = hp.make_plan(None, seq_counts, sps, t_high)
    for field in ("classes", "seq_order", "class_start"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype and np.array_equal(g, w), field
    assert got.tile_syms == want.tile_syms and got.t_high == want.t_high
    for c in range(1, t_high + 2):
        assert np.array_equal(got.class_seq_ids(c), want.class_seq_ids(c))


def test_max_tile_span_matches_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 50, 700):
        counts = rng.integers(0, 129, size=n)
        counts[rng.random(n) < 0.2] = 0
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        n_sym = int(offsets[-1])
        for tile in (64, 1024, 3584):
            want = jhp._max_tile_span(offsets, tile, n_sym)
            got = hp._max_tile_span(torch.from_numpy(offsets), tile, n_sym)
            assert got == want, (n, tile)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_tuned_decode_matches_jax(case, backend):
    book, syms, stream = case
    n = syms.shape[0]
    want = np.asarray(jhp.decode(stream, book, n, strategy="tuned"))
    pbook, pstream = _port(book, stream)
    be = hp.get_backend(backend)
    be.reset_stats()
    launches.reset()
    plan = hp.build_plan(pstream, pbook, backend=be)
    assert plan._classes is None         # classes are built when first read
    got = hp.decode(pstream, pbook, n, plan=plan, backend=be,
                    strategy="tuned")
    assert got.dtype == torch.uint16
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), syms)
    jplan = jhp.build_plan(stream, book)
    assert np.array_equal(plan.classes.classes, jplan.classes.classes)
    busy = {int(c) for c, k in zip(plan.classes.classes, plan.seq_counts)
            if k > 0}
    assert be.stats["decode_write_dispatches"] == len(busy)
    assert sum(launches.counts().values()) == 0


@pytest.mark.parametrize("extra", [-700, 50])
def test_tuned_decode_of_another_n_out(extra):
    """n_out below the decoded symbols gives their prefix, above it zeros
    after them, as in the reference; alone and in a batch."""
    rng = np.random.default_rng(9)
    items = [make_book_and_stream(rng, n_syms=n, zipf=z)[::-1]
             for n, z in ((3000, 1.3), (2000, 2.0))]
    n_outs = [len(syms) + extra for _, syms, _ in items]
    ported = [_port(b, s) for s, _, b in items]
    for (stream, syms, book), n_out, (pbook, pstream) in zip(items, n_outs,
                                                             ported):
        want = np.asarray(jhp.decode(stream, book, n_out, strategy="tuned"))
        got = hp.decode(pstream, pbook, n_out, backend="ref",
                        strategy="tuned")
        assert np.array_equal(got.numpy(), want)
    want = jhp.decode_batch([s for s, _, _ in items],
                            [b for _, _, b in items], n_outs)
    got = hp.decode_batch([s for _, s in ported], [b for b, _ in ported],
                          n_outs, backend="cuda")
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_execute_tuned_matches_jax(case):
    book, syms, stream = case
    n = syms.shape[0]
    jplan = jhp.build_plan(stream, book)
    want = np.asarray(jhp.execute_tuned(
        stream, jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len),
        book.max_len, n, jplan.start_bits, jplan.counts, t_high=4))
    pbook, pstream = _port(book, stream)
    plan = hp.build_plan(pstream, pbook, backend="ref")
    for tiles_fn in (None, ops.decode_write_tiles):
        got = hp.execute_tuned(
            pstream, torch.from_numpy(book.dec_sym),
            torch.from_numpy(book.dec_len), book.max_len, n, plan.start_bits,
            plan.counts, t_high=4, tiles_fn=tiles_fn)
        assert np.array_equal(got.numpy(), want)


def test_tuned_with_transform_raises():
    book, syms, stream = make_book_and_stream(np.random.default_rng(1),
                                              n_syms=500)
    pbook, pstream = _port(book, stream)
    t = hp.OutputTransform(eb=1e-3, radius=512,
                           outlier_pos=torch.full((8,), -1),
                           outlier_val=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="tuned per-CR-class gather"):
        hp.decode(pstream, pbook, len(syms), backend="ref", strategy="tuned",
                  transform=t)
    with pytest.raises(ValueError, match="unknown strategy"):
        hp.decode(pstream, pbook, len(syms), backend="ref", strategy="x")


# ---------------------------------------------------------------------------
# Batched decode (tests/test_pipeline.py, TestDecodeBatch)
# ---------------------------------------------------------------------------


def _items(rng, specs):
    items = []
    for n, max_len, zipf in specs:
        book, syms, stream = make_book_and_stream(rng, n_syms=n,
                                                  max_len=max_len, zipf=zipf)
        items.append((stream, book, syms))
    return items


def _decode_batch(items, **kw):
    ported = [_port(b, s) for s, b, _ in items]
    return hp.decode_batch([s for _, s in ported], [b for b, _ in ported],
                           [len(y) for _, _, y in items], **kw), ported


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_batch_byte_identical_to_per_tensor(backend):
    # >= 4 tensors, heterogeneous sizes AND codebook widths (max_len)
    items = _items(np.random.default_rng(0),
                   [(5000, 12, 1.4), (2000, 10, 1.2), (6001, 12, 2.0),
                    (900, 11, 1.6), (260, 12, 1.3)])
    outs, ported = _decode_batch(items, backend=backend)
    want = jhp.decode_batch([s for s, _, _ in items],
                            [b for _, b, _ in items],
                            [len(y) for _, _, y in items])
    for (_, _, syms), out, w, (pbook, pstream) in zip(items, outs, want,
                                                      ported):
        per_tensor = hp.decode(pstream, pbook, len(syms), backend=backend,
                               strategy="tuned")
        assert out.numpy().tobytes() == per_tensor.numpy().tobytes()
        assert out.numpy().tobytes() == np.asarray(w).tobytes()
        assert np.array_equal(out.numpy(), syms)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_one_dispatch_per_class(backend):
    """N tensors cost at most one decode-write dispatch per CR class, not
    N x classes."""
    items = _items(np.random.default_rng(1), [(4000, 12, 1.4)] * 4)
    ported = [_port(b, s) for s, b, _ in items]
    be = hp.get_backend(backend)
    plans = [hp.build_plan(s, b, backend=be) for b, s in ported]
    classes_present = set()
    for plan in plans:
        classes_present |= {int(c) for c in plan.classes.classes}
    be.reset_stats()
    outs = hp.decode_batch([s for _, s in ported], [b for b, _ in ported],
                           [len(y) for _, _, y in items], plans=plans,
                           backend=be)
    batched = be.stats["decode_write_dispatches"]
    assert batched <= len(classes_present)
    assert batched <= plans[0].t_high + 1
    be.reset_stats()
    for (b, s), (_, _, y), plan in zip(ported, items, plans):
        hp.decode(s, b, len(y), plan=plan, backend=be, strategy="tuned")
    assert batched < be.stats["decode_write_dispatches"]
    for (_, _, syms), out in zip(items, outs):
        assert np.array_equal(out.numpy(), syms)


def test_tail_padding_sequences():
    """Regression of the reference: tensors whose final sequence is mostly
    zero padding land in a low-CR class with many count-0 subsequences;
    gathered across tensors, a tile must not span more subsequences than
    its lane budget provisions."""
    rng = np.random.default_rng(0)
    items, k = [], 0
    while len(items) < 6 and k < 64:
        book, syms, stream = make_book_and_stream(rng, n_syms=17000 + 9 * k,
                                                  zipf=1.15)
        k += 1
        plan = jhp.build_plan(stream, book)
        if plan.classes.classes[-1] <= 2 and plan.seq_counts[-1] < 200:
            items.append((stream, book, syms))
    assert len(items) >= 4, "could not construct tail-padded streams"
    for backend in ("cuda", "ref"):
        outs, _ = _decode_batch(items, backend=backend)
        for (_, _, syms), out in zip(items, outs):
            assert np.array_equal(out.numpy(), syms)


def test_oversized_batch_chunks(monkeypatch):
    """Batches past the bit budget split; a single stream over the budget
    is the base case, not an endless split."""
    items = _items(np.random.default_rng(2), [(2000, 12, 1.4)] * 4)
    bits0 = int(items[0][0].units.shape[0]) * 32
    be = hp.get_backend("ref")
    monkeypatch.setattr(hp, "MAX_BATCH_BITS", bits0 + 1)
    be.reset_stats()
    outs, _ = _decode_batch(items, backend=be)
    split = be.stats["decode_write_dispatches"]
    monkeypatch.setattr(hp, "MAX_BATCH_BITS", bits0 // 2)
    solo, _ = _decode_batch(items[:1], backend=be)
    for (_, _, syms), out in zip(items, outs):
        assert np.array_equal(out.numpy(), syms)
    assert np.array_equal(solo[0].numpy(), items[0][2])
    monkeypatch.setattr(hp, "MAX_BATCH_BITS", 1 << 30)
    be.reset_stats()
    _decode_batch(items, backend=be)
    assert be.stats["decode_write_dispatches"] < split


def test_empty_batch():
    assert hp.decode_batch([], [], []) == []
    assert compressor.decompress_batch([]) == []
    assert Codec(CodecConfig(device="cpu")).decompress_batch([]) == []


def test_batch_with_plans_of_another_t_high():
    """Plans built for one t_high decode under another: the classes follow
    the dispatch's t_high, and the output does not change."""
    items = _items(np.random.default_rng(4), [(3000, 12, 1.3),
                                              (2500, 12, 2.5)])
    ported = [_port(b, s) for s, b, _ in items]
    plans = [hp.build_plan(s, b, backend="ref", t_high=8)
             for b, s in ported]
    be = hp.get_backend("ref")
    be.reset_stats()
    outs = hp.decode_batch([s for _, s in ported], [b for b, _ in ported],
                           [len(y) for _, _, y in items], plans=plans,
                           backend=be, t_high=2)
    assert be.stats["decode_write_dispatches"] <= 3
    for (_, _, syms), out in zip(items, outs):
        assert np.array_equal(out.numpy(), syms)


# ---------------------------------------------------------------------------
# decompress_batch: the compressor's and the codec's
# ---------------------------------------------------------------------------

_PAYLOADS: dict = {}


def _payloads():
    """JAX payloads of mixed ndim and dtype, the JAX batch bytes, and the
    same payloads carried into the port (memoized)."""
    if not _PAYLOADS:
        specs = [((3000,), "f32"), ((40, 56), "bf16"), ((5, 20, 30), "f16"),
                 ((1, 2500), "f32"), ((64, 48), "f32")]
        cjs, cts = [], []
        for i, (shape, dk) in enumerate(specs):
            xj, _ = both(spiky_field(shape, seed=40 + i), dk)
            cj = JCodec(JConfig(radius=RADIUS)).compress(xj)
            cjs.append(cj)
            cts.append(compressor.compressed_from_arrays(jax_arrays(cj),
                                                         "cpu"))
        for t_high in (8, 3):
            jcodec = JCodec(JConfig(radius=RADIUS, t_high=t_high))
            _PAYLOADS[t_high] = [np.asarray(y).tobytes()
                                 for y in jcodec.decompress_batch(cjs)]
        _PAYLOADS["cj"], _PAYLOADS["ct"] = cjs, cts
    return _PAYLOADS


@pytest.mark.parametrize("t_high", [8, 3])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_codec_decompress_batch_matches_jax(backend, t_high):
    p = _payloads()
    codec = Codec(CodecConfig(radius=RADIUS, backend=backend, t_high=t_high,
                              device="cpu"))
    codec.reset_stats()
    outs = codec.decompress_batch(p["ct"])
    assert [as_bytes(y) for y in outs] == p[t_high]
    s = codec.stats
    assert s["plan_builds"] == len(p["ct"]) and s["plan_misses"] == 5
    assert s["decode_write_dispatches"] <= t_high + 1
    for y, c in zip(outs, p["ct"]):
        assert y.dtype == c.dtype and tuple(y.shape) == tuple(c.shape)
    codec.decompress_batch(p["ct"])           # plans from the cache
    assert codec.stats["plan_builds"] == 5 and codec.stats["plan_hits"] == 5
    # the per-tensor decompress gives the same bytes
    assert [as_bytes(codec.decompress(c)) for c in p["ct"]] == p[t_high]


@pytest.mark.parametrize("strategy", ["tile", "padded", "tuned"])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_decompress_batch_fused_counts_each_fallback_once(backend, strategy):
    """Eligibility is judged once per tensor: eligible tensors decode fused
    one by one, each ineligible one counts one fallback and goes through
    the class-merged path; the bytes are the two-pass bytes, and the
    counters equal the reference's."""
    p = _payloads()
    cts = list(p["ct"])
    cjs = list(p["cj"])
    # ineligible: two 4-D views
    for i, shape in ((0, (2, 5, 15, 20)), (4, (2, 3, 16, 32))):
        cts.append(dataclasses.replace(cts[i], shape=shape))
        cjs.append(dataclasses.replace(cjs[i], shape=shape))
    be = hp.get_backend(backend)
    be.reset_stats()
    outs = compressor.decompress_batch(cts, backend=be, strategy=strategy,
                                       fused=True)
    jbe = jhp.get_backend("ref")
    jbe.reset_stats()
    jouts = jcomp.decompress_batch(cjs, backend="ref", strategy=strategy,
                                   fused=True)
    assert [as_bytes(y) for y in outs] == [np.asarray(y).tobytes()
                                           for y in jouts]
    assert be.stats["fused_fallbacks"] == jbe.stats["fused_fallbacks"]
    assert be.stats["fused_dispatches"] == jbe.stats["fused_dispatches"]
    n_bad = 7 if strategy == "tuned" else 2
    assert be.stats["fused_fallbacks"] == n_bad
    assert be.stats["fused_dispatches"] == 7 - n_bad
    two_pass = compressor.decompress_batch(cts, backend=be,
                                           strategy=strategy)
    assert [as_bytes(y) for y in two_pass] == [as_bytes(y) for y in outs]


# ---------------------------------------------------------------------------
# Codec: t_high, the plan cache and the shared-memory bound
# ---------------------------------------------------------------------------


def test_plan_cache_keys_on_t_high():
    """A codec never gets a plan whose classes were built for another
    t_high, even through a shared cache; classes are built only when read."""
    c = _payloads()["ct"][0]
    cache = PlanCache()
    a = Codec(CodecConfig(radius=RADIUS, device="cpu"), plan_cache=cache)
    b = Codec(CodecConfig(radius=RADIUS, device="cpu", t_high=2),
              plan_cache=cache)
    pa, pb = a.plan_for(c), b.plan_for(c)
    assert pa is not pb and (pa.t_high, pb.t_high) == (8, 2)
    assert a.plan_for(c) is pa and b.plan_for(c) is pb
    a.decompress(c)                          # "tile": no classes built
    assert pa._classes is None
    Codec(a.config.replace(strategy="tuned"), plan_cache=cache).decompress(c)
    assert pa._classes is not None and pa.classes.t_high == 8
    assert pb.classes.t_high == 2 and pb.classes.classes.max() <= 3


def test_t_high_validation():
    with pytest.raises(ValueError, match="t_high"):
        CodecConfig(t_high=0)
    assert CodecConfig(t_high=1).t_high == 1


@pytest.mark.parametrize("t_high,ok", [(8, True), (113, True),
                                       (114, False)])
def test_shared_memory_bound_covers_class_tiles(t_high, ok):
    """On "cuda" the largest class tile of t_high (1,024 * t_high codes)
    must fit a decode_tiles block's staging tile too (a LUT that does not
    fit beside it is read from device memory): t_high 113 (115,712 codes)
    fits and 114 does not, at any max_len."""
    tile = hp.max_class_tile(t_high)
    assert tile == max(1024 * t_high, hp.OVERFLOW_TILE)
    assert (K.decode_tiles_smem(tile, 0) <= K.SMEM_LIMIT) == ok
    assert K.decode_tiles_lut_in_smem(tile, 1 << 16) == (t_high <= 17)
    if ok:
        CodecConfig(max_len=16, t_high=t_high)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            CodecConfig(max_len=16, t_high=t_high)
    CodecConfig(backend="ref", max_len=16, t_high=t_high)


def test_lut_placement_by_size():
    """The tile kernel stages a LUT that fits beside the tile and reads a
    larger (merged) one from device memory."""
    assert K.decode_tiles_lut_in_smem(8192, 4096 * 17)
    assert not K.decode_tiles_lut_in_smem(8192, 4096 * 18)
    assert not K.decode_tiles_lut_in_smem(4096, 259 * 4096)
