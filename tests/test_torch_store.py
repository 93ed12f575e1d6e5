"""The port's ``.szt`` store against the JAX package's.

* Archives are byte-compatible both ways: the same tensors compressed with
  ``encode_backend="ref"`` by both packages give byte-identical files, and
  each package reads the other's archives bit for bit.
* Corruption and truncation raise the reference's ``StoreError`` types
  with its messages; ``skip`` and ``zero_fill`` recover as it does.
* ``KVPager`` over a reduced qwen3-0.6b decode cache (filled by the port's
  step decode) offloads, pages in and drops as the reference's pager does,
  with the same block archives and the same bf16 values.

The port runs on the CPU by request (``backend="ref"``).  Every comparison
is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.cache import PlanCache as JPlanCache
from repro import store as jstore
from repro.store import format as JF

from repro_torch import store
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.data.pipeline import smooth_field
from repro_torch.store import format as F

from test_torch_stream import as_bytes


def _codec(**kw):
    return Codec(CodecConfig(backend="ref", **kw), plan_cache=PlanCache())


def _jcodec(**kw):
    return japi.Codec(japi.CodecConfig(**kw), plan_cache=JPlanCache())


def _fields(n=4, seed=0):
    return [np.asarray(smooth_field((48, 40 + 9 * i), seed=seed + i),
                       np.float32) for i in range(n)]


def _write_both(tmp_path, *, max_len=12, bf16_input=False):
    """One archive a package from the same fields: t0-t3 float32 (t3
    recorded as bfloat16), a duplicate of t0 (codebook dedup) and, with
    ``bf16_input``, a tensor compressed from bfloat16."""
    xs = _fields()
    codec, jcodec = _codec(max_len=max_len), _jcodec(max_len=max_len)
    tentries, jentries = [], []
    for i, x in enumerate(xs):
        orig = "bfloat16" if i == 3 else None
        tentries.append((f"t{i}", codec.compress(torch.from_numpy(x)), orig))
        jentries.append((f"t{i}", jcodec.compress(x), orig))
    tentries.append(("dup", codec.compress(torch.from_numpy(xs[0])), None))
    jentries.append(("dup", jcodec.compress(xs[0]), None))
    if bf16_input:
        tentries.append(("half", codec.compress(
            torch.from_numpy(xs[1]).to(torch.bfloat16)), None))
        jentries.append(("half", jcodec.compress(
            jnp.asarray(xs[1]).astype(jnp.bfloat16)), None))
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tdir.mkdir()
    jdir.mkdir()
    tpath, jpath = str(tdir / "a.szt"), str(jdir / "a.szt")
    store.write_archive(tpath, tentries)
    jstore.write_archive(jpath, jentries)
    return tpath, jpath


def _read(path, max_len=12, **kw):
    with store.Archive(path, codec=_codec(max_len=max_len)) as ar:
        return ar.read_all(**kw)


def _jread(path, max_len=12, **kw):
    with jstore.Archive(path, codec=_jcodec(max_len=max_len)) as ar:
        return ar.read_all(**kw)


@pytest.mark.parametrize("max_len,bf16_input", [(12, False), (12, True),
                                                (20, False)])
def test_archives_are_byte_identical(tmp_path, max_len, bf16_input):
    tpath, jpath = _write_both(tmp_path, max_len=max_len,
                               bf16_input=bf16_input)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    with store.Archive(tpath, codec=_codec()) as ar:
        assert ar.n_codebooks == (5 if bf16_input else 4)
        assert ar.chunk("t0").codebook == ar.chunk("dup").codebook


@pytest.mark.parametrize("max_len", [12, 20])
def test_cross_reads_bit_for_bit(tmp_path, max_len):
    """The port reads the JAX archive, and the JAX package the port's, to
    the bytes of the reference's own read; recorded dtypes are kept."""
    tpath, jpath = _write_both(tmp_path, max_len=max_len, bf16_input=True)
    want = _jread(jpath, max_len)
    for got in (_read(jpath, max_len), _read(tpath, max_len)):
        assert list(got) == list(want)
        for name, w in want.items():
            w = np.asarray(w)
            assert str(got[name].dtype).removeprefix("torch.") == \
                w.dtype.name, name
            assert as_bytes(got[name]) == w.tobytes(), name
    for name, w in _jread(tpath, max_len).items():
        assert np.asarray(w).tobytes() == np.asarray(want[name]).tobytes()


def test_prefetch_matches_serial_and_as_numpy(tmp_path):
    tpath, _ = _write_both(tmp_path)
    a = _read(tpath, group_chunks=1, prefetch=True)
    b = _read(tpath, group_chunks=1, prefetch=False)
    c = _read(tpath, group_chunks=2, as_numpy=True)
    for n in a:
        assert as_bytes(a[n]) == as_bytes(b[n])
        if a[n].dtype == torch.bfloat16:
            assert isinstance(c[n], torch.Tensor) and c[n].device.type == "cpu"
            assert as_bytes(c[n]) == as_bytes(a[n])
        else:
            assert isinstance(c[n], np.ndarray)
            assert c[n].tobytes() == as_bytes(a[n])


def test_warm_reopen_builds_zero_plans_and_hits_the_codebooks(tmp_path):
    tpath, _ = _write_both(tmp_path)
    codec = _codec()
    be = hp.get_backend("ref")
    be.reset_stats()
    with store.Archive(tpath, codec=codec) as ar:
        first = ar.read_all()
    # "dup" holds t0's payload: one digest, one plan, one codebook.
    assert be.stats["plan_builds"] == len(first) - 1 == 4
    assert codec.plan_cache.stats["lut_misses"] == 4
    be.reset_stats()
    codec.plan_cache.reset_stats()
    with store.Archive(tpath, codec=codec) as ar:
        second = ar.read_all()
        direct = codec.decompress(ar.read_chunk("t1"))
    assert be.stats["plan_builds"] == 0
    assert codec.plan_cache.stats["plan_hits"] == len(first) + 1
    assert codec.plan_cache.stats["lut_misses"] == 0
    assert codec.plan_cache.stats["lut_hits"] == len(first) + 1
    assert all(as_bytes(first[n]) == as_bytes(second[n]) for n in first)
    assert as_bytes(direct) == as_bytes(first["t1"])


def test_close_unmaps_under_live_tensors(tmp_path):
    """The reader copies out of the map: tensors read from an archive stay
    valid after it is closed, and closing never fails on them."""
    tpath, _ = _write_both(tmp_path)
    ar = store.Archive(tpath, codec=_codec())
    c = ar.read_chunk("t2")
    out = ar.read_tensor("t2")
    ar.close()
    assert ar._mm is None
    assert as_bytes(_codec().decompress(c)) == as_bytes(out)


def _errors(fn_port, fn_jax, tmp_path):
    """(type name, message with the directory dropped) of both."""
    def run(fn):
        try:
            fn()
        except Exception as e:      # noqa: BLE001 -- compared, not handled
            return type(e).__name__, str(e).replace(
                str(tmp_path / "port"), "D").replace(str(tmp_path / "jax"),
                                                     "D")
        return None

    return run(fn_port), run(fn_jax)


def _mutate_both(tmp_path, fn):
    tpath, jpath = _write_both(tmp_path)
    fn(tpath)
    fn(jpath)
    return tpath, jpath


def _flip_chunk(name):
    def fn(path):
        with jstore.Archive(path, codec=_jcodec()) as ar:
            rec = ar.chunk(name)
        pos = rec.units.offset + rec.units.length // 2
        with open(path, "r+b") as f:
            f.seek(pos)
            b = f.read(1)[0] ^ 0xFF
            f.seek(pos)
            f.write(bytes([b]))
    return fn


def _truncate(n):
    def fn(path):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(n if n >= 0 else size + n)
    return fn


def _poke(offset, data):
    def fn(path):
        with open(path, "r+b") as f:
            f.seek(offset)
            f.write(data)
    return fn


@pytest.mark.parametrize("case", [
    "truncated_file", "partial_header", "version", "magic", "index_crc"])
def test_open_errors_as_the_reference(tmp_path, case):
    mutate = {"truncated_file": _truncate(-32),
              "partial_header": _truncate(F.HEADER_SIZE // 2),
              "version": _poke(8, (F.FORMAT_VERSION + 1).to_bytes(4,
                                                                  "little")),
              "magic": _poke(0, b"NOTASTOR"),
              "index_crc": _truncate(-1)}[case]
    tpath, jpath = _mutate_both(tmp_path, mutate)
    got, want = _errors(lambda: store.Archive(tpath, codec=_codec()),
                        lambda: jstore.Archive(jpath, codec=_jcodec()),
                        tmp_path)
    assert got is not None and got == want
    assert issubclass(getattr(store, got[0], store.StoreError),
                      store.StoreError)


@pytest.mark.parametrize("what", ["chunk", "codebook"])
def test_crc_errors_as_the_reference(tmp_path, what):
    if what == "chunk":
        mutate = _flip_chunk("t2")
    else:
        def mutate(path):
            with jstore.Archive(path, codec=_jcodec()) as ar:
                off = ar._cb_by_digest[ar.chunk("t2").codebook].enc_code.offset
            _poke(off, b"\xff\xff\xff\xff")(path)
    tpath, jpath = _mutate_both(tmp_path, mutate)

    def port():
        with store.Archive(tpath, codec=_codec()) as ar:
            ar.read_chunk("t0")
            ar.read_chunk("t2")

    def ref():
        with jstore.Archive(jpath, codec=_jcodec()) as ar:
            ar.read_chunk("t0")
            ar.read_chunk("t2")

    got, want = _errors(port, ref, tmp_path)
    assert got is not None and got == want
    assert got[0] == "StoreCorruptError"
    assert ("t2" in got[1]) if what == "chunk" else ("codebook" in got[1])


@pytest.mark.parametrize("policy", ["skip", "zero_fill", "raise"])
def test_recovery_as_the_reference(tmp_path, policy):
    """A corrupt chunk is skipped (counted), zero-filled with the recorded
    shape and dtype (t3 is recorded as bfloat16), or raised, as the
    reference does; the other chunks read bit for bit."""
    tpath, jpath = _mutate_both(tmp_path, lambda p: (_flip_chunk("t3")(p),
                                                     _flip_chunk("t1")(p)))
    seen, jseen = [], []
    with store.Archive(tpath, codec=_codec(recovery=policy)) as ar, \
            jstore.Archive(jpath, codec=_jcodec(recovery=policy)) as jar:
        got, want = _errors(
            lambda: seen.append(ar.read_all(
                group_chunks=2, on_error=lambda n, e: seen.append(n))),
            lambda: jseen.append(jar.read_all(
                group_chunks=2, on_error=lambda n, e: jseen.append(n))),
            tmp_path)
        assert got == want
        assert ar.stats == jar.stats
    if policy == "raise":
        assert got[0] == "StoreCorruptError"
        return
    out, jout = seen.pop(), jseen.pop()
    assert seen == jseen == ["t1", "t3"]
    assert list(out) == list(jout)
    for name, w in jout.items():
        w = np.asarray(w)
        assert as_bytes(out[name]) == w.tobytes(), name
        assert tuple(out[name].shape) == w.shape
    if policy == "zero_fill":
        assert out["t3"].dtype == torch.bfloat16 and not out["t3"].any()


def test_writer_rules(tmp_path):
    c = _codec().compress(torch.from_numpy(_fields(1)[0]))
    with pytest.raises(store.StoreError, match="duplicate"):
        with store.ArchiveWriter(str(tmp_path / "d.szt")) as w:
            w.add("x", c)
            w.add("x", c)
    assert not os.path.exists(tmp_path / "d.szt")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    w = store.ArchiveWriter(str(tmp_path / "e.szt"), codec=_codec())
    w.add_array("y", torch.from_numpy(_fields(1)[0]))
    assert list(w.checksums()) == ["y"]
    w.close()
    assert store.open_archive(str(tmp_path / "e.szt"),
                              codec=_codec()).names == ["y"]


def test_validate_record_names_what_is_wrong():
    """A record the reference refuses, the port refuses with the same
    message; the port's dtype check takes torch's float names."""
    rec = dict(name="r", shape=[4, 4], dtype="float32",
               orig_dtype="bfloat16", codebook="x", units=[64, 16],
               gaps=[128, 1], outlier_pos=[192, 32], outlier_val=[256, 32],
               bit_offset=512, total_bits=100, n_symbols=16,
               subseqs_per_seq=32, eb=1e-3, radius=512, rel_range=1.0,
               max_abs=1.0, cr_class=3, crc32=0, digest="d")
    F.validate_record(F.ChunkRecord.from_json(rec))
    for bad in ({"n_symbols": 15}, {"total_bits": 1000}, {"dtype": "nope"},
                {"subseqs_per_seq": 0}, {"units": [-1, 4]}):
        r = {**rec, **bad}
        got = pytest.raises(F.StoreCorruptError, F.validate_record,
                            F.ChunkRecord.from_json(r))
        want = pytest.raises(JF.StoreCorruptError, JF.validate_record,
                             JF.ChunkRecord.from_json(r))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# KVPager on a reduced qwen3-0.6b decode cache
# ---------------------------------------------------------------------------


def _qwen3_cache(steps=32):
    """The port's step decode of a reduced qwen3-0.6b over ``steps``
    tokens fills its bf16 cache; the reference gets the same values."""
    from repro_torch import configs
    from repro_torch.models import decode as D
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T

    cfg = configs.get_config("qwen3-0.6b").reduced()
    params = T.init_model(0, cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, steps)))
    cache = D.init_cache(cfg, 2, steps, "cpu")
    serve = St.make_serve_step(cfg)
    for t in range(steps):
        _, cache = serve(params, toks[:, t:t + 1], cache, t)
    jcache = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
              for k, v in cache.items()}
    jcache["pos"] = jnp.arange(4)
    cache["pos"] = torch.arange(4)
    return cache, jcache


def test_kv_pager_against_the_reference(tmp_path):
    cache, jcache = _qwen3_cache()
    assert cache["k"].dtype == torch.bfloat16 and cache["k"].any()
    orig = {k: v.clone() for k, v in cache.items()}
    pager = store.KVPager(str(tmp_path / "port"), codec=_codec())
    jpager = jstore.KVPager(str(tmp_path / "jax"), codec=_jcodec())
    cache, bid = pager.offload(cache, 8, 24)
    jcache, jbid = jpager.offload(jcache, 8, 24)
    assert bid == jbid == 0
    assert not cache["k"][:, :, 8:24].any()
    assert torch.equal(cache["k"][:, :, 24:], orig["k"][:, :, 24:])
    assert torch.equal(cache["pos"], orig["pos"])
    assert pager.stats == jpager.stats and pager.ratio == jpager.ratio
    assert pager.block_meta(bid)["names"] == ["k", "v"]
    with open(pager.block_meta(bid)["path"], "rb") as a, \
            open(jpager.block_meta(jbid)["path"], "rb") as b:
        assert a.read() == b.read()
    assert pager.block_key(bid) == jpager.block_key(jbid)
    cache = pager.page_in(cache, bid)
    jcache = jpager.page_in(jcache, jbid)
    for n in ("k", "v"):
        assert as_bytes(cache[n]) == np.asarray(jcache[n]).tobytes()
    be = hp.get_backend("ref")
    be.reset_stats()
    pager.page_in(cache, bid)
    assert be.stats["plan_builds"] == 0 and pager.stats["pages_in"] == 2
    fetched = pager.fetch_many([bid])[bid]
    assert set(fetched) == {"k", "v"} and fetched["k"].dtype == torch.float32
    path = pager.block_meta(bid)["path"]
    meta = pager.block_meta(bid)
    pager.drop(bid)
    assert not os.path.exists(path) and pager.resident_blocks == []
    with pytest.raises(store.PageLostError):
        pager.drop(bid)
    with pytest.raises(ValueError):
        pager.offload(cache, 8, 8)
    pager.adopt_block(5, meta)
    with pytest.raises(store.PageLostError) as ei:
        pager.fetch(5)
    assert ei.value.block_id == 5 and pager.stats["pages_lost"] == 1
