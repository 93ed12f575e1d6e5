"""The port's fault-injection campaign (``repro_torch.testing``) against
the JAX package's, and the reference's own robustness cases on the port.

* ``build_corpus`` writes byte-identical archives, checkpoints and KV
  blocks in both packages, from the same seed.
* ``run_campaign(seed=1, cases=16)`` runs the same ``(consumer, kind,
  seed)`` schedule in both, with the same outcome on every store,
  checkpoint and paging case; on the decode channel, where the two
  decoders' guards may part, both outcomes are non-violations.
* The cases of ``tests/test_faults.py``: decoder guards, single-byte
  flips, archive recovery policies and transient IO (the injected
  failures reach the prefetch thread), checkpoint salvage, KV paging
  degradation, and the campaign harness.

The port runs on the CPU by request (``backend="ref"``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.testing import faults as jfaults

from repro_torch.checkpoint.manager import (CheckpointIntegrityError,
                                            CheckpointManager)
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.data.pipeline import smooth_field
from repro_torch.models import kvcache
from repro_torch.store import (Archive, ArchiveWriter, KVPager,
                               PageLostError, StoreCorruptError, StoreError,
                               StoreIOError)
from repro_torch.testing import NAMED_ERRORS, faults, flip_bit, run_campaign


def _codec(**kw):
    kw.setdefault("eb", 1e-3)
    return Codec(CodecConfig(backend="ref", **kw), plan_cache=PlanCache())


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


# ---------------------------------------------------------------------------
# The campaign against the reference's
# ---------------------------------------------------------------------------


def test_corpus_is_byte_identical(tmp_path):
    got = faults.build_corpus(str(tmp_path / "port"))
    want = jfaults.build_corpus(str(tmp_path / "jax"))
    assert open(got.archive, "rb").read() == open(want.archive, "rb").read()
    assert _files(got.ckpt_dir) == _files(want.ckpt_dir)
    assert got.kv_block_bytes == want.kv_block_bytes
    assert got.kv_block_id == want.kv_block_id
    assert {k: v for k, v in got.kv_meta.items() if k != "path"} == \
        {k: v for k, v in want.kv_meta.items() if k != "path"}
    for name, w in want.baseline.items():
        assert got.baseline[name].tobytes() == np.asarray(w).tobytes()
    for name, w in want.ckpt_baseline.items():
        assert got.ckpt_baseline[name].tobytes() == np.asarray(w).tobytes()
    for name, w in want.kv_snapshot.items():
        # the port's snapshot is a copy taken before the in-place offload
        assert got.kv_snapshot[name].tobytes() == w.tobytes()
        assert np.any(got.kv_snapshot[name][:, :, :8])
        assert not got.kv_cache[name][:, :, :8].any()


def test_campaign_against_the_reference(tmp_path):
    got = run_campaign(seed=1, cases=16, base_dir=str(tmp_path / "port"))
    want = jfaults.run_campaign(seed=1, cases=16,
                                base_dir=str(tmp_path / "jax"))
    assert [(r.case.consumer, r.case.kind, r.case.seed)
            for r in got.results] == \
        [(r.case.consumer, r.case.kind, r.case.seed) for r in want.results]
    assert got.ok, got.summary()
    assert want.ok, want.summary()
    for g, w in zip(got.results, want.results):
        if g.case.consumer != "decode":
            assert g.outcome == w.outcome, (g, w)
    assert {r.case.consumer for r in got.results} == \
        {"store", "decode", "checkpoint", "paging"}
    assert got.summary().splitlines()[0] == want.summary().splitlines()[0]


def test_named_errors_and_exports():
    assert set(NAMED_ERRORS) == {StoreError, CheckpointIntegrityError,
                                 hp.DecodeGuardError}
    assert faults.VIOLATIONS == jfaults.VIOLATIONS
    assert [c.__name__ for c in faults.CHANNELS] == \
        [c.__name__ for c in jfaults.CHANNELS]
    rng = np.random.RandomState(3)
    a = np.arange(12, dtype=np.int32)
    b = faults.flip_array_bit(a, rng)
    assert b.dtype == a.dtype and int((a != b).sum()) == 1
    assert np.array_equal(b, jfaults.flip_array_bit(a,
                                                    np.random.RandomState(3)))


def test_decode_flip_of_every_field_is_contained(tmp_path):
    """Each in-memory field the decode channel corrupts, flipped on the
    port: a named error or a bounded, finite output of the right shape."""
    corpus = faults.build_corpus(str(tmp_path))
    seen = set()
    for seed in range(60):
        result = faults.run_case(faults.case_decode_field_flip, corpus, seed)
        assert result.ok, result
        seen.add(result.note.split()[0] if result.outcome != "detected"
                 else "detected")
    assert len(seen) >= 4, seen


# ---------------------------------------------------------------------------
# Decoder-level guards
# ---------------------------------------------------------------------------


def _compressed(seed):
    return _codec().compress(torch.from_numpy(np.asarray(
        smooth_field((64, 32), seed=seed), np.float32)))


class TestDecoderGuards:
    def test_corrupt_codebook_rejected_at_build_plan(self):
        c = _compressed(3)
        bad_len = np.array(c.codebook.enc_len)
        used = np.flatnonzero(bad_len)
        bad_len[used[: max(2, used.size // 2)]] = 1   # Kraft sum > 1
        book = dataclasses.replace(c.codebook, enc_len=bad_len)
        before = hp.get_backend("ref").stats["decode_guard_trips"]
        with pytest.raises(hp.DecodeGuardError, match="codebook"):
            hp.build_plan(c.stream, book, method="gap", backend="ref")
        assert hp.get_backend("ref").stats["decode_guard_trips"] == \
            before + 1

    def test_dec_len_over_max_rejected(self):
        c = _compressed(4)
        dec_len = np.array(c.codebook.dec_len)
        dec_len[0] = c.codebook.max_len + 7
        book = dataclasses.replace(c.codebook, dec_len=dec_len)
        with pytest.raises(hp.DecodeGuardError):
            hp.build_plan(c.stream, book, method="gap", backend="ref")

    def test_symbol_count_mismatch_guard(self):
        c = _compressed(5)
        stream = dataclasses.replace(c.stream,
                                     total_bits=int(c.stream.total_bits) // 2)
        bad = dataclasses.replace(c, stream=stream)
        with pytest.raises(hp.DecodeGuardError, match="symbol-count"):
            _codec().decompress(bad)

    def test_oversized_gap_clamped_not_crashed(self):
        c = _compressed(6)
        gaps = c.stream.gaps.clone()
        gaps[gaps.numel() // 2] = 255     # legit gaps never exceed 128
        stream = dataclasses.replace(c.stream, gaps=gaps)
        before = hp.get_backend("ref").stats["decode_guard_trips"]
        hp.build_plan(stream, c.codebook, method="gap", backend="ref")
        assert hp.get_backend("ref").stats["decode_guard_trips"] == \
            before + 1


# ---------------------------------------------------------------------------
# Single-byte flips: a named error or bit-exact, never silent
# ---------------------------------------------------------------------------


def _write(path, codec, names=("t0", "t1", "t2", "t3"), seed=0):
    arrays = {}
    with ArchiveWriter(path, codec=codec) as w:
        for i, n in enumerate(names):
            arrays[n] = np.asarray(smooth_field((40, 36 + 4 * i),
                                                seed=seed + i), np.float32)
            w.add_array(n, torch.from_numpy(arrays[n]))
    return arrays


def _flip_in_chunk(path, codec, name, rng):
    with Archive(path, codec=codec) as ar:
        rec = ar.chunk(name)
    flip_bit(path, rec.units.offset + int(rng.integers(rec.units.length)),
             int(rng.integers(8)))


def test_single_byte_flip_sweep(tmp_path):
    codec = _codec()
    path = str(tmp_path / "a.szt")
    _write(path, codec, names=("x", "y"))
    with Archive(path, codec=codec) as ar:
        baseline = {n: faults._host(v) for n, v in ar.read_all().items()}
    size, pristine = os.path.getsize(path), open(path, "rb").read()
    rng = np.random.default_rng(0)
    for _ in range(40):
        with open(path, "wb") as f:
            f.write(pristine)
        flip_bit(path, int(rng.integers(size)), int(rng.integers(8)))
        try:
            with Archive(path, codec=codec) as ar:
                out = ar.read_all(policy="raise")
        except NAMED_ERRORS:
            continue
        assert set(out) == set(baseline)
        for n in baseline:
            assert faults._host(out[n]).tobytes() == \
                baseline[n].tobytes(), f"{n}: silent corruption"


# ---------------------------------------------------------------------------
# Archive recovery policies + prefetch error propagation + transient IO
# ---------------------------------------------------------------------------


class TestArchiveRecovery:
    def test_policies(self, tmp_path):
        codec = _codec()
        path = str(tmp_path / "a.szt")
        arrays = _write(path, codec)
        _flip_in_chunk(path, codec, "t2", np.random.default_rng(1))
        with Archive(path, codec=codec) as ar:
            with pytest.raises(StoreCorruptError, match="t2"):
                ar.read_all(policy="raise")
        seen = []
        with Archive(path, codec=codec) as ar:
            out = ar.read_all(policy="skip",
                              on_error=lambda n, e: seen.append((n, e)))
            assert sorted(out) == ["t0", "t1", "t3"]
            assert ar.stats["chunks_skipped"] == 1
        assert seen[0][0] == "t2" and isinstance(seen[0][1], StoreError)
        with Archive(path, codec=codec) as ar:
            out = ar.read_all(policy="zero_fill")
            assert sorted(out) == ["t0", "t1", "t2", "t3"]
            assert not out["t2"].any()
            assert tuple(out["t2"].shape) == arrays["t2"].shape
            assert ar.stats["chunks_zero_filled"] == 1

    def test_codec_config_default_policy(self, tmp_path):
        codec = _codec(recovery="skip")
        path = str(tmp_path / "a.szt")
        _write(path, codec)
        _flip_in_chunk(path, codec, "t0", np.random.default_rng(2))
        with Archive(path, codec=codec) as ar:
            assert sorted(ar.read_all()) == ["t1", "t2", "t3"]

    def test_prefetch_error_reaches_consumer(self, tmp_path):
        codec = _codec()
        path = str(tmp_path / "a.szt")
        _write(path, codec, names=tuple(f"t{i}" for i in range(6)))
        _flip_in_chunk(path, codec, "t5", np.random.default_rng(3))
        got = []
        with Archive(path, codec=codec) as ar:
            with pytest.raises(StoreCorruptError, match="t5"):
                for n, _ in ar.iter_decode(group_chunks=2, prefetch=True,
                                           policy="raise"):
                    got.append(n)
        assert got == ["t0", "t1", "t2", "t3", "t4"]

    @pytest.mark.parametrize("prefetch", [False, True])
    def test_transient_io_retried_then_named(self, tmp_path, prefetch):
        """``inject_blob_failures`` patches the archive's ``_blob``; the
        reader's prefetch thread reads through the patched instance
        attribute too."""
        codec = _codec(io_retries=2)
        path = str(tmp_path / "a.szt")
        _write(path, codec, names=tuple(f"t{i}" for i in range(6)))
        with Archive(path, codec=codec) as ar:
            baseline = {n: faults._host(v) for n, v in ar.read_all().items()}
        with Archive(path, codec=codec) as ar:
            state = faults.inject_blob_failures(ar, 2)
            out = ar.read_all(group_chunks=2, prefetch=prefetch,
                              policy="raise")
            assert state["injected"] == 2 and ar.stats["io_retries"] >= 1
            for n, v in out.items():
                assert faults._host(v).tobytes() == baseline[n].tobytes()
        with Archive(path, codec=codec) as ar:
            faults.inject_blob_failures(ar, 10 ** 6)
            with pytest.raises(StoreIOError):
                ar.read_all(group_chunks=2, prefetch=prefetch,
                            policy="raise")


# ---------------------------------------------------------------------------
# Checkpoint salvage
# ---------------------------------------------------------------------------


def _ckpt(tmp_path, codec):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, codec=codec, compress_min_size=1024)
    rng = np.random.default_rng(7)
    params = {"w1": rng.normal(size=(48, 48)).astype(np.float32),
              "w2": rng.normal(size=(40, 40)).astype(np.float32),
              "n": np.int32(9)}
    mgr.save(1, params)
    mgr.save(2, params)
    return d, mgr, params


class TestCheckpointSalvage:
    def test_atomic_manifest_write(self, tmp_path):
        d, mgr, _ = _ckpt(tmp_path, _codec())
        step = os.path.join(d, "step_00000002")
        assert os.path.exists(os.path.join(step, "manifest.json"))
        assert not os.path.exists(os.path.join(step, "manifest.json.tmp"))
        r = mgr.restore()
        assert r["step"] == 2 and not r["quarantined"]

    def test_skip_quarantines_corrupt_entry(self, tmp_path):
        codec = _codec()
        d, mgr, params = _ckpt(tmp_path, codec)
        apath = os.path.join(d, "step_00000002", "archive.szt")
        with Archive(apath, codec=codec) as ar:
            rec = ar.chunk("params.w1")
        flip_bit(apath, rec.units.offset + rec.units.length // 2, 3)
        with pytest.raises(CheckpointIntegrityError):
            mgr.restore(2)
        r = mgr.restore(2, policy="skip")
        assert list(r["quarantined"]) == ["params.w1"]
        assert "w1" not in r["params"]
        assert np.allclose(r["params"]["w2"].numpy(), params["w2"],
                           atol=1e-2)
        assert int(r["params"]["n"]) == 9

    def test_zero_fill_keeps_tree_structure(self, tmp_path):
        d, mgr, params = _ckpt(tmp_path, _codec())
        os.unlink(os.path.join(d, "step_00000002", "archive.szt"))
        r = mgr.restore(2, policy="zero_fill")
        assert set(r["quarantined"]) == {"params.w1", "params.w2"}
        assert tuple(r["params"]["w1"].shape) == params["w1"].shape
        assert not r["params"]["w1"].any()
        assert int(r["params"]["n"]) == 9

    def test_torn_manifest_falls_back_to_newest_intact(self, tmp_path):
        d, mgr, params = _ckpt(tmp_path, _codec())
        mpath = os.path.join(d, "step_00000002", "manifest.json")
        with open(mpath, "r+b") as f:
            f.truncate(os.path.getsize(mpath) // 2)
        with pytest.raises(CheckpointIntegrityError):
            mgr.restore()
        r = mgr.restore(policy="skip")
        assert r["step"] == 1 and r["fallback_from"][0]["step"] == 2
        assert np.allclose(r["params"]["w1"].numpy(), params["w1"],
                           atol=1e-2)

    def test_corrupt_raw_shard_named_and_quarantined(self, tmp_path):
        d, mgr, _ = _ckpt(tmp_path, _codec())
        npy = os.path.join(d, "step_00000002", "params.n.npy")
        flip_bit(npy, os.path.getsize(npy) - 1, 0)
        with pytest.raises(CheckpointIntegrityError, match="params.n"):
            mgr.restore(2)
        r = mgr.restore(2, policy="skip")
        assert "params.n" in r["quarantined"] and "w1" in r["params"]


# ---------------------------------------------------------------------------
# KV paging degradation
# ---------------------------------------------------------------------------


def _kv(seed, n=16):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(size=(1, 1, n, 8)).astype(
        np.float32)) for k in ("k", "v")}


def _paged(tmp_path, codec):
    pager = KVPager(str(tmp_path / "kv"), codec=codec, seq_axis=2)
    cache, bid = pager.offload(_kv(11), 0, 8, keys=["k", "v"])
    return pager, cache, bid


class TestPagingDegradation:
    def test_lost_block_named_counted_evicted(self, tmp_path):
        pager, cache, bid = _paged(tmp_path, _codec())
        os.unlink(pager.block_meta(bid)["path"])
        with pytest.raises(PageLostError) as ei:
            pager.page_in(cache, bid)
        assert ei.value.block_id == bid
        assert pager.stats["pages_lost"] == 1
        assert bid not in pager.resident_blocks
        assert not cache["k"][:, :, :8].any()

    def test_corrupt_block_named(self, tmp_path):
        pager, cache, bid = _paged(tmp_path, _codec())
        path = pager.block_meta(bid)["path"]
        flip_bit(path, os.path.getsize(path) // 2, 5)
        with pytest.raises(PageLostError):
            pager.page_in(cache, bid)

    def test_page_in_blocks_on_lost_continues(self, tmp_path):
        pager = KVPager(str(tmp_path / "kv"), codec=_codec(), seq_axis=2)
        cache = _kv(13)
        snap = {k: v.clone() for k, v in cache.items()}
        cache, b0 = pager.offload(cache, 0, 8, keys=["k", "v"])
        cache, b1 = pager.offload(cache, 8, 16, keys=["k", "v"])
        os.unlink(pager.block_meta(b0)["path"])
        lost = []
        cache = kvcache.page_in_blocks(cache, pager, [b0, b1],
                                       on_lost=lambda b, e: lost.append(b))
        assert lost == [b0]
        assert not cache["k"][:, :, :8].any()
        assert torch.allclose(cache["k"][:, :, 8:], snap["k"][:, :, 8:],
                              atol=1e-2)
        with pytest.raises(PageLostError):
            kvcache.page_in_blocks(cache, pager, [b0])

    def test_adopt_block_reregisters(self, tmp_path):
        codec = _codec()
        pager, _, bid = _paged(tmp_path, codec)
        fresh = KVPager(pager.dir, codec=codec, seq_axis=2)
        fresh.adopt_block(bid, pager.block_meta(bid))
        assert set(fresh.fetch(bid)) == {"k", "v"}
        with pytest.raises(ValueError, match="missing keys"):
            fresh.adopt_block(99, {"path": "x"})


# ---------------------------------------------------------------------------
# The campaign harness itself
# ---------------------------------------------------------------------------


class TestCampaign:
    def test_small_campaign_clean(self, tmp_path):
        report = run_campaign(seed=1, cases=8,
                              base_dir=str(tmp_path / "campaign"))
        assert len(report.results) == 8
        assert report.ok, report.summary()
        assert {r.case.consumer for r in report.results} == \
            {"store", "decode", "checkpoint", "paging"}

    def test_deterministic_schedule(self, tmp_path):
        a = run_campaign(seed=2, cases=4, base_dir=str(tmp_path / "a"))
        b = run_campaign(seed=2, cases=4, base_dir=str(tmp_path / "b"))
        assert [(r.case.kind, r.case.seed) for r in a.results] == \
            [(r.case.kind, r.case.seed) for r in b.results]

    def test_paging_cases_start_from_a_fresh_cache(self, tmp_path):
        """``page_in`` writes the tensors it is given: the corpus's
        post-offload cache stays zeroed across paging cases."""
        corpus = faults.build_corpus(str(tmp_path))
        for seed in range(6):
            assert faults.run_case(faults.case_paging, corpus, seed).ok
            for t in corpus.kv_cache.values():
                assert not t[:, :, :8].any()

    def test_cli(self, tmp_path, capsys):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "faultinject_torch", os.path.join(
                os.path.dirname(__file__), "..", "tools",
                "faultinject_torch.py"))
        cli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cli)
        assert cli.main(["--seed", "3", "--cases", "8", "--dir",
                         str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "total 8 cases, 0 violations" in out and "backend ref" in out
