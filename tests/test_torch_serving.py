"""The port's serving package (``repro_torch.serving``) and the serve
launcher's KV paths, against the JAX package's.

* ``BlockCache`` keeps the reference's counters through the same calls.
* ``DecodeScheduler`` returns what ``KVPager.fetch`` returns, bit for bit
  and equal to the reference's decode of the same block archives, with
  the reference's ``stats`` for the same request sequence; shared content
  decodes once with and without overlap; a lost block fails only its
  futures; the fairness cap defers.
* The pager and codec shared by threads stay bit-exact with serial use.
* ``loadgen`` builds the reference's block archives and holds its
  invariants (``--check`` at its defaults).
* ``serve.main --device cpu --reduced --kv-offload`` gives the same tokens
  with ``--concurrency`` 1 and 2, and ``--compress-kv`` and
  ``--kv-recovery`` run.

The port runs on the CPU by request (``backend="ref"``).
"""

import concurrent.futures as futures
import os
import threading

import numpy as np
import pytest
import torch

from repro.core import Codec as JCodec, CodecConfig as JCodecConfig
from repro.serving import loadgen as jloadgen
from repro.serving import prefix_cache as jprefix
from repro.serving import scheduler as jscheduler
from repro.serving import sessions as jsessions
from repro.store import KVPager as JKVPager, PlanCache as JPlanCache

from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.launch import serve
from repro_torch.serving import (BlockCache, DecodeScheduler, build_corpus,
                                 loadgen, percentile, run_load,
                                 summarize_ttft)
from repro_torch.serving.loadgen import check_invariants
from repro_torch.store import KVPager, PageLostError

from test_torch_stream import as_bytes


def _codec():
    return Codec(CodecConfig(backend="ref"), plan_cache=PlanCache())


def _jcodec():
    return JCodec(JCodecConfig(), plan_cache=JPlanCache())


def _cache(seed=0, s=32):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=(2, 1, s, 2, 8)).astype(np.float32)
                     * 0.05, axis=2).astype(np.float32)
    return {"k": base, "v": (base + 0.5).astype(np.float32)}


def _offload_blocks(pager, n=4, s_per=8, seed=0, jax_side=False):
    """n blocks with distinct contents; returns their ids."""
    import jax.numpy as jnp

    arrays = _cache(seed=seed, s=n * s_per)
    cache = ({k: jnp.asarray(v) for k, v in arrays.items()} if jax_side
             else {k: torch.from_numpy(v) for k, v in arrays.items()})
    ids = []
    for i in range(n):
        cache, bid = pager.offload(cache, i * s_per, (i + 1) * s_per)
        ids.append(bid)
    return ids


# ---------------------------------------------------------------------------
# KVPager and Codec shared by threads
# ---------------------------------------------------------------------------


def test_fetch_many_matches_fetch(tmp_path):
    pager = KVPager(str(tmp_path), codec=_codec())
    ids = _offload_blocks(pager, n=3)
    serial = {bid: pager.fetch(bid) for bid in ids}
    batched = pager.fetch_many(ids)
    assert set(batched) == set(serial)
    for bid in ids:
        for name in serial[bid]:
            assert torch.equal(batched[bid][name], serial[bid][name])


def test_concurrent_fetch_bit_exact_and_counters(tmp_path):
    pager = KVPager(str(tmp_path), codec=_codec())
    ids = _offload_blocks(pager, n=4)
    serial = {bid: pager.fetch(bid) for bid in ids}
    fresh = KVPager(pager.dir, codec=_codec())
    for bid in ids:
        fresh.adopt_block(bid, pager.block_meta(bid))
    be = hp.get_backend("ref")
    before = dict(be.stats)
    with futures.ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda bid: (bid, fresh.fetch(bid)), ids * 4))
    for bid, tensors in got:
        for name, t in tensors.items():
            assert torch.equal(t, serial[bid][name])
    # single-flight: one plan a distinct chunk, whatever the threads
    assert be.stats["plan_builds"] - before["plan_builds"] == 2 * len(ids)
    assert fresh.stats["pages_in"] == 4 * len(ids)


def test_concurrent_offload_unique_ids(tmp_path):
    pager = KVPager(str(tmp_path), codec=_codec())
    out, lock = [], threading.Lock()

    def one(seed):
        cache = {k: torch.from_numpy(v) for k, v in _cache(seed, 8).items()}
        _, bid = pager.offload(cache, 0, 8)
        with lock:
            out.append(bid)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(out)) == 6 and pager.stats["pages_out"] == 6


# ---------------------------------------------------------------------------
# BlockCache, against the reference's
# ---------------------------------------------------------------------------


def _cache_script(cls):
    c = cls(capacity_bytes=100)
    log = [c.insert("a", {"x": 1}, 40, pinned=False),
           c.insert("b", {"x": 2}, 40, pinned=False),
           c.acquire("a")]
    c.release("a")
    log += [c.insert("c", {"x": 3}, 40, pinned=False), "b" in c, "a" in c,
            c.acquire("b"), c.insert("p", {"x": 4}, 60, pinned=True),
            c.insert("q", {"x": 5}, 60, pinned=False), "p" in c, "q" in c]
    c.release("p")
    log += [c.insert("d", {"x": 6}, 60, pinned=False), "p" in c,
            c.insert("big", {}, 101), c.insert("d", {"x": 7}, 10),
            c.acquire("d"), len(c), c.resident_bytes]
    c.release("ghost")
    return log, dict(c.stats)


def test_block_cache_as_the_reference():
    assert _cache_script(BlockCache) == _cache_script(jprefix.BlockCache)
    with pytest.raises(ValueError):
        BlockCache(-1)


def test_sessions_as_the_reference():
    xs = [10.0, 20.0, 30.0, 40.0, 50.0, 7.5]
    for p in (0, 25, 50, 99, 100):
        assert percentile(xs, p) == jsessions.percentile(xs, p)
    with pytest.raises(ValueError):
        percentile([], 50)
    assert summarize_ttft([])["n"] == 0
    assert np.isnan(summarize_ttft([])["p50_ms"])
    from repro_torch.serving import Session
    s = [Session(0, [1], 0.0, 0.25), Session(1, [1], 0.1, 0.2),
         Session(2, [1], 0.2, None, RuntimeError("x"))]
    js = [jsessions.Session(r.sid, r.block_ids, r.arrival_s,
                            r.t_first_token, r.error) for r in s]
    assert summarize_ttft(s) == jsessions.summarize_ttft(js)
    assert [r.done for r in s] == [True, True, True]


# ---------------------------------------------------------------------------
# DecodeScheduler
# ---------------------------------------------------------------------------


def test_scheduler_against_fetch_and_the_reference(tmp_path):
    """Sessions fetch one after another (one tick each): the blocks equal
    ``pager.fetch`` and the reference's decode of the same archives, and
    the stats equal the reference scheduler's for the same requests."""
    pager = KVPager(str(tmp_path / "port"), codec=_codec())
    jpager = JKVPager(str(tmp_path / "jax"), codec=_jcodec())
    ids = _offload_blocks(pager, n=4)
    assert _offload_blocks(jpager, n=4, jax_side=True) == ids
    for bid in ids:
        assert open(pager.block_meta(bid)["path"], "rb").read() == \
            open(jpager.block_meta(bid)["path"], "rb").read()
    direct = {bid: pager.fetch(bid) for bid in ids}
    sequence = [(0, ids[:2]), (1, ids[1:3]), (2, ids), (3, [ids[3]] * 2)]
    stats = []
    for sched_cls, pg, chk in ((DecodeScheduler, pager, True),
                               (jscheduler.DecodeScheduler, jpager, False)):
        with sched_cls(pg, batch_window_s=0.0) as sched:
            for sid, want in sequence:
                got = sched.fetch(sid, want)
                for bid in want:
                    for name, t in got[bid].items():
                        if chk:
                            assert torch.equal(t, direct[bid][name])
                        else:
                            assert as_bytes(direct[bid][name]) == \
                                np.asarray(t).tobytes()
        # Read once the worker has stopped: a tick resolves its requests'
        # futures before it counts itself, in both packages.
        stats.append(dict(sched.stats))
        cache_stats = dict(sched.cache.stats)
    assert stats[0] == stats[1]
    assert stats[0]["blocks_decoded"] == 4
    assert cache_stats["inserts"] == 4


@pytest.mark.parametrize("overlap", [True, False])
def test_shared_content_decodes_once(tmp_path, overlap):
    pager = KVPager(str(tmp_path), codec=_codec())
    ids = _offload_blocks(pager, n=2, seed=7)
    twin_src = KVPager(str(tmp_path) + "_twin", codec=_codec())
    twin_ids = _offload_blocks(twin_src, n=2, seed=7)
    twin_map = {}
    for bid in twin_ids:
        twin_map[bid] = 100 + bid
        pager.adopt_block(100 + bid, twin_src.block_meta(bid))
    direct = {bid: pager.fetch(bid) for bid in ids}
    n_sessions = 6
    with DecodeScheduler(pager, batch_window_s=0.02,
                         overlap=overlap) as sched:
        futs = []
        for sid in range(n_sessions):
            wanted = ids if sid % 2 == 0 else [twin_map[b] for b in twin_ids]
            futs += [(wanted[i % 2] % 100, sched.submit(sid, b))
                     for i, b in enumerate(wanted)]
        for bid, f in futs:
            for name, t in f.result().items():
                assert torch.equal(t, direct[bid][name])
        st = dict(sched.stats)
    assert st["blocks_decoded"] == 2
    assert st["requests"] == n_sessions * 2
    assert st["prefix_hits"] + st["coalesced_requests"] == n_sessions * 2 - 2
    assert (sched._stage_stream is None)


def test_lost_block_fails_only_its_futures(tmp_path):
    pager = KVPager(str(tmp_path), codec=_codec())
    ids = _offload_blocks(pager, n=2)
    os.unlink(pager.block_meta(ids[0])["path"])
    with DecodeScheduler(pager, batch_window_s=0.001) as sched:
        bad = sched.submit(0, ids[0])
        good = sched.submit(1, ids[1])
        assert good.result()
        with pytest.raises(PageLostError):
            bad.result()
        assert sched.stats["blocks_lost"] == 1
    assert pager.stats["pages_lost"] == 1


def test_fairness_cap_defers_large_sessions(tmp_path):
    pager = KVPager(str(tmp_path), codec=_codec())
    ids = _offload_blocks(pager, n=4)
    with DecodeScheduler(pager, batch_window_s=0.05,
                         max_blocks_per_session_per_tick=1) as sched:
        futs = [sched.submit(0, bid) for bid in ids]
        futs.append(sched.submit(1, ids[0]))
        for f in futs:
            f.result()
        assert sched.stats["deferred"] >= 1 and sched.stats["ticks"] >= 4


def test_scheduler_lifecycle_and_knobs(tmp_path):
    pager = KVPager(str(tmp_path), codec=_codec())
    ids = _offload_blocks(pager, n=1)
    sched = DecodeScheduler(pager, batch_window_s=0.001)
    sched.close()
    with pytest.raises(RuntimeError):
        sched.submit(0, ids[0])
    with pytest.raises(ValueError):
        DecodeScheduler(pager, batch_window_s=-1)
    with pytest.raises(ValueError):
        DecodeScheduler(pager, max_blocks_per_session_per_tick=0)
    assert set(DecodeScheduler.__init__.__code__.co_varnames) >= {
        "batch_window_s", "cache_bytes", "overlap",
        "max_blocks_per_session_per_tick"}


# ---------------------------------------------------------------------------
# The load generator
# ---------------------------------------------------------------------------


def test_loadgen_corpus_as_the_reference(tmp_path):
    kw = dict(n_sessions=3, prefix_blocks=2, unique_blocks=1,
              tokens_per_block=4, seed=0)
    corpus = build_corpus(str(tmp_path / "port"),
                          config=CodecConfig(backend="ref"), **kw)
    jcorpus = jloadgen.build_corpus(str(tmp_path / "jax"), **kw)
    assert corpus.prefix_ids == jcorpus.prefix_ids
    assert corpus.unique_ids == jcorpus.unique_ids
    assert corpus.n_distinct_blocks == jcorpus.n_distinct_blocks == 5
    assert corpus.n_block_requests == jcorpus.n_block_requests == 9
    for bid, meta in jcorpus.metas.items():
        assert open(corpus.metas[bid]["path"], "rb").read() == \
            open(meta["path"], "rb").read()
    with pytest.raises(ValueError):
        run_load(corpus, mode="warp")


def test_loadgen_invariants_end_to_end(tmp_path):
    corpus = build_corpus(str(tmp_path), n_sessions=6, prefix_blocks=2,
                          unique_blocks=1, tokens_per_block=4, seed=0,
                          config=CodecConfig(backend="ref"))
    base = run_load(corpus, mode="baseline", rate_per_s=2000.0, seed=0)
    schd = run_load(corpus, mode="scheduler", rate_per_s=2000.0, seed=0,
                    batch_window_s=0.005)
    check_invariants(corpus, base, schd)
    assert set(schd) == {"mode", "overlap", "wall_s", "ttft",
                         "block_requests", "decode_dispatches",
                         "plan_builds", "dispatches_per_request", "pager",
                         "scheduler", "cache"}


def test_loadgen_check_at_its_defaults(capsys):
    base, schd = loadgen.main(["--backend", "ref", "--check"])
    out = capsys.readouterr().out
    assert "CHECK OK" in out
    assert schd["scheduler"]["blocks_decoded"] == 104
    assert schd["decode_dispatches"] < base["decode_dispatches"]


# ---------------------------------------------------------------------------
# serve.main's KV paths
# ---------------------------------------------------------------------------

_SERVE = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2",
          "--prompt-len", "16", "--gen-len", "3", "--device", "cpu",
          "--kv-backend", "ref"]


def test_serve_offload_concurrency_gives_equal_tokens(tmp_path):
    plain = serve.main(_SERVE)
    one = serve.main(_SERVE + ["--kv-offload", "--kv-block", "4",
                               "--kv-offload-dir", str(tmp_path / "a")])
    two = serve.main(_SERVE + ["--kv-offload", "--kv-block", "4",
                               "--concurrency", "2",
                               "--kv-offload-dir", str(tmp_path / "b")])
    np.testing.assert_array_equal(one["tokens"], two["tokens"])
    assert one["tokens"].shape == plain["tokens"].shape == (2, 4)
    assert one["kv_err"] == two["kv_err"] and 0 < one["kv_err"] < 0.05
    assert one["ratio"] == two["ratio"] > 0
    st = two["page_stats"]["scheduler"]
    assert st["blocks_decoded"] == 4 and st["requests"] == 8
    assert st["prefix_hits"] + st["coalesced_requests"] == 4
    assert "scheduler" not in one["page_stats"]
    assert one["page_stats"]["pages_out"] == 4
    for name in ("a", "b"):
        assert sorted(os.listdir(tmp_path / name)) == [
            f"block_{i:06d}.szt" for i in range(4)]


def test_serve_compress_kv_and_recovery(tmp_path):
    r = serve.main(_SERVE + ["--compress-kv"])
    assert r["ratio"] > 0 and 0 < r["kv_err"] < 0.05
    assert r["page_stats"] is None
    r = serve.main(_SERVE + ["--kv-offload", "--kv-recovery", "skip",
                             "--kv-block", "8"])
    assert r["page_stats"]["pages_lost"] == 0


# ---------------------------------------------------------------------------
# Every public name of the slice's reference modules has a twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "repro.checkpoint.manager", "repro.testing", "repro.testing.faults",
    "repro.models.kvcache", "repro.serving", "repro.serving.loadgen",
    "repro.serving.prefix_cache", "repro.serving.scheduler",
    "repro.serving.sessions", "repro.distributed",
    "repro.distributed.partition", "repro.distributed.shards",
    "repro.distributed.restore", "repro.runtime.sharding",
    "repro.runtime.pspec", "repro.runtime.collectives",
    "repro.launch.mesh"])
def test_every_public_name_has_a_twin(name):
    import importlib
    import types

    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    missing = [n for n, v in vars(ref).items()
               if not n.startswith("_")
               and not (isinstance(v, types.ModuleType)
                        and not v.__name__.startswith(name + "."))
               and not hasattr(port, n)]
    assert not missing, missing
