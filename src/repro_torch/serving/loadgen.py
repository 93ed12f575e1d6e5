"""Poisson-arrival load generator: the "millions of users" story, measured.

Port of ``src/repro/serving/loadgen.py``.  The corpus's KV tensors are
drawn with numpy from the seed (the reference's values) and offloaded
from the codec's device; ``--backend`` picks the decode backend of the
run ("cuda", the default: the card; "ref": the CPU).

Builds a corpus of offloaded KV blocks -- a hot prompt prefix shared by
every session plus per-session unique blocks -- then replays N concurrent
sessions against either:

* ``mode="baseline"`` -- the pre-scheduler serving shape: each session
  demand-pages its blocks synchronously on its own critical path
  (``KVPager.fetch`` per block, per session; the shared prefix is
  re-decoded by every session), or
* ``mode="scheduler"`` -- the ``DecodeScheduler``: requests within a
  batching window coalesce into class-merged dispatches, tick N+1 stages
  while tick N decodes, and the shared prefix decodes exactly once.

Reports p50/p99 time-to-first-token and decode dispatches per request.
Structural invariants (decode-once, dispatch reduction) are deterministic
under a fixed seed and asserted by ``--check`` (the smoke tier) and by
``tests/test_torch_serving.py``; ``chip_smoke.py`` prints the latency
percentiles of a run on the card.

Usage:
  PYTHONPATH=src python -m repro_torch.serving.loadgen --sessions 100 \\
      --seed 0 --check
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.serving.scheduler import DecodeScheduler
from repro_torch.serving.sessions import Session, summarize_ttft
from repro_torch.store.paging import KVPager


@dataclasses.dataclass
class Corpus:
    """Offloaded KV blocks on disk + who needs which."""

    dir: str
    config: CodecConfig
    metas: dict                  # block_id -> pager meta (adoptable)
    prefix_ids: list             # blocks every session shares
    unique_ids: dict             # sid -> this session's own blocks

    @property
    def n_sessions(self) -> int:
        return len(self.unique_ids)

    def session_blocks(self, sid: int) -> list:
        return list(self.prefix_ids) + list(self.unique_ids[sid])

    @property
    def n_distinct_blocks(self) -> int:
        return len(self.prefix_ids) + sum(
            len(v) for v in self.unique_ids.values())

    @property
    def n_block_requests(self) -> int:
        return sum(len(self.session_blocks(s)) for s in self.unique_ids)


def _kv_tensors(rng, n_tokens: int, layers: int, heads: int, dim: int,
                device="cpu"):
    """A smooth-along-S synthetic KV pair, shaped like ``models/decode``,
    on ``device``."""
    shape = (layers, 1, n_tokens, heads, dim)
    walk = np.cumsum(rng.normal(size=shape).astype(np.float32), axis=2)
    k = 0.1 * walk
    v = 0.1 * walk[::-1] + rng.normal(size=shape).astype(np.float32) * 0.01
    return {"k": torch.from_numpy(np.ascontiguousarray(k)).to(device),
            "v": torch.from_numpy(np.ascontiguousarray(v)).to(device)}


def build_corpus(directory: str, *, n_sessions: int = 100,
                 prefix_blocks: int = 4, unique_blocks: int = 1,
                 tokens_per_block: int = 8, layers: int = 2, heads: int = 2,
                 head_dim: int = 8, seed: int = 0,
                 config: "CodecConfig | None" = None) -> Corpus:
    """Offload the shared prefix + per-session blocks into one pager dir
    (the KV tensors made on the codec's device)."""
    config = config if config is not None else CodecConfig()
    pager = KVPager(directory, codec=Codec(config))
    device = pager.codec.device
    rng = np.random.default_rng(seed)

    prefix_ids = []
    cache = _kv_tensors(rng, prefix_blocks * tokens_per_block, layers,
                        heads, head_dim, device)
    for i in range(prefix_blocks):
        cache, bid = pager.offload(cache, i * tokens_per_block,
                                   (i + 1) * tokens_per_block)
        prefix_ids.append(bid)

    unique_ids: dict = {}
    for sid in range(n_sessions):
        cache = _kv_tensors(rng, unique_blocks * tokens_per_block, layers,
                            heads, head_dim, device)
        ids = []
        for i in range(unique_blocks):
            cache, bid = pager.offload(cache, i * tokens_per_block,
                                       (i + 1) * tokens_per_block)
            ids.append(bid)
        unique_ids[sid] = ids

    metas = {bid: pager.block_meta(bid) for bid in pager.resident_blocks}
    return Corpus(dir=directory, config=config, metas=metas,
                  prefix_ids=prefix_ids, unique_ids=unique_ids)


def run_load(corpus: Corpus, *, mode: str = "scheduler",
             rate_per_s: float = 400.0, seed: int = 0,
             batch_window_s: float = 0.002, cache_bytes: int = 1 << 30,
             overlap: bool = True,
             max_blocks_per_session_per_tick: int = 8) -> dict:
    """Replay the corpus' sessions with Poisson arrivals; returns metrics.

    A fresh ``Codec`` (fresh plan cache) + ``KVPager`` are built per run so
    baseline and scheduler modes start equally cold.
    """
    if mode not in ("baseline", "scheduler"):
        raise ValueError(f"unknown mode {mode!r}; valid: baseline, "
                         f"scheduler")
    codec = Codec(corpus.config)
    pager = KVPager(corpus.dir, codec=codec)
    for bid, meta in corpus.metas.items():
        pager.adopt_block(bid, meta)

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_per_s,
                                         corpus.n_sessions))
    sessions = [Session(sid=sid, block_ids=corpus.session_blocks(sid),
                        arrival_s=float(t))
                for sid, t in zip(sorted(corpus.unique_ids), arrivals)]

    sched = (DecodeScheduler(
        pager, batch_window_s=batch_window_s, cache_bytes=cache_bytes,
        overlap=overlap,
        max_blocks_per_session_per_tick=max_blocks_per_session_per_tick)
        if mode == "scheduler" else None)

    def worker(s: Session, t0: float):
        try:
            if sched is not None:
                sched.fetch(s.sid, s.block_ids)
            else:
                for bid in s.block_ids:
                    pager.fetch(bid)
            s.mark_served(t0)
        except Exception as e:       # lost blocks -> failed session, counted
            s.error = e

    before = dict(codec.backend.stats)
    threads = []
    t0 = time.perf_counter()
    for s in sessions:
        delay = t0 + s.arrival_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        s.arrival_s = time.perf_counter() - t0   # actual spawn offset
        th = threading.Thread(target=worker, args=(s, t0), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    wall_s = time.perf_counter() - t0
    if sched is not None:
        sched.close()
    delta = {k: codec.backend.stats[k] - before.get(k, 0)
             for k in codec.backend.stats}

    n_req = corpus.n_block_requests
    out = {
        "mode": mode, "overlap": overlap, "wall_s": wall_s,
        "ttft": summarize_ttft(sessions),
        "block_requests": n_req,
        "decode_dispatches": delta["decode_write_dispatches"],
        "plan_builds": delta["plan_builds"],
        "dispatches_per_request":
            delta["decode_write_dispatches"] / max(n_req, 1),
        "pager": dict(pager.stats),
    }
    if sched is not None:
        out["scheduler"] = dict(sched.stats)
        out["cache"] = dict(sched.cache.stats)
    return out


def check_invariants(corpus: Corpus, base: dict, schd: dict):
    """The structural wins the scheduler must deliver, deterministically.

    Raises ``AssertionError`` naming the violated invariant; timing
    percentiles are deliberately NOT checked here (CI timers are noisy) --
    the benchmark records them.
    """
    for r in (base, schd):
        assert r["ttft"]["failed"] == 0, \
            f"{r['mode']}: {r['ttft']['failed']} sessions failed"
        assert r["ttft"]["n"] == corpus.n_sessions, \
            f"{r['mode']}: served {r['ttft']['n']} of {corpus.n_sessions}"
    st = schd["scheduler"]
    assert st["blocks_decoded"] == corpus.n_distinct_blocks, (
        f"every distinct block must decode exactly once: decoded "
        f"{st['blocks_decoded']}, distinct {corpus.n_distinct_blocks}")
    shared = (corpus.n_sessions - 1) * len(corpus.prefix_ids)
    got = st["prefix_hits"] + st["coalesced_requests"]
    assert got == shared, (
        f"shared-prefix requests must be served without re-decode: "
        f"hits+coalesced = {got}, expected {shared}")
    assert schd["decode_dispatches"] < base["decode_dispatches"], (
        f"batching must reduce decode dispatches: scheduler "
        f"{schd['decode_dispatches']} vs baseline "
        f"{base['decode_dispatches']}")


def _fmt(r: dict) -> str:
    t = r["ttft"]
    return (f"[loadgen] {r['mode']:<9} overlap={str(r['overlap']):<5} "
            f"n={t['n']} failed={t['failed']} "
            f"ttft p50={t['p50_ms']:.1f}ms p99={t['p99_ms']:.1f}ms "
            f"dispatches/req={r['dispatches_per_request']:.3f} "
            f"wall={r['wall_s']:.2f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Poisson load generator for the serving scheduler")
    ap.add_argument("--sessions", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=400.0,
                    help="mean session arrivals per second")
    ap.add_argument("--prefix-blocks", type=int, default=4)
    ap.add_argument("--unique-blocks", type=int, default=1)
    ap.add_argument("--tokens-per-block", type=int, default=8)
    ap.add_argument("--batch-window", type=float, default=0.002,
                    help="scheduler batching window (seconds)")
    ap.add_argument("--cache-mib", type=float, default=1024.0,
                    help="decoded-block cache capacity")
    ap.add_argument("--backend", default=None, choices=["cuda", "ref"],
                    help="decode backend (default: the CodecConfig "
                         "default, cuda on the card; ref: the CPU)")
    ap.add_argument("--check", action="store_true",
                    help="assert the structural invariants (CI smoke): "
                         "decode-once, prefix sharing, dispatch reduction")
    args = ap.parse_args(argv)
    config = (CodecConfig() if args.backend is None
              else CodecConfig(backend=args.backend))

    with tempfile.TemporaryDirectory(prefix="serving_loadgen_") as d:
        corpus = build_corpus(d, n_sessions=args.sessions,
                              prefix_blocks=args.prefix_blocks,
                              unique_blocks=args.unique_blocks,
                              tokens_per_block=args.tokens_per_block,
                              seed=args.seed, config=config)
        base = run_load(corpus, mode="baseline", rate_per_s=args.rate,
                        seed=args.seed)
        schd = run_load(corpus, mode="scheduler", rate_per_s=args.rate,
                        seed=args.seed, batch_window_s=args.batch_window,
                        cache_bytes=int(args.cache_mib * 2**20))
        print(_fmt(base))
        print(_fmt(schd))
        st = schd["scheduler"]
        print(f"[loadgen] scheduler: ticks={st['ticks']} "
              f"batch_dispatches={st['batch_dispatches']} "
              f"blocks_decoded={st['blocks_decoded']} "
              f"prefix_hits={st['prefix_hits']} "
              f"coalesced={st['coalesced_requests']} "
              f"deferred={st['deferred']}")
        if args.check:
            check_invariants(corpus, base, schd)
            print("[loadgen] CHECK OK: decode-once, prefix sharing, "
                  "dispatch reduction all hold")
    return base, schd


if __name__ == "__main__":
    main()
