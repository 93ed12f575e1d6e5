"""Continuous batching of KV page-in decode streams across sessions.

Port of ``src/repro/serving/scheduler.py``, with the same design, knobs and
``stats`` keys.  On the card the overlap is on CUDA streams as well as
threads: the I/O thread stages a tick (archive read, CRC, the H2D copies
and the plan builds, which launch ``count_subseq``) on a stream of its own
and records an event after it; the scheduler thread's decode stream waits
on that event, and every staged tensor is marked with ``record_stream``
for the decode stream before the decode reads it, so the caching
allocator cannot hand its memory to the next stage while the decode still
reads it.

``serve --kv-offload`` demand-pages one session's blocks synchronously on
its own critical path: every block is one archive open + one decode
dispatch chain, and the decoder idles between requests.  The paper's whole
premise is the opposite -- keep the decoder saturated with few, large
dispatches.  ``DecodeScheduler`` applies that to serving:

* **continuous batching** -- page-in requests from many concurrent
  sessions that arrive within one ``batch_window_s`` coalesce into a tick;
  each tick decodes through ONE class-merged ``decompress_batch`` over
  every tensor of every requested block (``KVPager.decode_staged``), so
  dispatch count scales with CR classes per tick, not with sessions.
* **async double buffering** -- the store reader already overlaps disk
  reads with decode *within* one archive; the scheduler extends that
  across requests: tick N+1's host stage (archive read + CRC + plan
  resolution, on the I/O thread) runs while tick N's device decode runs
  on the scheduler thread, so session N+1's blocks are staged while
  session N computes.
* **prefix-aware sharing** -- blocks are identified by content
  (``KVPager.block_key``); a hot shared prompt prefix decodes exactly
  once into the refcounted ``BlockCache`` and every later session is
  served from memory (``stats["prefix_hits"]``).
* **fairness / admission** -- at most ``max_blocks_per_session_per_tick``
  blocks of one session enter a tick (the rest stay queued, counted in
  ``stats["deferred"]``), so a 1-block session is never starved behind a
  1000-block restore; the decoded pool is capacity-bounded with LRU
  eviction and pinned-in-flight protection (``prefix_cache.BlockCache``).

Failures stay named: a lost block (``PageLostError`` -- missing / corrupt
/ guard-tripped archive, already evicted + counted by the pager) fails
only the futures of the sessions that asked for it; batch-mates decode on.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import dataclasses
import threading
import time

import torch

from repro_torch.serving.prefix_cache import BlockCache
from repro_torch.store.paging import KVPager, PageLostError

DEFAULT_BATCH_WINDOW_S = 0.002


@dataclasses.dataclass
class _Request:
    sid: int
    block_id: int
    future: futures.Future
    t_submit: float


@dataclasses.dataclass
class _Tick:
    """One batching round: cache hits already resolved (pinned until the
    tick retires), misses staging on the I/O thread."""

    hit_keys: list                    # pinned cache keys to release
    misses: dict                      # key -> (block_id, [requests])
    # -> ({key: StagedBlock | PageLostError}, stage event or None)
    staged: "futures.Future | None"


def _tensors(obj):
    """Every tensor of a staged block: its ``Compressed`` payloads and
    their plans (dataclasses, lists and tuples walked)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)


class DecodeScheduler:
    """Batch + overlap + dedupe KV page-in decodes for many sessions.

    One scheduler owns one shared ``Codec`` + ``KVPager`` (the pager's
    codec): requests from any thread via :meth:`submit` return futures that
    resolve to the block's decoded tensors ``{name: tensor}`` on the
    pager's device.

    ``overlap=False`` degrades to stage-then-decode on one thread and one
    stream (the ablation the serving benchmark measures); batching and
    sharing remain.
    """

    def __init__(self, pager: KVPager, *,
                 batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
                 cache_bytes: int = 1 << 30,
                 max_blocks_per_session_per_tick: int = 8,
                 overlap: bool = True):
        if batch_window_s < 0:
            raise ValueError(
                f"batch_window_s must be >= 0, got {batch_window_s}")
        if max_blocks_per_session_per_tick < 1:
            raise ValueError("max_blocks_per_session_per_tick must be >= 1, "
                             f"got {max_blocks_per_session_per_tick}")
        self.pager = pager
        self.codec = pager.codec
        self.cache = BlockCache(cache_bytes)
        self.batch_window_s = batch_window_s
        self.fair_cap = max_blocks_per_session_per_tick
        self.overlap = overlap
        self.stats = {"requests": 0, "ticks": 0, "batch_dispatches": 0,
                      "blocks_decoded": 0, "prefix_hits": 0,
                      "coalesced_requests": 0, "deferred": 0,
                      "blocks_lost": 0, "max_tick_requests": 0}
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        # key -> the (shared, mutable) request list of an in-flight decode:
        # requests for a block whose decode is already staged/decoding JOIN
        # it instead of re-staging (scheduler thread only -- no lock).
        self._pending: dict = {}
        self._stopping = False
        self._io = (futures.ThreadPoolExecutor(
            1, thread_name_prefix="serving-stage") if overlap else None)
        device = self.codec.device
        self._stage_stream = (torch.cuda.Stream(device=device)
                              if overlap and device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-scheduler")
        self._thread.start()

    # -- client surface ------------------------------------------------------

    def submit(self, sid: int, block_id: int) -> futures.Future:
        """Enqueue one block page-in for a session; returns a future that
        resolves to ``{name: decoded tensor}`` or raises ``PageLostError``.
        """
        fut: futures.Future = futures.Future()
        with self._cond:
            if self._stopping:
                raise RuntimeError("DecodeScheduler is closed")
            self._queue.append(_Request(sid, block_id, fut,
                                        time.perf_counter()))
            self.stats["requests"] += 1
            self._cond.notify_all()
        return fut

    def fetch(self, sid: int, block_ids) -> dict:
        """Blocking convenience: submit every block and wait.  Returns
        {block_id: {name: array}}; the first lost block raises."""
        futs = [(bid, self.submit(sid, bid)) for bid in block_ids]
        return {bid: f.result() for bid, f in futs}

    def close(self):
        """Drain the queue, retire in-flight ticks, stop the thread."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join()
        if self._io is not None:
            self._io.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- scheduler loop ------------------------------------------------------

    def _run(self):
        inflight: collections.deque = collections.deque()
        while True:
            batch = self._collect(bool(inflight))
            if batch:
                inflight.append(self._assemble(batch))
            # Keep exactly one tick staging in the background under
            # sustained load (decode of tick N overlaps stage of tick N+1);
            # drain fully when traffic pauses.
            while inflight and (len(inflight) > 1 or not batch):
                self._finish(inflight.popleft())
            with self._cond:
                if self._stopping and not self._queue and not inflight:
                    return

    def _collect(self, have_inflight: bool) -> list:
        """Wait for traffic, let the batching window coalesce arrivals,
        then drain the queue under the per-session fairness cap."""
        with self._cond:
            if not self._queue and not have_inflight and not self._stopping:
                while not self._queue and not self._stopping:
                    self._cond.wait(0.1)
            elif not self._queue and not self._stopping:
                # Inflight ticks exist: bounded wait so they retire even if
                # no more traffic arrives.
                self._cond.wait(self.batch_window_s or 0.001)
        if self.batch_window_s > 0 and not self._stopping:
            time.sleep(self.batch_window_s)
        with self._cond:
            taken: list = []
            left: collections.deque = collections.deque()
            per_sid: collections.Counter = collections.Counter()
            while self._queue:
                r = self._queue.popleft()
                if per_sid[r.sid] < self.fair_cap:
                    per_sid[r.sid] += 1
                    taken.append(r)
                else:
                    left.append(r)
            self.stats["deferred"] += len(left)
            self._queue = left
        if taken:
            self.stats["max_tick_requests"] = max(
                self.stats["max_tick_requests"], len(taken))
        return taken

    def _assemble(self, reqs: list) -> _Tick:
        """Group a tick's requests by block *content*, resolve cache hits
        immediately (best TTFT), kick off staging for the misses."""
        by_key: dict = {}
        for r in reqs:
            try:
                key = self.pager.block_key(r.block_id)
            except PageLostError as e:
                self.stats["blocks_lost"] += 1
                r.future.set_exception(e)
                continue
            if key in by_key:
                by_key[key][1].append(r)
            else:
                by_key[key] = (r.block_id, [r])
        hit_keys, misses = [], {}
        for key, (bid, rs) in by_key.items():
            pending = self._pending.get(key)
            if pending is not None:
                # A previous tick is already decoding this content: join it
                # (continuous batching across ticks, decode still happens
                # exactly once).
                self.stats["prefix_hits"] += len(rs)
                pending.extend(rs)
                continue
            val = self.cache.acquire(key)
            if val is not None:
                self.stats["prefix_hits"] += len(rs)
                for r in rs:
                    r.future.set_result(val)
                hit_keys.append(key)
            else:
                # One decode serves every same-tick duplicate of this key.
                self.stats["coalesced_requests"] += len(rs) - 1
                misses[key] = (bid, rs)
                self._pending[key] = rs
        staged = (self._io.submit(self._stage_overlapped, misses)
                  if self._io is not None and misses else None)
        return _Tick(hit_keys=hit_keys, misses=misses, staged=staged)

    def _stage_keys(self, misses: dict) -> dict:
        """Host stage (I/O thread): archive read + CRC + plan per miss.
        Failures travel as values -- the scheduler thread applies them."""
        out = {}
        for key, (bid, _) in misses.items():
            try:
                out[key] = self.pager.stage(bid)
            except PageLostError as e:
                out[key] = e
        return out

    def _stage_overlapped(self, misses: dict) -> tuple:
        """``_stage_keys`` on the I/O thread: on the card, on the stage
        stream, with an event recorded after it (else ``None``)."""
        if self._stage_stream is None:
            return self._stage_keys(misses), None
        with torch.cuda.stream(self._stage_stream):
            out = self._stage_keys(misses)
            ready = torch.cuda.Event()
            ready.record(self._stage_stream)
        return out, ready

    def _finish(self, tick: _Tick):
        """Decode a tick's staged misses in one merged dispatch set, publish
        results, unpin everything the tick touched."""
        if tick.staged is None:
            staged = self._stage_keys(tick.misses)
        else:
            staged, ready = tick.staged.result()
            if ready is not None:
                # The decode stream reads what the stage stream wrote: wait
                # for it, and keep the allocator from reusing those tensors
                # before the decode stream is done with them.
                decode = torch.cuda.current_stream(self.codec.device)
                decode.wait_event(ready)
                for t in _tensors(list(staged.values())):
                    t.record_stream(decode)
        ok = {k: s for k, s in staged.items()
              if not isinstance(s, Exception)}
        lost = {k: e for k, e in staged.items() if isinstance(e, Exception)}

        decode_lost: dict = {}
        decoded = self.pager.decode_staged(
            ok.values(),
            on_lost=lambda bid, e: decode_lost.setdefault(bid, e))
        if ok:
            self.stats["batch_dispatches"] += 1

        for key, sb in ok.items():
            tensors = decoded.get(sb.block_id)
            if tensors is None:
                lost[key] = decode_lost.get(sb.block_id) or PageLostError(
                    f"kv block {sb.block_id} lost in decode",
                    block_id=sb.block_id)
                continue
            self.stats["blocks_decoded"] += 1
            self.cache.insert(key, tensors, sb.decoded_bytes, pinned=True)
            # The pending list may have grown since assembly: later ticks'
            # requests joined this decode instead of re-staging.
            for r in self._pending.pop(key, tick.misses[key][1]):
                r.future.set_result(tensors)
        for key, e in lost.items():
            self.stats["blocks_lost"] += 1
            for r in self._pending.pop(key, tick.misses[key][1]):
                r.future.set_exception(e)

        for key in tick.hit_keys:
            self.cache.release(key)
        for key in ok:
            self.cache.release(key)
        self.stats["ticks"] += 1
