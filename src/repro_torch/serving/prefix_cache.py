"""Refcounted decoded-block cache: hot shared prefixes decode once.

Port of ``src/repro/serving/prefix_cache.py`` (plain Python; decoded
blocks are ``{name: tensor}`` dicts on the pager's device).

Serving traffic is prefix-heavy: thousands of sessions open with the same
system prompt, so their first KV page-ins all name blocks with identical
*content* (``KVPager.block_key`` -- the sorted (tensor name, chunk digest)
pairs of a block's archive).  ``BlockCache`` keys decoded blocks by that
content identity, so the first session's decode serves every later session
from memory and the scheduler's "decoded exactly once per distinct block"
invariant holds under arbitrary interleaving.

Admission / eviction policy (the compressed pool is bounded):

* **capacity** -- decoded bytes are bounded by ``capacity_bytes``; inserts
  evict least-recently-used entries to make room.
* **pinned-in-flight protection** -- entries referenced by an in-flight
  scheduler tick are pinned (refcounted) and NEVER evicted, so capacity
  pressure from one tick cannot thrash a block another tick is about to
  hand out (which would silently break decode-once).
* **admission** -- a block larger than the whole capacity is served but
  not cached (``stats["admission_rejects"]``), instead of wiping the
  cache for one oversized tenant.

Thread-safe; all operations are O(1) amortized.
"""

from __future__ import annotations

import collections
import dataclasses
import threading


@dataclasses.dataclass
class _Entry:
    value: dict          # {tensor name: decoded tensor}
    nbytes: int
    pins: int = 0


class BlockCache:
    """LRU cache of decoded KV blocks with refcount (pin) protection."""

    def __init__(self, capacity_bytes: int = 1 << 30):
        if capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "inserts": 0, "evictions": 0,
                      "admission_rejects": 0, "resident_bytes": 0}

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def __contains__(self, key):
        with self._lock:
            return key in self._entries

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self.stats["resident_bytes"]

    def acquire(self, key):
        """Look up + pin in one step.  Returns the decoded block (pinned:
        caller must ``release``) or ``None`` on a miss (counted)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.stats["misses"] += 1
                return None
            self._entries.move_to_end(key)
            e.pins += 1
            self.stats["hits"] += 1
            return e.value

    def insert(self, key, value: dict, nbytes: int, *,
               pinned: bool = True) -> bool:
        """Insert a freshly decoded block (pinned by default: the inserting
        tick is still in flight).  Returns False when admission rejects it
        (larger than the whole cache) or the key is already present (the
        existing entry wins and is pinned instead -- two ticks may race to
        decode the same content when it was evicted between them).
        """
        with self._lock:
            if nbytes > self.capacity_bytes:
                self.stats["admission_rejects"] += 1
                return False
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                if pinned:
                    e.pins += 1
                return False
            self._entries[key] = _Entry(value, int(nbytes),
                                        1 if pinned else 0)
            self.stats["inserts"] += 1
            self.stats["resident_bytes"] += int(nbytes)
            self._evict_locked()
            return True

    def release(self, key):
        """Unpin one reference; unknown keys (already evicted after their
        pins dropped) are ignored."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.pins > 0:
                e.pins -= 1
            self._evict_locked()

    def _evict_locked(self):
        """Evict LRU *unpinned* entries until within capacity.  If every
        resident entry is pinned the cache may transiently exceed capacity
        -- in-flight ticks always win over the bound."""
        if self.stats["resident_bytes"] <= self.capacity_bytes:
            return
        for key in list(self._entries):
            if self.stats["resident_bytes"] <= self.capacity_bytes:
                break
            e = self._entries[key]
            if e.pins > 0:
                continue
            del self._entries[key]
            self.stats["resident_bytes"] -= e.nbytes
            self.stats["evictions"] += 1
