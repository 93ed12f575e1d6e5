"""Plan / LUT cache and the content digests that key it.

Port of ``src/repro/core/cache.py``.  The digests hash the same bytes as the
reference's (tensors are copied to the host first), so a payload has the
same ``compressed_digest`` in both packages.  ``PlanCache`` holds two maps:

* **codebooks** -- codebook digest -> materialized ``Codebook`` (decode LUT
  included), built on first use (``get_codebook``; ``lut_hits`` /
  ``lut_misses``).  Archives store only the encoder tables, so every chunk
  and archive with the same histogram shares one LUT.
* **plans** -- (chunk digest, method, t_high) -> ``DecoderPlan`` with LRU
  eviction and single-flight builds.  ``t_high`` is in the key, as in the
  reference, so a cached plan's CR classes (built from it when first read)
  are never those of another ``t_high``.

``DEFAULT_PLAN_CACHE`` is the process-wide cache of the default ``Codec``.
"""

from __future__ import annotations

import collections
import hashlib
import struct
import threading
import zlib

import numpy as np
import torch


def _host(a):
    """numpy view of a tensor (copied to the host) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def crc32_arrays(*arrays) -> int:
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(_host(a)).tobytes(), crc)
    return crc & 0xFFFFFFFF


def payload_crc(units, gaps, outlier_pos, outlier_val) -> int:
    """Canonical CRC of a compressed payload: units, gaps, and only the
    VALID outlier prefix (``pos >= 0``).

    The outlier side list is padded to a power-of-two length, but that
    width is a storage detail, not content: different producers (host vs
    device encode backends, archive round-trips, re-padded copies) may
    materialize different pad widths for the same logical payload.  Hashing
    the valid prefix keeps the digest -- and therefore every plan-cache key
    -- identical across all of them.
    """
    pos = _host(outlier_pos).astype(np.int32)
    val = _host(outlier_val).astype(np.int32)
    n = int((pos >= 0).sum())
    return crc32_arrays(_host(units).astype(np.uint32),
                        _host(gaps).astype(np.uint8), pos[:n], val[:n])


def codebook_digest(enc_code, enc_len, max_len: int) -> str:
    """Content digest of a codebook (the dedup + LUT-cache key).

    The encoder tables fully determine the canonical decode LUT, so hashing
    (enc_code, enc_len, max_len) is sufficient.
    """
    h = hashlib.sha1()
    h.update(np.asarray(enc_code, np.uint32).tobytes())
    h.update(np.asarray(enc_len, np.uint8).tobytes())
    h.update(struct.pack("<I", max_len))
    return h.hexdigest()


def chunk_digest(payload_crc: int, total_bits: int, n_symbols: int,
                 subseqs_per_seq: int, codebook_digest_: str) -> str:
    """Stable identity of a chunk's *decode problem* (the plan-cache key).

    Two chunks with the same payload bytes, framing, and codebook decode
    through identical phase 1-3 plans, so the cache key hashes exactly that.
    """
    h = hashlib.sha1()
    h.update(struct.pack("<IqqI", payload_crc & 0xFFFFFFFF, total_bits,
                         n_symbols, subseqs_per_seq))
    h.update(codebook_digest_.encode())
    return h.hexdigest()


def compressed_digest(c) -> str:
    """Digest of an in-memory ``Compressed`` -- identical to the reference's
    ``compressed_digest`` (and so to its archive writer's) for the same
    payload.

    Memoized on the object (and its codebook): the CRC pass over the
    payload runs once per tensor, not once per decode.
    """
    d = getattr(c, "_digest", None)
    if d is not None:
        return d
    book = c.codebook
    cbd = getattr(book, "_digest", None)
    if cbd is None:
        cbd = codebook_digest(book.enc_code, book.enc_len, int(book.max_len))
        try:
            # Codebook is a frozen dataclass; the digest memo is not part of
            # its value, so bypass the frozen guard.
            object.__setattr__(book, "_digest", cbd)
        except AttributeError:
            pass
    crc = payload_crc(c.stream.units, c.stream.gaps,
                      c.outlier_pos, c.outlier_val)
    d = chunk_digest(crc, int(c.stream.total_bits), int(c.stream.n_symbols),
                     int(c.stream.subseqs_per_seq), cbd)
    try:
        c._digest = d
    except AttributeError:
        pass
    return d


class PlanCache:
    def __init__(self, max_plans: int = 4096):
        self.max_plans = max_plans
        self._books: dict = {}
        self._plans: collections.OrderedDict = collections.OrderedDict()
        self._inflight: dict = {}
        self._lock = threading.Lock()
        self.stats = {"plan_hits": 0, "plan_misses": 0,
                      "lut_hits": 0, "lut_misses": 0}

    # -- codebooks / LUTs ---------------------------------------------------

    def get_codebook(self, digest: str, build_fn):
        """Return the cached ``Codebook`` for ``digest``, building via
        ``build_fn()`` on first use."""
        with self._lock:
            book = self._books.get(digest)
            if book is not None:
                self.stats["lut_hits"] += 1
                return book
            self.stats["lut_misses"] += 1
        book = build_fn()
        with self._lock:
            return self._books.setdefault(digest, book)

    # -- plans --------------------------------------------------------------

    def get_plan(self, key):
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.stats["plan_hits"] += 1
            else:
                self.stats["plan_misses"] += 1
            return plan

    def put_plan(self, key, plan):
        with self._lock:
            self._plans[key] = plan
            self._plans.move_to_end(key)
            while len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)

    def get_or_build_plan(self, key, build_fn):
        """Single-flight plan resolution: concurrent misses on the same key
        build ONCE (one ``plan_builds`` tick), everyone else blocks on the
        winner's result.  This keeps the build counters deterministic when
        N serving threads decode the same hot prefix through one shared
        codec -- without it, simultaneous misses each rebuild the plan and
        the "decoded once" invariant is unverifiable.

        Build failures propagate to every waiter and are not cached, so a
        transient error does not poison the key.
        """
        import concurrent.futures as futures

        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.stats["plan_hits"] += 1
                return plan
            fut = self._inflight.get(key)
            owner = fut is None
            if owner:
                fut = futures.Future()
                self._inflight[key] = fut
                self.stats["plan_misses"] += 1
            else:
                # Another thread is building this exact plan; its result
                # serves us too (a hit: the plan is not rebuilt).
                self.stats["plan_hits"] += 1
        if not owner:
            return fut.result()
        try:
            plan = build_fn()
        except BaseException as e:
            with self._lock:
                self._inflight.pop(key, None)
            fut.set_exception(e)
            raise
        self.put_plan(key, plan)
        with self._lock:
            self._inflight.pop(key, None)
        fut.set_result(plan)
        return plan

    def clear(self):
        with self._lock:
            self._books.clear()
            self._plans.clear()

    def reset_stats(self):
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0

    def __len__(self):
        return len(self._plans)



#: Process-wide default used by the default ``Codec`` (and therefore by
#: ``Archive`` / ``KVPager`` unless given their own codec or cache).
DEFAULT_PLAN_CACHE = PlanCache()
