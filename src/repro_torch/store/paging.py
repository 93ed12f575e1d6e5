"""KV-cache block paging through the compressed tensor store.

Port of ``src/repro/store/paging.py`` over the port's serve cache
(``repro_torch.models.decode``: k/v of shape (L, B, S, H, D) in the
compute type).  The reference returns updated copies of the cache; the
port zeroes an offloaded span and writes a paged-in one in place, as
``models/decode.forward_decode`` writes its steps, so a full-width cache is
never held twice.

The serving cache is large, cold outside the active attention window, and tolerant of bounded
error -- the paper's in-memory-compression profile.  ``KVPager`` evicts a
token range of every pageable cache tensor into one ``.szt`` archive
(one chunk per tensor, codebooks deduped across K/V) and pages it back on
demand with the batched decoder.  Repeated page-ins of the same block hit
the plan cache, so the steady-state page-in cost is pure phase-4 decode.

The paged region is zeroed after eviction: attention over masked-out
positions never reads it, and the zeros compress to nothing if the block
is re-offloaded.

Concurrency: one pager may be shared by many serving sessions (the
reference's ``serving`` scheduler, ROADMAP A8, does exactly that), so
all block-table and counter mutations happen under an internal lock.  The decode work itself
is *not* serialized here -- ``stage`` (host read + CRC + plan) and
``decode_staged`` (one class-merged ``decompress_batch`` across blocks)
split the page-in into the two pipeline stages the scheduler overlaps.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import torch

from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, default_codec
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz.compressor import dtype_name
from repro_torch.store import format as F
from repro_torch.store.reader import Archive
from repro_torch.store.writer import ArchiveWriter


class PageLostError(F.StoreError):
    """An offloaded KV block could not be read back (missing, truncated,
    corrupt, or mangled archive).

    The pager *evicts* the block and counts ``stats["pages_lost"]`` before
    raising, so the serving loop degrades (the paged span stays zeroed --
    attention re-reads masked positions as zeros) instead of crashing on a
    raw ``FileNotFoundError`` / decode error.  ``block_id`` names the block.
    """

    def __init__(self, msg: str, block_id: "int | None" = None):
        super().__init__(msg)
        self.block_id = block_id


def _pageable(name: str, arr, seq_axis: int, hi: int) -> bool:
    """A floating tensor (bfloat16 included) whose sequence axis covers
    ``hi``."""
    return (isinstance(arr, torch.Tensor) and arr.is_floating_point()
            and arr.ndim > seq_axis and arr.shape[seq_axis] >= hi)


@dataclasses.dataclass
class StagedBlock:
    """One block's host-side half of a page-in: chunks read + CRC-checked,
    phase 1-3 plans resolved (cache hits for repeats), no decode yet.

    ``key`` is the block's *content* identity -- the sorted (tensor name,
    chunk digest) pairs -- so two blocks holding identical bytes (e.g. the
    same shared prompt prefix offloaded twice) compare equal and can share
    one decode (the reference's ``serving.prefix_cache`` keys on it).
    """

    block_id: int
    key: tuple
    names: list
    cs: list
    plans: list
    meta: dict

    @property
    def decoded_bytes(self) -> int:
        """Size of the decoded (float32) tensors this block expands to."""
        return sum(int(np.prod(c.shape)) * 4 for c in self.cs)


class KVPager:
    """Evict / restore token ranges of a decode cache via store archives.

    One ``Codec`` drives both directions: its eb/mode compresses evicted
    blocks, its method/backend/t_high decode them back, and its plan cache
    makes repeat page-ins phase-4 only.  Safe to share across threads: the
    block table (``_blocks``), id counter, and ``stats`` are guarded by one
    reentrant lock.
    """

    def __init__(self, directory: str, *, codec: "Codec | None" = None,
                 seq_axis: int = 2,
                 plan_cache: "PlanCache | None" = None):
        self.dir = directory
        self.codec = codec if codec is not None else default_codec()
        self.seq_axis = seq_axis
        self.cache = (self.codec.plan_cache if plan_cache is None
                      else plan_cache)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        self._blocks: dict = {}
        self._next_id = 0
        self.stats = {"pages_out": 0, "pages_in": 0,
                      "bytes_raw": 0, "bytes_compressed": 0,
                      "pages_lost": 0}

    def _bump(self, key: str, n: int = 1):
        with self._lock:
            self.stats[key] += n

    def _span(self, lo: int, hi: int):
        return (slice(None),) * self.seq_axis + (slice(lo, hi),)

    def block_path(self, block_id: int) -> str:
        return os.path.join(self.dir, f"block_{block_id:06d}.szt")

    @property
    def resident_blocks(self) -> list:
        with self._lock:
            return sorted(self._blocks)

    def block_meta(self, block_id: int) -> dict:
        """{"path", "lo", "hi", "names"} of one offloaded block."""
        with self._lock:
            return dict(self._blocks[block_id])

    def _meta(self, block_id: int) -> dict:
        """Resident-block lookup for the paging paths: a non-resident id
        (never offloaded, dropped, or already evicted by a prior
        ``PageLostError``) raises the named error, so a serving loop that
        re-requests a lost block degrades instead of crashing on
        ``KeyError``."""
        with self._lock:
            meta = self._blocks.get(block_id)
        if meta is None:
            raise PageLostError(
                f"kv block {block_id} is not resident (unknown, dropped, "
                f"or already evicted after a page loss)", block_id=block_id)
        return meta

    def _lose(self, block_id: int, path: str, exc) -> PageLostError:
        """Evict + count a lost block; returns the named error to raise."""
        with self._lock:
            self._blocks.pop(block_id, None)
            self.stats["pages_lost"] += 1
        return PageLostError(
            f"kv block {block_id} ({path}) lost: "
            f"{type(exc).__name__}: {exc}", block_id=block_id)

    # -- eviction -----------------------------------------------------------

    def offload(self, cache: dict, lo: int, hi: int, keys=None):
        """Compress tokens [lo, hi) of each pageable tensor to one archive.

        Returns ``(cache, block_id)`` where ``cache`` (the same dict, its
        tensors updated in place) has the paged region zeroed for every
        tensor that was written.  ``keys`` defaults to all float tensors
        with a sequence axis covering the range.  Each span is compressed
        as float32 through the pager's codec.
        """
        if hi <= lo:
            raise ValueError(f"empty page range [{lo}, {hi})")
        candidates = cache if keys is None else keys
        keys = [k for k in candidates
                if _pageable(k, cache[k], self.seq_axis, hi)]
        if not keys:
            raise ValueError("no pageable cache tensors for range "
                             f"[{lo}, {hi})")
        with self._lock:
            block_id = self._next_id
            self._next_id += 1
        span = self._span(lo, hi)
        path = self.block_path(block_id)
        raw_bytes = 0
        with ArchiveWriter(path) as w:
            for k in keys:
                arr = cache[k]
                block = arr[span].to(torch.float32)
                # The reference counts a bfloat16 value as the float32 it
                # compresses.
                raw_bytes += block.numel() * (
                    4 if arr.dtype == torch.bfloat16 else arr.element_size())
                w.add(k, self.codec.compress(block),
                      orig_dtype=dtype_name(arr.dtype))
                arr[span] = 0
        with self._lock:
            self._blocks[block_id] = {"path": path, "lo": lo, "hi": hi,
                                      "names": keys}
            self.stats["pages_out"] += 1
            self.stats["bytes_raw"] += raw_bytes
            self.stats["bytes_compressed"] += os.path.getsize(path)
        return cache, block_id

    # -- page-in ------------------------------------------------------------

    def block_key(self, block_id: int) -> tuple:
        """Content identity of a block: sorted (name, chunk digest) pairs.

        Index-only read (no chunk payload, CRC, or decode), memoized in the
        block table -- the serving scheduler's prefix cache calls this per
        request to detect blocks whose decode can be shared.  A missing /
        corrupt archive evicts the block and raises ``PageLostError``.
        """
        meta = self._meta(block_id)
        key = meta.get("key")
        if key is not None:
            return key
        try:
            with Archive(meta["path"], codec=self.codec,
                         plan_cache=self.cache) as ar:
                key = tuple(sorted(
                    (n, ar.chunk(n).digest) for n in meta["names"]))
        except (F.StoreError, OSError, KeyError) as e:
            raise self._lose(block_id, meta["path"], e) from e
        with self._lock:
            live = self._blocks.get(block_id)
            if live is not None:
                live["key"] = key
        return key

    def stage(self, block_id: int) -> StagedBlock:
        """Host half of a page-in: read + CRC-check every chunk of the
        block and resolve its phase 1-3 plans (plan-cache hits on repeats).

        No decode dispatch happens here, so this is safe to run on an I/O
        thread while the device decodes another block's batch
        (``decode_staged``).  Failures evict + count the block and raise
        ``PageLostError``.
        """
        meta = self._meta(block_id)
        try:
            with Archive(meta["path"], codec=self.codec,
                         plan_cache=self.cache) as ar:
                missing = [k for k in meta["names"] if k not in ar]
                if missing:
                    raise F.StoreCorruptError(
                        f"{meta['path']}: block is missing tensors "
                        f"{missing}")
                cs = [ar.read_chunk(n) for n in meta["names"]]
                key = tuple(sorted(
                    (n, ar.chunk(n).digest) for n in meta["names"]))
            plans = [self.codec.plan_for(c) for c in cs]
        except (F.StoreError, hp.DecodeGuardError, OSError) as e:
            raise self._lose(block_id, meta["path"], e) from e
        with self._lock:
            live = self._blocks.get(block_id)
            if live is not None:
                live["key"] = key
        return StagedBlock(block_id=block_id, key=key,
                           names=list(meta["names"]), cs=cs, plans=plans,
                           meta=meta)

    def decode_staged(self, staged, *, on_lost=None) -> dict:
        """Decode staged blocks: ONE class-merged ``decompress_batch`` over
        every tensor of every block.  Returns {block_id: {name: array}}.

        A block whose decode trips a guard (malformed stream) is salvaged
        out of the batch: it is evicted + counted, and either ``on_lost
        (block_id, exc)`` absorbs it or the named ``PageLostError`` raises.
        """
        staged = list(staged)
        if not staged:
            return {}
        all_cs = [c for s in staged for c in s.cs]
        all_plans = [p for s in staged for p in s.plans]
        out: dict = {}
        try:
            decoded = self.codec.decompress_batch(all_cs, plans=all_plans)
            i = 0
            for s in staged:
                out[s.block_id] = dict(zip(s.names,
                                           decoded[i:i + len(s.names)]))
                i += len(s.names)
        except hp.DecodeGuardError:
            # Per-block salvage: one malformed stream must not take down
            # its batch-mates.
            for s in staged:
                try:
                    decoded = self.codec.decompress_batch(s.cs,
                                                          plans=s.plans)
                    out[s.block_id] = dict(zip(s.names, decoded))
                except hp.DecodeGuardError as e:
                    err = self._lose(s.block_id, s.meta["path"], e)
                    if on_lost is None:
                        raise err from e
                    on_lost(s.block_id, err)
        self._bump("pages_in", len(out))
        return out

    def fetch(self, block_id: int) -> dict:
        """Decode a block's tensors (float32 on the codec's device), without
        touching any
        cache.  Plan-cache hits make repeat fetches phase-4 only.

        Any store-level failure -- missing/truncated block file, checksum
        mismatch, decode-guard trip, persistent IO error -- evicts the
        block, increments ``stats["pages_lost"]``, and raises the named
        ``PageLostError`` (with the original error chained) so callers
        catch one exception family.
        """
        return self.decode_staged([self.stage(block_id)])[block_id]

    def fetch_many(self, block_ids, *, on_lost=None) -> dict:
        """Batched ``fetch``: stage every block, then decode them ALL in one
        class-merged dispatch set.  Returns {block_id: {name: array}}.

        With ``on_lost(block_id, exc)`` a lost block (missing / corrupt /
        guard-tripped archive -- evicted + counted as usual) is reported and
        skipped; without it the first ``PageLostError`` propagates.
        """
        staged = []
        for bid in block_ids:
            try:
                staged.append(self.stage(bid))
            except PageLostError as e:
                if on_lost is None:
                    raise
                on_lost(bid, e)
        return self.decode_staged(staged, on_lost=on_lost)

    def page_in(self, cache: dict, block_id: int) -> dict:
        """Restore a block into ``cache`` at its original token range, in
        place, cast to each tensor's dtype.

        On a lost block (see ``fetch``) the named ``PageLostError``
        propagates; the cache is untouched and the paged span stays zeroed,
        so a caller that catches the error keeps serving degraded.
        """
        meta = self._meta(block_id)
        span = self._span(meta["lo"], meta["hi"])
        for k, block in self.fetch(block_id).items():
            cache[k][span] = block.to(cache[k].device, cache[k].dtype)
        return cache

    def adopt_block(self, block_id: int, meta: dict):
        """(Re-)register an offloaded block from its metadata.

        Recovery / restart path: a serving process that inherits block
        archives on disk (or re-tries a block evicted by ``PageLostError``
        after the storage heals) re-registers it here.  ``meta`` needs
        ``path`` / ``lo`` / ``hi`` / ``names`` as returned by
        ``block_meta``.
        """
        missing = {"path", "lo", "hi", "names"} - set(meta)
        if missing:
            raise ValueError(f"block meta missing keys {sorted(missing)}")
        with self._lock:
            self._blocks[block_id] = dict(meta)
            self._next_id = max(self._next_id, block_id + 1)

    def drop(self, block_id: int):
        """Forget a block and delete its archive.

        Dropping a non-resident id raises the named ``PageLostError``
        (matching the paging paths), not a bare ``KeyError``.
        """
        meta = self._meta(block_id)
        with self._lock:
            self._blocks.pop(block_id, None)
        if os.path.exists(meta["path"]):
            os.unlink(meta["path"])

    @property
    def ratio(self) -> float:
        """Achieved compression ratio; ``0.0`` until something has been
        offloaded (no more ``bytes_raw / 1`` nonsense on an idle pager)."""
        with self._lock:
            if self.stats["bytes_compressed"] == 0:
                return 0.0
            return self.stats["bytes_raw"] / self.stats["bytes_compressed"]
