"""Compressed tensor store: chunked ``.szt`` archives + paging over a Codec.

Port of ``src/repro/store``; archives are byte-compatible both ways (the
spec is ``docs/format.md``).  Public surface:
  * ``ArchiveWriter`` / ``write_archive``  -- build an archive (codebooks
    deduped by digest, per-chunk CRC32, atomic publish); ``add_array``
    compresses through the writer's codec.
  * ``Archive`` / ``open_archive``         -- mmap reader; ``read_all`` /
    ``iter_decode`` overlap disk reads with batched device decode.  Decode
    policy and the plan cache come from the ``codec=`` the archive was
    opened with (default: ``repro_torch.core.default_codec()``, the card).
  * ``KVPager``                            -- evict / restore KV-cache token
    ranges through archives, one codec for both directions.
  * ``StoreError`` hierarchy               -- ``StoreVersionError`` for
    incompatible archives, ``StoreCorruptError`` for truncation/checksum,
    ``StoreIOError`` for OS reads that failed after retries, and
    ``PageLostError`` for an unreadable KV block (evicted + counted in
    ``KVPager.stats["pages_lost"]``).  Recovery policies ("raise" / "skip"
    / "zero_fill" + transient-IO retry) thread through from the codec.

``PlanCache`` / ``DEFAULT_PLAN_CACHE`` live in ``repro_torch.core.cache``
(the Codec owns plan reuse); they are re-exported here, as in the
reference.
"""

from repro_torch.core.cache import DEFAULT_PLAN_CACHE, PlanCache  # noqa: F401
from repro_torch.store.format import (  # noqa: F401
    FORMAT_VERSION,
    StoreCorruptError,
    StoreError,
    StoreIOError,
    StoreVersionError,
)
from repro_torch.store.paging import KVPager, PageLostError  # noqa: F401
from repro_torch.store.reader import Archive, open_archive  # noqa: F401
from repro_torch.store.writer import ArchiveWriter, write_archive  # noqa: F401
