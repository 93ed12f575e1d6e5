"""Compressed KV-cache blocks: the paper's in-memory-compression use case.

Port of ``src/repro/models/kvcache.py`` over the port's codec trees and
``repro_torch.store.KVPager``.  Decode caches are large, cold beyond the
active window, and tolerant of bounded error -- exactly the profile of the
paper's RTM / GAMESS in-memory workloads.  ``compress_cache``
SZ-compresses (Lorenzo+Huffman) each cache tensor; ``decompress_cache``
restores it with the optimized parallel decoder (gap-array by default --
the encoder is ours, so coupling is free; see paper §V-C for the self-sync
trade-off).

Along the sequence axis a KV cache is smooth per channel (adjacent tokens'
keys correlate), so the Lorenzo predictor gets ratios well above the
raw-entropy floor.

The pager writes the caller's tensors in place (an offloaded span is
zeroed, a paged-in one written back), where the reference returns updated
copies; ``offload_prefix`` and both page-ins return the same dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.codec import Codec, default_codec
from repro_torch.core.sz.compressor import dtype_name
from repro_torch.store.paging import KVPager, PageLostError  # noqa: F401


@dataclasses.dataclass
class CompressedCache:
    blobs: dict           # name -> core.sz.Compressed
    orig_dtypes: dict
    orig_shapes: dict

    @property
    def compressed_bytes(self) -> int:
        return sum(c.compressed_bytes for c in self.blobs.values())

    @property
    def original_bytes(self) -> int:
        # 2 B a value whatever the dtype, as in the reference, so the
        # ratios of the two packages agree.
        return sum(int(np.prod(s)) * 2 for s in self.orig_shapes.values())

    @property
    def ratio(self) -> float:
        return self.original_bytes / max(self.compressed_bytes, 1)


def compress_cache(cache: dict, codec: "Codec | None" = None,
                   skip: tuple = ()) -> CompressedCache:
    """Compress every tensor of a decode cache through one ``Codec``, as
    float32 (on the codec's device).

    ``codec`` defaults to ``repro_torch.core.default_codec()`` (the
    paper's relative 1e-3 bound, on the card).
    """
    codec = codec if codec is not None else default_codec()
    picked = {n: torch.as_tensor(a).to(torch.float32)
              for n, a in cache.items() if n not in skip}
    blobs = codec.compress_tree(picked)
    return CompressedCache(
        blobs,
        {n: dtype_name(torch.as_tensor(cache[n]).dtype) for n in picked},
        {n: tuple(cache[n].shape) for n in picked})


def decompress_cache(cc: CompressedCache,
                     codec: "Codec | None" = None) -> dict:
    """Restore every cache tensor via the codec's class-batched decoder.

    All blocks decode in one ``decompress_tree`` call -- one decode-write
    dispatch per CR class across the whole cache, not per tensor -- with
    phase 1-3 plans served from the codec's cache on repeats.  Each tensor
    is cast to its original dtype on its device.
    """
    codec = codec if codec is not None else default_codec()
    xs = codec.decompress_tree(cc.blobs)
    return {n: x.to(getattr(torch, cc.orig_dtypes[n]))
            for n, x in xs.items()}


# ---------------------------------------------------------------------------
# Block paging through the compressed tensor store (serve --kv-offload)
# ---------------------------------------------------------------------------


def offload_prefix(cache: dict, pager: KVPager, n_tokens: int,
                   block_tokens: int = 64, keys=None):
    """Evict tokens [0, n_tokens) of the cache in fixed-size blocks.

    Each block becomes one store archive (one chunk per cache tensor,
    codebooks deduped); the evicted region of ``cache`` is zeroed in place.
    Returns ``(cache, block_ids)`` in eviction order.
    """
    ids = []
    for lo in range(0, n_tokens, block_tokens):
        cache, bid = pager.offload(cache, lo, min(lo + block_tokens,
                                                  n_tokens), keys=keys)
        ids.append(bid)
    return cache, ids


def page_in_blocks(cache: dict, pager: KVPager, block_ids,
                   on_lost=None) -> dict:
    """Restore offloaded blocks into the cache, in place (demand paging:
    call with whatever blocks the next attention window needs).

    ``on_lost(block_id, exc)`` turns a lost block (``PageLostError``:
    missing/corrupt archive -- already evicted and counted in
    ``pager.stats["pages_lost"]``) into degraded service: the callback is
    invoked, the block's span stays zeroed, and paging continues with the
    remaining blocks.  Without the callback the named error propagates.
    """
    for bid in block_ids:
        try:
            cache = pager.page_in(cache, bid)
        except PageLostError as e:
            if on_lost is None:
                raise
            on_lost(bid, e)
    return cache


def install_block(cache: dict, pager: KVPager, block_id: int,
                  tensors: dict) -> None:
    """Write one decoded block (``{name: tensor}``) into ``cache`` at its
    token span, in place, cast to each cache tensor's dtype."""
    meta = pager.block_meta(block_id)
    span = ((slice(None),) * pager.seq_axis
            + (slice(meta["lo"], meta["hi"]),))
    for name, block in tensors.items():
        cache[name][span] = block.to(cache[name].device, cache[name].dtype)


def page_in_blocks_batched(cache: dict, pager: KVPager, block_ids,
                           on_lost=None) -> dict:
    """Batched ``page_in_blocks``: stage every block, decode them all in ONE
    class-merged dispatch set (``KVPager.fetch_many``), then install each
    block at its original token span, in place.

    Same loss semantics as ``page_in_blocks`` -- a lost block either raises
    ``PageLostError`` or is absorbed by ``on_lost(block_id, exc)`` with its
    span left zeroed -- but the decode cost is one ``decompress_batch`` over
    every tensor of every block instead of one dispatch chain per block.
    """
    decoded = pager.fetch_many(block_ids, on_lost=on_lost)
    for bid, tensors in decoded.items():
        install_block(cache, pager, bid, tensors)
    return cache
