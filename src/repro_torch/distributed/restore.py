"""``ShardedRestorer``: decode a mesh-sharded archive into target shardings.

Port of ``src/repro/distributed/restore.py``.  Restore runs each shard's
stage->decode pipeline concurrently (one worker thread per shard, each an
ordinary ``store.Archive`` whose ``iter_decode`` already double-buffers
disk reads against class-merged decode), then lands every entry
*directly* in its target ``NamedSharding``: this rank's slice is assembled
on the device from the decoded tiles that overlap it
(``partition.extract_slice``) and wrapped as a ``DTensor`` with
``DTensor.from_local`` -- the unsharded tensor is never materialized when
a sharding is given.  When the restore topology matches the write grid,
every rank's slice is exactly one tile and the assembly is copy-free.

The reference decodes to host arrays and glues them with
``jax.device_put`` and ``make_array_from_single_device_arrays``; here the
decoded tiles stay on the device they were decoded on, and the result's
placements are checked against the target's (the counterpart of its
``is_equivalent_to`` assert).

All shard archives share the restorer's codec, so its digest-keyed plan
cache deduplicates phase 1-3 plans across shards (identical tiles build
one plan total), and a re-restore builds zero plans.

Failure containment: a corrupt or missing shard quarantines only the
entries with tiles in that shard -- the reason names the shard file --
and every other shard restores.  ``policy`` selects ``"raise"`` /
``"skip"`` / ``"zero_fill"`` semantics per entry.
"""

from __future__ import annotations

import concurrent.futures as futures
import os
import threading

import torch

from repro_torch.distributed import partition as pt
from repro_torch.distributed.shards import load_manifest
from repro_torch.store import format as F
from repro_torch.store.reader import Archive, _torch_dtype


class ShardedRestorer:
    """One open mesh-sharded archive directory (see ``shards.py``);
    ``codec`` defaults to the port's ``default_codec()`` (the card)."""

    def __init__(self, directory: str, *, codec=None):
        if codec is None:
            from repro_torch.core.codec import default_codec
            codec = default_codec()
        self.dir = directory
        self.codec = codec
        self.manifest = load_manifest(directory)
        self.entries: dict = self.manifest["entries"]
        self.stats = {"shards_opened": 0, "tiles_decoded": 0,
                      "entries_quarantined": 0, "io_retries": 0}
        self._stats_lock = threading.Lock()

    @property
    def names(self) -> list:
        return list(self.entries)

    def entry_shape(self, name: str) -> tuple:
        return tuple(int(s) for s in self.entries[name]["shape"])

    def _count(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    # -- per-shard decode ----------------------------------------------------

    def _read_shard(self, shard: int, chunks: list, validate: bool):
        """Decode one shard's tile chunks; returns (decoded, failed) maps.

        Failures are collected, never raised, so one bad shard cannot
        abort its siblings mid-flight; the entry loop applies the policy.
        """
        path = os.path.join(self.dir, F.shard_filename(shard))
        fname = F.shard_filename(shard)
        if not os.path.exists(path):
            err = F.StoreCorruptError(
                f"shard {fname} is missing from {self.dir}")
            return {}, {c: err for c in chunks}
        failed: dict = {}

        def on_error(name, exc):
            failed[name] = F.StoreCorruptError(f"shard {fname}: {exc}")

        try:
            with Archive(path, codec=self.codec) as ar:
                decoded = ar.read_all(chunks, policy="skip",
                                      on_error=on_error, validate=validate)
                self._count(io_retries=ar.stats["io_retries"])
        except F.StoreError as e:
            err = F.StoreCorruptError(
                f"shard {fname} is corrupt or truncated: {e}")
            err.__cause__ = e
            return {}, {c: err for c in chunks}
        self._count(shards_opened=1, tiles_decoded=len(decoded))
        return decoded, failed

    # -- assembly ------------------------------------------------------------

    def _place(self, name: str, meta: dict, tiles: dict, sharding):
        """Assemble one entry from its decoded tiles, on their device.

        With a sharding: this rank's slice only, wrapped as a ``DTensor``
        in the target placements.  Without: the full tensor.
        """
        shape = self.entry_shape(name)
        dtype = _torch_dtype(meta["dtype"])
        if sharding is None:
            full_idx = tuple(slice(0, n) for n in shape)
            return pt.extract_slice(full_idx, tiles, dtype, shape)
        local = pt.extract_slice(sharding.index(shape), tiles, dtype, shape)
        return sharding.wrap(local, shape)

    def _substitute(self, name: str, meta: dict, pol, sharding):
        """Zeros in the target sharding for a quarantined entry, or None."""
        if pol.on_error != "zero_fill":
            return None
        shape = self.entry_shape(name)
        dtype = _torch_dtype(meta["dtype"])
        if sharding is None:
            return torch.zeros(shape, dtype=dtype, device=self.codec.device)
        local = tuple(s.stop - s.start for s in sharding.index(shape))
        return sharding.wrap(torch.zeros(local, dtype=dtype,
                                         device=self.codec.device), shape)

    # -- public --------------------------------------------------------------

    def decode_shards(self, shards, *, devices=None,
                      validate: bool = True) -> dict:
        """Decode the tile chunks of ``shards`` -- one host's local share.

        This is the per-host critical path of a multi-host restore: each
        host decodes only the shard archives its devices own and places
        the tiles locally (``devices`` round-robins them over torch
        devices).  Returns ``{chunk: tensor}``, synchronized; any shard
        failure raises (salvage semantics live in :meth:`restore`).
        """
        by_shard: dict[int, list] = {s: [] for s in shards}
        for meta in self.entries.values():
            for t in meta["tiles"]:
                s = int(t["shard"])
                if s in by_shard:
                    by_shard[s].append(t["chunk"])
        out: dict = {}
        for s, chunks in sorted(by_shard.items()):
            decoded, failed = self._read_shard(s, chunks, validate)
            if failed:
                raise next(iter(failed.values()))
            out.update(decoded)
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            out = {c: a.to(devices[i % len(devices)])
                   for i, (c, a) in enumerate(out.items())}
        for d in {a.device for a in out.values()}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return out

    def restore(self, shardings: "dict | None" = None, *, names=None,
                policy=None, on_error=None, validate: bool = True,
                concurrency: "int | None" = None) -> dict:
        """Restore entries into ``{name: tensor}``.

        ``shardings`` maps entry name -> target ``NamedSharding`` (missing
        or ``None`` values restore as full tensors on the codec's device;
        given ones as ``DTensor``s holding this rank's slice).  Shards
        decode concurrently (``concurrency`` workers, default one per
        shard); ``policy`` / ``on_error`` follow the store's recovery
        semantics, with quarantine reasons naming the failing shard file.
        """
        shardings = shardings or {}
        pol = self.codec.recovery_policy(policy)
        names = self.names if names is None else list(names)
        unknown = [n for n in names if n not in self.entries]
        if unknown:
            raise KeyError(f"{self.dir}: no entries named {unknown}")

        by_shard: dict[int, list] = {}
        for name in names:
            for t in self.entries[name]["tiles"]:
                by_shard.setdefault(int(t["shard"]), []).append(t["chunk"])

        decoded: dict = {}
        failed: dict = {}
        workers = min(len(by_shard), concurrency or len(by_shard)) or 1
        if workers <= 1 or len(by_shard) <= 1:
            results = [self._read_shard(s, cs, validate)
                       for s, cs in sorted(by_shard.items())]
        else:
            with futures.ThreadPoolExecutor(
                    workers, thread_name_prefix="szt-shard") as pool:
                results = list(pool.map(
                    lambda sc: self._read_shard(sc[0], sc[1], validate),
                    sorted(by_shard.items())))
        for dec, fail in results:
            decoded.update(dec)
            failed.update(fail)

        out: dict = {}
        for name in names:
            meta = self.entries[name]
            sharding = shardings.get(name)
            bad = [t for t in meta["tiles"] if t["chunk"] in failed]
            if bad:
                exc = failed[bad[0]["chunk"]]
                if pol.on_error == "raise":
                    raise exc
                self._count(entries_quarantined=1)
                if on_error is not None:
                    on_error(name, exc)
                sub = self._substitute(name, meta, pol, sharding)
                if sub is not None:
                    out[name] = sub
                continue
            tiles = {
                (tuple(int(o) for o in t["offset"]),
                 tuple(int(s) for s in t["shape"])): decoded[t["chunk"]]
                for t in meta["tiles"]}
            out[name] = self._place(name, meta, tiles, sharding)
        return out
