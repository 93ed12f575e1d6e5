"""Mesh-sharded archive layout: manifest + ``ShardedWriter``.

Port of ``src/repro/distributed/shards.py``: the same directory, the same
manifest bytes and the same shard files for the same tensors and specs,
so a layout written by either package restores in the other.

A sharded archive is a directory:

    <dir>/shard_manifest.json     entry -> tile records (see below)
    <dir>/shard_00000.szt         ordinary ``.szt`` archives, one per
    <dir>/shard_00001.szt         "host" (shard), each fully
    ...                           self-describing and CRC-checked

Each tensor is partitioned by its ``runtime/sharding.py`` partition spec
into a grid of tiles (``partition.spec_parts``); every tile compresses
independently through the codec and lands as one chunk in one shard
archive, written by a plain ``store.ArchiveWriter``.  Tiles are assigned
to shards in contiguous linear-index blocks -- the row-major device order
of a mesh maps hosts to contiguous device ranges, so a host's shard holds
exactly the tiles its devices own.  Fully-replicated (single-tile)
entries rotate across shards to balance bytes.

The manifest records, per entry, the global shape/dtype, the partition
grid, and per tile the owning shard, chunk name, global offset, tile
shape, and payload CRC.  Nothing in the layout depends on the writing
topology beyond those offsets: a checkpoint written at H hosts restores
at any H' (``restore.ShardedRestorer`` reshards on read).

A tensor's tiles are sliced on its device and made contiguous there, so a
codec with ``encode_backend="cuda"`` compresses them on the card.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.sz.compressor import dtype_name
from repro_torch.distributed import partition as pt
from repro_torch.store import format as F
from repro_torch.store.writer import ArchiveWriter


class ShardManifestError(F.StoreError):
    """The sharded-archive manifest is missing, torn, or invalid."""


def chunk_name(entry: str, index: tuple) -> str:
    """Chunk name of one tile inside its shard archive."""
    return f"{entry}@{'.'.join(map(str, index))}" if index else entry


def write_manifest(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_manifest(directory: str) -> dict:
    """Parse and validate a sharded-archive manifest; every failure mode
    is the named ``ShardManifestError``."""
    path = os.path.join(directory, F.SHARD_MANIFEST_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError as e:
        raise ShardManifestError(
            f"{directory}: {F.SHARD_MANIFEST_NAME} is missing") from e
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise ShardManifestError(
            f"{directory}: {F.SHARD_MANIFEST_NAME} is torn or unreadable: "
            f"{e}") from e
    version = doc.get("version") if isinstance(doc, dict) else None
    if not isinstance(version, int):
        raise ShardManifestError(
            f"{directory}: {F.SHARD_MANIFEST_NAME} is structurally invalid")
    if version > F.SHARD_MANIFEST_VERSION:
        raise ShardManifestError(
            f"{directory}: shard manifest version {version} is newer than "
            f"this reader (supports <= {F.SHARD_MANIFEST_VERSION})")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        raise ShardManifestError(
            f"{directory}: {F.SHARD_MANIFEST_NAME} has no entries table")
    for name, meta in entries.items():
        if not (isinstance(meta, dict) and isinstance(meta.get("tiles"), list)
                and meta.get("shape") is not None and meta.get("dtype")):
            raise ShardManifestError(
                f"{directory}: manifest entry {name!r} is invalid")
        for t in meta["tiles"]:
            if not (isinstance(t, dict) and "shard" in t and "chunk" in t
                    and "offset" in t and "shape" in t):
                raise ShardManifestError(
                    f"{directory}: tile record of entry {name!r} is invalid")
    return doc


class ShardedWriter:
    """Write one mesh-sharded archive directory.

    ``mesh`` supplies the partition-axis sizes -- a ``DeviceMesh``, a plain
    ``{axis: size}`` mapping or a layout object with a mapping ``shape``
    (layouts can be written without any devices; only *restore into
    shardings* needs them).  ``n_shards`` is the number of per-host
    archives (default 1: a single-process writer is one "host"); it is
    write-time layout only and places no constraint on the restore
    topology.  ``codec`` defaults to the port's ``default_codec()``.
    """

    def __init__(self, directory: str, mesh=None, *, codec=None,
                 n_shards: int = 1):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if codec is None:
            from repro_torch.core.codec import default_codec
            codec = default_codec()
        self.dir = directory
        self.codec = codec
        self.axis_sizes = pt.axis_sizes_of(mesh) if mesh is not None else {}
        self.n_shards = n_shards
        os.makedirs(directory, exist_ok=True)
        self._writers: dict[int, ArchiveWriter] = {}
        self._entries: dict[str, dict] = {}
        self._rr = 0                 # rotation cursor for single-tile entries
        self._closed = False

    def _writer(self, shard: int) -> ArchiveWriter:
        w = self._writers.get(shard)
        if w is None:
            w = ArchiveWriter(os.path.join(self.dir, F.shard_filename(shard)),
                              codec=self.codec)
            self._writers[shard] = w
        return w

    def add(self, name: str, array, spec=None, *,
            orig_dtype: "str | None" = None):
        """Partition ``array`` (a tensor, sliced on its device, or an
        array) by ``spec`` and append its tiles.

        ``spec`` is a ``PartitionSpec`` resolved against the writer's mesh
        axes, or a ``NamedSharding`` (whose own mesh supplies the axis
        sizes), or ``None`` for a replicated single-tile entry.
        """
        if self._closed:
            raise F.StoreError("sharded writer already closed")
        if name in self._entries:
            raise F.StoreError(f"duplicate entry name {name!r}")
        if isinstance(array, torch.Tensor):
            arr = array.detach()
            dtype = dtype_name(arr.dtype)
        else:
            arr = np.asarray(array)
            dtype = str(arr.dtype)
        shape = tuple(int(s) for s in arr.shape)
        axis_sizes = self.axis_sizes
        if spec is not None and hasattr(spec, "spec"):   # NamedSharding
            axis_sizes = pt.axis_sizes_of(spec.mesh)
            spec = spec.spec
        parts = pt.spec_parts(spec, shape, axis_sizes)
        tiles = list(pt.tile_extents(shape, parts))
        n_tiles = len(tiles)
        records = []
        for lin, (index, offset, tshape) in enumerate(tiles):
            if n_tiles == 1:
                shard = self._rr % self.n_shards
                self._rr += 1
            else:
                shard = lin * self.n_shards // n_tiles
            cname = chunk_name(name, index)
            tile = arr[pt.tile_slice(offset, tshape)]
            tile = (tile.contiguous() if isinstance(tile, torch.Tensor)
                    else np.ascontiguousarray(tile))
            w = self._writer(shard)
            w.add(cname, self.codec.compress(tile),
                  orig_dtype=orig_dtype or dtype)
            records.append({"shard": shard, "chunk": cname,
                            "offset": list(offset), "shape": list(tshape),
                            "crc32": w.checksums()[cname]})
        self._entries[name] = {
            "shape": list(shape),
            "dtype": str(orig_dtype or dtype),
            "parts": list(parts), "tiles": records}

    def manifest(self) -> dict:
        return {"version": F.SHARD_MANIFEST_VERSION,
                "n_shards": self.n_shards,
                "axis_sizes": dict(self.axis_sizes),
                "entries": self._entries}

    def close(self):
        if self._closed:
            return
        self._closed = True
        for w in self._writers.values():
            w.close()
        write_manifest(os.path.join(self.dir, F.SHARD_MANIFEST_NAME),
                       self.manifest())

    def abort(self):
        if not self._closed:
            self._closed = True
            for w in self._writers.values():
                w.abort()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False
