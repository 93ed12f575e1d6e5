"""Checkpointing over the compressed tensor store.

Port of ``src/repro/checkpoint/manager.py``.

Layout:  <dir>/step_<N>/{manifest.json, archive.szt, <flat-key>.npy}
         (+ shard_manifest.json, shard_<k>.szt for mesh-sharded entries)
Writes are atomic (tmp dir + rename) so a preempted save can never corrupt
the restore path; restore starts from ``latest_step``.

Compression policy lives in one ``repro_torch.core.Codec`` handed to the
manager: its eb/mode quantize the float shards, its method/backend decode
them back, and its digest-keyed plan cache persists across restores.
Compressible float shards are packed into ONE ``.szt`` archive per step
(chunked format, deduped codebooks, per-chunk CRC32); restore streams the
archive through the double-buffered reader, and plan-cache hits on a
re-restore skip the phase 1-3 rebuild.  Everything else is a raw ``.npy``
with its checksum recorded in ``manifest.json``; any corrupt or truncated
shard surfaces as ``CheckpointIntegrityError`` naming the entry, never a
numpy parse error.

With ``mesh=`` (or ``shardings=`` / ``opt_shardings=``) the float32
entries above the size floor are written in the mesh-sharded layout
(``repro_torch.distributed``): partitioned by their
``runtime/sharding.py`` specs into ``shard_count`` per-host shard
archives; ``restore(mesh=...)`` decodes the shards in parallel and lands
every entry as a ``DTensor`` holding this rank's slice.

The step directories are byte-identical with the reference's for the same
tree, and each package restores the other's, with one departure:

* a raw bfloat16 leaf is written as the reference writes it (an ``.npy``
  whose header says ``'<V2'``, the manifest's ``"dtype"`` saying
  ``"bfloat16"``), and the manifest's dtype turns it back into
  ``torch.bfloat16`` on restore, where the reference's restore raises
  ``TypeError``.

Restored leaves are torch tensors on the codec's device (``device=`` for a
manager without a codec; the card by default), or ``DTensor``s where a
target sharding is given.
"""

from __future__ import annotations

import concurrent.futures as futures
import json
import os
import shutil
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.codec import Codec, CodecConfig, default_codec
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz.compressor import Compressed, dtype_name
from repro_torch.distributed.restore import ShardedRestorer
from repro_torch.distributed.shards import ShardedWriter
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.store import Archive, ArchiveWriter, StoreError

ARCHIVE_NAME = "archive.szt"
#: v2 = single archive per step; v3 adds mesh-sharded entries
#: (kind "sz-sharded" + shard_manifest.json).
MANIFEST_VERSION = 3
_STORE_MANIFEST_VERSION = 2     # first version with .szt-archived sz entries
#: The ``.npy`` descr numpy gives a bfloat16 array (``ml_dtypes``'), which
#: this port writes without ``ml_dtypes``.
_BF16_DESCR = "<V2"


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint entry is missing, truncated, or fails its checksum."""


def _entry_spec(fname: str, shape: tuple, mesh):
    """Partition spec of a flat checkpoint entry under the sharding rules.

    Entry names are dot-joined tree paths ("params.layers.attn.wq");
    the rules in ``runtime/sharding.py`` match "/"-joined substrings, so
    the path is translated before lookup.  Optimizer entries reuse their
    parameter's rules the same way ``opt_state_shardings`` does: the
    leading m/v element and any quantized-leaf suffix are stripped.
    """
    from repro_torch.runtime.sharding import P, param_spec

    tname, _, key = fname.partition(".")
    path = key.replace(".", "/")
    if tname == "opt":
        if path.endswith("step"):
            return P()
        path = path.split("/", 1)[1] if "/" in path else path
        for suffix in ("/q", "/scale", "/f"):
            if path.endswith(suffix):
                path = path[: -len(suffix)]
                break
    return param_spec(path, shape, mesh)


def _process_count() -> int:
    """Ranks of the initialized world, else 1: the default shard count
    (the reference's ``jax.process_count()``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _is_sharded_leaf(leaf, min_size: int) -> bool:
    """A leaf the sharded layout compresses: float32, at least
    ``min_size`` values."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype == torch.float32 and leaf.numel() >= min_size
    return (isinstance(leaf, np.ndarray) and leaf.dtype == np.float32
            and leaf.size >= min_size)


def _write_json_atomic(path: str, obj) -> None:
    """Durable atomic JSON write: temp file + fsync + rename + dir fsync.

    A crash at any point leaves either the old file or the new one, never
    a torn half-write -- and the rename is not published before the bytes
    are durable, so power loss cannot surface an empty manifest either.
    """
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _flatten(tree):
    """{dot-joined path: leaf}; descends dicts only, as the reference."""
    flat = {}

    def rec(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(f"{prefix}.{k}" if prefix else str(k), v)
        else:
            flat[prefix] = t

    rec("", tree)
    return flat


def _unflatten(flat):
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _snapshot(tree):
    """A copy of ``tree`` that later in-place writes to its leaves cannot
    reach: tensors cloned (on their device), everything else as a numpy
    copy.  Dict keys come out sorted, as the reference's ``jax.tree.map``
    snapshot leaves them, so the manifest lists entries in its order."""
    if isinstance(tree, dict):
        return {k: _snapshot(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return np.array(tree)


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(1 << 20)
            if not buf:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(buf, crc)


class _CrcTee:
    """File-object wrapper that CRCs bytes as they are written, so the raw
    save path never re-reads what it just wrote."""

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, buf):
        self.crc = zlib.crc32(buf, self.crc) & 0xFFFFFFFF
        return self._f.write(buf)

    def __getattr__(self, name):
        return getattr(self._f, name)


def _leaf_dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return dtype_name(leaf.dtype)
    return str(leaf.dtype)


def _save_raw(f, leaf) -> None:
    """Write one raw leaf as the reference's ``np.save`` does: a bfloat16
    tensor as its 16-bit patterns under the ``'<V2'`` descr, everything
    else through ``np.save`` of its host copy."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(leaf.shape)})
            f.write(leaf.view(torch.int16).numpy().tobytes())
            return
        leaf = leaf.numpy()
    np.save(f, np.asarray(leaf, order="C"), allow_pickle=False)


def _torch_dtype(name: str):
    dt = getattr(torch, str(name), None)
    return dt if isinstance(dt, torch.dtype) else None


def _from_npy(arr: np.ndarray, dtype: "str | None") -> torch.Tensor:
    """A loaded ``.npy`` as a tensor; a 2-byte void array recorded as
    bfloat16 in the manifest is one."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    """Checkpoints over the store, with one ``Codec`` as the whole policy.

    ``codec=None`` saves raw shards only.  With a codec, float shards
    (float32, bfloat16, float16) of at least ``compress_min_size`` elements
    compress under the codec's eb/mode into the step archive, and restores
    decode with the codec's method/backend -- re-restores hit its plan
    cache (phase 4 only).  ``device`` is where a manager without a codec
    restores (default: the card); with a codec, restored leaves land on
    the codec's device.
    """

    def __init__(self, directory: str, codec: "Codec | None" = None,
                 compress_min_size: int = 65536, asynchronous: bool = False,
                 *, device=None):
        self.dir = directory
        self.codec = codec
        self.min_size = compress_min_size
        self._device = (torch.device(device) if device is not None
                        else None)
        os.makedirs(directory, exist_ok=True)
        self._pool = futures.ThreadPoolExecutor(1) if asynchronous else None
        self._pending = None

    @property
    def _read_codec(self) -> Codec:
        """Codec for the restore path: a raw-only manager can still read a
        compressed checkpoint through the default codec."""
        return self.codec if self.codec is not None else default_codec()

    @property
    def device(self) -> torch.device:
        """Where restored leaves land."""
        if self.codec is not None:
            return self.codec.device
        device = self._device or CodecConfig().resolved_device()
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"CheckpointManager restores onto {device}, but "
                f"torch.cuda.is_available() is False.  Pass device='cpu' "
                f"or a codec on the CPU.")
        return device

    # -- write --------------------------------------------------------------

    def save(self, step: int, params, opt_state=None, extra: dict | None = None,
             *, mesh=None, shardings=None, opt_shardings=None,
             shard_count: "int | None" = None):
        """Save a step: compressible leaves into one archive, the rest as
        raw ``.npy`` files, then the manifest; the step directory is
        published by a rename.  With ``asynchronous=True`` the trees are
        copied first (tensors cloned on their device) and written on a
        worker thread: an in-place write to a leaf after ``save`` returns
        does not reach the checkpoint.

        With ``mesh=`` (a ``DeviceMesh`` or a layout; or explicit
        ``shardings=`` / ``opt_shardings=`` trees of ``NamedSharding`` or
        ``PartitionSpec``), compressible entries write the mesh-sharded
        layout: partitioned by their ``runtime/sharding.py`` specs into
        ``shard_count`` per-host ``.szt`` shards (default: one per rank of
        the world) that ``restore(mesh=...)`` decodes in parallel, directly
        into the target shardings."""
        if self._pool is not None:
            self.wait()
            params = _snapshot(params)
            opt_state = _snapshot(opt_state) if opt_state else None
            self._pending = self._pool.submit(
                self._save_sync, step, params, opt_state, extra, mesh,
                shardings, opt_shardings, shard_count)
            return
        self._save_sync(step, params, opt_state, extra, mesh, shardings,
                        opt_shardings, shard_count)

    def _save_sync(self, step, params, opt_state, extra, mesh=None,
                   shardings=None, opt_shardings=None, shard_count=None):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"version": _STORE_MANIFEST_VERSION, "step": step,
                    "entries": {}, "extra": extra or {}}
        trees = {"params": params}
        if opt_state is not None:
            trees["opt"] = opt_state
        sharded = (mesh is not None or shardings is not None
                   or opt_shardings is not None) and self.codec is not None
        spec_trees = {"params": shardings, "opt": opt_shardings}
        writer = sw = None
        try:
            for tname, tree in trees.items():
                flat = {key: (leaf if isinstance(leaf, torch.Tensor)
                              else np.asarray(leaf))
                        for key, leaf in _flatten(tree).items()}
                flat_specs = (_flatten(spec_trees[tname])
                              if spec_trees[tname] is not None else None)
                if self.codec is not None and not sharded:
                    # Tree-level compression: every float shard above the
                    # size floor becomes a Compressed leaf in one codec call.
                    # The reference's tree map returns the keys sorted.
                    flat = self.codec.compress_tree(
                        dict(sorted(flat.items())), min_size=self.min_size)
                for key, leaf in flat.items():
                    fname = f"{tname}.{key}"
                    if sharded and _is_sharded_leaf(leaf, self.min_size):
                        if sw is None:
                            sw = ShardedWriter(
                                tmp, mesh, codec=self.codec,
                                n_shards=shard_count or _process_count())
                        shape = tuple(int(s) for s in leaf.shape)
                        spec = (flat_specs.get(key)
                                if flat_specs is not None
                                else _entry_spec(fname, shape, mesh))
                        sw.add(fname, leaf, spec)
                        manifest["entries"][fname] = {
                            "kind": "sz-sharded", "shape": list(shape),
                            "dtype": "float32"}
                    elif isinstance(leaf, Compressed):
                        if writer is None:
                            writer = ArchiveWriter(
                                os.path.join(tmp, ARCHIVE_NAME),
                                codec=self.codec)
                        dtype = dtype_name(leaf.dtype)
                        writer.add(fname, leaf, orig_dtype=dtype)
                        # shape/dtype recorded so a zero_fill restore can
                        # size the substitute even when the archive is gone.
                        manifest["entries"][fname] = {
                            "kind": "sz",
                            "shape": [int(s) for s in leaf.shape],
                            "dtype": dtype}
                    else:
                        path = os.path.join(tmp, fname + ".npy")
                        with open(path, "wb") as f:
                            tee = _CrcTee(f)
                            _save_raw(tee, leaf)
                        manifest["entries"][fname] = {
                            "kind": "raw", "dtype": _leaf_dtype(leaf),
                            "shape": [int(s) for s in leaf.shape],
                            "checksum": tee.crc}
        except BaseException:
            if writer is not None:
                writer.abort()
            if sw is not None:
                sw.abort()
            raise
        if writer is not None:
            for fname, crc in writer.checksums().items():
                manifest["entries"][fname]["checksum"] = crc
            writer.close()
        if sw is not None:
            sw.close()
            manifest["version"] = MANIFEST_VERSION
            manifest["n_shards"] = sw.n_shards
        _write_json_atomic(os.path.join(tmp, "manifest.json"), manifest)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -- read ---------------------------------------------------------------

    def _steps(self) -> list:
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self):
        steps = self._steps()
        return max(steps) if steps else None

    def _load_manifest(self, d: str, step: int) -> dict:
        """Parse a step's manifest; every failure mode -- missing, torn
        half-write, valid-JSON-wrong-shape -- is the named
        ``CheckpointIntegrityError``, never a raw parse error."""
        mpath = os.path.join(d, "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except FileNotFoundError as e:
            raise CheckpointIntegrityError(
                f"step {step}: manifest.json is missing") from e
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise CheckpointIntegrityError(
                f"step {step}: manifest.json is torn or unreadable: "
                f"{e}") from e
        entries = manifest.get("entries") if isinstance(manifest, dict) \
            else None
        if not isinstance(entries, dict) or not all(
                isinstance(m, dict) and "kind" in m
                for m in entries.values()):
            raise CheckpointIntegrityError(
                f"step {step}: manifest.json is structurally invalid")
        version = manifest.get("version", 1)
        if version > MANIFEST_VERSION:
            raise CheckpointIntegrityError(
                f"step {step}: manifest version {version} is newer than this "
                f"reader (supports <= {MANIFEST_VERSION})")
        if version < _STORE_MANIFEST_VERSION and any(
                m["kind"] == "sz" for m in entries.values()):
            raise CheckpointIntegrityError(
                f"step {step}: checkpoint uses the pre-store manifest "
                f"version {version} (loose .szblob.npz shards); re-save it "
                f"with this manager's writer -- it is not corrupt")
        return manifest

    def _restore_archive(self, d: str, step: int, manifest, pol,
                         quarantined: dict) -> dict:
        """Decode every compressed entry of a step's archive (integrity-
        checked, plan-cached, I/O overlapped with decode).

        Under a non-raise policy, failures quarantine entries (recorded in
        ``quarantined`` as name -> reason) instead of aborting: a corrupt
        chunk loses that entry, a corrupt/missing archive loses all of
        them, and everything else restores.
        """
        sz_entries = {fname: meta for fname, meta in
                      manifest["entries"].items() if meta["kind"] == "sz"}
        if not sz_entries:
            return {}
        apath = os.path.join(d, ARCHIVE_NAME)

        def lose_all(reason: str) -> dict:
            if pol.on_error == "raise":
                raise CheckpointIntegrityError(f"step {step}: {reason}")
            for fname in sz_entries:
                quarantined[fname] = reason
            return {}

        if not os.path.exists(apath):
            return lose_all(f"manifest lists {len(sz_entries)} compressed "
                            f"entries but {ARCHIVE_NAME} is missing")
        try:
            ar = Archive(apath, codec=self._read_codec)
        except (StoreError, OSError) as e:
            return lose_all(f"{ARCHIVE_NAME} is corrupt or truncated: {e}")
        with ar:
            want = []
            for fname, meta in sz_entries.items():
                if fname not in ar:
                    reason = f"entry missing from {ARCHIVE_NAME}"
                elif (meta.get("checksum") is not None
                        and ar.chunk(fname).crc32 != meta["checksum"]):
                    reason = (f"entry checksum in manifest.json disagrees "
                              f"with {ARCHIVE_NAME}")
                else:
                    want.append(fname)
                    continue
                if pol.on_error == "raise":
                    raise CheckpointIntegrityError(
                        f"step {step}: {fname!r}: {reason}")
                quarantined[fname] = reason

            def on_error(name, exc):
                quarantined[name] = f"{type(exc).__name__}: {exc}"

            try:
                if pol.on_error == "raise":
                    return ar.read_all(want, policy="raise")
                # Salvage: skip failed chunks here; restore() substitutes
                # zeros for quarantined entries under "zero_fill".
                return ar.read_all(want, policy="skip", on_error=on_error)
            except (StoreError, hp.DecodeGuardError) as e:
                raise CheckpointIntegrityError(
                    f"step {step}: {ARCHIVE_NAME} is corrupt or truncated: "
                    f"{e}") from e

    def _restore_sharded(self, d: str, step: int, manifest, pol,
                         quarantined: dict, targets: dict) -> dict:
        """Decode every mesh-sharded entry of a step (per-shard parallel
        decode, landing in ``targets`` shardings).

        Mirrors ``_restore_archive``'s salvage contract: under a non-raise
        policy a corrupt/missing shard quarantines only the entries with
        tiles in it (the reason names the shard file), and a lost shard
        manifest loses all sharded entries.
        """
        entries = {f: m for f, m in manifest["entries"].items()
                   if m["kind"] == "sz-sharded"}
        if not entries:
            return {}

        def lose_all(reason: str) -> dict:
            if pol.on_error == "raise":
                raise CheckpointIntegrityError(f"step {step}: {reason}")
            for fname in entries:
                quarantined[fname] = reason
            return {}

        try:
            restorer = ShardedRestorer(d, codec=self._read_codec)
        except StoreError as e:
            return lose_all(f"sharded layout is unreadable: {e}")

        missing = [f for f in entries if f not in restorer.entries]
        if missing:
            return lose_all(f"{len(missing)} sharded entries (e.g. "
                            f"{missing[0]!r}) are missing from the shard "
                            f"manifest")

        def on_error(name, exc):
            quarantined[name] = f"{type(exc).__name__}: {exc}"

        try:
            if pol.on_error == "raise":
                return restorer.restore(targets, names=list(entries),
                                        policy="raise")
            # Salvage: skip failed entries here; restore() substitutes
            # zeros for quarantined entries under "zero_fill".
            return restorer.restore(targets, names=list(entries),
                                    policy="skip", on_error=on_error)
        except (StoreError, hp.DecodeGuardError) as e:
            raise CheckpointIntegrityError(f"step {step}: {e}") from e

    def _restore_raw(self, d: str, step: int, fname: str, meta):
        path = os.path.join(d, fname + ".npy")
        if not os.path.exists(path):
            raise CheckpointIntegrityError(
                f"step {step}: raw shard {fname!r} is missing")
        want = meta.get("checksum")
        if want is not None and _file_crc32(path) != want:
            raise CheckpointIntegrityError(
                f"step {step}: raw shard {fname!r} failed its checksum "
                f"(corrupt or truncated file)")
        try:
            arr = np.load(path, allow_pickle=False)
            return _from_npy(arr, meta.get("dtype")).to(self.device)
        except (ValueError, OSError, EOFError, TypeError) as e:
            raise CheckpointIntegrityError(
                f"step {step}: raw shard {fname!r} is unreadable: {e}") from e

    def _zero_fill(self, meta: dict, pol):
        """Zeros of an entry's recorded shape/dtype, or None when the
        policy isn't ``zero_fill`` / the manifest predates shape records."""
        if pol.on_error != "zero_fill":
            return None
        shape, dtype = meta.get("shape"), meta.get("dtype")
        if shape is None or dtype is None:
            return None
        dt = _torch_dtype(dtype)
        if dt is None:
            return None
        return torch.zeros(tuple(int(s) for s in shape), dtype=dt,
                           device=self.device)

    def restore(self, step: int | None = None, policy=None, *, mesh=None,
                shardings=None, opt_shardings=None):
        """Restore a step (default: newest) as torch tensors on the
        manager's device.

        ``mesh=`` (a ``DeviceMesh``; or explicit ``shardings=`` /
        ``opt_shardings=`` trees of ``NamedSharding``) gives every entry a
        target sharding: mesh-sharded entries decode per shard in parallel
        and are assembled *directly* into this rank's slice of their
        target (the restore mesh need not match the write mesh), and raw
        and archived entries are cut to this rank's slice; each lands as a
        ``DTensor``.  Without either, every entry restores as a full
        tensor, whatever layout it was written in.

        ``policy`` (a string or ``RecoveryPolicy``; default: the codec's
        ``recovery`` config, i.e. ``"raise"``) selects salvage behaviour on
        corruption:

        * ``"raise"`` -- any integrity failure raises the named
          ``CheckpointIntegrityError``.
        * ``"skip"`` -- intact entries restore; failing ones are omitted
          and reported in the result's ``"quarantined"`` dict
          (name -> reason).  When the *newest* step's manifest is torn and
          no explicit ``step`` was requested, restore falls back to the
          newest intact step (skipped steps listed in ``"fallback_from"``).
        * ``"zero_fill"`` -- like ``"skip"``, but quarantined entries are
          replaced by zeros of their recorded shape/dtype so the restored
          tree keeps its structure.
        """
        config = self.codec.config if self.codec is not None else None
        pol = ft.RecoveryPolicy.resolve(policy, config or CodecConfig())
        fallback_from: list = []
        if step is None:
            manifest = None
            for s in reversed(self._steps()):
                d = os.path.join(self.dir, f"step_{s:08d}")
                try:
                    manifest = self._load_manifest(d, s)
                    step = s
                    break
                except CheckpointIntegrityError as e:
                    if pol.on_error == "raise":
                        raise
                    fallback_from.append({"step": s, "reason": str(e)})
            if manifest is None:
                return None
        else:
            d = os.path.join(self.dir, f"step_{step:08d}")
            manifest = self._load_manifest(d, step)
        targets: dict = {}
        for tname, stree in (("params", shardings), ("opt", opt_shardings)):
            if stree is not None:
                for key, s in _flatten(stree).items():
                    targets[f"{tname}.{key}"] = s
        from repro_torch.runtime.sharding import NamedSharding
        bad = [f for f, s in targets.items()
               if s is not None and not isinstance(s, NamedSharding)]
        if bad:
            raise TypeError(f"target of {bad[0]!r} is "
                            f"{type(targets[bad[0]]).__name__}, not a "
                            f"repro_torch NamedSharding")
        if mesh is not None:
            for fname, meta in manifest["entries"].items():
                if fname not in targets and meta.get("shape") is not None:
                    targets[fname] = NamedSharding(
                        mesh, _entry_spec(fname, tuple(meta["shape"]), mesh))

        trees: dict = {"params": {}, "opt": {}}
        quarantined: dict = {}
        sz_restored = self._restore_archive(d, step, manifest, pol,
                                            quarantined)
        sharded_restored = self._restore_sharded(d, step, manifest, pol,
                                                 quarantined, targets)
        for fname, meta in manifest["entries"].items():
            tname, _, key = fname.partition(".")
            if not key:
                if pol.on_error == "raise":
                    raise CheckpointIntegrityError(
                        f"step {step}: malformed entry name {fname!r}")
                quarantined[fname] = "malformed entry name"
                continue
            placed = False
            if meta["kind"] == "sz-sharded":
                arr = sharded_restored.get(fname)
                placed = arr is not None  # restorer lands in the sharding
                if arr is None:          # quarantined by _restore_sharded
                    arr = self._zero_fill(meta, pol)
                    if arr is None:
                        continue
            elif meta["kind"] == "sz":
                arr = sz_restored.get(fname)
                if arr is None:          # quarantined by _restore_archive
                    arr = self._zero_fill(meta, pol)
                    if arr is None:
                        continue
            else:
                try:
                    arr = self._restore_raw(d, step, fname, meta)
                except CheckpointIntegrityError as e:
                    if pol.on_error == "raise":
                        raise
                    quarantined[fname] = str(e)
                    arr = self._zero_fill(meta, pol)
                    if arr is None:
                        continue
            if not placed:
                tgt = targets.get(fname)
                if tgt is not None:
                    arr = tgt.distribute(arr)
            trees.setdefault(tname, {})[key] = arr
        params = _unflatten(trees["params"])
        opt = _unflatten(trees["opt"]) if trees.get("opt") else None
        return {"step": step, "params": params, "opt": opt,
                "extra": manifest.get("extra", {}),
                "quarantined": quarantined, "fallback_from": fallback_from}
