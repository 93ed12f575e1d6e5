"""mmap-backed archive reader with double-buffered read + decode.

Port of ``src/repro/store/reader.py``.  Opening an archive is two small
reads (header, index) over an ``mmap``.  Every read validates the chunk's
CRC32 before the bytes reach the decoder, turning silent disk / transfer
corruption into a ``StoreCorruptError`` that names the tensor.

A chunk is read in two halves:

* the host half (:meth:`Archive._read_host`): the blobs are *copied* out
  of the map into numpy arrays and CRC-checked.  A tensor made with
  ``torch.from_numpy`` aliases its buffer, so a view of the map would pin
  it (and the file) for the tensor's lifetime; the copy is what lets
  :meth:`Archive.close` unmap with no tensor alive over it.
* the device half (:meth:`Archive._to_device`): the arrays become tensors
  on the codec's device.

The batched read path (``iter_decode`` / ``read_all``) decodes chunks in
groups through ``decompress_batch`` (one decode-write dispatch per CR class
a group) while one prefetch thread runs the host half of group N+1: it
only reads and CRCs.  The device half, plan building and every kernel
launch run on the caller's thread, on its current stream.  Phase 1-3 plans
come from the ``PlanCache`` keyed by chunk digest; a warm cache rebuilds
zero plans (``DecodeBackend.stats["plan_builds"]``).
"""

from __future__ import annotations

import concurrent.futures as futures
import mmap
import os

import numpy as np
import torch

from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, default_codec
from repro_torch.core.huffman import codebook as cb
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.huffman.encode import EncodedStream
from repro_torch.core.sz import compressor as sz
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.store import format as F

DEFAULT_GROUP_CHUNKS = 8


def _build_codebook(rec: F.CodebookRecord, enc_code, enc_len) -> cb.Codebook:
    dec_sym, dec_len = cb.build_decode_lut(enc_code, enc_len, rec.max_len)
    return cb.Codebook(n_symbols=rec.n_symbols, max_len=rec.max_len,
                       enc_code=np.array(enc_code),
                       enc_len=np.array(enc_len),
                       dec_sym=dec_sym, dec_len=dec_len)


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of an archive's dtype string ("float32",
    "bfloat16", ...)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise F.StoreCorruptError(f"dtype {name!r} has no torch dtype")
    return dt


def _host_value(t):
    """``as_numpy``'s host value: a numpy array, or a CPU tensor for a
    dtype numpy cannot hold (bfloat16)."""
    t = t.cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


class Archive:
    """One open ``.szt`` archive (use as a context manager)."""

    def __init__(self, path: str, *, codec: "Codec | None" = None,
                 plan_cache: "PlanCache | None" = None):
        self.path = path
        self.codec = codec if codec is not None else default_codec()
        self.cache = (self.codec.plan_cache if plan_cache is None
                      else plan_cache)
        #: Degradation counters: chunks dropped / zeroed by a non-raise
        #: recovery policy, and transient-IO retries spent on this archive.
        self.stats = {"chunks_skipped": 0, "chunks_zero_filled": 0,
                      "io_retries": 0}
        # Transient IO errors (OSError) while opening retry per the codec's
        # recovery policy; corruption (StoreError) never retries.
        ft.with_retries(self._open, self.codec.recovery_policy(),
                        on_retry=self._count_retry)

    def _count_retry(self, attempt, exc):
        self.stats["io_retries"] += 1

    def _open(self):
        path = self.path
        size = os.path.getsize(path)
        self._f = open(path, "rb")
        try:
            if size < F.HEADER_SIZE:
                raise F.StoreCorruptError(
                    f"{path}: truncated archive ({size} bytes)")
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
            head = F.unpack_header(self._mm[:F.HEADER_SIZE])
            lo, n = head["index_off"], head["index_len"]
            if lo + n > size:
                raise F.StoreCorruptError(
                    f"{path}: truncated archive (index extends to byte "
                    f"{lo + n} of a {size}-byte file)")
            index = self._mm[lo:lo + n]
            if F.crc32_arrays(np.frombuffer(index, np.uint8)) != \
                    head["index_crc"]:
                raise F.StoreCorruptError(f"{path}: index checksum mismatch")
            self._codebooks, chunks = F.unpack_index(index)
            self._cb_by_digest = {c.digest: c for c in self._codebooks}
            self._chunks = {c.name: c for c in chunks}
            if len(self._chunks) != head["n_chunks"]:
                raise F.StoreCorruptError(
                    f"{path}: header declares {head['n_chunks']} chunks, "
                    f"index holds {len(self._chunks)}")
        except BaseException:
            if getattr(self, "_mm", None) is not None:
                self._mm.close()
                self._mm = None
            self._f.close()
            raise

    # -- introspection ------------------------------------------------------

    @property
    def names(self) -> list:
        return list(self._chunks)

    def __len__(self):
        return len(self._chunks)

    def __contains__(self, name):
        return name in self._chunks

    def chunk(self, name: str) -> F.ChunkRecord:
        try:
            return self._chunks[name]
        except KeyError:
            raise KeyError(f"{self.path}: no chunk named {name!r}") from None

    @property
    def n_codebooks(self) -> int:
        return len(self._codebooks)

    # -- raw access ---------------------------------------------------------

    def _blob(self, ref: F.BlobRef, dtype) -> np.ndarray:
        """A copy of one blob (never a view of the map)."""
        if ref.offset + ref.length > len(self._mm):
            raise F.StoreCorruptError(
                f"{self.path}: blob at {ref.offset}+{ref.length} extends "
                f"past end of file")
        return np.frombuffer(self._mm, dtype=dtype, count=ref.length
                             // np.dtype(dtype).itemsize,
                             offset=ref.offset).copy()

    def codebook(self, digest: str) -> cb.Codebook:
        rec = self._cb_by_digest[digest]

        def build():
            enc_code = self._blob(rec.enc_code, np.uint32)
            enc_len = self._blob(rec.enc_len, np.uint8)
            if F.crc32_arrays(enc_code, enc_len) != rec.crc32:
                raise F.StoreCorruptError(
                    f"{self.path}: codebook {digest[:12]} checksum mismatch")
            return _build_codebook(rec, enc_code, enc_len)

        return self.cache.get_codebook(digest, build)

    def _read_host(self, name: str, validate: bool = True) -> tuple:
        """The host half of a chunk read: its record, its codebook and its
        four blobs copied out of the map, CRC-checked.  No tensor is made
        here: this is what the prefetch thread runs."""
        rec = self.chunk(name)
        units = self._blob(rec.units, np.uint32)
        gaps = self._blob(rec.gaps, np.uint8)
        opos = self._blob(rec.outlier_pos, np.int32)
        oval = self._blob(rec.outlier_val, np.int32)
        if validate and F.crc32_arrays(units, gaps, opos, oval) != rec.crc32:
            raise F.StoreCorruptError(
                f"{self.path}: chunk {name!r} payload checksum mismatch "
                f"(corrupt or truncated archive)")
        return rec, self.codebook(rec.codebook), units, gaps, opos, oval

    def _to_device(self, host: tuple) -> sz.Compressed:
        """The device half: a ``Compressed`` on the codec's device."""
        rec, book, units, gaps, opos, oval = host
        device = self.codec.device

        def t(a):
            return torch.from_numpy(a).to(device)

        n_subseq = gaps.shape[0]
        stream = EncodedStream(
            units=t(units), gaps=t(gaps),
            # Ground-truth counts are not stored: the decoder recomputes
            # them on device in phase 1 (or loads a cached plan).
            counts=torch.zeros(n_subseq, dtype=torch.int32, device=device),
            seq_counts=torch.zeros(n_subseq // rec.subseqs_per_seq,
                                   dtype=torch.int32, device=device),
            total_bits=rec.total_bits, n_symbols=rec.n_symbols,
            subseqs_per_seq=rec.subseqs_per_seq)
        c = sz.Compressed(
            stream=stream, codebook=book, outlier_pos=t(opos),
            outlier_val=t(oval), shape=rec.shape,
            dtype=_torch_dtype(rec.dtype), eb=rec.eb, radius=rec.radius,
            rel_range=rec.rel_range, max_abs=rec.max_abs)
        # Seed the content digest from the index record so a direct
        # ``Codec.decompress`` of this tensor shares the archive's
        # plan-cache entries without re-hashing the payload.
        c._digest = rec.digest
        return c

    def read_chunk(self, name: str, validate: bool = True) -> sz.Compressed:
        """Read (and optionally CRC-check) one chunk into a ``Compressed``
        on the codec's device."""
        return self._to_device(self._read_host(name, validate=validate))

    # -- decoded access -----------------------------------------------------

    def _plan_for(self, rec: F.ChunkRecord, c, method: str, t_high: int,
                  backend):
        key = (rec.digest, method, t_high)
        return self.cache.get_or_build_plan(
            key, lambda: hp.build_plan(c.stream, c.codebook, method=method,
                                       backend=backend, t_high=t_high))

    def _recover(self, name: str, exc, pol, on_error):
        """Apply the recovery policy to one failed chunk.

        Returns the substitute tensor (``zero_fill``), ``None`` (``skip``,
        counted), or raises the named error (``raise``).
        """
        if on_error is not None:
            on_error(name, exc)
        if pol.on_error == "raise":
            raise exc
        if pol.on_error == "zero_fill":
            rec = self._chunks.get(name)
            if rec is not None:
                self.stats["chunks_zero_filled"] += 1
                return torch.zeros(rec.shape,
                                   dtype=_torch_dtype(rec.orig_dtype),
                                   device=self.codec.device)
        self.stats["chunks_skipped"] += 1
        return None

    def iter_decode(self, names=None, *, group_chunks: int =
                    DEFAULT_GROUP_CHUNKS, method: "str | None" = None,
                    backend: "str | None" = None, t_high: "int | None" = None,
                    fused: "bool | None" = None, validate: bool = True,
                    prefetch: bool = True, policy=None, on_error=None,
                    as_numpy: bool = False):
        """Yield ``(name, decoded tensor)`` with I/O overlapped against
        decode.

        Chunks stream in groups of ``group_chunks``: each group decodes as
        one ``decompress_batch`` call on the caller's thread while the
        prefetch thread reads and CRC-validates the next group.  Decoded
        tensors stay on the codec's device, cast to each chunk's recorded
        ``orig_dtype``.  Decode policy (sync method, backend, tuner
        ``t_high``, ``fused``) defaults to the archive's codec; the keyword
        overrides exist for benchmarking alternates.

        Failure handling: the prefetch thread captures per-chunk errors and
        hands them to the consumer loop, so an exception in group N+1's
        read/validate deterministically reaches the caller.  ``policy`` (a
        string or ``RecoveryPolicy``; default: the codec's ``recovery``
        config) decides what happens per failed chunk: ``"raise"``
        propagates the named error, ``"skip"`` omits the entry (counted in
        ``stats["chunks_skipped"]``), ``"zero_fill"`` yields zeros of the
        recorded shape/dtype (``stats["chunks_zero_filled"]``).  Transient
        ``OSError`` reads retry with backoff first (``stats["io_retries"]``).
        ``on_error(name, exc)`` is invoked for every failed chunk before
        the policy applies.

        ``as_numpy`` yields host values instead of device tensors: numpy
        arrays, and CPU tensors for bfloat16 (which numpy cannot hold).
        """
        cfg = self.codec.config
        method = cfg.method if method is None else method
        t_high = cfg.t_high if t_high is None else t_high
        fused = cfg.fused if fused is None else fused
        be = (self.codec.backend if backend is None
              else hp.get_backend(backend))
        pol = self.codec.recovery_policy(policy)
        names = self.names if names is None else list(names)
        groups = [names[i:i + group_chunks]
                  for i in range(0, len(names), group_chunks)]
        if not groups:
            return

        def load_one(name):
            return ft.with_retries(
                lambda: self._read_host(name, validate=validate), pol,
                on_retry=self._count_retry)

        def load(group):
            # Per-chunk outcomes (host arrays or the exception), NOT a
            # raise: raising here would kill the prefetch thread and lose
            # the error; the consumer loop applies the recovery policy.
            out = []
            for n in group:
                try:
                    out.append(load_one(n))
                except F.StoreError as e:
                    out.append(e)
                except OSError as e:
                    err = F.StoreIOError(
                        f"{self.path}: reading chunk {n!r} failed after "
                        f"{pol.retries} retries: {e}")
                    err.__cause__ = e
                    out.append(err)
            return out

        pool = (futures.ThreadPoolExecutor(
            1, thread_name_prefix="szt-prefetch")
            if prefetch and len(groups) > 1 else None)
        try:
            nxt = pool.submit(load, groups[0]) if pool else None
            for gi, group in enumerate(groups):
                blobs = nxt.result() if pool else load(group)
                if pool and gi + 1 < len(groups):
                    nxt = pool.submit(load, groups[gi + 1])

                failed = {}                      # name -> named exception
                ok_names, ok_cs, ok_plans = [], [], []
                for n, host in zip(group, blobs):
                    if isinstance(host, Exception):
                        failed[n] = host
                        continue
                    c = self._to_device(host)
                    try:
                        plan = self._plan_for(self.chunk(n), c, method,
                                              t_high, be)
                    except hp.DecodeGuardError as e:
                        failed[n] = e
                        continue
                    ok_names.append(n)
                    ok_cs.append(c)
                    ok_plans.append(plan)

                outs = {}
                if ok_cs:
                    try:
                        decoded = sz.decompress_batch(
                            ok_cs, method=method, tile_syms=cfg.tile_syms,
                            backend=be, strategy=cfg.strategy,
                            t_high=t_high, plans=ok_plans, fused=fused)
                        outs = dict(zip(ok_names, decoded))
                    except hp.DecodeGuardError:
                        # Salvage the group chunk-by-chunk so one malformed
                        # stream cannot take down its batch-mates.
                        for n, c, p in zip(ok_names, ok_cs, ok_plans):
                            try:
                                outs[n] = sz.decompress(
                                    c, method=method,
                                    tile_syms=cfg.tile_syms, backend=be,
                                    strategy=cfg.strategy, t_high=t_high,
                                    plan=p, fused=fused)
                            except hp.DecodeGuardError as e:
                                failed[n] = e

                for name in group:
                    if name in outs:
                        out = outs[name].to(
                            _torch_dtype(self.chunk(name).orig_dtype))
                        yield name, _host_value(out) if as_numpy else out
                        continue
                    sub = self._recover(name, failed[name], pol, on_error)
                    if sub is not None:
                        yield name, _host_value(sub) if as_numpy else sub
        finally:
            if pool:
                pool.shutdown(wait=False, cancel_futures=True)

    def read_all(self, names=None, **kwargs) -> dict:
        """Decode ``names`` (default: every chunk) into {name: tensor}."""
        return dict(self.iter_decode(names, **kwargs))

    def read_tensor(self, name: str, **kwargs):
        return self.read_all([name], **kwargs)[name]

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        # Every blob was copied out of the map, so no tensor or array can
        # hold a view of it: unmapping is always safe.
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def open_archive(path: str, **kwargs) -> Archive:
    return Archive(path, **kwargs)
