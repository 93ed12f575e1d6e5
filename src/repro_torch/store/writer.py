"""Streaming archive writer with codebook dedup and atomic publish.

Port of ``src/repro/store/writer.py``: the same bytes for the same
payloads (header, blobs, alignment padding and JSON index), with tensors
copied to the host before they are written.

``ArchiveWriter`` appends chunk payloads to a temp file as tensors are
added (so a many-GiB checkpoint never has to be resident twice), then
writes the JSON index + header and atomically renames into place -- a
reader can never observe a half-written archive.

Codebooks are deduplicated by content digest: N tensors that quantize to
the same histogram (e.g. the K and V halves of a KV block, or identically
initialized layers) share one on-disk table and, via the plan cache, one
device LUT.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.huffman.pipeline import T_HIGH_DEFAULT
from repro_torch.core.sz.compressor import dtype_name
from repro_torch.store import format as F


def _host(a, dtype) -> np.ndarray:
    """A tensor (copied to the host) or array as numpy of ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _dtype_str(dtype) -> str:
    """A torch dtype, numpy dtype or name as the archive's dtype string."""
    if isinstance(dtype, torch.dtype):
        return dtype_name(dtype)
    return str(dtype)


def _overall_cr_class(n_symbols: int, total_bits: int,
                      t_high: int = T_HIGH_DEFAULT) -> int:
    """Whole-chunk CR class: same (decoded bytes / encoded bytes) metric the
    per-sequence tuner uses, summarized for scheduling/stats."""
    enc_bytes = max(total_bits // 8, 1)
    ratio = n_symbols * 2 / enc_bytes
    return int(np.clip(np.ceil(ratio), 1, t_high + 1))


class ArchiveWriter:
    """Write one ``.szt`` archive; use as a context manager or call close().

    ``codec`` (default: ``repro_torch.core.default_codec()``) matters only
    for ``add_array``, which compresses through it; ``add`` accepts
    already-compressed tensors from any codec, on any device.
    """

    def __init__(self, path: str, *, codec=None):
        self.path = path
        self._codec = codec
        self._tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(self._tmp, "wb")
        self._f.write(b"\0" * F.HEADER_SIZE)
        self._off = F.HEADER_SIZE
        self._codebooks: dict[str, F.CodebookRecord] = {}
        self._chunks: list[F.ChunkRecord] = []
        self._names: set[str] = set()
        self._closed = False

    # -- low-level ----------------------------------------------------------

    def _write_blob(self, arr) -> F.BlobRef:
        pad = F.align_up(self._off) - self._off
        if pad:
            self._f.write(b"\0" * pad)
            self._off += pad
        buf = np.ascontiguousarray(arr).tobytes()
        self._f.write(buf)
        ref = F.BlobRef(offset=self._off, length=len(buf))
        self._off += len(buf)
        return ref

    def _add_codebook(self, book) -> str:
        digest = F.codebook_digest(book.enc_code, book.enc_len, book.max_len)
        if digest not in self._codebooks:
            enc_code = np.asarray(book.enc_code, np.uint32)
            enc_len = np.asarray(book.enc_len, np.uint8)
            self._codebooks[digest] = F.CodebookRecord(
                digest=digest, n_symbols=int(book.n_symbols),
                max_len=int(book.max_len),
                enc_code=self._write_blob(enc_code),
                enc_len=self._write_blob(enc_len),
                crc32=F.crc32_arrays(enc_code, enc_len))
        return digest

    # -- public -------------------------------------------------------------

    def add(self, name: str, compressed, orig_dtype: "str | None" = None):
        """Append one compressed tensor (a ``core.sz.Compressed``) as a chunk.

        ``orig_dtype`` (a name or a torch dtype) records the dtype to cast
        to on restore when it differs from the reconstruction dtype (e.g.
        bfloat16 params that decode through float32).
        """
        if self._closed:
            raise F.StoreError("writer already closed")
        if name in self._names:
            raise F.StoreError(f"duplicate chunk name {name!r}")
        self._names.add(name)
        c = compressed
        cb_digest = self._add_codebook(c.codebook)

        units = _host(c.stream.units, np.uint32)
        gaps = _host(c.stream.gaps, np.uint8)
        opos = _host(c.outlier_pos, np.int32)
        oval = _host(c.outlier_val, np.int32)
        # Integrity CRC covers the stored (padded) blobs exactly as written;
        # the *digest* hashes only content (valid outlier prefix), so the
        # plan-cache key is independent of pad width / producing backend.
        crc = F.crc32_arrays(units, gaps, opos, oval)
        content_crc = F.payload_crc(units, gaps, opos, oval)

        units_ref = self._write_blob(units)
        total_bits = int(c.stream.total_bits)
        n_symbols = int(c.stream.n_symbols)
        sps = int(c.stream.subseqs_per_seq)
        self._chunks.append(F.ChunkRecord(
            name=name,
            shape=tuple(int(s) for s in c.shape),
            dtype=_dtype_str(c.dtype),
            orig_dtype=_dtype_str(orig_dtype or c.dtype),
            codebook=cb_digest,
            units=units_ref,
            gaps=self._write_blob(gaps),
            outlier_pos=self._write_blob(opos),
            outlier_val=self._write_blob(oval),
            bit_offset=units_ref.offset * 8,
            total_bits=total_bits,
            n_symbols=n_symbols,
            subseqs_per_seq=sps,
            eb=float(c.eb),
            radius=int(c.radius),
            rel_range=float(c.rel_range),
            max_abs=float(c.max_abs),
            cr_class=_overall_cr_class(n_symbols, total_bits),
            crc32=crc,
            digest=F.chunk_digest(content_crc, total_bits, n_symbols, sps,
                                  cb_digest),
        ))

    def add_array(self, name: str, arr, orig_dtype: "str | None" = None):
        """Compress ``arr`` through the writer's codec and append it."""
        if self._codec is None:
            from repro_torch.core.codec import default_codec
            self._codec = default_codec()
        self.add(name, self._codec.compress(arr), orig_dtype=orig_dtype)

    def checksums(self) -> dict:
        """{chunk name: payload CRC32} for everything added so far (e.g. to
        cross-record in an external manifest)."""
        return {c.name: c.crc32 for c in self._chunks}

    def close(self):
        if self._closed:
            return
        self._closed = True
        index = F.pack_index(list(self._codebooks.values()), self._chunks)
        index_off = self._off
        self._f.write(index)
        self._f.seek(0)
        self._f.write(F.pack_header(
            n_chunks=len(self._chunks), n_codebooks=len(self._codebooks),
            index_off=index_off, index_len=len(index),
            index_crc=F.crc32_arrays(np.frombuffer(index, np.uint8))))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self.path)

    def abort(self):
        if not self._closed:
            self._closed = True
            self._f.close()
            os.unlink(self._tmp)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


def write_archive(path: str, entries) -> None:
    """Write ``entries`` (iterable of (name, Compressed) or
    (name, Compressed, orig_dtype)) as one archive."""
    with ArchiveWriter(path) as w:
        for e in entries:
            w.add(*e)
