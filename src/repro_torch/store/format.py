"""On-disk layout of the compressed tensor store (``.szt`` archives).

Port of ``src/repro/store/format.py``: the same layout, records, JSON index
and errors, so an archive written by either package reads in the other and
the same payloads give byte-identical files.

One archive holds MANY compressed tensors (chunks) plus a *deduplicated*
codebook table; see ``docs/format.md`` for the normative byte-level spec.
Layout (all integers little-endian):

    [ header | payload blobs ... | index (JSON) ]

* **Header** -- fixed ``HEADER_SIZE`` bytes at offset 0: magic, format
  version, chunk/codebook counts, and the (offset, length, crc32) of the
  index section.  The header is the only thing a reader must parse before
  it can seek anywhere, which keeps the open path one small read + one
  index read even for multi-GiB archives.
* **Payload blobs** -- raw C-order array bytes, each aligned to
  ``BLOB_ALIGN`` so an mmap'd archive yields aligned, zero-copy
  ``np.frombuffer`` views (which the reader copies before they reach a
  tensor).  Blobs are the encoded unit arrays, gap arrays,
  outlier side lists, and the codebook tables.
* **Index** -- one JSON object (codebook records + chunk records) at the
  end of the file, so the writer can stream payload first and the reader
  can locate everything from the header.

Chunk records carry the *bit* offset and length of the tensor's payload
inside the units blob space, the gap-array blob, the CR class summary, and
a CRC32 over the chunk's payload bytes.  Codebook records are keyed by a
content digest; two tensors with identical histograms share one table on
disk and one decode LUT in memory.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch

from repro_torch.core.cache import (  # noqa: F401  (re-exports: digests in
    chunk_digest,               # core so the Codec's plan-cache keys and the
    codebook_digest,            # archive's are one namespace)
    crc32_arrays,
    payload_crc,
)

MAGIC = b"SZTSTORE"
FORMAT_VERSION = 1
HEADER_SIZE = 64
BLOB_ALIGN = 64

# --- sharded layout (the distributed restore, ``repro_torch.distributed``) -
# A mesh-sharded archive is a directory: one JSON manifest mapping entries
# to per-host tile chunks, plus N ordinary ``.szt`` shard files (each a
# fully self-describing archive of this format).  The manifest version is
# independent of FORMAT_VERSION: shard payload bytes never change meaning
# when the manifest schema evolves.
SHARD_MANIFEST_NAME = "shard_manifest.json"
SHARD_MANIFEST_VERSION = 1


def shard_filename(shard: int) -> str:
    """Canonical shard file name inside a sharded-archive directory."""
    return f"shard_{shard:05d}.szt"

# struct: magic, version, flags, n_chunks, n_codebooks, index_off, index_len,
# index_crc, then zero padding up to HEADER_SIZE.
_HEADER_FMT = "<8sIIIIQQI"
_HEADER_USED = struct.calcsize(_HEADER_FMT)


class StoreError(RuntimeError):
    """Base class for archive format errors."""


class StoreVersionError(StoreError):
    """Archive was written by an incompatible format version."""


class StoreCorruptError(StoreError):
    """Archive is truncated or fails a checksum."""


class StoreIOError(StoreError):
    """An OS-level read failed and retries (if configured) were exhausted.

    Wraps the underlying ``OSError`` so store consumers catch one exception
    family whether bytes were corrupt or the filesystem misbehaved."""


@dataclasses.dataclass(frozen=True)
class BlobRef:
    """Byte extent of one payload blob inside the archive file."""

    offset: int
    length: int

    def to_json(self):
        return [self.offset, self.length]

    @classmethod
    def from_json(cls, v) -> "BlobRef":
        return cls(offset=int(v[0]), length=int(v[1]))


@dataclasses.dataclass
class CodebookRecord:
    """One deduplicated codebook table (referenced by chunks via digest)."""

    digest: str              # content digest of (enc_code, enc_len, max_len)
    n_symbols: int
    max_len: int
    enc_code: BlobRef        # uint32[n_symbols]
    enc_len: BlobRef         # uint8[n_symbols]
    crc32: int               # CRC32 over (enc_code, enc_len) payload bytes

    def to_json(self):
        return {"digest": self.digest, "n_symbols": self.n_symbols,
                "max_len": self.max_len, "enc_code": self.enc_code.to_json(),
                "enc_len": self.enc_len.to_json(), "crc32": self.crc32}

    @classmethod
    def from_json(cls, d) -> "CodebookRecord":
        return cls(digest=d["digest"], n_symbols=int(d["n_symbols"]),
                   max_len=int(d["max_len"]),
                   enc_code=BlobRef.from_json(d["enc_code"]),
                   enc_len=BlobRef.from_json(d["enc_len"]),
                   crc32=int(d["crc32"]))


@dataclasses.dataclass
class ChunkRecord:
    """One compressed tensor: payload extents + decode metadata + checksum."""

    name: str
    shape: tuple
    dtype: str               # reconstruction dtype of the decoded tensor
    orig_dtype: str          # dtype of the original array (may be bfloat16)
    codebook: str            # digest key into the codebook table
    units: BlobRef           # uint32 payload units
    gaps: BlobRef            # uint8[n_subseq] gap array
    outlier_pos: BlobRef     # int32[m_pad]
    outlier_val: BlobRef     # int32[m_pad]
    bit_offset: int          # bit position of this chunk in the units space
    total_bits: int
    n_symbols: int           # quantization codes encoded in the stream
    subseqs_per_seq: int
    eb: float
    radius: int
    rel_range: float
    max_abs: float
    cr_class: int            # ceil(overall CR) clipped to [1, t_high+1]
    crc32: int               # CRC32 over the chunk's payload bytes
    digest: str              # stable content digest (plan-cache key)

    def to_json(self):
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        for f in ("units", "gaps", "outlier_pos", "outlier_val"):
            d[f] = getattr(self, f).to_json()
        return d

    @classmethod
    def from_json(cls, d) -> "ChunkRecord":
        kw = dict(d)
        kw["shape"] = tuple(int(s) for s in d["shape"])
        for f in ("units", "gaps", "outlier_pos", "outlier_val"):
            kw[f] = BlobRef.from_json(d[f])
        return cls(**kw)


def pack_header(n_chunks: int, n_codebooks: int, index_off: int,
                index_len: int, index_crc: int) -> bytes:
    head = struct.pack(_HEADER_FMT, MAGIC, FORMAT_VERSION, 0,
                       n_chunks, n_codebooks, index_off, index_len, index_crc)
    return head + b"\0" * (HEADER_SIZE - _HEADER_USED)


def unpack_header(buf: bytes) -> dict:
    if len(buf) < HEADER_SIZE:
        raise StoreCorruptError(
            f"archive truncated: {len(buf)} bytes is smaller than the "
            f"{HEADER_SIZE}-byte header")
    magic, version, _flags, n_chunks, n_codebooks, index_off, index_len, \
        index_crc = struct.unpack(_HEADER_FMT, buf[:_HEADER_USED])
    if magic != MAGIC:
        raise StoreError(f"not a tensor-store archive (magic {magic!r})")
    if version != FORMAT_VERSION:
        raise StoreVersionError(
            f"archive format version {version} unsupported "
            f"(reader supports {FORMAT_VERSION})")
    return {"n_chunks": n_chunks, "n_codebooks": n_codebooks,
            "index_off": index_off, "index_len": index_len,
            "index_crc": index_crc}


def pack_index(codebooks: list, chunks: list) -> bytes:
    doc = {"codebooks": [c.to_json() for c in codebooks],
           "chunks": [c.to_json() for c in chunks]}
    return json.dumps(doc, separators=(",", ":")).encode("utf-8")


def unpack_index(buf: bytes) -> tuple:
    try:
        doc = json.loads(buf.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise StoreCorruptError(f"archive index is unreadable: {e}") from e
    try:
        records = ([CodebookRecord.from_json(c) for c in doc["codebooks"]],
                   [ChunkRecord.from_json(c) for c in doc["chunks"]])
    except (KeyError, TypeError, ValueError, IndexError) as e:
        # CRC-valid JSON with mangled structure (e.g. an in-memory mutation
        # before the CRC was stamped) must still fail with a named error.
        raise StoreCorruptError(
            f"archive index is structurally invalid: "
            f"{type(e).__name__}: {e}") from e
    for rec in records[1]:
        validate_record(rec)
    return records


def _dtype_ok(name) -> bool:
    """True when ``name`` parses as a numpy dtype or names a torch floating
    dtype (bfloat16 and the float8 types, which numpy does not know) --
    the names the reference accepts through numpy and ``ml_dtypes``."""
    try:
        np.dtype(name)
        return True
    except TypeError:
        pass
    return isinstance(getattr(torch, str(name), None), torch.dtype)


def validate_record(rec: ChunkRecord) -> None:
    """Sanity-check a parsed chunk record before any payload is touched.

    The index CRC proves the *bytes* of the index survived; this proves the
    *values* are self-consistent, so a record mangled before it was CRC'd
    (or mutated in memory) cannot drive giant allocations or unnamed
    downstream errors.  Raises ``StoreCorruptError``.
    """
    problems = []
    for f in ("units", "gaps", "outlier_pos", "outlier_val"):
        ref = getattr(rec, f)
        if ref.offset < 0 or ref.length < 0:
            problems.append(f"negative {f} extent {ref.offset}+{ref.length}")
    n = 1
    for s in rec.shape:
        if s < 0:
            problems.append(f"negative dimension in shape {rec.shape}")
            break
        n *= s
    else:
        if n != rec.n_symbols:
            problems.append(f"n_symbols={rec.n_symbols} != prod(shape "
                            f"{rec.shape})={n}")
    if rec.total_bits < 0:
        problems.append(f"negative total_bits {rec.total_bits}")
    elif rec.total_bits > 8 * rec.units.length:
        problems.append(f"total_bits={rec.total_bits} exceeds the units "
                        f"blob ({rec.units.length} bytes)")
    if rec.subseqs_per_seq < 1:
        problems.append(f"subseqs_per_seq={rec.subseqs_per_seq} < 1")
    for f in ("dtype", "orig_dtype"):
        if not _dtype_ok(getattr(rec, f)):
            problems.append(f"unparseable {f} {getattr(rec, f)!r}")
    if problems:
        raise StoreCorruptError(
            f"chunk record {rec.name!r} is invalid: " + "; ".join(problems))


def align_up(off: int, align: int = BLOB_ALIGN) -> int:
    return (off + align - 1) // align * align
