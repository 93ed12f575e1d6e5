"""Plan/execute decoder pipeline: the single entry point for decoding.

Port of ``src/repro/core/huffman/pipeline.py``:

    build_plan()    phases 1-3: sync starts from the gap array
                    (``method="gap"``) or by self-synchronization
                    (``method="selfsync"``, with the ``early_exit``
                    toggle), per-subsequence counts, output-offset prefix
                    sum; the per-CR-class dispatch plan (paper Alg. 2) is
                    built from the plan's per-sequence counts on first
                    read (``plan.classes``).
    decode()        phase 4 through a named *backend*; strategies:
                    "tile"   fixed-tile staged decode-write (paper Alg. 1),
                    "tuned"  per-CR-class tile decode (paper Alg. 1 + 2),
                    "padded" padded-layout baseline (the original decoders'
                             uncoalesced-write cost structure).
                    With an ``OutputTransform`` the "tile" and "padded"
                    strategies run their fused form: decode -> dequantize
                    -> inverse Lorenzo (``fused=True``).
    decode_batch()  class-merged decode of many tensors: sequences of equal
                    CR class from all tensors go into one decode-write
                    dispatch, so N tensors cost one dispatch per class.

Backends live in a registry: "ref" is the plain torch reference
(``core.huffman.decode``); "cuda" runs the hand-written CUDA kernels
(``repro_torch.kernels.ops``) for CUDA tensors and their plain versions for
CPU tensors.  Every backend counts plan builds and decode-write dispatches
in ``backend.stats``.  The encode side has a registry of its own: "ref" is
the reference's host path (float64 prequantization, exact histogram, the
bit-pack as torch ops); "cuda" is the device write path (float32 quantize,
histogram and bit-pack as CUDA kernels, their plain versions for CPU
tensors), the port's counterpart of the reference's "jnp", "pallas" and
"pallas-compiled" encode backends, which are no names of the port.

Options whose code is not ported yet (``UNPORTED``, empty now) raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.huffman import codebook as _cb
from repro_torch.core.huffman import decode as hd
from repro_torch.core.huffman import encode as he
from repro_torch.core.huffman.bits import SUBSEQ_BITS, UNIT_BITS
from repro_torch.core.huffman.encode import EncodedStream


class DecodeGuardError(RuntimeError):
    """A decoder-level integrity guard tripped on malformed input.

    Raised by ``build_plan`` (corrupt codebook) and by the symbol-count
    guard in ``sz.compressor.decompress``.  Every trip -- including
    non-raising containment such as gap clamping -- is counted in
    ``backend.stats["decode_guard_trips"]``.
    """


# Paper Alg. 2 constants: class c in {1..T_high} covers CR in (c-1, c];
# class T_high+1 covers (T_high, 16].
T_HIGH_DEFAULT = 8          # the paper's V100 value, kept as the reference's
OVERFLOW_TILE = 3584        # paper: optimal buffer for CR > T_high on V100
SYMBOL_BYTES = 2
DEFAULT_TILE_SYMS = 4096

#: Decode-write strategies accepted by ``decode`` (and ``CodecConfig``).
VALID_STRATEGIES = ("tuned", "tile", "padded")
#: Sync-discovery methods of the reference: the methods that build a plan.
VALID_PLAN_METHODS = ("gap", "selfsync")
#: Every decode method of the reference: the plan methods and the
#: sequential oracle "naive_ref", which builds no plan
#: (:func:`decode_naive_ref`).
VALID_METHODS = VALID_PLAN_METHODS + ("naive_ref",)

#: Options of the reference whose code waits for a later slice, and the
#: ROADMAP.md item that ports each (none left).
UNPORTED: dict = {}


def check_ported(option: str, value) -> None:
    """Raise ``NotImplementedError`` for an option the port lacks so far."""
    item = UNPORTED.get((option, value))
    if item is not None:
        raise NotImplementedError(
            f"{option}={value!r} is not ported to repro_torch yet; see "
            f"ROADMAP.md {item}")


def ss_max_for_tile(tile_syms: int, max_len: int) -> int:
    """Static bound on subsequences overlapping one ``tile_syms`` output tile.

    A 128-bit subsequence holds at least ``(SUBSEQ_BITS - max_len) //
    max_len + 1`` codeword starts, so a tile overlaps at most ``tile_syms /
    min_starts`` whole subsequences plus one partial one at each edge.  The
    tile kernel's lane budget.
    """
    min_starts = (SUBSEQ_BITS - max_len) // max_len + 1
    return tile_syms // min_starts + 2


# ---------------------------------------------------------------------------
# CR classification (paper Alg. 2: CLASSIFY / HISTOGRAM / SORT / plan)
# ---------------------------------------------------------------------------
# Host numpy over the per-sequence counts the plan already holds: built only
# when the "tuned" strategy or ``decode_batch`` reads it, so the default
# "tile" path never pays for it.


def sequence_ratios(seq_counts, subseqs_per_seq: int) -> np.ndarray:
    """Per-sequence compression ratio: decoded bytes / encoded bytes
    (float32, as in the reference)."""
    enc_bytes = subseqs_per_seq * SUBSEQ_BITS // 8
    return (np.asarray(seq_counts).astype(np.float32)
            * np.float32(SYMBOL_BYTES) / np.float32(enc_bytes))


def classify(ratios, t_high: int = T_HIGH_DEFAULT) -> np.ndarray:
    """CLASSIFYCR: CR in (c-1, c] -> class c; CR > t_high -> t_high + 1."""
    return np.clip(np.ceil(ratios).astype(np.int32), 1, t_high + 1)


def class_histogram(classes, t_high: int = T_HIGH_DEFAULT) -> np.ndarray:
    """HISTOGRAM: sequences per class, over classes 0..t_high+1."""
    return np.bincount(classes, minlength=t_high + 2)


def sort_by_class(classes):
    """ParKeyValueSort: stable sort of sequence ids by class; returns
    (sorted classes, sequence ids)."""
    order = np.argsort(classes, kind="stable").astype(np.int32)
    return classes[order], order


def tile_for_class(c: int, t_high: int = T_HIGH_DEFAULT) -> int:
    """Buffer (tile) size for a class: 1024 symbols per CR unit, as in the
    paper ("sequences in the (3,4] group ... buffer of length 4096"), with
    the overflow class pinned at OVERFLOW_TILE.  The paper's V100 values,
    kept as the reference's: the output does not depend on them."""
    if c > t_high:
        return OVERFLOW_TILE
    return 1024 * max(c, 1)


def max_class_tile(t_high: int = T_HIGH_DEFAULT) -> int:
    """The largest tile any class of ``t_high`` uses."""
    return max(tile_for_class(c, t_high) for c in range(1, t_high + 2))


@dataclasses.dataclass
class ClassPlan:
    """Host-side per-CR-class dispatch plan (per-class sequence id lists)."""

    t_high: int
    classes: np.ndarray          # int32[n_seq]
    seq_order: np.ndarray        # int32[n_seq] sequence ids sorted by class
    class_start: np.ndarray      # int32[t_high+3] prefix offsets into seq_order
    tile_syms: dict              # class -> tile size

    def class_seq_ids(self, c: int) -> np.ndarray:
        lo, hi = int(self.class_start[c]), int(self.class_start[c + 1])
        return self.seq_order[lo:hi]


def make_plan(stream, seq_counts, subseqs_per_seq: int,
              t_high: int = T_HIGH_DEFAULT) -> ClassPlan:
    """Build the per-CR-class dispatch plan from per-sequence symbol counts
    (``stream`` is accepted and ignored, as in the reference)."""
    del stream
    classes = classify(sequence_ratios(seq_counts, subseqs_per_seq), t_high)
    hist = class_histogram(classes, t_high)
    _, order = sort_by_class(classes)
    class_start = np.zeros(t_high + 3, np.int32)
    class_start[1:] = np.cumsum(hist)
    return ClassPlan(
        t_high=t_high, classes=classes, seq_order=order,
        class_start=class_start,
        tile_syms={c: tile_for_class(c, t_high) for c in range(1, t_high + 2)})


# ---------------------------------------------------------------------------
# Decode backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OutputTransform:
    """Fused decode epilogue: dequantization + inverse Lorenzo attached to a
    decode call, so phase 4 emits reconstructed floats directly.

    The transform is ``x = 2*eb * cumsum(code - radius)`` with the outlier
    side list (``outlier_pos`` int32[m_pad] flat positions, -1 padded;
    ``outlier_val`` the exact residuals) scattered in before the prefix sum
    -- exactly ``core.sz.lorenzo.dequantize``.  ``shape`` selects the
    geometry: ``None`` (or at most one non-unit axis) is the 1-D epilogue,
    2-D/3-D shapes cumsum along every axis.  ``out_dtype`` (a torch dtype,
    float32 by default) is the output type; the product is f32 and cast
    once.  Served by backends that register ``fused_tiles_fn``.
    """

    eb: float
    radius: int
    outlier_pos: Any
    outlier_val: Any
    shape: Any = None
    out_dtype: Any = None


@dataclasses.dataclass
class DecodeBackend:
    """One implementation of the decode phases.

    ``count_fn``  (units, ds, dl, start_abs, end_abs, total_bits, max_len)
                  -> counts
    ``sync_fn``   (units, ds, dl, total_bits, n_subseq, sps, max_len,
                  early_exit) -> (start_abs, counts): self-sync discovery
                  (``method="selfsync"``); a backend without it serves
                  "gap" plans only
    ``tiles_fn``  phase-4 tile decode; signature of
                  ``decode.decode_write_tiles`` (+ optional ``lut_base``)
    ``padded_fn`` phase-4 padded baseline: (units, ds, dl, start_abs,
                  end_abs, total_bits, max_len, n_out) -> out

    Optional fused phase-4 ops (decode + dequantize + reconstruct; see
    :class:`OutputTransform`):

    ``fused_tiles_fn``   tiles_fn signature + (opos, oval, eb, radius,
                         shape=, out_dtype=) -> reconstructed
                         ``out_dtype[n_out]`` (flat, C order)
    ``fused_padded_fn``  padded_fn signature + (opos, oval, eb, radius,
                         shape=, out_dtype=) -> reconstructed
                         ``out_dtype[n_out]`` (flat, C order)

    A backend registered without them still works everywhere; fused
    requests fall back to the two-pass path, recorded in
    ``stats["fused_fallbacks"]``.

    ``dequant_fn`` (codes, n_out, opos, oval, eb, radius, shape, out_dtype)
                   -> ``out_dtype[n_out]`` (flat, C order): the two-pass
                   dequantize of a CUDA tensor whose shape and dtype the
                   padded epilogue takes
                   (``compressor.reconstruct_unsupported_reason``).  A
                   backend without it, every CPU tensor and every other
                   shape run ``lorenzo.dequantize``'s torch ops.
    """

    name: str
    count_fn: Callable
    tiles_fn: Callable
    padded_fn: Callable
    sync_fn: "Callable | None" = None
    fused_tiles_fn: "Callable | None" = None
    fused_padded_fn: "Callable | None" = None
    dequant_fn: "Callable | None" = None
    stats: dict = dataclasses.field(
        default_factory=lambda: {"decode_write_dispatches": 0,
                                 "plan_builds": 0,
                                 "fused_dispatches": 0,
                                 "fused_fallbacks": 0,
                                 "decode_guard_trips": 0})
    _stats_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def supports_fused(self) -> bool:
        """Whether the backend serves ``fused=True``: both fused ops."""
        return (self.fused_tiles_fn is not None
                and self.fused_padded_fn is not None)

    def bump(self, key: str, n: int = 1):
        """Atomic counter increment (one handle serves every codec)."""
        with self._stats_lock:
            self.stats[key] += n

    def reset_stats(self):
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def decode_tiles(self, *args, **kwargs):
        """Counted phase-4 dispatch."""
        self.bump("decode_write_dispatches")
        return self.tiles_fn(*args, **kwargs)

    def decode_padded(self, *args, **kwargs):
        """Counted padded phase-4 dispatch."""
        self.bump("decode_write_dispatches")
        return self.padded_fn(*args, **kwargs)

    def decode_tiles_fused(self, *args, **kwargs):
        """Counted fused phase-4 dispatch."""
        self.bump("decode_write_dispatches")
        self.bump("fused_dispatches")
        return self.fused_tiles_fn(*args, **kwargs)

    def decode_padded_fused(self, *args, **kwargs):
        """Counted fused padded phase-4 dispatch."""
        self.bump("decode_write_dispatches")
        self.bump("fused_dispatches")
        return self.fused_padded_fn(*args, **kwargs)


_BACKEND_FACTORIES: dict[str, Callable[[], DecodeBackend]] = {}
_BACKENDS: dict[str, DecodeBackend] = {}


def register_backend(name: str, factory: Callable[[], DecodeBackend]):
    """Register (or replace) a decode backend under ``name`` (lazy factory)."""
    _BACKEND_FACTORIES[name] = factory
    _BACKENDS.pop(name, None)


def available_backends() -> list[str]:
    return sorted(_BACKEND_FACTORIES)


def get_backend(backend: "str | DecodeBackend") -> DecodeBackend:
    if isinstance(backend, DecodeBackend):
        return backend
    if backend not in _BACKEND_FACTORIES:
        raise ValueError(
            f"unknown backend {backend!r}; available: {available_backends()}")
    if backend not in _BACKENDS:
        _BACKENDS[backend] = _BACKEND_FACTORIES[backend]()
    return _BACKENDS[backend]


def _make_ref_backend() -> DecodeBackend:
    def count(units, ds, dl, start_abs, end_abs, total_bits, max_len):
        _, counts = hd.subseq_scan(units, ds, dl, start_abs, end_abs,
                                   total_bits, max_len)
        return counts

    def sync(units, ds, dl, total_bits, n_subseq, sps, max_len,
             early_exit=True):
        start, _ = hd.selfsync_intra(units, ds, dl, total_bits, n_subseq,
                                     max_len, sps, early_exit=early_exit)
        start, _ = hd.selfsync_inter(units, ds, dl, start, total_bits,
                                     max_len, sps)
        ends = (torch.arange(n_subseq, dtype=torch.int32,
                             device=start.device) * SUBSEQ_BITS
                + SUBSEQ_BITS)
        _, counts = hd.subseq_scan(units, ds, dl, start, ends, total_bits,
                                   max_len)
        return start, counts

    def padded(units, ds, dl, start_abs, end_abs, total_bits, max_len,
               n_out):
        del end_abs  # the padded reference derives windows from boundaries
        out, _ = hd.decode_write(units, ds, dl, start_abs, total_bits,
                                 max_len, n_out)
        return out

    # The fused ops compose the plain paths (decode, then the exact N-D
    # dequantize the two-pass path uses), as the reference's _epilogue does,
    # so fused-vs-two-pass parity holds by construction.
    def _epilogue(codes, n_out, opos, oval, eb, radius, shape, out_dtype):
        from repro_torch.core.sz import lorenzo  # core.sz imports this module

        shape = tuple(shape) if shape is not None else (n_out,)
        dtype = out_dtype if out_dtype is not None else torch.float32
        return lorenzo.dequantize(codes.reshape(shape), opos, oval, eb, shape,
                                  radius=radius, dtype=dtype).reshape(-1)

    def fused_tiles(units, ds, dl, starts, ends, offsets, total_bits,
                    max_len, n_out, tile_syms, ss_max, opos, oval, eb,
                    radius, shape=None, out_dtype=None, **kwargs):
        codes = hd.decode_write_tiles(units, ds, dl, starts, ends, offsets,
                                      total_bits, max_len, n_out, tile_syms,
                                      ss_max, **kwargs)
        return _epilogue(codes, n_out, opos, oval, eb, radius, shape,
                         out_dtype)

    def fused_padded(units, ds, dl, start_abs, end_abs, total_bits, max_len,
                     n_out, opos, oval, eb, radius, shape=None,
                     out_dtype=None):
        codes = padded(units, ds, dl, start_abs, end_abs, total_bits,
                       max_len, n_out)
        return _epilogue(codes, n_out, opos, oval, eb, radius, shape,
                         out_dtype)

    return DecodeBackend(name="ref", count_fn=count, sync_fn=sync,
                         tiles_fn=hd.decode_write_tiles, padded_fn=padded,
                         fused_tiles_fn=fused_tiles,
                         fused_padded_fn=fused_padded)


def _make_cuda_backend() -> DecodeBackend:
    """Kernel backend: CUDA kernels for CUDA tensors, their plain versions
    for CPU tensors (``repro_torch.kernels.huffman_decode``)."""
    from repro_torch.kernels import ops

    def count(units, ds, dl, start_abs, end_abs, total_bits, max_len):
        counts, _ = ops.subseq_counts(units, ds, dl, start_abs, end_abs,
                                      total_bits, max_len)
        return counts

    def sync(units, ds, dl, total_bits, n_subseq, sps, max_len,
             early_exit=True):
        start, counts, _ = ops.selfsync_sync(units, ds, dl, total_bits,
                                             n_subseq, sps, max_len,
                                             early_exit=early_exit)
        return start, counts

    def padded(units, ds, dl, start_abs, end_abs, total_bits, max_len,
               n_out):
        out, _ = ops.decode_padded_compact(units, ds, dl, start_abs, end_abs,
                                           total_bits, max_len, n_out)
        return out

    return DecodeBackend(name="cuda", count_fn=count, sync_fn=sync,
                         tiles_fn=ops.decode_write_tiles, padded_fn=padded,
                         fused_tiles_fn=ops.decode_write_tiles_fused,
                         fused_padded_fn=ops.decode_padded_fused,
                         dequant_fn=ops.dequant_epilogue)


register_backend("ref", _make_ref_backend)
register_backend("cuda", _make_cuda_backend)


# ---------------------------------------------------------------------------
# Encode-side backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EncodeBackend:
    """One implementation of the encode phases (quantize/histogram/bit-pack).

    ``device=True`` backends keep the full-size arrays on the input's
    device: quantize in float32, the histogram reduced there, and the only
    host transfer before the bit-pack is the ``2*radius``-entry histogram
    (codebook construction is host numpy).  "ref" is the host path (float64
    prequantization, exact histogram), the storage-grade oracle.

    ``quantize_fn``  (x, abs_eb, radius) -> (codes u16, outlier bool,
                     residual int), shaped like ``x``
    ``hist_fn``      (codes, nbins) -> int[nbins]
    ``pack_fn``      (symbols, enc_code, enc_len, total_bits, sps, min_len)
                     -> ``EncodedStream``

    Every bit-pack is counted in ``stats["encode_dispatches"]``; compress
    requests a device backend cannot serve (non-float32 inputs) fall back to
    the host path, counted in ``stats["encode_fallbacks"]``.
    """

    name: str
    device: bool
    quantize_fn: Callable
    hist_fn: Callable
    pack_fn: Callable
    stats: dict = dataclasses.field(
        default_factory=lambda: {"encode_dispatches": 0,
                                 "encode_fallbacks": 0,
                                 "encoder_plan_builds": 0})
    _stats_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def bump(self, key: str, n: int = 1):
        with self._stats_lock:
            self.stats[key] += n

    def reset_stats(self):
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def pack(self, symbols, enc_code, enc_len, total_bits, sps, min_len):
        self.bump("encode_dispatches")
        return self.pack_fn(symbols, enc_code, enc_len, total_bits, sps,
                            min_len)


_ENCODE_FACTORIES: dict[str, Callable[[], EncodeBackend]] = {}
_ENCODE_BACKENDS: dict[str, EncodeBackend] = {}


def register_encode_backend(name: str, factory: Callable[[], EncodeBackend]):
    _ENCODE_FACTORIES[name] = factory
    _ENCODE_BACKENDS.pop(name, None)


def available_encode_backends() -> list[str]:
    return sorted(_ENCODE_FACTORIES)


def get_encode_backend(backend: "str | EncodeBackend") -> EncodeBackend:
    if isinstance(backend, EncodeBackend):
        return backend
    if backend not in _ENCODE_FACTORIES:
        raise ValueError(f"unknown encode backend {backend!r}; available: "
                         f"{available_encode_backends()}")
    if backend not in _ENCODE_BACKENDS:
        _ENCODE_BACKENDS[backend] = _ENCODE_FACTORIES[backend]()
    return _ENCODE_BACKENDS[backend]


def _ref_quantize(x, abs_eb, radius):
    from repro_torch.core.sz import lorenzo  # core.sz imports this module

    return lorenzo.quantize_host(x, abs_eb, radius=radius)


def _ref_hist(codes, nbins):
    return torch.bincount(codes.reshape(-1).to(torch.int64), minlength=nbins)


def _ref_pack(symbols, enc_code, enc_len, total_bits, sps, min_len):
    del min_len  # sizes only the device pack's lane budget
    if symbols.numel() == 0:
        return he.empty_stream(sps, device=symbols.device)
    return he._encode_padded(symbols, enc_code, enc_len,
                             he.units_for_bits(total_bits, sps), sps)


def _make_ref_encode_backend() -> EncodeBackend:
    """The reference's storage path: float64 prequantization, exact
    histogram and the bit-pack, as torch ops on the input's device."""
    return EncodeBackend(name="ref", device=False, quantize_fn=_ref_quantize,
                         hist_fn=_ref_hist, pack_fn=_ref_pack)


def _make_cuda_encode_backend() -> EncodeBackend:
    """Device write path: the ``lorenzo_quantize``, ``histogram`` and
    ``pack_tiles`` kernels for CUDA tensors, their plain versions (the
    reference's "jnp" math) for CPU tensors
    (``repro_torch.kernels.ops``)."""
    from repro_torch.kernels import ops

    return EncodeBackend(name="cuda", device=True,
                         quantize_fn=ops.lorenzo_quantize,
                         hist_fn=ops.histogram, pack_fn=ops.encode_bitpack)


register_encode_backend("ref", _make_ref_encode_backend)
register_encode_backend("cuda", _make_cuda_encode_backend)


@dataclasses.dataclass
class EncoderPlan:
    """What the bit-pack needs, sized from the histogram alone: the
    canonical codebook (host), its encoder tables on the device and the
    exact payload size ``total_bits = sum(freq * code_lengths)``."""

    codebook: _cb.Codebook
    enc_code: torch.Tensor      # uint32[K]
    enc_len: torch.Tensor       # uint8[K]
    total_bits: int
    subseqs_per_seq: int

    @property
    def min_len(self) -> int:
        return self.codebook.min_len


def build_encoder_plan(freq, max_len: int, subseqs_per_seq: int,
                       backend: "str | EncodeBackend" = "ref", *,
                       device) -> EncoderPlan:
    """Histogram -> canonical length-limited codebook -> placement sizes.
    ``freq`` may live on the device; its ``2*radius`` counts are the only
    host transfer of a device-backend encode.  Counted in
    ``backend.stats["encoder_plan_builds"]``."""
    be = get_encode_backend(backend)
    be.bump("encoder_plan_builds")
    freq_np = np.asarray(torch.as_tensor(freq).cpu(), dtype=np.int64)
    book = _cb.build_codebook(freq_np, max_len=max_len)
    total_bits = int((freq_np * book.enc_len.astype(np.int64)).sum())
    return EncoderPlan(codebook=book,
                       enc_code=torch.from_numpy(book.enc_code).to(device),
                       enc_len=torch.from_numpy(book.enc_len).to(device),
                       total_bits=total_bits,
                       subseqs_per_seq=subseqs_per_seq)


def encode_with_plan(symbols, plan: EncoderPlan,
                     backend: "str | EncodeBackend" = "ref") -> EncodedStream:
    """Bit-pack ``symbols`` through ``backend`` under a prebuilt plan; the
    stream layout is identical across backends."""
    be = get_encode_backend(backend)
    return be.pack(symbols, plan.enc_code.to(symbols.device),
                   plan.enc_len.to(symbols.device), plan.total_bits,
                   plan.subseqs_per_seq, plan.min_len)


# ---------------------------------------------------------------------------
# Plan construction (phases 1-3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeLuts:
    """Decode tables on the stream's device: what ``decode()`` needs."""

    dec_sym: torch.Tensor       # uint16[2**max_len]
    dec_len: torch.Tensor       # uint8[2**max_len]
    max_len: int


def _as_luts(codebook, device) -> DecodeLuts:
    return DecodeLuts(
        dec_sym=torch.as_tensor(np.asarray(codebook.dec_sym,
                                           np.uint16)).to(device),
        dec_len=torch.as_tensor(np.asarray(codebook.dec_len,
                                           np.uint8)).to(device),
        max_len=int(codebook.max_len))


@dataclasses.dataclass
class DecoderPlan:
    """Everything phase 4 needs: sync starts, counts, offsets, CR classes.

    ``classes`` (the per-CR-class dispatch plan for ``t_high``) is built
    from ``seq_counts`` on the host when first read, so a plan that only
    the "tile" or "padded" strategy decodes never builds it.
    """

    method: str                 # "gap" | "selfsync"
    start_bits: torch.Tensor    # int32[n_subseq] absolute sync starts
    end_bits: torch.Tensor      # int32[n_subseq] absolute window ends
    counts: torch.Tensor        # int32[n_subseq] codeword starts per window
    offsets: torch.Tensor       # int32[n_subseq+1] exclusive prefix sum
    seq_counts: np.ndarray      # int64[n_seq] symbols per sequence (host)
    subseqs_per_seq: int
    t_high: int = T_HIGH_DEFAULT
    _classes: "ClassPlan | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def classes(self) -> ClassPlan:
        """The per-CR-class dispatch plan (paper Alg. 2), built once."""
        if self._classes is None:
            self._classes = make_plan(None, self.seq_counts,
                                      self.subseqs_per_seq, self.t_high)
        return self._classes


def check_method(method: str):
    """Raise for a method the port lacks (``NotImplementedError``) or that
    the reference does not know (``ValueError``)."""
    check_ported("method", method)
    if method not in VALID_METHODS:
        raise ValueError(f"unknown method {method!r}; valid methods: "
                         f"{list(VALID_METHODS)}")


def decode_naive_ref(stream: EncodedStream, codebook,
                     n_out: int) -> torch.Tensor:
    """``method="naive_ref"``: the whole stream decoded by one sequential
    scan, with no plan (the reference's ``decode.decode_sequential``, a
    ``lax.scan`` of peek, LUT lookup and advance).  Returns uint16[n_out]
    on the stream's device.

    On the card it runs the ``decode_chunked`` kernel (one thread a chunk)
    with the stream as its only chunk: ``units`` as a ``[1, n_units]``
    row, the stream's valid bits as the row's bits, ``n_out`` symbols.
    The kernel peeks as ``decode_sequential`` does (the unit at ``pos >>
    5`` clipped to the row, the next one read as 0 past it) and stops at
    the row's bits; a stream's ``n_out`` codewords end exactly at its
    ``total_bits``, so it gives the same ``n_out`` symbols.  On the CPU,
    ``decode_sequential`` itself, the kernel's plain version here.
    """
    with trace.span("repro_torch.decode"):
        with trace.crossing("repro_torch.decode.luts.h2d", stream.device):
            luts = _as_luts(codebook, stream.device)
        with trace.span("repro_torch.decode.phase4"):
            if stream.device.type == "cpu":
                return hd.decode_sequential(stream.units, luts.dec_sym,
                                            luts.dec_len, n_out,
                                            luts.max_len)
            return hd.decode_chunked(
                stream.units.reshape(1, -1), [stream.total_bits], [n_out],
                luts.dec_sym, luts.dec_len, luts.max_len, n_out).reshape(-1)


def build_plan(stream: EncodedStream, codebook, method: str = "gap",
               backend: "str | DecodeBackend" = "cuda",
               t_high: int = T_HIGH_DEFAULT,
               early_exit: bool = True) -> DecoderPlan:
    """Run decode phases 1-3 on ``backend``.

    Phases 1-2 find the per-subsequence sync points -- from the stored gap
    array (``method="gap"``) or by self-synchronization
    (``method="selfsync"``, the backend's ``sync_fn``, with ``early_exit``
    the paper's ``__all_sync`` round exit) -- and count the codewords per
    128-bit window; phase 3 prefix-sums the counts into output offsets.
    The per-sequence counts come to the host once, for the symbol-count
    guard of ``sz.compressor.decompress`` and the CR classes of ``t_high``
    (built when first read).  The plan is backend-portable and every build
    is counted in ``backend.stats["plan_builds"]``.
    """
    be = get_backend(backend)
    check_method(method)
    if method not in VALID_PLAN_METHODS:
        raise ValueError(f"unknown method {method!r}; valid methods: "
                         f"{list(VALID_PLAN_METHODS)}")
    if method == "selfsync" and be.sync_fn is None:
        raise ValueError(f"backend {be.name!r} registers no sync_fn: it "
                         f"serves method 'gap' only")
    be.bump("plan_builds")
    problems = _cb.validate_codebook(codebook)
    if problems:
        be.bump("decode_guard_trips")
        raise DecodeGuardError("corrupt codebook rejected at build_plan: "
                               + "; ".join(problems))
    with trace.span("repro_torch.plan"):
        return _build_plan(stream, codebook, method, be, t_high, early_exit)


def _build_plan(stream: EncodedStream, codebook, method: str,
                be: DecodeBackend, t_high: int,
                early_exit: bool) -> DecoderPlan:
    device = stream.units.device
    with trace.crossing("repro_torch.plan.luts.h2d", device):
        luts = _as_luts(codebook, device)
    n_subseq = stream.n_subseq
    sps = stream.subseqs_per_seq
    boundaries = torch.arange(n_subseq, dtype=torch.int32,
                              device=device) * SUBSEQ_BITS
    ends = boundaries + SUBSEQ_BITS

    if method == "gap":
        # A valid gap never exceeds SUBSEQ_BITS; clamp a corrupt gap array
        # so sync starts stay inside the window their counts were computed
        # for, and count the containment.
        gaps = stream.gaps.to(torch.int32)
        with trace.crossing("repro_torch.plan.gap.sync", device):
            corrupt = n_subseq and int(stream.gaps.max()) > SUBSEQ_BITS
        if corrupt:
            be.bump("decode_guard_trips")
            gaps = gaps.clamp(max=SUBSEQ_BITS)
        starts = boundaries + gaps
        with trace.span("repro_torch.plan.count"):
            counts = be.count_fn(stream.units, luts.dec_sym, luts.dec_len,
                                 starts, ends, stream.total_bits,
                                 luts.max_len)
    else:
        try:
            with trace.span("repro_torch.plan.count"):
                starts, counts = be.sync_fn(stream.units, luts.dec_sym,
                                            luts.dec_len, stream.total_bits,
                                            n_subseq, sps, luts.max_len,
                                            early_exit=early_exit)
        except DecodeGuardError:
            be.bump("decode_guard_trips")
            raise
    with trace.span("repro_torch.plan.offsets"):
        offsets = hd.output_offsets(counts)
        seq_counts = counts.reshape(-1, sps).sum(dim=1, dtype=torch.int64)
    with trace.crossing("repro_torch.plan.counts.sync", device):
        seq_counts = seq_counts.cpu().numpy()
    return DecoderPlan(method=method, start_bits=starts, end_bits=ends,
                       counts=counts, offsets=offsets, seq_counts=seq_counts,
                       subseqs_per_seq=sps, t_high=t_high)


# ---------------------------------------------------------------------------
# Execution (phase 4)
# ---------------------------------------------------------------------------




def decode(stream: EncodedStream, codebook, n_out: int, *,
           plan: "DecoderPlan | None" = None,
           backend: "str | DecodeBackend" = "cuda",
           method: str = "gap", strategy: str = "tile",
           tile_syms: int = DEFAULT_TILE_SYMS,
           t_high: int = T_HIGH_DEFAULT,
           early_exit: bool = True,
           transform: "OutputTransform | None" = None) -> torch.Tensor:
    """Decode one stream to ``n_out`` uint16 quant codes.

    ``plan`` may carry a prebuilt ``DecoderPlan`` (phases 1-3); ``None``
    builds one with ``method``, ``t_high`` and (for "selfsync")
    ``early_exit``.  ``strategy``: "tile" runs
    the fixed-tile staged decode-write (paper Alg. 1) with tiles of
    ``tile_syms`` codes; "tuned" decodes the sequences of each CR class of
    the plan with that class's tile (paper Alg. 2), one dispatch per class;
    "padded" is the original decoders' baseline layout.  ``transform`` (an
    ``OutputTransform``) runs the backend's fused op for "tile" and
    "padded": the decoded symbols go through dequantization and the inverse
    Lorenzo, and the return value is the reconstructed ``out_dtype[n_out]``,
    flat in C order.  A backend without fused ops, and the "tuned"
    strategy, raise ``ValueError`` with a transform, as in the reference;
    ``sz.compressor.decompress`` checks first and falls back.
    """
    be = get_backend(backend)
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; valid strategies: "
                         f"{list(VALID_STRATEGIES)}")
    if transform is not None and strategy == "tuned":
        raise ValueError(
            f"fused decode (transform=) supports strategies 'tile' and "
            f"'padded', not {strategy!r}: the tuned per-CR-class gather "
            f"reorders the output, which breaks the sequential Lorenzo "
            f"reconstruction carry")
    if transform is not None and not be.supports_fused:
        raise ValueError(
            f"backend {be.name!r} registers no fused ops; check "
            f"backend.supports_fused before attaching a transform")
    if plan is None:
        plan = build_plan(stream, codebook, method=method, backend=be,
                          t_high=t_high, early_exit=early_exit)
    with trace.span("repro_torch.decode"):
        with trace.crossing("repro_torch.decode.luts.h2d", stream.device):
            luts = _as_luts(codebook, stream.device)
        with trace.span("repro_torch.decode.phase4"):
            return _phase4(be, stream, luts, plan, n_out, strategy,
                           tile_syms, transform)


def _phase4(be: DecodeBackend, stream: EncodedStream, luts: DecodeLuts,
            plan: DecoderPlan, n_out: int, strategy: str, tile_syms: int,
            transform: "OutputTransform | None") -> torch.Tensor:
    """The backend's phase-4 dispatch for ``decode``."""
    lut_args = (stream.units, luts.dec_sym, luts.dec_len)
    if transform is not None:
        t = transform
        out = dict(shape=None if t.shape is None else tuple(t.shape),
                   out_dtype=(t.out_dtype if t.out_dtype is not None
                              else torch.float32))
        if strategy == "padded":
            return be.decode_padded_fused(
                *lut_args, plan.start_bits, plan.end_bits, stream.total_bits,
                luts.max_len, n_out, t.outlier_pos, t.outlier_val, t.eb,
                t.radius, **out)
        return be.decode_tiles_fused(
            *lut_args, plan.start_bits, plan.end_bits, plan.offsets,
            stream.total_bits, luts.max_len, n_out, tile_syms,
            ss_max_for_tile(tile_syms, luts.max_len), t.outlier_pos,
            t.outlier_val, t.eb, t.radius, **out)
    if strategy == "padded":
        return be.decode_padded(*lut_args, plan.start_bits, plan.end_bits,
                                stream.total_bits, luts.max_len, n_out)
    if strategy == "tile":
        return be.decode_tiles(*lut_args, plan.start_bits, plan.end_bits,
                               plan.offsets, stream.total_bits, luts.max_len,
                               n_out, tile_syms,
                               ss_max_for_tile(tile_syms, luts.max_len))
    return _class_dispatch(be.decode_tiles, *lut_args, luts.max_len,
                           stream.total_bits,
                           [_tensor_meta(plan, n_out, plan.t_high)],
                           plan.t_high)[0]


def _max_tile_span(offsets: torch.Tensor, tile_syms: int, n_sym: int) -> int:
    """Most subsequences any ``tile_syms``-symbol output tile overlaps.

    ``offsets`` is the exclusive prefix sum over the gathered subsequences;
    the ``searchsorted`` tile -> subsequence mapping of the decode-write
    kernels.  Torch ops on the offsets' device; one host sync.
    """
    if n_sym <= 0 or offsets.shape[0] <= 1:
        return 1
    offsets = offsets.to(torch.int64)
    n_tiles = (n_sym + tile_syms - 1) // tile_syms
    base = torch.arange(n_tiles, dtype=torch.int64,
                        device=offsets.device) * tile_syms
    s0 = torch.searchsorted(offsets, base, right=True) - 1
    last = torch.clamp(base + tile_syms, max=n_sym) - 1
    s1 = torch.maximum(torch.searchsorted(offsets, last, right=True) - 1, s0)
    with trace.crossing("repro_torch.decode.tile_span.sync", offsets.device):
        return int((s1 - s0 + 1).max())


def _tensor_meta(plan: DecoderPlan, n_out: int, t_high: int,
                 bit_offset: int = 0, lut_base: "int | None" = None,
                 clamp_bits: "int | None" = None) -> dict:
    """Phase-4 view of one tensor for ``_class_dispatch``: its plan, its CR
    classes under ``t_high``, where its bits sit in the merged stream
    (``bit_offset``, with window ends clamped at ``clamp_bits`` first), its
    slice of a merged LUT (``lut_base``) and its output size."""
    classes = (plan.classes if plan.t_high == t_high else
               make_plan(None, plan.seq_counts, plan.subseqs_per_seq,
                         t_high))
    return {"plan": plan, "classes": classes, "bit_offset": bit_offset,
            "lut_base": lut_base, "clamp_bits": clamp_bits, "n_out": n_out}


def _class_dispatch(tiles_fn, units, dec_sym, dec_len, max_len: int,
                    total_bits, tensors: list, t_high: int) -> list:
    """Per-CR-class decode-write over one or many tensors.

    ``tensors`` holds one ``_tensor_meta`` per decoded tensor.  For every
    class, the subsequences of that class's sequences in ALL tensors are
    gathered into ONE ``tiles_fn`` dispatch with the class's tile, in
    (tensor, sequence, subsequence) order, dropping count-0 lanes (the
    zero-padded tail of a tensor's final sequence), which would consume
    tile lanes without carrying symbols; the class's output is then
    scattered back to each tensor's positions.  Bit-exact with the
    reference's loop over classes and tensors, built with torch ops on the
    device instead: one stable sort of the subsequences by class, one
    gather and one scatter per class, and one host sync per class for the
    lane budget.  Classes whose sequences hold no symbols are not
    dispatched.  The outputs are views into one buffer.
    """
    device = units.device
    plans = [m["plan"] for m in tensors]
    # Each tensor's region of the concatenated output holds every symbol
    # its plan decodes, so the scatter needs no bound check; its output is
    # the region's first n_out codes (zeros past the decoded symbols).
    region = [max(m["n_out"], int(np.sum(p.seq_counts)))
              for m, p in zip(tensors, plans)]
    out_base = np.concatenate([[0], np.cumsum(region)]).astype(np.int64)

    # Per sequence (host): class, symbols, and where its first symbol lands
    # in the concatenated output.
    seq_cls = np.concatenate([m["classes"].classes for m in tensors])
    seq_cnt = np.concatenate([np.asarray(p.seq_counts, np.int64)
                              for p in plans])
    seq_dest = np.concatenate([
        out_base[i] + np.cumsum(p.seq_counts) - p.seq_counts
        for i, p in enumerate(plans)]).astype(np.int64)

    # Per subsequence (device), in (tensor, sequence, subsequence) order:
    # windows shifted into the merged bit space after clamping at each
    # tensor's own payload end, counts, LUT slice and class.  Each
    # subsequence finds its tensor by a search over the tensors' ends (a
    # repeat_interleave would give one tensor's subsequences to one warp).
    counts = torch.cat([p.counts.to(torch.int32) for p in plans])
    seq_sps = np.repeat([p.subseqs_per_seq for p in plans],
                        [len(p.seq_counts) for p in plans])
    with trace.crossing("repro_torch.decode.classes.h2d", device):
        sub_end = torch.as_tensor(np.cumsum([p.start_bits.shape[0]
                                             for p in plans]), device=device)
        per_tensor = torch.as_tensor(np.array(
            [[m["bit_offset"] for m in tensors],
             [2**31 - 1 if m["clamp_bits"] is None else m["clamp_bits"]
              for m in tensors],
             [m["lut_base"] or 0 for m in tensors]], np.int64), device=device)
        seq_cls_d = torch.as_tensor(seq_cls.astype(np.int64), device=device)
        seq_sps_d = torch.as_tensor(seq_sps.astype(np.int64), device=device)
    owner = torch.searchsorted(
        sub_end, torch.arange(counts.shape[0], device=device), right=True)
    shift, clamp, lut = per_tensor[:, owner]
    starts = (torch.cat([p.start_bits.to(torch.int64) for p in plans])
              + shift).to(torch.int32)
    ends = (torch.minimum(torch.cat([p.end_bits.to(torch.int64)
                                     for p in plans]), clamp)
            + shift).to(torch.int32)
    lut = (lut.to(torch.int32)
           if any(m["lut_base"] is not None for m in tensors) else None)
    sub_cls = torch.repeat_interleave(seq_cls_d, seq_sps_d,
                                      output_size=counts.shape[0])
    key, order = torch.sort(torch.where(counts > 0, sub_cls, 0), stable=True)
    # lane_end[c]: where class c's lanes end in `order` (class 0: dropped)
    lane_end = torch.searchsorted(
        key, torch.arange(t_high + 2, device=device), right=True)
    with trace.crossing("repro_torch.decode.lanes.sync", device):
        lane_end = lane_end.cpu()

    out = torch.zeros(int(out_base[-1]), dtype=torch.int16, device=device)
    for c in range(1, t_high + 2):
        sel = seq_cls == c
        class_n = int(seq_cnt[sel].sum())
        if class_n == 0:
            continue
        idx = order[int(lane_end[c - 1]):int(lane_end[c])]
        offsets = hd.output_offsets(counts[idx])
        tile = tile_for_class(c, t_high)
        # Lane provisioning: the static bound assumes every subsequence in a
        # tile's span carries >= min_starts codewords; the (at most one per
        # tensor) partial subsequence at a stream tail can carry fewer, so
        # also bound by the worst actual span any tile needs.
        ss_max = max(ss_max_for_tile(tile, max_len),
                     _max_tile_span(offsets, tile, class_n) + 2)
        kwargs = {} if lut is None else {"lut_base": lut[idx]}
        class_out = tiles_fn(units, dec_sym, dec_len, starts[idx], ends[idx],
                             offsets, total_bits, max_len, class_n, tile,
                             ss_max, **kwargs)
        # Scatter: the j-th code of the class goes to its sequence's
        # destination plus j minus the codes of the class's earlier
        # sequences.
        cnt = seq_cnt[sel]
        with trace.crossing("repro_torch.decode.class.h2d", device):
            head = torch.as_tensor(np.stack([seq_dest[sel] - (np.cumsum(cnt)
                                                              - cnt), cnt]),
                                   device=device)
        pos = torch.arange(class_n, device=device) + torch.repeat_interleave(
            head[0], head[1], output_size=class_n)
        out[pos] = class_out.view(torch.int16)
    out = out.view(torch.uint16)
    return [out[out_base[i]:out_base[i] + m["n_out"]]
            for i, m in enumerate(tensors)]


def execute_tuned(stream: EncodedStream, dec_sym, dec_len, max_len: int,
                  n_out: int, start_bits, counts,
                  t_high: int = T_HIGH_DEFAULT, tiles_fn=None) -> torch.Tensor:
    """Tuned per-class decode from precomputed phase 1-3 outputs.

    Raw-LUT entry point for callers that hold decode tables instead of a
    ``Codebook``: ``tiles_fn`` defaults to the plain tile decoder and may be
    any ``decode_write_tiles``-shaped callable (e.g. the kernel-backed
    ``ops.decode_write_tiles``).
    """
    if tiles_fn is None:
        tiles_fn = hd.decode_write_tiles
    counts = torch.as_tensor(counts).to(torch.int32)
    sps = stream.subseqs_per_seq
    seq_counts = counts.reshape(-1, sps).sum(dim=1, dtype=torch.int64)
    ends = torch.arange(stream.n_subseq, dtype=torch.int32,
                        device=counts.device) * SUBSEQ_BITS + SUBSEQ_BITS
    plan = DecoderPlan(method="gap", start_bits=torch.as_tensor(start_bits),
                       end_bits=ends, counts=counts,
                       offsets=hd.output_offsets(counts),
                       seq_counts=seq_counts.cpu().numpy(),
                       subseqs_per_seq=sps, t_high=t_high)
    return _class_dispatch(tiles_fn, stream.units, dec_sym, dec_len, max_len,
                           stream.total_bits,
                           [_tensor_meta(plan, n_out, t_high)], t_high)[0]


# ---------------------------------------------------------------------------
# Batched multi-tensor decode
# ---------------------------------------------------------------------------


def _merge_luts(codebooks, device) -> tuple:
    """Stack per-tensor decode LUTs into one table at a common ``max_len``.

    A tensor whose codebook peeks fewer bits than the global maximum gets
    its LUT upsampled: window ``w`` at ``max_len_g`` bits resolves via the
    top ``max_len_t`` bits, i.e. ``np.repeat`` by the width ratio.  Huffman
    codes are prefix-free, so the extra peeked bits never change the decoded
    (symbol, length) pair.  Returns (dec_sym, dec_len, max_len_g, bases).
    """
    max_len_g = max(int(cb.max_len) for cb in codebooks)
    syms, lens, bases = [], [], []
    stride = 1 << max_len_g
    for t, cb in enumerate(codebooks):
        reps = 1 << (max_len_g - int(cb.max_len))
        syms.append(np.repeat(np.asarray(cb.dec_sym, np.uint16), reps))
        lens.append(np.repeat(np.asarray(cb.dec_len, np.uint8), reps))
        bases.append(t * stride)
    return (torch.from_numpy(np.concatenate(syms)).to(device),
            torch.from_numpy(np.concatenate(lens)).to(device), max_len_g,
            bases)


# Bit positions are int32 throughout the decode stack; keep every merged
# stream comfortably inside that space (one chunk still decode-batches
# hundreds of tensors -- 2^30 bits is 128 MiB of compressed payload).
MAX_BATCH_BITS = 1 << 30


def decode_batch(streams, codebooks, n_outs, *,
                 plans=None, backend: "str | DecodeBackend" = "cuda",
                 method: str = "gap",
                 t_high: int = T_HIGH_DEFAULT,
                 early_exit: bool = True) -> list:
    """Decode many tensors with one decode-write dispatch per CR class.

    Streams are concatenated at subsequence granularity (every stream is
    already padded to whole sequences), LUTs are merged at a common
    ``max_len`` with a per-subsequence ``lut_base``, and phase 4 gathers
    same-class sequences from ALL tensors into one tile-decode dispatch.
    Phases 1-3 remain per-tensor.  On "cuda" a merged LUT too large for
    shared memory is read from device memory by the tile kernel
    (``huffman_decode.decode_tiles_lut_in_smem``), so the batch is never
    split by LUT size.

    Batches whose merged bitstream would overflow the int32 bit-position
    space are split into sub-batches of at most ``MAX_BATCH_BITS`` merged
    bits (the dispatch count then scales with the number of sub-batches);
    a single stream over the budget decodes alone.

    Returns a list of uint16 symbol arrays, bit-exact with per-tensor
    ``decode()``.  The fused path is per-tensor by construction (its
    reconstruction carry follows one tensor's output order), so
    ``sz.compressor.decompress_batch(fused=True)`` routes eligible tensors
    through per-tensor fused decodes and only the rest through here.
    """
    streams, codebooks, n_outs = list(streams), list(codebooks), list(n_outs)
    if not streams:
        return []
    be = get_backend(backend)
    if plans is None:
        plans = [build_plan(s, cb, method=method, backend=be, t_high=t_high,
                            early_exit=early_exit)
                 for s, cb in zip(streams, codebooks)]
    plans = list(plans)

    item_bits = [int(s.units.shape[0]) * UNIT_BITS for s in streams]
    if len(streams) > 1 and sum(item_bits) > MAX_BATCH_BITS:
        outs, lo, acc = [], 0, 0
        for i, b in enumerate(item_bits):
            if acc and acc + b > MAX_BATCH_BITS:
                outs += decode_batch(streams[lo:i], codebooks[lo:i],
                                     n_outs[lo:i], plans=plans[lo:i],
                                     backend=be, t_high=t_high)
                lo, acc = i, 0
            acc += b
        outs += decode_batch(streams[lo:], codebooks[lo:], n_outs[lo:],
                             plans=plans[lo:], backend=be, t_high=t_high)
        return outs

    device = streams[0].units.device
    dec_sym, dec_len, max_len_g, lut_bases = _merge_luts(codebooks, device)
    # uint32 has no cat on every build: concatenate the int32 views.
    units = torch.cat([s.units.view(torch.int32) for s in streams]).view(
        torch.uint32)
    bit_offsets = np.concatenate([[0], np.cumsum(item_bits)[:-1]])
    metas = [_tensor_meta(plan, n_out, t_high, bit_offset=int(bit_offsets[t]),
                          lut_base=lut_bases[t], clamp_bits=stream.total_bits)
             for t, (stream, n_out, plan) in enumerate(zip(streams, n_outs,
                                                           plans))]
    return _class_dispatch(be.decode_tiles, units, dec_sym, dec_len,
                           max_len_g, int(units.shape[0]) * UNIT_BITS, metas,
                           t_high)
