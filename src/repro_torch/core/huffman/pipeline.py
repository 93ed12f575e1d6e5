"""Plan/execute decoder pipeline: the single entry point for decoding.

Port of ``src/repro/core/huffman/pipeline.py`` for the gap-array method and
the "tile" strategy:

    build_plan()    phases 1-3: gap-array sync starts, per-subsequence
                    counts, output-offset prefix sum.
    decode()        phase 4 through a named *backend*: fixed-tile staged
                    decode-write (paper Alg. 1), or with an
                    ``OutputTransform`` the fused decode -> dequantize ->
                    inverse Lorenzo (``fused=True``).

Backends live in a registry: "ref" is the plain torch reference
(``core.huffman.decode``); "cuda" runs the hand-written CUDA kernels
(``repro_torch.kernels.ops``) for CUDA tensors and their plain versions for
CPU tensors.  Every backend counts plan builds and decode-write dispatches
in ``backend.stats``.  The encode side keeps the reference's registry with
its "ref" backend.

Options whose code is not ported yet (``method="selfsync"``, the "tuned"
and "padded" strategies, device encode backends) raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.
The reference's per-CR-class dispatch plan (paper Alg. 2) is read only by
the "tuned" strategy, so it is ported with that strategy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.huffman import codebook as _cb
from repro_torch.core.huffman import decode as hd
from repro_torch.core.huffman import encode as he
from repro_torch.core.huffman.bits import SUBSEQ_BITS
from repro_torch.core.huffman.encode import EncodedStream


class DecodeGuardError(RuntimeError):
    """A decoder-level integrity guard tripped on malformed input.

    Raised by ``build_plan`` (corrupt codebook) and by the symbol-count
    guard in ``sz.compressor.decompress``.  Every trip -- including
    non-raising containment such as gap clamping -- is counted in
    ``backend.stats["decode_guard_trips"]``.
    """


DEFAULT_TILE_SYMS = 4096

#: Decode-write strategies of the reference (only "tile" is ported).
VALID_STRATEGIES = ("tuned", "tile", "padded")
#: Sync-discovery methods of the reference (only "gap" is ported).  The
#: reference's sequential oracle method "naive_ref" is no decode path of the
#: port: ``decode.decode_sequential`` stays a CPU test oracle.
VALID_PLAN_METHODS = ("gap", "selfsync")

#: Options of the reference whose code waits for a later slice, and the
#: ROADMAP.md item that ports each.
UNPORTED = {
    ("method", "selfsync"): "queue A item 3 (self-sync method)",
    ("strategy", "tuned"): "queue A item 2 (tuned and padded strategies)",
    ("strategy", "padded"): "queue A item 2 (tuned and padded strategies)",
    ("encode_backend", "jnp"): "queue A item 4 (device write side)",
    ("encode_backend", "pallas"): "queue A item 4 (device write side)",
}


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
    ``tiles_fn``  phase-4 tile decode; signature of
                  ``decode.decode_write_tiles`` (+ optional ``lut_base``)

    Optional fused phase-4 op (decode + dequantize + reconstruct in one
    dispatch; see :class:`OutputTransform`):

    ``fused_tiles_fn``  tiles_fn signature + (opos, oval, eb, radius,
                        shape=, out_dtype=) -> reconstructed
                        ``out_dtype[n_out]`` (flat, C order)

    A backend registered without it still works everywhere; fused requests
    fall back to the two-pass path, recorded in ``stats["fused_fallbacks"]``.
    """

    name: str
    count_fn: Callable
    tiles_fn: Callable
    fused_tiles_fn: "Callable | None" = None
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
        """Whether the backend serves ``fused=True``.  The reference also
        needs ``fused_padded_fn``; the port needs only ``fused_tiles_fn``
        until the padded strategy is ported (ROADMAP.md queue A item 2)."""
        return self.fused_tiles_fn is not None

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

    def decode_tiles_fused(self, *args, **kwargs):
        """Counted fused phase-4 dispatch."""
        self.bump("decode_write_dispatches")
        self.bump("fused_dispatches")
        return self.fused_tiles_fn(*args, **kwargs)


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

    # The fused op composes the plain paths (decode, then the exact N-D
    # dequantize the two-pass path uses), as the reference's _epilogue does,
    # so fused-vs-two-pass parity holds by construction.
    def fused_tiles(units, ds, dl, starts, ends, offsets, total_bits,
                    max_len, n_out, tile_syms, ss_max, opos, oval, eb,
                    radius, shape=None, out_dtype=None, **kwargs):
        from repro_torch.core.sz import lorenzo  # core.sz imports this module

        codes = hd.decode_write_tiles(units, ds, dl, starts, ends, offsets,
                                      total_bits, max_len, n_out, tile_syms,
                                      ss_max, **kwargs)
        shape = tuple(shape) if shape is not None else (n_out,)
        dtype = out_dtype if out_dtype is not None else torch.float32
        return lorenzo.dequantize(codes.reshape(shape), opos, oval, eb, shape,
                                  radius=radius, dtype=dtype).reshape(-1)

    return DecodeBackend(name="ref", count_fn=count,
                         tiles_fn=hd.decode_write_tiles,
                         fused_tiles_fn=fused_tiles)


def _make_cuda_backend() -> DecodeBackend:
    """Kernel backend: CUDA kernels for CUDA tensors, their plain versions
    for CPU tensors (``repro_torch.kernels.huffman_decode``)."""
    from repro_torch.kernels import ops

    def count(units, ds, dl, start_abs, end_abs, total_bits, max_len):
        counts, _ = ops.subseq_counts(units, ds, dl, start_abs, end_abs,
                                      total_bits, max_len)
        return counts

    return DecodeBackend(name="cuda", count_fn=count,
                         tiles_fn=ops.decode_write_tiles,
                         fused_tiles_fn=ops.decode_write_tiles_fused)


register_backend("ref", _make_ref_backend)
register_backend("cuda", _make_cuda_backend)


# ---------------------------------------------------------------------------
# Encode-side backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EncodeBackend:
    """One implementation of the encode phases.

    ``quantize_fn``  (x, abs_eb, radius) -> (codes u16, outlier bool,
                     residual int64), shaped like ``x``
    ``hist_fn``      (codes, nbins) -> int64[nbins]
    ``pack_fn``      (symbols, enc_code, enc_len, total_bits, sps)
                     -> ``EncodedStream``
    """

    name: str
    quantize_fn: Callable
    hist_fn: Callable
    pack_fn: Callable
    stats: dict = dataclasses.field(
        default_factory=lambda: {"encode_dispatches": 0,
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

    def pack(self, symbols, enc_code, enc_len, total_bits, sps):
        self.bump("encode_dispatches")
        return self.pack_fn(symbols, enc_code, enc_len, total_bits, sps)


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
    check_ported("encode_backend", backend)
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


def _ref_pack(symbols, enc_code, enc_len, total_bits, sps):
    if symbols.numel() == 0:
        return he.empty_stream(sps, device=symbols.device)
    return he._encode_padded(symbols, enc_code, enc_len,
                             he.units_for_bits(total_bits, sps), sps)


def _make_ref_encode_backend() -> EncodeBackend:
    """The reference's storage path: float64 prequantization, exact
    histogram and the bit-pack, as torch ops on the input's device."""
    return EncodeBackend(name="ref", quantize_fn=_ref_quantize,
                         hist_fn=_ref_hist, pack_fn=_ref_pack)


register_encode_backend("ref", _make_ref_encode_backend)


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


def build_encoder_plan(freq, max_len: int, subseqs_per_seq: int,
                       backend: "str | EncodeBackend" = "ref", *,
                       device) -> EncoderPlan:
    """Histogram -> canonical length-limited codebook -> placement sizes.
    Counted in ``backend.stats["encoder_plan_builds"]``."""
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
    """Bit-pack ``symbols`` through ``backend`` under a prebuilt plan."""
    be = get_encode_backend(backend)
    return be.pack(symbols, plan.enc_code.to(symbols.device),
                   plan.enc_len.to(symbols.device), plan.total_bits,
                   plan.subseqs_per_seq)


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
    """Everything phase 4 needs: sync starts, counts, offsets."""

    method: str                 # "gap"
    start_bits: torch.Tensor    # int32[n_subseq] absolute sync starts
    end_bits: torch.Tensor      # int32[n_subseq] absolute window ends
    counts: torch.Tensor        # int32[n_subseq] codeword starts per window
    offsets: torch.Tensor       # int32[n_subseq+1] exclusive prefix sum
    seq_counts: np.ndarray      # int64[n_seq] symbols per sequence (host)
    subseqs_per_seq: int


def check_method(method: str):
    """Raise for a method the port lacks (``NotImplementedError``) or that
    the reference does not know (``ValueError``)."""
    check_ported("method", method)
    if method not in VALID_PLAN_METHODS:
        raise ValueError(f"unknown method {method!r}; valid methods: "
                         f"{list(VALID_PLAN_METHODS)}")


def build_plan(stream: EncodedStream, codebook, method: str = "gap",
               backend: "str | DecodeBackend" = "cuda") -> DecoderPlan:
    """Run decode phases 1-3 on ``backend``.

    Phase 1 takes the per-subsequence sync points from the stored gap array
    and counts the codewords per 128-bit window; phase 3 prefix-sums the
    counts into output offsets.  The per-sequence counts come to the host
    once, for the symbol-count guard of ``sz.compressor.decompress``.  The
    plan is backend-portable and every build is counted in
    ``backend.stats["plan_builds"]``.
    """
    be = get_backend(backend)
    check_method(method)
    be.bump("plan_builds")
    problems = _cb.validate_codebook(codebook)
    if problems:
        be.bump("decode_guard_trips")
        raise DecodeGuardError("corrupt codebook rejected at build_plan: "
                               + "; ".join(problems))
    device = stream.units.device
    luts = _as_luts(codebook, device)
    n_subseq = stream.n_subseq
    sps = stream.subseqs_per_seq
    boundaries = torch.arange(n_subseq, dtype=torch.int32,
                              device=device) * SUBSEQ_BITS
    ends = boundaries + SUBSEQ_BITS

    # A valid gap never exceeds SUBSEQ_BITS; clamp a corrupt gap array so
    # sync starts stay inside the window their counts were computed for,
    # and count the containment.
    gaps = stream.gaps.to(torch.int32)
    if n_subseq and int(stream.gaps.max()) > SUBSEQ_BITS:
        be.bump("decode_guard_trips")
        gaps = gaps.clamp(max=SUBSEQ_BITS)
    starts = boundaries + gaps
    counts = be.count_fn(stream.units, luts.dec_sym, luts.dec_len, starts,
                         ends, stream.total_bits, luts.max_len)
    offsets = hd.output_offsets(counts)
    seq_counts = counts.reshape(-1, sps).sum(dim=1, dtype=torch.int64)
    seq_counts = seq_counts.cpu().numpy()
    return DecoderPlan(method=method, start_bits=starts, end_bits=ends,
                       counts=counts, offsets=offsets, seq_counts=seq_counts,
                       subseqs_per_seq=sps)


# ---------------------------------------------------------------------------
# Execution (phase 4)
# ---------------------------------------------------------------------------


def decode(stream: EncodedStream, codebook, n_out: int, *,
           plan: "DecoderPlan | None" = None,
           backend: "str | DecodeBackend" = "cuda",
           method: str = "gap", strategy: str = "tile",
           tile_syms: int = DEFAULT_TILE_SYMS,
           transform: "OutputTransform | None" = None) -> torch.Tensor:
    """Decode one stream to ``n_out`` uint16 quant codes.

    ``plan`` may carry a prebuilt ``DecoderPlan`` (phases 1-3); ``None``
    builds one with ``method``.  ``strategy="tile"`` runs the fixed-tile
    staged decode-write (paper Alg. 1) with tiles of ``tile_syms`` codes.
    ``transform`` (an ``OutputTransform``) runs the backend's fused op
    instead: the decoded symbols go through dequantization and the inverse
    Lorenzo inside the decode-write dispatch, and the return value is the
    reconstructed ``out_dtype[n_out]``, flat in C order (no quant-code
    array).  A backend without fused ops raises ``ValueError``, as in the
    reference; ``sz.compressor.decompress`` checks first and falls back.
    """
    be = get_backend(backend)
    check_ported("strategy", strategy)
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; valid strategies: "
                         f"{list(VALID_STRATEGIES)}")
    if transform is not None and not be.supports_fused:
        raise ValueError(
            f"backend {be.name!r} registers no fused ops; check "
            f"backend.supports_fused before attaching a transform")
    if plan is None:
        plan = build_plan(stream, codebook, method=method, backend=be)
    luts = _as_luts(codebook, stream.units.device)
    ss_max = ss_max_for_tile(tile_syms, luts.max_len)
    if transform is not None:
        t = transform
        return be.decode_tiles_fused(
            stream.units, luts.dec_sym, luts.dec_len, plan.start_bits,
            plan.end_bits, plan.offsets, stream.total_bits, luts.max_len,
            n_out, tile_syms, ss_max, t.outlier_pos, t.outlier_val, t.eb,
            t.radius, shape=None if t.shape is None else tuple(t.shape),
            out_dtype=(t.out_dtype if t.out_dtype is not None
                       else torch.float32))
    return be.decode_tiles(stream.units, luts.dec_sym, luts.dec_len,
                           plan.start_bits, plan.end_bits, plan.offsets,
                           stream.total_bits, luts.max_len, n_out, tile_syms,
                           ss_max)
