"""End-to-end SZ-style compressor: Lorenzo -> quantize -> Huffman.

Port of ``src/repro/core/sz/compressor.py`` (``compress`` on the "ref"
host path and the "cuda" device write path, the two-pass ``decompress`` and
its fused form under every strategy, and the class-batched
``decompress_batch``).  Codebook construction is host numpy; quantization,
histogram, bit-pack, decode and dequantization run as torch ops and CUDA
kernels on the input's device.

:func:`compressed_from_arrays` and :func:`compressed_to_arrays` carry a
``Compressed`` across as plain numpy arrays and scalars, the form in which a
payload written by the JAX package enters the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.huffman import codebook as cb
from repro_torch.core.huffman import encode as he
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import lorenzo
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels.lorenzo import MAX_AXES
from repro_torch.kernels.ops import (PADDED_EPILOGUE_BLOCK, fused_squeeze,
                                    fused_tile_rows)

DEFAULT_EB = 1e-3

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy's / ml_dtypes' names)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class Compressed:
    """A compressed tensor (host container; tensor fields on one device)."""

    stream: he.EncodedStream
    codebook: cb.Codebook
    outlier_pos: torch.Tensor  # int32[m_pad], -1 padded
    outlier_val: torch.Tensor  # int32[m_pad] Lorenzo residuals
    shape: tuple
    dtype: torch.dtype
    eb: float
    radius: int
    rel_range: float           # value range used for relative error bounds
    max_abs: float = 0.0       # max |x|, for the effective-bound guarantee

    @property
    def n_symbols(self) -> int:
        return int(np.prod(self.shape))

    @property
    def device(self) -> torch.device:
        return self.stream.units.device

    def to(self, device) -> "Compressed":
        return dataclasses.replace(
            self, stream=self.stream.to(device),
            outlier_pos=self.outlier_pos.to(device),
            outlier_val=self.outlier_val.to(device))

    @property
    def compressed_bytes(self) -> int:
        """Storage accounting (paper's compression-ratio definition)."""
        unit_bytes = int(np.ceil(int(self.stream.total_bits) / 8))
        gap_bytes = self.stream.gaps.shape[0]  # 1 B / subsequence
        outlier_bytes = 8 * int((self.outlier_pos >= 0).sum())
        codebook_bytes = 2 * (1 << self.codebook.max_len)
        return unit_bytes + gap_bytes + outlier_bytes + codebook_bytes

    @property
    def original_bytes(self) -> int:
        return self.n_symbols * self.dtype.itemsize

    @property
    def ratio(self) -> float:
        return self.original_bytes / max(self.compressed_bytes, 1)

    @property
    def quant_code_bytes(self) -> int:
        """Size of the quantization-code array (2 bytes per code): the
        paper's decoder throughput is relative to it."""
        return 2 * self.n_symbols

    @property
    def eb_effective(self) -> float:
        """Guaranteed bound: eb + reconstruction rounding.

        The lattice value q is exact (float64 prequantization); the further
        rounding is the float32 product ``q * 2*eb`` (one f32 ulp at max
        |x|), plus -- for bf16/f16 outputs -- the single final cast (half an
        output-dtype ulp at max |x'|).
        """
        bound = self.eb + float(np.spacing(np.float32(self.max_abs + self.eb)))
        if self.dtype.itemsize < 4:
            bound += 0.5 * float(torch.finfo(self.dtype).eps) * (
                self.max_abs + bound)
        return bound


def _outlier_m_pad(n_out: int) -> int:
    """Power-of-two side-list padding, as in the reference."""
    return max(8, int(2 ** np.ceil(np.log2(max(n_out, 1) + 1))))


def _gather_outliers(csum, resid_flat, m_pad: int):
    """Compact the outlier side list from an inclusive mask prefix sum.

    The k-th outlier's position is ``searchsorted(csum, k + 1)``: ``m_pad``
    binary searches and one gather, no scatter.  Ascending positions, -1 /
    0 padded, the layout of the host path's ``nonzero``.
    """
    m = csum[-1]
    k = torch.arange(1, m_pad + 1, dtype=torch.int32, device=csum.device)
    pos = torch.searchsorted(csum, k, side="left").to(torch.int32)
    pos = torch.where(k <= m, pos, -1)
    val = torch.where(pos >= 0, resid_flat[pos.clamp(min=0)].to(torch.int32),
                      0)
    return pos, val


def encode_unsupported_reason(x, backend) -> "str | None":
    """Why the device encode path cannot serve this tensor (None = it can).

    The device quantizer is float32 (``lorenzo.quantize``) and takes at
    most ``kernels.lorenzo.MAX_AXES`` non-unit axes; other tensors fall
    back to the host path, counted in ``stats["encode_fallbacks"]``.
    """
    be = hp.get_encode_backend(backend)
    if not be.device:
        return f"backend {be.name!r} is the host path"
    if x.dtype != torch.float32:
        return (f"dtype {dtype_name(x.dtype)} is not float32 (the device "
                f"quantizer is f32)")
    axes = sum(1 for s in x.shape if s != 1)
    if axes > MAX_AXES:
        return (f"{axes} non-unit axes (the device quantizer takes at most "
                f"{MAX_AXES})")
    return None


def compress(x, eb: float = DEFAULT_EB, mode: str = "rel",
             radius: int = lorenzo.DEFAULT_RADIUS,
             max_len: int = cb.DEFAULT_MAX_LEN,
             subseqs_per_seq: int = he.DEFAULT_SUBSEQS_PER_SEQ,
             encode_backend: "str | hp.EncodeBackend" = "ref",
             device="cuda") -> Compressed:
    """Compress a float tensor with error bound ``eb``.

    mode="rel": bound is ``eb * (max(x) - min(x))`` (the paper's setting,
    "relative error bound 1e-3"); mode="abs": bound is ``eb`` directly.
    ``x`` (a tensor or numpy array) is moved to ``device`` (the card unless
    the caller asks for the CPU) and compressed there.

    ``encode_backend`` selects the write path: "ref" is the host path
    (float64 prequantization); "cuda" runs quantize -> outlier gather ->
    histogram -> bit-pack on the device (kernels on the card, their plain
    versions on the CPU), with only the ``2*radius``-entry histogram
    crossing to the host for the codebook.  It quantizes in float32, so for
    eb far above ulp scale the codes, and so the bytes, match the host
    path's; a tensor it cannot serve (``encode_unsupported_reason``) falls
    back to "ref", counted in ``stats["encode_fallbacks"]``.
    """
    ebe = hp.get_encode_backend(encode_backend)
    x = torch.as_tensor(x).to(device)
    if x.numel() == 0:
        raise ValueError(f"cannot compress an empty tensor of shape "
                         f"{tuple(x.shape)}")
    if mode == "rel":
        rng = float(x.max() - x.min())
        rng = rng if rng > 0 else 1.0
        abs_eb = eb * rng
    elif mode == "abs":
        rng = 1.0
        abs_eb = eb
    else:
        raise ValueError(f"unknown mode {mode!r}")
    max_abs = float(x.abs().max())

    if ebe.device and encode_unsupported_reason(x, ebe) is not None:
        ebe.bump("encode_fallbacks")
        ebe = hp.get_encode_backend("ref")

    if ebe.device:
        # The int32-lattice guard of the host prequantizer.
        if np.round(max_abs / (2.0 * abs_eb)) >= 2**31 - 1:
            raise ValueError(
                "error bound too small for int32 lattice; increase eb")
        codes, outlier, resid = ebe.quantize_fn(x, abs_eb, radius)
        codes_flat = codes.reshape(-1)
        csum = torch.cumsum(outlier.reshape(-1), 0, dtype=torch.int32)
        # One scalar sync sizes the side list; the gather stays on device.
        m_pad = _outlier_m_pad(int(csum[-1]))
        pos_pad, val_pad = _gather_outliers(csum, resid.reshape(-1), m_pad)
    else:
        codes, outlier, resid = ebe.quantize_fn(x, abs_eb, radius)
        codes_flat = codes.reshape(-1)
        # Outlier side list (exact residuals), padded to power-of-two length.
        pos = torch.nonzero(outlier.reshape(-1)).reshape(-1)
        m_pad = _outlier_m_pad(pos.shape[0])
        pos_pad = torch.full((m_pad,), -1, dtype=torch.int32,
                             device=x.device)
        val_pad = torch.zeros(m_pad, dtype=torch.int32, device=x.device)
        pos_pad[: pos.shape[0]] = pos.to(torch.int32)
        val_pad[: pos.shape[0]] = resid.reshape(-1)[pos].to(torch.int32)
    freq = ebe.hist_fn(codes_flat, 2 * radius)

    # Histogram -> codebook (host package-merge) -> bit-pack.
    plan = hp.build_encoder_plan(freq, max_len=max_len,
                                 subseqs_per_seq=subseqs_per_seq,
                                 backend=ebe, device=x.device)
    stream = hp.encode_with_plan(codes_flat, plan, backend=ebe)
    return Compressed(stream=stream, codebook=plan.codebook,
                      outlier_pos=pos_pad, outlier_val=val_pad,
                      shape=tuple(x.shape), dtype=x.dtype, eb=abs_eb,
                      radius=radius, rel_range=rng, max_abs=max_abs)


def _fused_transform(c: Compressed) -> hp.OutputTransform:
    return hp.OutputTransform(eb=c.eb, radius=c.radius,
                              outlier_pos=c.outlier_pos,
                              outlier_val=c.outlier_val,
                              shape=tuple(c.shape), out_dtype=c.dtype)


#: Output dtypes the fused epilogue serves (f32 compute, one final cast).
FUSED_DTYPES = ("float32", "bfloat16", "float16")


def fused_max_cols(max_len: int) -> int:
    """Widest row the N-D fused kernel takes at ``max_len``: a one-row tile
    (int32 residuals), its scan scratch and the 2**max_len-entry LUT must
    fit one block's shared memory on Hopper (227 KB)."""
    free = K.SMEM_LIMIT - fd.decode_tiles_fused_nd_smem(0, 1 << max_len)
    return max(free // 4, 0)


#: Widest fastest axis of the N-D fused kernel at the default max_len (12):
#: 54,960 columns (the TPU's VMEM bound was 2**15).
FUSED_MAX_COLS = fused_max_cols(cb.DEFAULT_MAX_LEN)
#: Widest fastest axis of the padded strategy's fused epilogue
#: (``dequant_reconstruct_nd``): a one-row tile of int32 residuals and its
#: scan scratch in one block's shared memory, with no LUT beside them, so
#: it does not depend on max_len: (232,448 - 320) / 4 = 58,032 columns.
FUSED_PADDED_MAX_COLS = (K.SMEM_LIMIT - fd.dequant_reconstruct_smem(0)) // 4
#: Largest 3-D plane (rows * cols) the fused kernel carries.  The plane
#: carry is one (rows, cols) buffer of tagged 8-byte words in global memory,
#: no longer in on-chip memory; 2**20 values keep it at 8 MiB, resident in
#: the H100's 50 MB L2, where each plane's tiles read what the previous
#: plane's wrote.  Kept at the reference's value.
FUSED_MAX_PLANE = 1 << 20


def fused_unsupported_reason(c: Compressed, backend, method: str,
                             strategy: str,
                             tile_syms: int = hp.DEFAULT_TILE_SYMS
                             ) -> "str | None":
    """Why the fused decode path cannot serve this tensor (None = it can).

    The reference's checks and reason strings, in its order: the fused
    epilogue covers 1-D/2-D/3-D inverse Lorenzo (unit axes squeezed first,
    ``ops.fused_squeeze``) over float32, bfloat16 and float16 outputs
    (``FUSED_DTYPES``).  Falling back to the two-pass path (recorded in
    ``stats["fused_fallbacks"]``): >3-D tensors, other dtypes, rows wider
    than the row bound, 3-D planes larger than ``FUSED_MAX_PLANE``,
    strategies other than "tile"/"padded", backends without fused ops --
    and, new in the port, a tile whose block would not fit Hopper's shared
    memory.  The bounds follow the block of the kernel that runs: for
    "tile" the fused decode's tile of ``tile_syms`` codes (or whole rows)
    beside the LUT, so the row bound is ``fused_max_cols(max_len)``; for
    "padded" the epilogue's tile of ``PADDED_EPILOGUE_BLOCK`` codes (or
    whole rows) with no LUT, so the row bound is ``FUSED_PADDED_MAX_COLS``.
    The bounds apply on every backend, as the reference's VMEM bounds do,
    so both backends fall back alike.
    """
    be = hp.get_backend(backend)
    if method == "naive_ref":
        return "method 'naive_ref' is the sequential oracle"
    if strategy not in ("tile", "padded"):
        return ("strategy 'tuned' gathers sequences by CR class, which "
                "breaks the sequential reconstruction carry")
    if not be.supports_fused:
        return f"backend {be.name!r} registers no fused ops"
    return reconstruct_unsupported_reason(c.shape, c.dtype, strategy,
                                          c.codebook.max_len, tile_syms)


def reconstruct_unsupported_reason(shape, dtype: torch.dtype,
                                   strategy: str = "padded",
                                   max_len: int = cb.DEFAULT_MAX_LEN,
                                   tile_syms: int = hp.DEFAULT_TILE_SYMS
                                   ) -> "str | None":
    """Why the fused reconstruction of ``strategy`` cannot take a tensor of
    ``shape`` and ``dtype`` (None = it can): the shape and dtype half of
    :func:`fused_unsupported_reason`, with its reason strings.

    With ``strategy="padded"`` (the default) these are the bounds of the
    epilogue kernels over a code array (``dequant_reconstruct``,
    ``dequant_reconstruct_nd``), which do not depend on ``max_len``: the
    padded strategy's fused form and the card's two-pass dequantize
    (:func:`_dequantize`) both ask here, so the two cannot drift apart.
    With "tile" they are the bounds of the fused decode kernels, whose
    block holds the ``2**max_len``-entry LUT beside a tile of
    ``tile_syms`` codes.
    """
    if dtype_name(dtype) not in FUSED_DTYPES:
        return f"dtype {dtype_name(dtype)} not in fused set {FUSED_DTYPES}"
    sq = tuple(s for s in shape if s != 1)
    if len(sq) > 3:
        return (f"{len(sq)}-D Lorenzo reconstruction (fused epilogue "
                f"covers up to 3-D)")
    padded = strategy == "padded"
    max_cols = FUSED_PADDED_MAX_COLS if padded else fused_max_cols(max_len)
    if len(sq) >= 2 and sq[-1] > max_cols:
        return (f"fastest axis {sq[-1]} exceeds the per-tile row bound "
                f"{max_cols}")
    if len(sq) == 3 and sq[-2] * sq[-1] > FUSED_MAX_PLANE:
        return (f"plane {sq[-2]}x{sq[-1]} exceeds the VMEM plane-carry "
                f"bound {FUSED_MAX_PLANE}")
    nd = fused_squeeze(shape)
    tile = PADDED_EPILOGUE_BLOCK if padded else tile_syms
    block = tile if nd is None else fused_tile_rows(nd, tile) * nd[-1]
    lut = 1 << max_len
    if padded:
        smem = (fd.epilogue_smem(2 * block) if nd is None
                else fd.dequant_reconstruct_smem(block))
    elif nd is None:
        smem = fd.fused_unit_smem(block, lut)
    else:
        smem = fd.decode_tiles_fused_nd_smem(block, lut)
    if smem > K.SMEM_LIMIT:
        return (f"a fused tile of {block} codes needs {smem} B of shared "
                f"memory per block; Hopper allows {K.SMEM_LIMIT}")
    return None


def _dequantize(c: Compressed, codes: torch.Tensor,
                backend: "str | hp.DecodeBackend") -> torch.Tensor:
    """The two-pass dequantize: ``2eb * cumsum_every_axis(code - radius)``
    with the outliers scattered in, a float32 product (float64 for a
    float64 output) and one cast to ``c.dtype``.

    Codes on the card, of a shape and dtype the padded epilogue takes
    (:func:`reconstruct_unsupported_reason`), go to ``backend``'s
    ``dequant_fn`` where it registers one: on "cuda" one launch of the
    epilogue kernel, ``eb`` passed by value (``ops.dequant_epilogue``:
    ``dequant_reconstruct_nd`` for 2-D/3-D after the unit axes are
    squeezed, ``dequant_reconstruct`` for 1-D).  Every other tensor, every
    tensor off the card and every backend without the op ("ref") run
    ``lorenzo.dequantize``'s torch ops.  Both give the same bits: int32
    sums wrap alike in any order.  The span ``repro_torch.dequantize``
    says which ran (args ``"kernel"`` or ``"torch"``).

    The kernel path assumes the outlier positions ascend with the ``-1``
    padding at the tail, as both packages' ``compress`` write them (each
    tile finds its slice of the list by ``searchsorted``).  On both paths
    a position below 0 or at or past ``c.n_symbols`` is dropped: past the
    end it lands in the pad or in no tile, and the pad is cut off.
    """
    dequant_fn = hp.get_backend(backend).dequant_fn
    on_kernel = (dequant_fn is not None and codes.device.type == "cuda"
                 and reconstruct_unsupported_reason(c.shape, c.dtype) is None)
    with trace.span("repro_torch.dequantize",
                    "kernel" if on_kernel else "torch"):
        if on_kernel:
            return dequant_fn(codes.reshape(-1), c.n_symbols, c.outlier_pos,
                              c.outlier_val, c.eb, c.radius, c.shape,
                              c.dtype).reshape(c.shape)
        return lorenzo.dequantize(codes.reshape(c.shape), c.outlier_pos,
                                  c.outlier_val, c.eb, c.shape,
                                  radius=c.radius, dtype=c.dtype)


def _guard_symbol_count(c: Compressed, plan, backend) -> None:
    """Decoder guard: a plan must decode exactly ``c.n_symbols`` symbols;
    a mismatch (corrupt stream metadata) counts a guard trip and raises
    ``DecodeGuardError``.  No plan (``method="naive_ref"``): no guard."""
    if plan is None:
        return
    total = int(np.asarray(plan.seq_counts).sum())
    if total != c.n_symbols:
        hp.get_backend(backend).bump("decode_guard_trips")
        raise hp.DecodeGuardError(
            f"symbol-count mismatch: plan decodes {total} symbols but the "
            f"tensor records n_symbols={c.n_symbols} (shape "
            f"{tuple(c.shape)}) -- corrupt stream metadata")


def decompress(c: Compressed, method: str = "gap",
               tile_syms: int = hp.DEFAULT_TILE_SYMS, *,
               backend: "str | hp.DecodeBackend" = "cuda",
               strategy: str = "tile", t_high: int = hp.T_HIGH_DEFAULT,
               plan=None, fused: bool = False) -> torch.Tensor:
    """Decompress on the device ``c`` lives on; ``method`` in {"gap",
    "selfsync", "naive_ref"} (``pipeline.VALID_METHODS``).

    Decoding goes through ``pipeline.decode`` on ``backend`` with
    ``strategy`` ("tile", "tuned" or "padded"); ``plan`` may carry a
    prebuilt ``DecoderPlan``, else one is built with ``method``.
    "naive_ref", the reference's sequential oracle, builds no plan and
    decodes the whole stream in one sequential scan
    (``pipeline.decode_naive_ref``: on the card the ``decode_chunked``
    kernel with the stream as its one chunk).
    ``fused=True`` runs phase 4, dequantization and the inverse Lorenzo
    without a two-pass dequantize: one CUDA kernel on "cuda" for "tile",
    and the padded decode followed by one epilogue kernel for "padded"; the
    output is bit-exact with the two-pass path.  A tensor the fused path
    cannot serve (:func:`fused_unsupported_reason`, which includes every
    "tuned" decode) decodes two-pass and increments
    ``backend.stats["fused_fallbacks"]``.
    """
    book = c.codebook
    hp.check_method(method)
    if plan is None and method in hp.VALID_PLAN_METHODS:
        plan = hp.build_plan(c.stream, book, method=method, backend=backend,
                             t_high=t_high)
    _guard_symbol_count(c, plan, backend)

    if fused:
        reason = fused_unsupported_reason(c, backend, method, strategy,
                                          tile_syms)
        if reason is None:
            out = hp.decode(c.stream, book, c.n_symbols, plan=plan,
                            method=method, backend=backend,
                            strategy=strategy, tile_syms=tile_syms,
                            t_high=t_high, transform=_fused_transform(c))
            return out.reshape(c.shape)
        hp.get_backend(backend).bump("fused_fallbacks")

    if method == "naive_ref":
        codes = hp.decode_naive_ref(c.stream, book, c.n_symbols)
    else:
        codes = hp.decode(c.stream, book, c.n_symbols, plan=plan,
                          method=method, backend=backend, strategy=strategy,
                          tile_syms=tile_syms, t_high=t_high)
    return _dequantize(c, codes, backend)


def decompress_batch(cs: "list[Compressed]", method: str = "gap",
                     tile_syms: int = hp.DEFAULT_TILE_SYMS, *,
                     backend: "str | hp.DecodeBackend" = "cuda",
                     strategy: str = "tile",
                     t_high: int = hp.T_HIGH_DEFAULT,
                     plans: "list | None" = None,
                     fused: bool = False) -> list:
    """Decompress many tensors with class-batched decode dispatch.

    Huffman decode-write runs once per CR class across ALL tensors
    (``pipeline.decode_batch``) instead of once per class per tensor; the
    output is bit-exact with per-tensor :func:`decompress`.  ``plans`` may
    carry prebuilt (e.g. cached) ``DecoderPlan`` objects, one per tensor,
    which skips phases 1-3.

    ``fused=True``: tensors the fused path can serve under ``strategy``
    (:func:`fused_unsupported_reason`, judged exactly once per tensor)
    decode one by one through the fused path; the rest go through the
    class-merged two-pass path, and each of them counts
    ``stats["fused_fallbacks"]`` exactly once.  Output order and bits are
    the same either way.
    """
    cs = list(cs)
    if not cs:
        return []
    hp.check_method(method)
    be = hp.get_backend(backend)
    if plans is None:
        plans = [hp.build_plan(c.stream, c.codebook, method=method,
                               backend=be, t_high=t_high) for c in cs]
    for c, p in zip(cs, plans):
        _guard_symbol_count(c, p, be)
    outs: list = [None] * len(cs)
    rest = list(range(len(cs)))
    if fused:
        rest = []
        for i, c in enumerate(cs):
            if fused_unsupported_reason(c, be, method, strategy,
                                        tile_syms) is None:
                out = hp.decode(c.stream, c.codebook, c.n_symbols,
                                plan=plans[i], method=method, backend=be,
                                strategy=strategy, tile_syms=tile_syms,
                                t_high=t_high, transform=_fused_transform(c))
                outs[i] = out.reshape(c.shape)
            else:
                be.bump("fused_fallbacks")
                rest.append(i)
    if rest:
        codes = hp.decode_batch(
            [cs[i].stream for i in rest], [cs[i].codebook for i in rest],
            [cs[i].n_symbols for i in rest], plans=[plans[i] for i in rest],
            method=method, backend=be, t_high=t_high)
        for i, q in zip(rest, codes):
            outs[i] = _dequantize(cs[i], q, be)
    return outs


# ---------------------------------------------------------------------------
# Carrying a payload across as plain arrays
# ---------------------------------------------------------------------------

#: Keys of the dict form of a ``Compressed``.
ARRAY_FIELDS = ("units", "gaps", "counts", "seq_counts", "total_bits",
                "n_symbols", "subseqs_per_seq", "enc_code", "enc_len",
                "max_len", "outlier_pos", "outlier_val", "shape", "dtype",
                "eb", "radius", "rel_range", "max_abs")


def compressed_from_arrays(fields: dict, device) -> Compressed:
    """Build a ``Compressed`` on ``device`` from numpy arrays and scalars.

    ``fields`` has the keys of ``ARRAY_FIELDS``: the stream (``units``
    uint32, ``gaps`` uint8, ``counts`` / ``seq_counts`` int32,
    ``total_bits``, ``n_symbols``, ``subseqs_per_seq``), the codebook's
    encoder tables (``enc_code`` uint32, ``enc_len`` uint8, ``max_len``; the
    decode LUT is rebuilt from them), the outlier side list, ``shape``,
    ``dtype`` as a string ("float32", "bfloat16", "float16") and the
    quantizer scalars.
    """
    missing = [k for k in ARRAY_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"compressed_from_arrays: missing fields {missing}")
    f = fields

    def t(name, np_dtype):
        return torch.from_numpy(np.array(f[name], np_dtype)).to(device)

    stream = he.EncodedStream(
        units=t("units", np.uint32), gaps=t("gaps", np.uint8),
        counts=t("counts", np.int32), seq_counts=t("seq_counts", np.int32),
        total_bits=int(f["total_bits"]), n_symbols=int(f["n_symbols"]),
        subseqs_per_seq=int(f["subseqs_per_seq"]))
    enc_code = np.asarray(f["enc_code"], np.uint32)
    enc_len = np.asarray(f["enc_len"], np.uint8)
    max_len = int(f["max_len"])
    dec_sym, dec_len = cb.build_decode_lut(enc_code, enc_len, max_len)
    book = cb.Codebook(n_symbols=int(enc_code.shape[0]), max_len=max_len,
                       enc_code=enc_code, enc_len=enc_len, dec_sym=dec_sym,
                       dec_len=dec_len)
    dtype = _DTYPES.get(str(f["dtype"]))
    if dtype is None:
        raise ValueError(f"unsupported dtype {f['dtype']!r}; "
                         f"known: {sorted(_DTYPES)}")
    return Compressed(
        stream=stream, codebook=book,
        outlier_pos=t("outlier_pos", np.int32),
        outlier_val=t("outlier_val", np.int32),
        shape=tuple(int(s) for s in f["shape"]), dtype=dtype,
        eb=float(f["eb"]), radius=int(f["radius"]),
        rel_range=float(f["rel_range"]), max_abs=float(f["max_abs"]))


def compressed_to_arrays(c: Compressed) -> dict:
    """Inverse of :func:`compressed_from_arrays` (host numpy copies)."""
    s = c.stream
    host = {k: v.cpu().numpy() for k, v in (
        ("units", s.units), ("gaps", s.gaps), ("counts", s.counts),
        ("seq_counts", s.seq_counts), ("outlier_pos", c.outlier_pos),
        ("outlier_val", c.outlier_val))}
    return {**host, "total_bits": int(s.total_bits),
            "n_symbols": int(s.n_symbols),
            "subseqs_per_seq": int(s.subseqs_per_seq),
            "enc_code": np.asarray(c.codebook.enc_code, np.uint32),
            "enc_len": np.asarray(c.codebook.enc_len, np.uint8),
            "max_len": int(c.codebook.max_len), "shape": tuple(c.shape),
            "dtype": dtype_name(c.dtype), "eb": float(c.eb),
            "radius": int(c.radius), "rel_range": float(c.rel_range),
            "max_abs": float(c.max_abs)}
