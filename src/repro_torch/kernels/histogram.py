"""Integer histogram: CUDA wrapper and plain version.

Port of ``src/repro/kernels/histogram.py``: :func:`histogram` counts the
values of an integer tensor, clipped to ``[0, nbins)``, into int32
``[nbins]`` (``csrc/histogram.cu``: 16-byte loads, a shared-memory
sub-histogram a block added into the output, one wave of blocks; one block
that stores every bin up to ``HIST_SINGLE_MAX`` values; past shared memory,
a variant with global atomics only).  Its geometry comes from
:func:`histogram_geometry`.  On the write path it counts the quantization
codes for the codebook.

The wrapper follows ``huffman_decode``'s rules: input checks, the kernel
for CUDA tensors, the plain version for CPU tensors, any other device
raises, and each launch is counted (``kernels/launches``).
"""

from __future__ import annotations

import functools
import typing

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

#: Input dtypes the kernel reads, and their code in the C interface; other
#: integer dtypes are cast to int32 first (wrapping, as the reference's
#: ``astype(int32)`` does).
IN_KINDS = {torch.uint16: 0, torch.int32: 1}
_INTS = (torch.uint8, torch.int8, torch.int16, torch.uint16, torch.int32,
         torch.int64)
#: Bytes of one load of the kernel's body.
HIST_VEC_BYTES = 16
#: Threads of a block of the grid, and blocks of it an SM.
HIST_THREADS = 1024
HIST_BLOCKS_PER_SM = 1
#: A block's share of x is at least ``HIST_SHARE_PER_BIN * nbins`` values,
#: so its zeroing and its flush are small beside its counting.
HIST_SHARE_PER_BIN = 16
#: Largest input one block counts alone, storing every bin of the output
#: (which then needs no zero fill): a KV page of 32,768 codes is one.
HIST_SINGLE_MAX = 1 << 16


def histogram_smem(nbins: int) -> int:
    """Shared memory of one block of the sub-histogram variant."""
    return 4 * nbins


def histogram_in_smem(nbins: int) -> bool:
    """Whether the ``nbins`` counters fit one block's shared memory (else
    the global-atomics variant runs)."""
    return histogram_smem(nbins) <= K.SMEM_LIMIT


class HistogramGeometry(typing.NamedTuple):
    """Launch geometry of :func:`histogram` (:func:`histogram_geometry`).

    ``head`` values before the first 16-byte boundary of x, ``vectors``
    16-byte loads, ``tail`` values after them (head and tail fewer than a
    load's values each); ``blocks`` of ``threads``; ``shared``: a
    sub-histogram a block in shared memory (else global atomics);
    ``single``: one block that stores every bin, so the output needs no
    zero fill."""
    head: int
    vectors: int
    tail: int
    blocks: int
    threads: int
    shared: bool
    single: bool


def histogram_geometry(ptr: int, n: int, itemsize: int, nbins: int,
                       sm_count: int) -> HistogramGeometry:
    """Launch geometry of :func:`histogram` for ``n`` values of
    ``itemsize`` bytes (2 or 4) from address ``ptr`` into ``nbins`` bins on
    a card of ``sm_count`` SMs (:func:`_histogram_geometry`)."""
    if itemsize not in (2, 4) or ptr % itemsize:
        raise ValueError(f"x must hold aligned 2- or 4-byte values, got "
                         f"itemsize {itemsize} at address {ptr:#x}")
    return _histogram_geometry(ptr % HIST_VEC_BYTES, n, itemsize, nbins,
                               sm_count)


@functools.lru_cache(maxsize=256)
def _histogram_geometry(offset: int, n: int, itemsize: int, nbins: int,
                        sm_count: int) -> HistogramGeometry:
    """:func:`histogram_geometry` for x ``offset`` bytes past a 16-byte
    boundary.

    The head is what lies before the first 16-byte boundary at or after
    x; the body whole 16-byte loads; the tail the rest.  Up to
    ``HIST_SINGLE_MAX`` values one block counts (as wide as its loads, a
    warp at least); above, ``HIST_BLOCKS_PER_SM`` blocks an SM, fewer if a
    block's share of x would fall below ``HIST_SHARE_PER_BIN * nbins``.
    Past shared memory (:func:`histogram_in_smem`) global atomics, one wave
    of blocks, never a single block.
    """
    per = HIST_VEC_BYTES // itemsize
    head = min(n, (-offset % HIST_VEC_BYTES) // itemsize)
    vectors = (n - head) // per
    tail = n - head - vectors * per
    shared = histogram_in_smem(nbins)
    wave = sm_count * HIST_BLOCKS_PER_SM
    threads = HIST_THREADS
    if not shared:
        blocks = max(1, min(wave, -(-n // (threads * per))))
    elif n <= HIST_SINGLE_MAX:
        blocks = 1
        threads = min(threads, max(32, -(-max(vectors, 1) // 32) * 32))
    else:
        blocks = max(1, min(wave, n // (HIST_SHARE_PER_BIN * nbins)))
    return HistogramGeometry(head=head, vectors=vectors, tail=tail,
                             blocks=blocks, threads=threads, shared=shared,
                             single=shared and blocks == 1)


def histogram_plain(x, nbins: int):
    """Plain version of :func:`histogram` (any device)."""
    v = x.reshape(-1).to(torch.int32).clamp(0, nbins - 1)
    return torch.bincount(v, minlength=nbins).to(torch.int32)


@launches.counted
def histogram(x, nbins: int):
    """int32[nbins] counts of ``x`` (any integer dtype, contiguous), values
    clipped to ``[0, nbins)`` as the reference's ``_hist_kernel`` does."""
    if not isinstance(x, torch.Tensor) or x.dtype not in _INTS:
        raise TypeError(f"x must be an integer tensor, got "
                        f"{getattr(x, 'dtype', type(x))}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 1 <= nbins < 1 << 31:
        raise ValueError(f"nbins must be in [1, 2**31), got {nbins}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain path for device "
                         f"{x.device}")
    if x.device.type == "cpu":
        return histogram_plain(x, nbins)
    if x.numel() == 0:
        return torch.zeros(nbins, dtype=torch.int32, device=x.device)
    if x.dtype not in IN_KINDS:
        x = x.to(torch.int32)
    # a tensor's values are aligned to their size: no check needed
    geo = _histogram_geometry(x.data_ptr() % HIST_VEC_BYTES, x.numel(),
                              x.element_size(), nbins,
                              K.sm_count(x.device.index))
    out = (torch.empty if geo.single else torch.zeros)(
        nbins, dtype=torch.int32, device=x.device)
    launch = _build.load("histogram")
    rc = launch(x.data_ptr(), x.numel(), IN_KINDS[x.dtype], nbins, geo.head,
                geo.vectors, geo.blocks, geo.threads, int(geo.shared),
                int(geo.single), out.data_ptr(),
                K._stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {rc}")
    launches.launched(histogram)
    return out
