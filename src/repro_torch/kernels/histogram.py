"""Integer histogram: CUDA wrapper and plain version.

Port of ``src/repro/kernels/histogram.py``: :func:`histogram` counts the
values of an integer tensor, clipped to ``[0, nbins)``, into int32
``[nbins]`` (``csrc/histogram.cu``: a shared-memory sub-histogram per
block, added into the output with global atomics; past shared memory, a
variant with global atomics only, chosen by size before the launch).  On
the write path it counts the quantization codes for the codebook.

The wrapper follows ``huffman_decode``'s rules: input checks, the kernel
for CUDA tensors, the plain version for CPU tensors, any other device
raises, and each launch is counted (``kernels/launches``).
"""

from __future__ import annotations

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


def histogram_smem(nbins: int) -> int:
    """Shared memory of one block of the sub-histogram variant."""
    return 4 * nbins


def histogram_in_smem(nbins: int) -> bool:
    """Whether the ``nbins`` counters fit one block's shared memory (else
    the global-atomics variant runs)."""
    return histogram_smem(nbins) <= K.SMEM_LIMIT


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
    out = torch.zeros(nbins, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    if x.dtype not in IN_KINDS:
        x = x.to(torch.int32)
    launch = _build.load("histogram")
    rc = launch(x.data_ptr(), x.numel(), IN_KINDS[x.dtype], nbins,
                0 if histogram_in_smem(nbins) else 1, out.data_ptr(),
                K._stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {rc}")
    launches.launched(histogram)
    return out
