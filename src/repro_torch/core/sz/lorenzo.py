"""Lorenzo prediction + error-bounded quantization (cuSZ's dual-quant).

Port of ``src/repro/core/sz/lorenzo.py``: the storage path
(``quantize_host``), the float32 device quantizer (``quantize``) and
``dequantize``.

  compress:    q  = round(x / (2*eb))               (half to even: float64
                                                     in quantize_host,
                                                     float32 in quantize)
               d  = q - L(q)                         (Lorenzo residual, exact)
               code = clip(d + R, 0, 2R-1)           (uint16 bins, radius R)
               outliers: positions with |d| >= R keep d in a side list
  decompress:  d  = code - R  (outliers scattered back)
               q  = inclusive prefix-sum of d along every axis (int32)
               x' = q * 2*eb                         (float32, one final cast)

Both run as torch ops on the tensor's own device.  The division takes the
error bound as a tensor on that device: PyTorch's CUDA ``div`` by a Python
scalar multiplies by the reciprocal, which moves lattice ties.
"""

from __future__ import annotations

import torch

from repro_torch.core import trace

DEFAULT_RADIUS = 512  # 1024 quantization bins, cuSZ default


def _lorenzo_residual(q: torch.Tensor) -> torch.Tensor:
    """d = q - L(q): first differences along every axis, zero boundary."""
    d = q
    for axis in range(q.ndim):
        if d.shape[axis] > 1:
            d = torch.diff(d, dim=axis,
                           prepend=torch.zeros_like(d.narrow(axis, 0, 1)))
    return d


def quantize(x: torch.Tensor, eb: float, radius: int = DEFAULT_RADIUS):
    """Float32 quantizer of the device write path: the plain version of the
    ``lorenzo_quantize`` kernel (``kernels/lorenzo.py``).

    Returns ``(codes uint16, outlier_mask bool, residual int32)``, shaped
    like ``x``.  As in the reference, ``eb`` is cast to ``x.dtype`` and
    doubled (exact), ``x / (2*eb)`` is a true division rounded half to
    even, and the residual is int32, wrapping as XLA's int32 does.  Where
    ``|x| / (2*eb)`` nears 2**23 the float32 division can misplace lattice
    cells; the storage path (:func:`quantize_host`) divides in float64.
    """
    two_eb = torch.tensor(eb, dtype=x.dtype, device=x.device) * 2
    q = torch.round(x / two_eb).to(torch.int32)
    d = _lorenzo_residual(q)
    code = d + radius
    outlier = (code < 0) | (code >= 2 * radius)
    codes = torch.where(outlier, 0, code.clamp(0, 2 * radius - 1))
    return codes.to(torch.uint16), outlier, d


def quantize_host(x: torch.Tensor, eb: float, radius: int = DEFAULT_RADIUS):
    """Float64 prequantization (storage path).

    Returns ``(codes uint16, outlier_mask bool, residual int64)``, shaped like
    ``x``.  Raises if the lattice index overflows int32, which the int32
    reconstruction requires.
    """
    x64 = x.to(torch.float64)
    two_eb = torch.tensor(2.0 * eb, dtype=torch.float64, device=x.device)
    q = torch.round(x64 / two_eb)
    if q.numel() and float(q.abs().max()) >= 2**31 - 1:
        raise ValueError(
            "error bound too small for int32 lattice; increase eb")
    d = _lorenzo_residual(q.to(torch.int64))
    code = d + radius
    outlier = (code < 0) | (code >= 2 * radius)
    codes = torch.where(outlier, 0, code.clamp(0, 2 * radius - 1))
    return codes.to(torch.uint16), outlier, d


def dequantize(codes: torch.Tensor, outlier_pos: torch.Tensor,
               outlier_val: torch.Tensor, eb: float, shape: tuple,
               radius: int = DEFAULT_RADIUS, dtype=torch.float32):
    """Inverse of :func:`quantize_host`.

    ``outlier_pos`` / ``outlier_val`` are flat positions and int32 residuals;
    entries with ``pos < 0`` (padding) or past the end are dropped.  The
    product runs in float32 (float64 for a float64 output) and is cast once
    to ``dtype``, as in the reference.
    """
    n = codes.numel()
    flat = torch.empty(n + 1, dtype=torch.int32, device=codes.device)
    torch.sub(codes.reshape(-1).to(torch.int32), radius, out=flat[:n])
    pos = outlier_pos.to(device=codes.device, dtype=torch.int64)
    safe = torch.where((pos >= 0) & (pos < n), pos, n)
    flat[safe] = outlier_val.to(device=codes.device, dtype=torch.int32)
    q = flat[:n].reshape(shape)
    for axis in range(q.ndim):
        q = torch.cumsum(q, dim=axis, dtype=torch.int32)
    compute = torch.float64 if dtype == torch.float64 else torch.float32
    with trace.crossing("repro_torch.dequantize.eb.h2d", codes.device):
        eb_t = torch.tensor(eb, dtype=compute, device=codes.device)
    two_eb = eb_t * 2
    return (q.to(compute) * two_eb).to(dtype)
