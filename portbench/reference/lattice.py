"""The dual-quant lattice of cuSZ, worked out from a field alone.

A float32 field ``x`` compressed at a relative error bound ``eb_rel`` has
one exact reconstruction:

    abs_eb = eb_rel * (max(x) - min(x))        (the range in float32)
    two_eb = float32(abs_eb) * 2
    q      = round_half_even(x / two_eb)        (an IEEE float32 division)
    x'     = float32(q) * two_eb                (one float32 product)

The Lorenzo residuals, the Huffman code and the outlier list only carry
``q`` from the writer to the reader, so every correct read returns ``x'``
bit for bit.  Plain torch on the field's device; nothing here comes from
the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

#: Values a comparison handles at once, which bounds its temporaries.
BLOCK = 1 << 25


def abs_eb(x: torch.Tensor, eb_rel: float) -> float:
    """The absolute bound of a relative one: ``eb_rel`` times the range."""
    rng = float(x.max() - x.min())
    return eb_rel * (rng if rng > 0 else 1.0)


def two_eb(eb: float, device) -> torch.Tensor:
    """The lattice step: ``float32(eb) * 2``, a tensor on ``device``.

    A tensor divisor keeps the division IEEE on the card (a Python scalar
    becomes a reciprocal multiply there)."""
    return torch.tensor(eb, dtype=torch.float32, device=device) * 2


def guarantee(x: torch.Tensor, eb: float) -> float:
    """The stated bound on ``max|x - x'|``: ``eb`` plus two float32 ulps at
    ``max|x|``, one for the rounded quotient and one for the product."""
    top = float(x.abs().max())
    return eb + 2.0 * float(np.spacing(np.float32(top + eb)))


def lattice(x: torch.Tensor, eb: float,
            compute: torch.dtype = torch.float32) -> torch.Tensor:
    """The reconstruction ``x'`` of ``x`` at absolute bound ``eb``, float32.

    ``compute`` is the precision of the product ``q * two_eb``; anything
    but float32 is the lower-precision control, not the reference.
    """
    step = two_eb(eb, x.device)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    flat, dst = x.reshape(-1), out.reshape(-1)
    for lo in range(0, flat.numel(), BLOCK):
        q = torch.round(flat[lo:lo + BLOCK] / step).to(torch.int32)
        dst[lo:lo + BLOCK] = (q.to(compute) * step.to(compute)).float()
    return out


def dequantize(codes: torch.Tensor, outlier_pos: torch.Tensor,
               outlier_val: torch.Tensor, eb: float, shape, radius: int,
               compute: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain inverse of the Lorenzo quantizer, float32 of ``shape``.

    ``codes`` are the decoded bins (``d + radius``), ``outlier_pos`` /
    ``outlier_val`` the stored side list (``pos < 0`` is padding).  The
    residuals are summed along every axis in int64, so no step wraps.
    ``compute`` is the precision of the product, as in :func:`lattice`.
    """
    n = codes.numel()
    d = codes.reshape(-1).to(torch.int64) - radius
    pos = outlier_pos.to(device=d.device, dtype=torch.int64)
    val = outlier_val.to(device=d.device, dtype=torch.int64)
    keep = (pos >= 0) & (pos < n)
    d[pos[keep]] = val[keep]
    q = d.reshape(tuple(shape))
    for axis in range(q.ndim):
        q = torch.cumsum(q, dim=axis)
    step = two_eb(eb, d.device)
    return (q.to(compute) * step.to(compute)).float()


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Values whose float32 bits differ (a length difference counts whole)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    n = min(fa.numel(), fb.numel())
    bad = abs(fa.numel() - fb.numel())
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        bad += int((fa[lo:hi].view(torch.int32)
                    != fb[lo:hi].view(torch.int32)).sum())
    return bad


def max_error(x: torch.Tensor, xr: torch.Tensor) -> float:
    """``max|x - xr|``, taken in float64; infinite when the sizes differ."""
    fx, fr = x.reshape(-1), xr.reshape(-1)
    if fx.numel() != fr.numel():
        return float("inf")
    worst = 0.0
    for lo in range(0, fx.numel(), BLOCK):
        gap = (fx[lo:lo + BLOCK].double() - fr[lo:lo + BLOCK].double()).abs()
        worst = max(worst, float(gap.nan_to_num(nan=float("inf")).max()))
    return worst
