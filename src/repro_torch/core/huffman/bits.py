"""Bit-level primitives shared by the torch reference decoders.

Port of ``src/repro/core/huffman/bits.py``.  Units are read as int64 so the
shifts below stay exact (PyTorch has no shifts on ``torch.uint32``).
"""

from __future__ import annotations

import torch

from repro_torch.core.huffman.encode import SUBSEQ_BITS, UNIT_BITS  # re-export

__all__ = ["peek", "SUBSEQ_BITS", "UNIT_BITS"]


def peek(units: torch.Tensor, pos: torch.Tensor, max_len: int) -> torch.Tensor:
    """Read ``max_len`` bits at absolute bit position(s) ``pos``.

    ``units`` holds the uint32 stream units as int64 (MSB-first packing);
    ``pos`` is an integer tensor.  Returns int64 in ``[0, 2**max_len)`` -- an
    index into the decode LUT.  Unit reads are clipped, and a window that
    overruns the stream reads zero padding, as in the reference.
    """
    pos = pos.to(torch.int64)
    u = pos >> 5
    sh = pos & 31
    n = units.shape[0]
    w0 = units[u.clamp(0, n - 1)]
    w1 = torch.where(u + 1 < n, units[(u + 1).clamp(0, n - 1)], 0)
    hi = (w0 << sh) & 0xFFFFFFFF
    lo = torch.where(sh == 0, 0, w1 >> (32 - sh))
    window = hi | lo
    return window >> (32 - max_len)
