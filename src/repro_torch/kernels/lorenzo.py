"""Lorenzo quantize and 1-D reconstruct: CUDA wrappers and plain versions.

Port of ``src/repro/kernels/lorenzo.py``:

  * :func:`lorenzo_quantize` -- the dual-quant Lorenzo quantizer: ``q =
    round(x / 2eb)``, the residual ``d = q - L(q)``, ``code = d + radius``
    (0 for an outlier) and the outlier mask (``csrc/lorenzo_quantize.cu``).
    The TPU kernel ``quantize1d`` took 1-D inputs only; this kernel takes
    up to ``MAX_AXES`` non-unit axes, so the N-D quantize runs on the card
    too.  Its plain version is ``core/sz/lorenzo.py:quantize``.
  * :func:`reconstruct1d` -- the inverse 1-D Lorenzo, ``2eb * cumsum(d)``
    with the int32 carry between tiles taken by decoupled look-back
    (``csrc/reconstruct1d.cu``).

The wrappers follow ``huffman_decode``'s rules: input checks, the kernel for
CUDA tensors, the plain version (``*_plain``, beside it) for CPU tensors,
any other device raises, and each launch is counted (``kernels/launches``).
``two_eb`` is the float32 scale as a Python float (``ops._two_eb_f32``):
the kernels divide and multiply by it at run time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sz import lorenzo as _lor
from repro_torch.kernels import _build
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

#: Most non-unit axes the quantize kernel takes (2**8 corners a value).
MAX_AXES = 8
#: Values one ``reconstruct1d`` block scans (the reference's block).
RECONSTRUCT_BLOCK = 4096


def _check_device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain path for device "
                         f"{t.device}")


def squeezed_dims(shape) -> tuple:
    """The non-unit axes of ``shape``, slowest first: the geometry the
    quantize kernel runs over (a difference along a unit axis is the
    identity).  Raises ``ValueError`` past ``MAX_AXES`` axes."""
    dims = tuple(int(s) for s in shape if s != 1)
    if len(dims) > MAX_AXES:
        raise ValueError(f"lorenzo_quantize takes at most {MAX_AXES} "
                         f"non-unit axes, got shape {tuple(shape)}")
    return dims


def lorenzo_quantize_plain(x, two_eb: float, radius: int):
    """Plain version of :func:`lorenzo_quantize` (any device):
    ``lorenzo.quantize`` at ``eb = two_eb / 2`` (halving a float32 value is
    exact, so the quantizer divides by ``two_eb`` itself)."""
    return _lor.quantize(x, two_eb / 2, radius=radius)


@launches.counted
def lorenzo_quantize(x, two_eb: float, radius: int):
    """Dual-quant Lorenzo quantize of a float32 tensor.

    ``x``: float32, contiguous, any shape with at most ``MAX_AXES`` non-unit
    axes and fewer than 2**31 values.  Returns ``(codes uint16, outlier
    bool, residual int32)``, shaped like ``x``, bit-identical to
    ``core/sz/lorenzo.py:quantize``.
    """
    K._expect("x", x, torch.float32)
    dims = squeezed_dims(x.shape)
    K._check_two_eb(two_eb)
    if not 1 <= radius < 1 << 30:
        raise ValueError(f"radius must be in [1, 2**30), got {radius}")
    if x.numel() >= 1 << 31:
        raise ValueError(f"lorenzo_quantize takes fewer than 2**31 values, "
                         f"got {x.numel()}")
    _check_device(x)
    if x.device.type == "cpu":
        return lorenzo_quantize_plain(x, two_eb, radius)
    codes = torch.empty(x.shape, dtype=torch.uint16, device=x.device)
    outlier = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    resid = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return codes, outlier, resid
    launch = _build.load("lorenzo_quantize")
    rc = launch(x.data_ptr(), x.numel(),
                (ctypes.c_longlong * MAX_AXES)(*dims), len(dims), two_eb,
                radius, codes.data_ptr(), outlier.data_ptr(),
                resid.data_ptr(), K._stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError(f"lorenzo_quantize kernel launch failed: CUDA "
                           f"error {rc}")
    launches.launched(lorenzo_quantize)
    return codes, outlier, resid


def reconstruct1d_plain(resid, two_eb: float):
    """Plain version of :func:`reconstruct1d` (any device): the int32
    cumsum, then one float32 multiply."""
    q = torch.cumsum(resid, 0, dtype=torch.int32)
    scale = torch.tensor(two_eb, dtype=torch.float32, device=resid.device)
    return q.to(torch.float32) * scale


@launches.counted
def reconstruct1d(resid, two_eb: float, block: int = RECONSTRUCT_BLOCK):
    """Inverse 1-D Lorenzo: ``float32(cumsum(resid)) * two_eb``.

    ``resid``: int32[n], contiguous.  Returns float32[n], bit-identical to
    ``kernels/ref.lorenzo_reconstruct`` of the reference.  ``block`` is the
    kernel's tile (any length works: the last tile is ragged).
    """
    K._expect("resid", resid, torch.int32)
    if resid.ndim != 1:
        raise ValueError(f"resid must be 1-D, got shape {tuple(resid.shape)}")
    K._check_two_eb(two_eb)
    if not 32 <= block <= 16384:
        raise ValueError(f"block must be in [32, 16384], got {block}")
    _check_device(resid)
    if resid.device.type == "cpu":
        return reconstruct1d_plain(resid, two_eb)
    n = resid.numel()
    out = torch.empty(n, dtype=torch.float32, device=resid.device)
    if n == 0:
        return out
    n_tiles = -(-n // block)
    # ticket (uint32, padded to 8 B), then one uint64 status word per tile
    scratch = torch.zeros(2 + 2 * n_tiles, dtype=torch.int32,
                          device=resid.device)
    launch = _build.load("reconstruct1d")
    rc = launch(resid.data_ptr(), n, block, two_eb, scratch.data_ptr(),
                scratch.data_ptr() + 8, out.data_ptr(),
                K._stream_ptr(resid.device))
    if rc != 0:
        raise RuntimeError(f"reconstruct1d kernel launch failed: CUDA error "
                           f"{rc}")
    launches.launched(reconstruct1d)
    return out
