"""Lorenzo quantize and 1-D reconstruct: CUDA wrappers and plain versions.

Port of ``src/repro/kernels/lorenzo.py``:

  * :func:`lorenzo_quantize` -- the dual-quant Lorenzo quantizer: ``q =
    round(x / 2eb)``, the residual ``d = q - L(q)``, ``code = d + radius``
    (0 for an outlier) and the outlier mask (``csrc/lorenzo_quantize.cu``).
    The TPU kernel ``quantize1d`` took 1-D inputs only; this kernel takes
    up to ``MAX_AXES`` non-unit axes, so the N-D quantize runs on the card
    too: a row kernel for one axis, a tiled kernel for two or three, the
    corner sum past that (:func:`quantize_geometry`).  Its plain version is
    ``core/sz/lorenzo.py:quantize``.
  * :func:`reconstruct1d` -- the inverse 1-D Lorenzo, ``2eb * cumsum(d)``
    over units of tiles on persistent blocks, the int32 carry between units
    taken by decoupled look-back (``csrc/reconstruct1d.cu``; the geometry
    from ``fused_decode.epilogue_geometry``).

The wrappers follow ``huffman_decode``'s rules: input checks, the kernel for
CUDA tensors, the plain version (``*_plain``, beside it) for CPU tensors,
any other device raises, and each launch is counted (``kernels/launches``).
``two_eb`` is the float32 scale as a Python float (``ops._two_eb_f32``):
the kernels divide and multiply by it at run time.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.sz import lorenzo as _lor
from repro_torch.kernels import _build
from repro_torch.kernels import fused_decode as _fd
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

#: Most non-unit axes the quantize kernel takes (2**8 corners a value).
MAX_AXES = 8
#: The quantize kernels (``csrc/lorenzo_quantize.cu``) by the C entry's
#: ``tile`` code: 0 the corner sum (more than three non-unit axes), 1 the
#: row kernel (at most one; ``QUANT_ROW_BLOCK`` values a block a
#: grid-stride step, at most ``QUANT_ROW_MAX_BLOCKS`` blocks), 2 the tiled
#: kernel (two or three; ``QUANT_TILE`` rows x columns of the two fastest
#: axes, a run of planes of the slowest).
QUANT_THREADS = 256
QUANT_ROW_BLOCK = 4 * QUANT_THREADS
QUANT_ROW_MAX_BLOCKS = 1 << 20
QUANT_TILE = (8, 128)
#: Blocks of the tiled kernel an SM holds (its ``__launch_bounds__``); the
#: waves of blocks its runs of planes aim for; and the fewest planes a run
#: takes when the slowest axis is cut into runs (each run stages one plane
#: more than it stores).  On the H100 at isabel3d's shape, runs of 4
#: planes (~8 waves) ran faster than one wave of runs of 25.
QUANT_BLOCKS_PER_SM = 6
QUANT_WAVES = 8
QUANT_MIN_Z_RUN = 4
#: ``reconstruct1d``'s tile (the reference's block): a unit is whole tiles.
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


def quantize_geometry(dims, sm_count: int):
    """Launch geometry of :func:`lorenzo_quantize` over the squeezed shape
    ``dims`` (slowest first) on a card of ``sm_count`` SMs: ``(tile, z_run,
    blocks)``, ``tile`` the C entry's kernel code (``QUANT_THREADS``
    threads a block).

    At most one axis runs the row kernel (``z_run`` 1).  Two or three run
    the tiled kernel: the shape seen as Z x R x C, tiles of ``QUANT_TILE``
    over R x C, and Z cut into runs of ``z_run`` planes, a block a tile and
    run, as many runs as bring the grid to ``QUANT_WAVES`` waves of
    ``QUANT_BLOCKS_PER_SM`` blocks an SM (at least one) but none shorter
    than ``QUANT_MIN_Z_RUN`` planes.
    More axes run the corner-sum kernel (``z_run`` 0): a thread a value,
    at most 2**20 blocks (a grid stride beyond).
    """
    dims = tuple(int(d) for d in dims)
    n = math.prod(dims)
    if len(dims) > 3:
        return 0, 0, min(-(-n // QUANT_THREADS), 1 << 20)
    if len(dims) <= 1:
        return 1, 1, min(-(-n // QUANT_ROW_BLOCK), QUANT_ROW_MAX_BLOCKS)
    z, r, c = (1,) * (3 - len(dims)) + dims
    rows, cols = QUANT_TILE
    plane_tiles = -(-c // cols) * -(-r // rows)
    want = -(-sm_count * QUANT_BLOCKS_PER_SM * QUANT_WAVES // plane_tiles)
    runs = max(1, min(want, z // QUANT_MIN_Z_RUN))
    z_run = -(-z // runs)
    return 2, z_run, plane_tiles * -(-z // z_run)


@functools.lru_cache(maxsize=256)
def _quantize_launch_args(dims: tuple, device_index: int):
    """The C entry's shape arguments for ``dims`` on a device: the dims as
    a ctypes array (built once a shape), ``k``, ``tile`` and ``z_run``."""
    tile, z_run, _ = quantize_geometry(dims, K.sm_count(device_index))
    return ((ctypes.c_longlong * MAX_AXES)(*dims), len(dims), tile, z_run)


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
    shape_args = _quantize_launch_args(dims, x.device.index)
    rc = launch(x.data_ptr(), x.numel(), *shape_args, two_eb, radius,
                codes.data_ptr(), outlier.data_ptr(), resid.data_ptr(),
                K._stream_ptr(x.device))
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
    kernel's tile (any length works: the last tile is ragged); a unit, one
    block's work between two look-backs, is up to ``fused_decode.MAX_GROUP``
    tiles, so a small ``block`` makes many units and long look-backs.
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
    geo = _fd.epilogue_geometry(-(-n // block), block, 4,
                                K.sm_count(resid.device.index))
    scratch = torch.zeros(geo.scratch_words, dtype=torch.int32,
                          device=resid.device)
    launch = _build.load("reconstruct1d")
    rc = launch(resid.data_ptr(), n, block, geo.unit_tiles, geo.window,
                geo.blocks, geo.smem, two_eb,
                scratch.data_ptr(), scratch.data_ptr() + 8, out.data_ptr(),
                K._stream_ptr(resid.device))
    if rc != 0:
        raise RuntimeError(f"reconstruct1d kernel launch failed: CUDA error "
                           f"{rc}")
    launches.launched(reconstruct1d)
    return out
