"""Spec-driven tensor partitioning for the sharded archive layout.

Port of ``src/repro/distributed/partition.py``.

A tensor's ``PartitionSpec`` (from ``runtime/sharding.py``) determines how
the sharded writer tiles it: each dimension splits into as many parts as
the product of its mesh axes, with the same divisibility fallback as
``runtime.sharding._fit`` -- a dim that does not divide evenly stays whole
(replication), never padded.  Tiles carry their global offset and shape in
the manifest, so the partition grid is pure metadata: any restore topology
can reassemble any slice from the tile records, which is what makes the
layout host-count-agnostic.

Tiles are numpy arrays or torch tensors; ``extract_slice`` assembles
tensors on the device that holds them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh


def axis_sizes_of(mesh) -> dict:
    """``{axis name: size}`` of a mesh, in the mesh's axis order.

    ``mesh`` is a torch ``DeviceMesh`` (its ``mesh_dim_names`` beside its
    tuple ``shape``), a plain ``{axis: size}`` mapping, or a layout object
    whose ``shape`` is such a mapping (the reference's ``jax.sharding.Mesh``
    and its tests' ``SimpleNamespace(shape=...)``); the last two let layout
    code and tests run without devices."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("a DeviceMesh without mesh_dim_names has no "
                             "axis names to partition over")
        return {str(k): int(v)
                for k, v in zip(mesh.mesh_dim_names, mesh.shape)}
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def _axes_product(axis_sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        if a not in axis_sizes:
            raise ValueError(f"partition axis {a!r} not in mesh axes "
                             f"{sorted(axis_sizes)}")
        n *= axis_sizes[a]
    return n


def spec_parts(spec, shape: tuple, axis_sizes: dict) -> tuple:
    """Parts per dimension for ``spec`` over a mesh of ``axis_sizes``.

    Mirrors ``runtime.sharding._fit``: an indivisible dim degrades to one
    part (replication) instead of erroring, so any spec the sharding rules
    emit produces a valid grid.  ``spec=None`` means fully replicated.
    """
    entries = tuple(spec) if spec is not None else ()
    parts = []
    for i, dim in enumerate(shape):
        ax = entries[i] if i < len(entries) else None
        n = _axes_product(axis_sizes, ax)
        parts.append(n if n > 1 and dim % n == 0 else 1)
    return tuple(parts)


def tile_extents(shape: tuple, parts: tuple):
    """Yield ``(index, offset, tile_shape)`` for every tile of the grid,
    in row-major index order (the linear order shard assignment uses)."""
    if len(parts) != len(shape):
        raise ValueError(f"parts {parts} does not match shape {shape}")
    steps = tuple(int(dim) // p for dim, p in zip(shape, parts))
    for index in itertools.product(*(range(p) for p in parts)):
        offset = tuple(i * s for i, s in zip(index, steps))
        yield index, offset, steps


def tile_slice(offset: tuple, tile_shape: tuple) -> tuple:
    """The global-array slice covered by one tile."""
    return tuple(slice(o, o + s) for o, s in zip(offset, tile_shape))


def _empty_like_tiles(tiles: dict, dtype, shape: tuple):
    """An uninitialized slice: a tensor on the tiles' device (of ``dtype``
    when it is a torch dtype, else of the tiles') when they are tensors,
    else a numpy array."""
    first = next(iter(tiles.values()), None)
    if not isinstance(first, torch.Tensor):
        return np.empty(shape, dtype)
    if not isinstance(dtype, torch.dtype):
        dtype = first.dtype
    return torch.empty(shape, dtype=dtype, device=first.device)


def extract_slice(index, tiles: dict, dtype, out_shape: tuple):
    """Assemble the sub-array covered by ``index`` (a tuple of slices into
    the global array) from decoded tiles.

    ``tiles`` maps ``(offset, tile_shape)`` -> decoded ``np.ndarray`` or
    ``torch.Tensor``; tensors are assembled on their device.  When the
    requested slice is exactly one tile, that tile is returned without a
    copy -- the matched-topology fast path, where every device's shard is
    one tile of the write grid.
    """
    bounds = tuple((s.start or 0, s.stop if s.stop is not None else n)
                   for s, n in zip(index, out_shape))
    for (offset, tshape), arr in tiles.items():
        if all(b == o and e == o + t
               for (b, e), o, t in zip(bounds, offset, tshape)):
            return arr
    local = _empty_like_tiles(tiles, dtype, tuple(e - b for b, e in bounds))
    filled = 0
    for (offset, tshape), arr in tiles.items():
        dst, src = [], []
        empty = False
        for (b, e), o, t in zip(bounds, offset, tshape):
            lo, hi = max(b, o), min(e, o + t)
            if lo >= hi:
                empty = True
                break
            dst.append(slice(lo - b, hi - b))
            src.append(slice(lo - o, hi - o))
        if empty:
            continue
        local[tuple(dst)] = arr[tuple(src)]
        filled += int(np.prod([s.stop - s.start for s in dst]))
    size = local.numel() if isinstance(local, torch.Tensor) else local.size
    if filled != size:
        raise ValueError(
            f"tiles cover {filled} of {size} elements of slice "
            f"{bounds} -- tile records are inconsistent with the shape")
    return local
