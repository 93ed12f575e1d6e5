"""Lightweight in-model sharding constraints.

Port of ``src/repro/runtime/pspec.py``.  The model code pins the canonical
layout -- batch on ("pod","data"), heads / vocab / ffn on "model" --
through this module; everything no-ops when no mesh is registered (unit
tests, single-device runs).

Where the reference pins a ``with_sharding_constraint`` that GSPMD
propagates, eager torch has no sharding to constrain on a plain tensor:
with a mesh, a ``DTensor`` is redistributed to the resolved placements
and a plain tensor passes through unchanged.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor

from repro_torch.distributed.partition import axis_sizes_of
from repro_torch.launch.mesh import axis_names_of
from repro_torch.runtime.sharding import NamedSharding, P

BATCH = "__batch__"
MODEL = "__model__"

_MESH = None


def set_mesh(mesh):
    """Register the mesh used to materialize constraints (None to clear)."""
    global _MESH
    _MESH = mesh


def _resolve(token):
    names = axis_names_of(_MESH)
    if token == BATCH:
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if axes else None
    if token == MODEL:
        return "model" if "model" in names else None
    return token


def _fits(x, dim, axes):
    if axes is None:
        return None
    sizes = axis_sizes_of(_MESH)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return axes if (dim % n == 0 and dim >= n) else None


def shard(x, *spec):
    """``x`` in the layout ``P(*spec)`` with BATCH/MODEL tokens.

    Dims whose size does not divide the axis fall back to unconstrained
    (replicated).  A ``DTensor`` is redistributed over the registered mesh;
    a plain tensor, or any ``x`` with no mesh registered, is returned as
    it is.
    """
    if _MESH is None:
        return x
    resolved = tuple(
        _fits(x, x.shape[i], _resolve(s)) if s is not None else None
        for i, s in enumerate(spec))
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(_MESH, NamedSharding(_MESH, P(*resolved))
                          .placements(x.shape))


def place(x, sharding):
    """``x`` on ``sharding`` (a ``NamedSharding``), the counterpart of the
    reference's ``with_sharding_constraint`` on a leaf: a ``DTensor`` is
    redistributed to the sharding's placements, a plain tensor (the global
    value, on every rank) is cut to this rank's piece and wrapped
    (``NamedSharding.distribute``, no collective).  ``sharding`` None
    returns ``x``."""
    if sharding is None:
        return x
    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements(x.shape))
    return sharding.distribute(x)
