"""Mesh construction over ``torch.distributed``.

Port of ``src/repro/launch/mesh.py``.  A JAX mesh is a grid of devices
that one process always sees; a torch ``DeviceMesh`` is a grid of the
ranks of a process group.  So the world's ranks play the devices here:
``make_host_mesh`` lays out the ranks of the initialized world (or a
one-rank group it creates on an in-process store, the counterpart of
JAX's always-present local devices), and every capacity is counted
against the world size.

Never touches process-group state at import time: everything is a
function.  Single pod = (16, 16) ("data", "model") = 256 ranks; multi-pod
adds a leading "pod" axis -> (2, 16, 16) = 512.  The FSDP / batch
dimension is ("pod", "data") combined; "model" carries TP / EP / head
sharding.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: The process-group backends ``make_host_mesh`` starts a one-rank world
#: with: CPU tensors over gloo beside the card's over NCCL, so one world
#: carries a "cuda" and a "cpu" mesh.
_LOCAL_BACKENDS = {"cuda": "cpu:gloo,cuda:nccl", "cpu": "gloo"}


class MeshCapacityError(ValueError):
    """A requested mesh shape does not fit the available devices."""


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _ensure_world(device_type: str) -> None:
    """A one-rank world on an in-process store when no process group
    exists yet; an initialized world is used as it is."""
    if dist.is_initialized():
        return
    if device_type not in _LOCAL_BACKENDS:
        raise ValueError(f"device_type must be one of "
                         f"{sorted(_LOCAL_BACKENDS)}, got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA device, and "
                           "torch.cuda.is_available() is False; pass "
                           "device_type='cpu'")
    dist.init_process_group(_LOCAL_BACKENDS[device_type],
                            store=dist.HashStore(), rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with a leading
    "pod" axis, over a world of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, n = 1, _world_size()
    for s in shape:
        need *= s
    if n != need:
        raise MeshCapacityError(
            f"mesh {dict(zip(axes, shape))} needs a world of {need} "
            f"rank(s) but the world has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: "int | None" = None, model: int = 1, *,
                   devices=None, device_type: str = "cuda"):
    """Small ("data", "model") ``DeviceMesh`` over the world's ranks.

    ``data`` defaults to ``len(devices) // model``.  ``devices`` (default:
    every rank of the world) restricts the mesh to a subset of ranks, in
    the order given.  With no process group, a one-rank world is made
    first (``nccl`` for the card beside ``gloo`` for the CPU, or ``gloo``
    alone for ``device_type="cpu"``).  A shape that cannot fit raises the
    named ``MeshCapacityError`` (requested vs. available) instead of an
    opaque ``DeviceMesh`` failure or a zero-sized axis.
    """
    devs = list(range(_world_size()) if devices is None else devices)
    n = len(devs)
    if model < 1:
        raise MeshCapacityError(f"model axis must be >= 1, got {model}")
    if data is None:
        if model > n:
            raise MeshCapacityError(
                f"requested model={model} but only {n} device(s) are "
                f"available; the data axis would be {n} // {model} = 0")
        data = n // model
    if data < 1:
        raise MeshCapacityError(f"data axis must be >= 1, got {data}")
    if data * model > n:
        raise MeshCapacityError(
            f"mesh (data={data}, model={model}) needs {data * model} "
            f"device(s) but only {n} are available")
    _ensure_world(device_type)
    if devices is None and data * model == n:
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=("data", "model"))
    grid = torch.tensor(devs[:data * model], dtype=torch.int64)
    return DeviceMesh(device_type, grid.reshape(data, model),
                      mesh_dim_names=("data", "model"))


def axis_names_of(mesh) -> tuple:
    """A mesh's axis names in its order: a ``DeviceMesh``'s
    ``mesh_dim_names``, a layout object's ``axis_names``, or the keys of a
    ``{axis: size}`` mapping."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names or ())
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = dict(getattr(mesh, "shape", mesh))
    return tuple(names)


def batch_axes(mesh) -> tuple:
    """The composite FSDP/batch mesh axes present in ``mesh``."""
    names = axis_names_of(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh):
    return "model" if "model" in axis_names_of(mesh) else None


def forced_host_devices_env(n: int, *, single_threaded: bool = False,
                            base_env: "dict | None" = None) -> dict:
    """Environment for the ``n`` CPU processes of an ``n``-rank gloo world.

    Where the reference's ``XLA_FLAGS`` gives ONE process ``n`` host
    devices, a torch world is ``n`` processes of one rank each: this sets
    ``WORLD_SIZE`` and hides the card (``CUDA_VISIBLE_DEVICES=""``, the
    counterpart of ``JAX_PLATFORMS=cpu``), and the launcher adds each
    process's ``RANK`` and its rendezvous (a ``FileStore`` path or
    ``MASTER_ADDR`` / ``MASTER_PORT``).  ``single_threaded`` pins each
    rank's intra-op pools to one thread, so wall-clock scaling across
    ranks reflects rank count rather than the host's thread pools.
    """
    env = dict(base_env) if base_env is not None else {}
    if single_threaded:
        env["OMP_NUM_THREADS"] = "1"
        env["OPENBLAS_NUM_THREADS"] = "1"
        env["MKL_NUM_THREADS"] = "1"
    env["WORLD_SIZE"] = str(n)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env
