"""One rank of the multi-rank CPU cases of ``test_torch_ranks.py``.

Run as ``python tests/torch_ranks.py CASE WORKDIR`` in each of the
processes of a gloo world, with ``RANK`` and ``WORLD_SIZE`` set
(``launch.mesh.forced_host_devices_env`` gives the rest of the
environment).  The ranks meet on a ``FileStore`` in ``WORKDIR``; each
writes what it saw to ``WORKDIR/rank<r>.json`` for the test to check.
Imports the port only.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager, _entry_spec
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.launch import mesh as M
from repro_torch.runtime import collectives as C
from repro_torch.runtime import pspec
from repro_torch.runtime.sharding import NamedSharding, P

#: The restore meshes of the cross-topology case, (data, model).
MESHES = ((2, 4), (8, 1), (4, 2))


def _codec():
    return Codec(CodecConfig(backend="ref", eb=1e-3, mode="rel"),
                 plan_cache=PlanCache())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _leaves(r):
    return _flat({"params": r["params"], "opt": r["opt"] or {}})


def restore(work, rank):
    """The reference's (4, 2) checkpoint on each mesh of ``MESHES``: every
    entry a ``DTensor`` in its target placements whose local piece is the
    reference's full restore at JAX's index for this rank's coordinate;
    then the port's own checkpoint with shard 1 overwritten, restored
    under "raise" and "zero_fill" on the (4, 2) mesh."""
    from torch.distributed.tensor import DTensor

    want = dict(np.load(os.path.join(work, "expected.npz")))
    with open(os.path.join(work, "jax_maps.json")) as f:
        maps = json.load(f)
    out = {"world": dist.get_world_size(), "meshes": {}}
    for d, m in MESHES:
        mesh = M.make_host_mesh(d, m, device_type="cpu")
        coord = mesh.get_coordinate()
        key = ",".join(map(str, coord))
        r = CheckpointManager(os.path.join(work, "ref_ckpt"),
                              codec=_codec()).restore(1, mesh=mesh)
        seen = {}
        for name, leaf in _leaves(r).items():
            shape = tuple(want[name].shape)
            target = NamedSharding(mesh, _entry_spec(name, shape, mesh))
            idx = tuple(slice(a, b) for a, b in maps[f"{d}x{m}"][name][key])
            local = leaf.to_local()
            seen[name] = {
                "dtensor": isinstance(leaf, DTensor),
                "placements": tuple(leaf.placements)
                == target.placements(shape),
                "local_shape": list(local.shape),
                "equal": local.numpy().tobytes()
                == np.ascontiguousarray(want[name][idx]).tobytes()}
        out["meshes"][f"{d}x{m}"] = {"coord": list(coord), "entries": seen}

    mesh = M.make_host_mesh(4, 2, device_type="cpu")
    mgr = CheckpointManager(os.path.join(work, "port_ckpt"), codec=_codec())
    try:
        mgr.restore(1, policy="raise", mesh=mesh)
        out["raise_named"] = False
    except Exception as e:      # noqa: BLE001 -- the message is checked
        out["raise_named"] = "shard_00001.szt" in str(e)
        out["raise_type"] = type(e).__name__
    r = mgr.restore(1, policy="zero_fill", mesh=mesh)
    salvage = dict(np.load(os.path.join(work, "salvage.npz")))
    out["quarantined"] = sorted(r["quarantined"])
    out["reasons_name_shard"] = all(
        "shard_00001.szt" in why for why in r["quarantined"].values())
    pieces = {}
    for name, leaf in _leaves(r).items():
        shape = tuple(salvage[name].shape)
        idx = NamedSharding(mesh, _entry_spec(name, shape, mesh)).index(
            shape)
        local = leaf.to_local().numpy()
        pieces[name] = {
            "zeros": not local.any(),
            "equal": local.tobytes()
            == np.ascontiguousarray(salvage[name][idx]).tobytes()}
    out["salvage"] = pieces
    return out


def collectives(work, rank):
    """``make_dp_gradient_sync`` over the 8-rank "data" group with the
    reference's inputs (each rank its row), two steps of error feedback;
    ``pspec.shard`` redistributing a DTensor; ``make_host_mesh``'s
    capacity errors against the world."""
    out = {"world": dist.get_world_size()}
    errors = {}
    for kw in ({"model": 9}, {"data": 16, "model": 1}, {"model": 0}):
        try:
            M.make_host_mesh(device_type="cpu", **kw)
            errors[str(kw)] = None
        except M.MeshCapacityError as e:
            errors[str(kw)] = str(e)
    out["capacity_errors"] = errors
    sub = M.make_host_mesh(2, 2, devices=[0, 1, 2, 3], device_type="cpu")
    out["sub_coord"] = sub.get_coordinate()

    mesh = M.make_host_mesh(device_type="cpu")
    out["mesh"] = [mesh.size(0), mesh.size(1)]
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((8, 1024)).astype(
        np.float32)) * 1e-3
    sync, init = C.make_dp_gradient_sync(mesh, eb=1e-7)
    grads = {"w": g[rank].clone()}
    res = init(grads)
    out["residual_numel"] = res["w"].numel()
    mean, res = sync(grads, res)
    want = g.numpy().mean(axis=0)
    out["err"] = float(np.abs(mean["w"].numpy() - want).max())
    out["mean_bytes"] = mean["w"].numpy().tobytes().hex()
    mean2, _ = sync(grads, res)
    out["err2"] = float(np.abs(mean2["w"].numpy() - want).max())

    mesh42 = M.make_host_mesh(4, 2, device_type="cpu")
    x = torch.arange(64.0).reshape(8, 8)
    d = NamedSharding(mesh42, P()).distribute(x)
    pspec.set_mesh(mesh42)
    try:
        y = pspec.shard(d, pspec.BATCH, pspec.MODEL)
        idx = NamedSharding(mesh42, P("data", "model")).index(x.shape)
        out["pspec_placements"] = [str(p) for p in y.placements]
        out["pspec_local"] = torch.equal(y.to_local(), x[idx])
        out["pspec_full"] = torch.equal(y.full_tensor(), x)
        z = pspec.shard(y, None, None)
        out["pspec_back"] = torch.equal(z.to_local(), x)
        out["pspec_plain"] = pspec.shard(x, pspec.BATCH, None) is x
    finally:
        pspec.set_mesh(None)
    return out


CASES = {"restore": restore, "collectives": collectives}


def main(case: str, work: str) -> int:
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        out = CASES[case](work, rank)
        dist.barrier()
    except Exception:           # noqa: BLE001 -- reported to the test
        out = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
