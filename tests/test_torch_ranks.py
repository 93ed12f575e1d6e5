"""The distributed restore and the gradient sync on 8 CPU ranks over gloo.

The counterpart of the reference's forced 8 host devices: two launches of
8 processes (``tests/torch_ranks.py``), each meeting on a ``FileStore``
under ``tmp_path`` and given at most ``LAUNCH_TIMEOUT`` seconds.

* A checkpoint the reference writes on a (4, 2) layout restores in the
  port on (2, 4), (8, 1) and (4, 2) meshes: every rank's local piece is
  the reference's full restore sliced at JAX's index map for the device at
  that rank's mesh coordinate (``NamedSharding.devices_indices_map`` in a
  forced-8-device JAX subprocess), in the target placements.
* The reference's ``test_corrupted_shard_salvage_on_8_devices`` on the
  port: "raise" names the shard file, "zero_fill" quarantines the entries
  the reference's restore quarantines, zeros for them, every other piece
  intact.
* ``make_dp_gradient_sync`` with the reference's inputs meets its bound,
  5e-5, on every rank; ``pspec.shard`` redistributes a ``DTensor``;
  ``make_host_mesh`` refuses meshes larger than the world.
* The port's ``NamedSharding`` index maps equal JAX's on every mesh.
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jman
from repro.core import Codec as JCodec, CodecConfig as JCodecConfig
from repro.core.cache import PlanCache as JPlanCache

from repro_torch.checkpoint import manager as man
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.launch.mesh import forced_host_devices_env
from repro_torch.runtime.sharding import NamedSharding

from torch_ranks import MESHES

N_RANKS = 8
LAUNCH_TIMEOUT = 300
LAYOUT = SimpleNamespace(shape={"data": 4, "model": 2},
                         axis_names=("data", "model"))
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_ranks.py")


def _base_env() -> dict:
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
           if k in os.environ}
    env["PYTHONPATH"] = SRC
    return env


def _launch(case: str, work: str) -> list:
    """Run ``case`` on ``N_RANKS`` ranks; their reports, rank order."""
    env = forced_host_devices_env(N_RANKS, single_threaded=True,
                                  base_env=_base_env())
    procs = []
    try:
        for rank in range(N_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, case, work],
                env={**env, "RANK": str(rank)}, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=LAUNCH_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, logs[rank][-3000:]
    reports = []
    for rank in range(N_RANKS):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
        assert "error" not in reports[-1], reports[-1]["error"]
    return reports


def _tree(seed=0):
    """The reference's ``test_cross_topology_restore_bit_exact`` tree."""
    rng = np.random.default_rng(seed)
    return {
        "layers": {"0": {
            "attn": {"wq": rng.normal(size=(256, 512)).astype(np.float32)},
            "mlp": {"wg": rng.normal(size=(256, 1024)).astype(np.float32)}}},
        "norm": rng.normal(size=(64,)).astype(np.float32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _codec():
    return Codec(CodecConfig(backend="ref", eb=1e-3, mode="rel"),
                 plan_cache=PlanCache())


def _jcodec():
    return JCodec(JCodecConfig(eb=1e-3, mode="rel"), plan_cache=JPlanCache())


_JAX_MAPS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    from jax.sharding import NamedSharding
    from repro.checkpoint.manager import _entry_spec
    from repro.launch.mesh import make_host_mesh

    entries = json.loads(sys.argv[1])
    out = {}
    for d, m in json.loads(sys.argv[2]):
        mesh = make_host_mesh(d, m)
        maps = {}
        for name, shape in entries.items():
            shape = tuple(shape)
            s = NamedSharding(mesh, _entry_spec(name, shape, mesh))
            dmap = s.devices_indices_map(shape)
            per = {}
            for c in np.ndindex(mesh.devices.shape):
                idx = tuple(dmap[mesh.devices[c]])
                idx += (slice(None),) * (len(shape) - len(idx))
                per[",".join(map(str, c))] = [
                    [sl.start or 0, n if sl.stop is None else sl.stop]
                    for sl, n in zip(idx, shape)]
            maps[name] = per
        out[f"{d}x{m}"] = maps
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """The reference's checkpoint of ``_tree`` with an optimizer state on
    the (4, 2) layout in 4 shards, its full restore, and JAX's index maps
    of every entry on ``MESHES`` from a forced-8-device subprocess."""
    work = tmp_path_factory.mktemp("ref")
    params = _tree()
    opt = {"m": {"layers": params["layers"]}, "step": np.int32(3)}
    jm = jman.CheckpointManager(str(work / "ref_ckpt"), codec=_jcodec(),
                                compress_min_size=4096)
    jm.save(1, params, opt, mesh=LAYOUT, shard_count=4)
    r = jm.restore(1)
    want = {k: np.asarray(v) for k, v in
            _flat({"params": r["params"], "opt": r["opt"]}).items()}
    entries = {k: list(v.shape) for k, v in want.items()}
    p = subprocess.run(
        [sys.executable, "-c", _JAX_MAPS, json.dumps(entries),
         json.dumps(MESHES)], capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT, env=_base_env())
    assert p.returncode == 0, p.stderr[-3000:]
    maps = json.loads(p.stdout.strip().splitlines()[-1])
    return work, want, maps


def test_index_maps_as_jax(reference_checkpoint):
    """The port's ``NamedSharding`` over a layout of each mesh gives, for
    every mesh coordinate, the index JAX gives the device there."""
    _, want, maps = reference_checkpoint
    for d, m in MESHES:
        layout = SimpleNamespace(shape={"data": d, "model": m},
                                 axis_names=("data", "model"))
        for name, arr in want.items():
            s = NamedSharding(layout, man._entry_spec(name, arr.shape,
                                                      layout))
            got = {",".join(map(str, c)): [[sl.start, sl.stop] for sl in idx]
                   for c, idx in s.devices_indices_map(arr.shape).items()}
            assert got == maps[f"{d}x{m}"][name], (d, m, name)


def test_reference_checkpoint_restores_on_8_ranks(reference_checkpoint,
                                                  tmp_path):
    work, want, maps = reference_checkpoint
    os.symlink(work / "ref_ckpt", tmp_path / "ref_ckpt")
    np.savez(tmp_path / "expected.npz", **want)
    with open(tmp_path / "jax_maps.json", "w") as f:
        json.dump(maps, f)

    # The reference's salvage case, written by the port: shard 1 overwritten
    # by 4 KiB in its middle.
    rng = np.random.default_rng(0)
    params = {"wq": rng.normal(size=(256, 512)).astype(np.float32),
              "wg": rng.normal(size=(256, 1024)).astype(np.float32),
              "norm": rng.normal(size=(64,)).astype(np.float32)}
    tm = man.CheckpointManager(str(tmp_path / "port_ckpt"), codec=_codec(),
                               compress_min_size=4096)
    tm.save(1, {k: torch.from_numpy(v) for k, v in params.items()},
            mesh=LAYOUT, shard_count=4)
    clean = tm.restore(1)
    np.savez(tmp_path / "salvage.npz", **{
        f"params.{k}": v.numpy() for k, v in clean["params"].items()})
    path = tmp_path / "port_ckpt" / "step_00000001" / "shard_00001.szt"
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff" * 4096)
    jq = jman.CheckpointManager(str(tmp_path / "port_ckpt"),
                                codec=_jcodec()).restore(
        1, policy="zero_fill")["quarantined"]

    reports = _launch("restore", str(tmp_path))
    coords = set()
    for rank, rep in enumerate(reports):
        assert rep["world"] == N_RANKS
        for d, m in MESHES:
            seen = rep["meshes"][f"{d}x{m}"]
            coords.add((d, m, tuple(seen["coord"])))
            assert sorted(seen["entries"]) == sorted(want)
            for name, e in seen["entries"].items():
                assert e["dtensor"] and e["placements"] and e["equal"], \
                    (rank, d, m, name, e)
        wq = rep["meshes"]["2x4"]["entries"]["params.layers.0.attn.wq"]
        assert wq["local_shape"] == [128, 128]
        assert rep["raise_named"]
        assert rep["raise_type"] == "CheckpointIntegrityError"
        assert rep["quarantined"] == sorted(jq)
        assert rep["quarantined"], "corruption must quarantine something"
        assert rep["reasons_name_shard"]
        for name, piece in rep["salvage"].items():
            if name in jq:
                assert piece["zeros"], (rank, name)
            else:
                assert piece["equal"], (rank, name)
    assert len(coords) == N_RANKS * len(MESHES)   # one rank a coordinate
    intact = [k for k in reports[0]["salvage"] if k not in jq]
    assert "params.norm" in intact and len(intact) >= 2


def test_gradient_sync_pspec_and_meshes_on_8_ranks(tmp_path):
    reports = _launch("collectives", str(tmp_path))
    for rank, rep in enumerate(reports):
        assert rep["world"] == N_RANKS and rep["mesh"] == [N_RANKS, 1]
        # bf16 reduce-scatter + int8 wire: the reference's bound
        assert rep["err"] < 5e-5 and rep["err2"] < 5e-5, rep
        assert rep["residual_numel"] == 1024 // N_RANKS
        assert rep["mean_bytes"] == reports[0]["mean_bytes"]
        errors = rep["capacity_errors"]
        assert "model=9 but only 8 device(s)" in errors[str({"model": 9})]
        assert "needs 16 device(s) but only 8" in errors[
            str({"data": 16, "model": 1})]
        assert ">= 1" in errors[str({"model": 0})]
        assert rep["sub_coord"] == ([rank // 2, rank % 2] if rank < 4
                                    else None)
        assert rep["pspec_placements"] == ["S(0)", "S(1)"]
        assert rep["pspec_local"] and rep["pspec_full"]
        assert rep["pspec_back"] and rep["pspec_plain"]
