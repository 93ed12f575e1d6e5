"""The port's distributed restore against the JAX package's, in process.

* The partition helpers (``spec_parts``, ``tile_extents``, ``tile_slice``,
  ``extract_slice``) give the reference's results on seeded random
  shapes, specs and slices, for numpy arrays and for tensors.
* The same tensors through both ``ShardedWriter``s (mesh ``{data: 4,
  model: 2}``, three shards) give byte-identical shard files and
  manifests, and each package's ``ShardedRestorer`` reads the other's
  directory bit for bit.
* The reference's manifest-failure, corrupt-shard and missing-shard cases
  as parity cases: the same errors, quarantines and survivors.
* On a one-rank CPU mesh (gloo): a restore into ``NamedSharding``s lands
  ``DTensor``s in the target placements; ``make_host_mesh`` and
  ``make_production_mesh`` refuse as the reference does, counted against
  the world; ``pspec.shard`` passes plain tensors through.

The port runs on the CPU by request (``backend="ref"``).  Every comparison
is exact.  The multi-rank cases are in ``test_torch_ranks.py``.
"""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import distributed as jd
from repro.core import Codec as JCodec, CodecConfig as JCodecConfig
from repro.core.cache import PlanCache as JPlanCache
from repro.launch import mesh as jmesh
from repro.store import format as JF

from repro_torch import distributed as td
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.distributed import partition as pt
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import pspec
from repro_torch.runtime.sharding import NamedSharding, P
from repro_torch.store import format as F


AX = {"data": 4, "model": 2}
LAYOUT = SimpleNamespace(shape=dict(AX), axis_names=tuple(AX))


def _codec(**kw):
    kw = {"eb": 1e-3, "mode": "rel", **kw}
    return Codec(CodecConfig(backend="ref", **kw), plan_cache=PlanCache())


def _jcodec(**kw):
    kw = {"eb": 1e-3, "mode": "rel", **kw}
    return JCodec(JCodecConfig(**kw), plan_cache=JPlanCache())


@pytest.fixture
def cpu_world():
    """A one-rank gloo world for the test, torn down after it."""
    made = not dist.is_initialized()
    yield
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _np(x):
    if isinstance(x, DTensor):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Partition helpers
# ---------------------------------------------------------------------------


def _random_specs(rng, n=60):
    """(shape, spec entries) pairs over AX: None, one axis, two axes in
    either order, and dims that do and do not divide."""
    choices = [None, "data", "model", ("data", "model"), ("model", "data"),
               ("data",)]
    out = []
    for _ in range(n):
        nd = int(rng.integers(1, 4))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16]))
                      for _ in range(nd))
        spec = tuple(choices[int(rng.integers(len(choices)))]
                     for _ in range(int(rng.integers(0, nd + 1))))
        out.append((shape, spec))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_spec_parts_and_tiles_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    for shape, spec in _random_specs(rng):
        want = jd.spec_parts(JP(*spec), shape, AX)
        assert pt.spec_parts(P(*spec), shape, AX) == want
        assert pt.spec_parts(spec, shape, AX) == want
        assert list(pt.tile_extents(shape, want)) == \
            list(jd.tile_extents(shape, want))
        for _, off, tshape in jd.tile_extents(shape, want):
            assert pt.tile_slice(off, tshape) == jd.tile_slice(off, tshape)
    assert pt.spec_parts(None, (8, 6), AX) == jd.spec_parts(None, (8, 6), AX)
    for mod in (pt, jd):
        with pytest.raises(ValueError, match="not in mesh axes"):
            mod.spec_parts(("tp",), (8,), AX)
        with pytest.raises(ValueError, match="does not match"):
            list(mod.tile_extents((8, 6), (2,)))


def _tiles(x, parts, as_tensor):
    out = {}
    for _, off, tshape in jd.tile_extents(x.shape, parts):
        t = x[jd.tile_slice(off, tshape)]
        out[(off, tshape)] = torch.from_numpy(t.copy()) if as_tensor else t
    return out


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_extract_slice_as_the_reference(seed, as_tensor):
    rng = np.random.default_rng(100 + seed)
    shape, parts = (8, 12, 6), (4, 3, 2)
    x = rng.normal(size=shape).astype(np.float32)
    ref_tiles = _tiles(x, parts, False)
    tiles = _tiles(x, parts, as_tensor)
    for _ in range(40):
        sl = []
        for n in shape:
            lo = int(rng.integers(0, n))
            sl.append(slice(lo, int(rng.integers(lo + 1, n + 1))))
        sl = tuple(sl)
        want = jd.extract_slice(sl, ref_tiles, np.float32, shape)
        got = pt.extract_slice(sl, tiles, np.float32, shape)
        assert isinstance(got, torch.Tensor) == as_tensor
        assert _np(got).tobytes() == want.tobytes()
        assert _np(got).shape == want.shape == x[sl].shape
    # one tile: returned as it is, no copy
    (off, tshape), tile = next(iter(tiles.items()))
    assert pt.extract_slice(pt.tile_slice(off, tshape), tiles, np.float32,
                            shape) is tile
    # a gap in the tiles is an error naming the cover
    some = dict(list(tiles.items())[:2])
    full = tuple(slice(0, n) for n in shape)
    for mod, tl in ((pt, some), (jd, dict(list(ref_tiles.items())[:2]))):
        with pytest.raises(ValueError, match="cover"):
            mod.extract_slice(full, tl, np.float32, shape)


def test_extract_slice_keeps_the_tiles_device_and_dtype():
    x = torch.arange(48, dtype=torch.bfloat16).reshape(8, 6)
    tiles = {((0, 0), (4, 6)): x[:4], ((4, 0), (4, 6)): x[4:]}
    got = pt.extract_slice((slice(2, 6), slice(0, 6)), tiles, "bfloat16",
                           (8, 6))
    assert got.dtype == torch.bfloat16 and got.device == x.device
    assert torch.equal(got, x[2:6])


def test_axis_sizes_of_every_mesh_form(cpu_world):
    assert pt.axis_sizes_of(AX) == jd.axis_sizes_of(AX) == AX
    assert pt.axis_sizes_of(LAYOUT) == jd.axis_sizes_of(LAYOUT) == AX
    mesh = tmesh.make_host_mesh(device_type="cpu")
    assert pt.axis_sizes_of(mesh) == {"data": 1, "model": 1}
    assert list(pt.axis_sizes_of(mesh)) == ["data", "model"]


# ---------------------------------------------------------------------------
# The sharded layout: byte-identical both ways, cross reads
# ---------------------------------------------------------------------------


def _layout_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"a.big": (rng.normal(size=(64, 32)).astype(np.float32),
                      ("data", "model")),
            "a.rep": (rng.normal(size=(16, 8)).astype(np.float32), None),
            "a.rows": (rng.normal(size=(40, 24)).astype(np.float32),
                       (("data", "model"),)),
            "a.odd": (rng.normal(size=(7, 6)).astype(np.float32),
                      ("data", "model")),
            "a.rep2": (rng.normal(size=(12,)).astype(np.float32), None)}


def _write_both(tmp_path, n_shards=3, spec_kind="spec"):
    arrays = _layout_arrays()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jd.ShardedWriter(jdir, AX, codec=_jcodec(), n_shards=n_shards) as sw:
        for name, (x, spec) in arrays.items():
            sw.add(name, x, JP(*spec) if spec is not None else None)
    with td.ShardedWriter(tdir, AX, codec=_codec(),
                          n_shards=n_shards) as sw:
        for name, (x, spec) in arrays.items():
            s = P(*spec) if spec is not None else None
            if spec_kind == "named" and s is not None:
                s = NamedSharding(LAYOUT, s)
            sw.add(name, torch.from_numpy(x) if name != "a.rep2" else x, s)
    return arrays, jdir, tdir


@pytest.mark.parametrize("spec_kind", ["spec", "named"])
@pytest.mark.parametrize("n_shards", [1, 3])
def test_shard_files_and_manifest_are_byte_identical(tmp_path, n_shards,
                                                     spec_kind):
    _, jdir, tdir = _write_both(tmp_path, n_shards, spec_kind)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert F.SHARD_MANIFEST_NAME in names
    assert len([n for n in names if n.endswith(".szt")]) == n_shards
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f, \
                open(os.path.join(tdir, name), "rb") as g:
            assert f.read() == g.read(), name
    man = td.load_manifest(tdir)
    assert man["entries"]["a.big"]["parts"] == [4, 2]
    assert man["entries"]["a.rows"]["parts"] == [8, 1]
    assert man["entries"]["a.odd"]["parts"] == [1, 2]
    assert man["entries"]["a.big"]["dtype"] == "float32"


def test_each_restorer_reads_the_others_layout(tmp_path):
    arrays, jdir, tdir = _write_both(tmp_path)
    jown = jd.ShardedRestorer(jdir, codec=_jcodec()).restore()
    for d in (jdir, tdir):
        port = td.ShardedRestorer(d, codec=_codec()).restore()
        jax_ = jd.ShardedRestorer(d, codec=_jcodec()).restore()
        assert list(port) == list(jax_) == list(jown) == list(arrays)
        for name, (x, _) in arrays.items():
            assert isinstance(port[name], torch.Tensor)
            assert port[name].device.type == "cpu"
            assert _np(port[name]).tobytes() == np.asarray(
                jax_[name]).tobytes() == np.asarray(jown[name]).tobytes()
            bound = 1e-3 * float(x.max() - x.min()) * 1.0001
            assert np.abs(_np(port[name]) - x).max() <= bound


def test_decode_shards_and_stats_as_the_reference(tmp_path):
    _, jdir, tdir = _write_both(tmp_path)
    tr = td.ShardedRestorer(tdir, codec=_codec())
    jr = jd.ShardedRestorer(jdir, codec=_jcodec())
    for shards in ([0], [1, 2], [0, 1, 2]):
        got, want = tr.decode_shards(shards), jr.decode_shards(shards)
        assert list(got) == list(want)
        for c in want:
            assert _np(got[c]).tobytes() == np.asarray(want[c]).tobytes()
    tr.restore()
    jr.restore()
    assert tr.stats.keys() == jr.stats.keys()
    assert tr.stats["tiles_decoded"] == jr.stats["tiles_decoded"]
    assert tr.stats["shards_opened"] == jr.stats["shards_opened"]
    assert tr.names == jr.names
    assert all(tr.entry_shape(n) == jr.entry_shape(n) for n in tr.names)
    with pytest.raises(KeyError, match="no entries named"):
        tr.restore(names=["nope"])
    got = tr.decode_shards([1], devices=["cpu"])
    assert got and all(t.device.type == "cpu" for t in got.values())


def test_writer_refusals_as_the_reference(tmp_path):
    for mod, codec, x in ((td, _codec(), torch.zeros(8)),
                          (jd, _jcodec(), np.zeros(8, np.float32))):
        with pytest.raises(ValueError, match="n_shards"):
            mod.ShardedWriter(str(tmp_path / "z"), AX, codec=codec,
                              n_shards=0)
        sw = mod.ShardedWriter(str(tmp_path / mod.__name__), AX,
                               codec=codec)
        sw.add("x", x)
        with pytest.raises(Exception, match="duplicate"):
            sw.add("x", x)
        sw.close()
        with pytest.raises(Exception, match="closed"):
            sw.add("y", x)
    assert td.chunk_name("w", (1, 0)) == jd.chunk_name("w", (1, 0))
    assert td.chunk_name("w", ()) == jd.chunk_name("w", ())


def test_manifest_failure_modes(tmp_path):
    """The reference's ``test_manifest_failure_modes``, both packages."""
    d = str(tmp_path / "arc")
    cases = []
    cases.append(("missing", None))
    cases.append(("torn", '{"version": 1, "entr'))
    cases.append(("newer", json.dumps({"version": F.SHARD_MANIFEST_VERSION
                                       + 1, "entries": {}})))
    cases.append(("invalid", json.dumps({"version": 1, "entries": {
        "x": {"tiles": "nope"}}})))
    cases.append(("invalid", json.dumps({"version": "1"})))
    cases.append(("no entries", json.dumps({"version": 1})))
    cases.append(("tile record", json.dumps({"version": 1, "entries": {
        "x": {"tiles": [{"shard": 0}], "shape": [2], "dtype": "float32"}}})))
    for match, body in cases:
        if body is not None:
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, F.SHARD_MANIFEST_NAME), "w") as f:
                f.write(body)
        msgs = []
        for mod in (td, jd):
            with pytest.raises(mod.ShardManifestError, match=match) as e:
                mod.load_manifest(d)
            msgs.append(str(e.value))
        assert issubclass(td.ShardManifestError, F.StoreError)
        assert msgs[0].split(":")[:2] == msgs[1].split(":")[:2]


def _restore_both(d, **kw):
    out, reasons = [], []
    for mod, codec in ((td, _codec()), (jd, _jcodec())):
        why = {}
        r = mod.ShardedRestorer(d, codec=codec).restore(
            on_error=lambda n, e, why=why: why.setdefault(n, str(e)), **kw)
        out.append(r)
        reasons.append(why)
    return out, reasons


def test_corrupt_shard_quarantines_only_its_entries(tmp_path):
    """The reference's case, both packages on each package's layout."""
    rng = np.random.default_rng(1)
    xs = {f"t{i}": rng.normal(size=(32, 16)).astype(np.float32)
          for i in range(3)}
    for mod, codec, spec in ((td, _codec(), P("data")),
                             (jd, _jcodec(), JP("data"))):
        d = str(tmp_path / mod.__name__)
        with mod.ShardedWriter(d, {"data": 2}, codec=codec,
                               n_shards=2) as sw:
            for name, x in xs.items():
                sw.add(name, x, spec)
        path = os.path.join(d, F.shard_filename(1))
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.write(b"\xff" * size)
        for rmod, rcodec in ((td, _codec()), (jd, _jcodec())):
            with pytest.raises(F.StoreError if rmod is td else JF.StoreError,
                               match="shard_00001.szt"):
                rmod.ShardedRestorer(d, codec=rcodec).restore(policy="raise")
        (tout, jout), (twhy, jwhy) = _restore_both(d, policy="skip")
        assert tout == {} and jout == {}
        assert sorted(twhy) == sorted(jwhy) == sorted(xs)
        assert all("shard_00001.szt" in w for w in twhy.values())
        (tout, jout), _ = _restore_both(d, policy="zero_fill")
        assert sorted(tout) == sorted(jout) == sorted(xs)
        for name in xs:
            assert not _np(tout[name]).any()
            assert _np(tout[name]).tobytes() == np.asarray(
                jout[name]).tobytes()
        os.remove(path)
        for rmod, rcodec in ((td, _codec()), (jd, _jcodec())):
            with pytest.raises(F.StoreError if rmod is td else JF.StoreError,
                               match="missing"):
                rmod.ShardedRestorer(d, codec=rcodec).restore(policy="raise")


def test_missing_shard_spares_other_entries(tmp_path):
    """The reference's case, both packages on each package's layout."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(32, 16)).astype(np.float32)
    b = rng.normal(size=(32, 16)).astype(np.float32)
    for mod, codec, spec in ((td, _codec(), P("data")),
                             (jd, _jcodec(), JP("data"))):
        d = str(tmp_path / mod.__name__)
        with mod.ShardedWriter(d, {"data": 2}, codec=codec,
                               n_shards=2) as sw:
            sw.add("a", a, spec)
            sw.add("b", b)                   # single tile -> shard 0
        os.remove(os.path.join(d, F.shard_filename(1)))
        (tout, jout), (twhy, jwhy) = _restore_both(d, policy="skip")
        assert set(twhy) == set(jwhy) == {"a"}
        assert "shard_00001.szt" in twhy["a"]
        assert list(tout) == list(jout) == ["b"]
        intact = td.ShardedRestorer(d, codec=_codec()).restore(names=["b"])
        assert _np(tout["b"]).tobytes() == _np(intact["b"]).tobytes() == \
            np.asarray(jout["b"]).tobytes()


# ---------------------------------------------------------------------------
# One rank: DTensors, meshes, pspec
# ---------------------------------------------------------------------------


def test_restore_into_named_shardings_on_a_one_rank_mesh(tmp_path, cpu_world):
    arrays, _, tdir = _write_both(tmp_path)
    mesh = tmesh.make_host_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    targets = {"a.big": NamedSharding(mesh, P("data", "model")),
               "a.rep": NamedSharding(mesh, P())}
    r = td.ShardedRestorer(tdir, codec=_codec())
    full = r.restore()
    out = r.restore(targets)
    for name in arrays:
        if name in targets:
            assert isinstance(out[name], DTensor)
            assert out[name].placements == targets[name].placements(
                arrays[name][0].shape)
            assert tuple(out[name].shape) == arrays[name][0].shape
        assert _np(out[name]).tobytes() == _np(full[name]).tobytes()
    # zero_fill lands zeros in the target sharding
    os.remove(os.path.join(tdir, F.shard_filename(0)))
    out = r.restore(targets, policy="zero_fill")
    assert isinstance(out["a.big"], DTensor)
    assert not _np(out["a.big"]).any()


def test_named_sharding_placements_and_index():
    mesh = SimpleNamespace(shape={"data": 4, "model": 2},
                           axis_names=("data", "model"))
    s = NamedSharding(mesh, P(("data", "model"), None))
    assert s.placements((16, 3)) == (Shard(0), Shard(0))
    assert s.index((16, 3), (0, 1)) == (slice(2, 4), slice(0, 3))
    assert s.index((16, 3), (3, 1)) == (slice(14, 16), slice(0, 3))
    # an indivisible dim stays whole, as the layout has it
    assert NamedSharding(mesh, P("data")).placements((6,)) == (
        Replicate(), Replicate())
    assert NamedSharding(mesh, P("data")).index((6,), (2, 0)) == (
        slice(0, 6),)
    with pytest.raises(ValueError, match="mesh's axis order"):
        NamedSharding(mesh, P(("model", "data"))).placements((16,))
    with pytest.raises(ValueError, match="twice"):
        NamedSharding(mesh, P("data", "data")).placements((4, 4))
    with pytest.raises(TypeError, match="DeviceMesh"):
        NamedSharding(mesh, P()).wrap(torch.zeros(2), (2,))
    assert P(("data",), None) == ("data", None)
    assert tuple(P(("data",), None)) == tuple(JP(("data",), None))
    assert repr(P("data")) == "PartitionSpec('data',)"
    import pickle
    assert pickle.loads(pickle.dumps(P(("data", "model"), None))) == \
        P(("data", "model"), None)


def test_make_host_mesh_capacity_errors_as_the_reference(cpu_world):
    """The reference's messages with the world (one rank) as the devices;
    nothing is initialized for a refused mesh."""
    n = len(jax.devices())
    assert n == 1
    for kw in ({"model": 0}, {"model": n + 1}, {"data": 2 * n, "model": 1},
               {"data": 0}):
        msgs = []
        for mod, extra in ((tmesh, {"device_type": "cpu"}), (jmesh, {})):
            with pytest.raises(mod.MeshCapacityError) as e:
                mod.make_host_mesh(**kw, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert not dist.is_initialized()
    mesh = tmesh.make_host_mesh(device_type="cpu")
    assert dist.get_world_size() == 1
    assert mesh.shape == (1, 1) and mesh.device_type == "cpu"
    jm = jmesh.make_host_mesh()
    assert (mesh.size(0), mesh.size(1)) == (jm.shape["data"],
                                            jm.shape["model"])
    sub = tmesh.make_host_mesh(1, 1, devices=[0], device_type="cpu")
    assert sub.mesh.tolist() == [[0]]
    with pytest.raises(tmesh.MeshCapacityError, match="256"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(tmesh.MeshCapacityError, match="512"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert tmesh.batch_axes(mesh) == jmesh.batch_axes(jm) == ("data",)
    assert tmesh.model_axis(mesh) == jmesh.model_axis(jm) == "model"
    layout = SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2},
                             axis_names=("pod", "data", "model"))
    assert tmesh.batch_axes(layout) == jmesh.batch_axes(layout)
    assert tmesh.model_axis({"data": 2}) is None


def test_forced_host_devices_env():
    env = tmesh.forced_host_devices_env(8, single_threaded=True,
                                        base_env={"PATH": "/bin"})
    ref = jmesh.forced_host_devices_env(8, single_threaded=True)
    assert env["WORLD_SIZE"] == "8" and env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["PATH"] == "/bin"
    for key in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        assert env[key] == ref[key] == "1"
    assert "OMP_NUM_THREADS" not in tmesh.forced_host_devices_env(2)


def test_pspec_shard(cpu_world):
    x = torch.arange(8.0).reshape(4, 2)
    pspec.set_mesh(None)
    assert pspec.shard(x, pspec.BATCH, None) is x
    mesh = tmesh.make_host_mesh(device_type="cpu")
    pspec.set_mesh(mesh)
    try:
        assert pspec._resolve(pspec.BATCH) == ("data",)
        assert pspec._resolve(pspec.MODEL) == "model"
        assert pspec.shard(x, pspec.BATCH, pspec.MODEL) is x
        d = NamedSharding(mesh, P()).distribute(x)
        y = pspec.shard(d, pspec.BATCH, pspec.MODEL)
        assert isinstance(y, DTensor)
        assert torch.equal(y.to_local(), x)
    finally:
        pspec.set_mesh(None)
