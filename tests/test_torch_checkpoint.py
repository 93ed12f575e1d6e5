"""The port's ``CheckpointManager`` against the JAX package's.

* For the same tree (float32 and bfloat16 leaves over and under
  ``compress_min_size``, an int32 scalar) both managers write
  byte-identical step directories, synchronously and asynchronously.
* Each package restores the other's checkpoint bit for bit; a raw
  bfloat16 leaf, which the reference's restore refuses with ``TypeError``,
  comes back from the port as ``torch.bfloat16``.
* Salvage (skip, zero_fill, a torn newest manifest, a corrupt raw shard)
  quarantines and falls back as the reference does.
* The mesh-sharded layout (``mesh=``, ``shardings=``, ``opt_shardings=``,
  ``shard_count=``) writes the reference's step directory byte for byte,
  each package restores the other's under every policy, and the port also
  into a one-rank CPU mesh as ``DTensor``s.
* A reduced qwen3-0.6b's parameters, stacked by ``convert.stack_layers``,
  save under the reference's entry names and round-trip.

The port runs on the CPU by request (``backend="ref"``).  Every comparison
is exact unless stated.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.checkpoint import manager as jman
from repro.core import Codec as JCodec, CodecConfig as JCodecConfig
from repro.core.cache import PlanCache as JPlanCache
from repro.models import transformer as JT

from repro_torch import configs as PCFG
from repro_torch.checkpoint import manager as man
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.data.pipeline import smooth_field
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.store import Archive
from repro_torch.testing import flip_bit

from test_torch_stream import as_bytes

MIN_SIZE = 1024
STEP = "step_00000001"


def _codec(**kw):
    return Codec(CodecConfig(backend="ref", **kw), plan_cache=PlanCache())


def _jcodec(**kw):
    return JCodec(JCodecConfig(**kw), plan_cache=JPlanCache())


def _arrays(seed=0, raw_bf16=True):
    """numpy values of the tree: float32 over and under the size floor,
    bfloat16 (as float32 here) over and, with ``raw_bf16``, under it, an
    int32 scalar; ``opt`` holds a float32 leaf and a step counter."""
    rng = np.random.default_rng(seed)
    f = np.asarray(smooth_field((48, 40), seed=seed), np.float32)
    out = {"params": {
        "w": f,
        "layers": {"b": rng.normal(size=(24,)).astype(np.float32),
                   "h": np.asarray(smooth_field((2048,), seed=seed + 1),
                                   np.float32)},
        "n": np.int32(3)},
        "opt": {"m": {"w": (f * 0.5).astype(np.float32)},
                "step": np.int32(7)}}
    if raw_bf16:
        out["params"]["layers"]["s"] = rng.normal(size=(5, 3)).astype(
            np.float32)
    return out


_BF16 = ("h", "s")


def _port_tree(arrays):
    def conv(key, a):
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if key in _BF16 else t
    return _map(arrays, conv)


def _jax_tree(arrays):
    def conv(key, a):
        return jnp.asarray(a).astype(jnp.bfloat16) if key in _BF16 else a
    return _map(arrays, conv)


def _map(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(key, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return as_bytes(x)
    return np.asarray(x).tobytes()


def _dtype(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _save_both(tmp_path, *, codec=True, asynchronous=False, raw_bf16=True,
               seed=0):
    arrays = _arrays(seed, raw_bf16)
    tm = man.CheckpointManager(
        str(tmp_path / "port"), codec=_codec() if codec else None,
        compress_min_size=MIN_SIZE, asynchronous=asynchronous,
        device="cpu")
    jm = jman.CheckpointManager(
        str(tmp_path / "jax"), codec=_jcodec() if codec else None,
        compress_min_size=MIN_SIZE, asynchronous=asynchronous)
    pt, jt = _port_tree(arrays), _jax_tree(arrays)
    tm.save(1, pt["params"], pt["opt"], extra={"seed": seed})
    jm.save(1, jt["params"], jt["opt"], extra={"seed": seed})
    tm.wait()
    jm.wait()
    return tm, jm


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("codec,asynchronous", [(True, False), (True, True),
                                                (False, False),
                                                (False, True)])
def test_step_directories_are_byte_identical(tmp_path, codec, asynchronous):
    tm, jm = _save_both(tmp_path, codec=codec, asynchronous=asynchronous)
    got, want = (_files(os.path.join(m.dir, STEP)) for m in (tm, jm))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    manifest = json.loads(want["manifest.json"])
    kinds = {k: e["kind"] for k, e in manifest["entries"].items()}
    if codec:
        assert kinds["params.w"] == kinds["params.layers.h"] == "sz"
        assert man.ARCHIVE_NAME in got
    assert kinds["params.layers.s"] == kinds["params.n"] == "raw"
    assert manifest["entries"]["params.layers.s"]["dtype"] == "bfloat16"
    assert got["params.layers.s.npy"].startswith(
        b"\x93NUMPY\x01\x00v\x00{'descr': '<V2'")


@pytest.mark.parametrize("raw_bf16", [False, True])
def test_each_package_restores_the_others(tmp_path, raw_bf16):
    """Bit for bit both ways, dtypes kept; with a raw bfloat16 leaf the
    reference's restore raises ``TypeError`` and the port's gives
    ``torch.bfloat16``."""
    tm, jm = _save_both(tmp_path, raw_bf16=raw_bf16)
    port_of_jax = man.CheckpointManager(jm.dir, codec=_codec()).restore()
    port_own = tm.restore()
    if raw_bf16:
        for d in (tm.dir, jm.dir):
            with pytest.raises(TypeError, match="V2"):
                jman.CheckpointManager(d, codec=_jcodec()).restore()
        want = _flat(_port_tree(_arrays(0, raw_bf16)))
        for r in (port_of_jax, port_own):
            s = r["params"]["layers"]["s"]
            assert s.dtype == torch.bfloat16
            assert torch.equal(s, want["params.layers.s"])
        return
    jax_own = jm.restore()
    jax_of_port = jman.CheckpointManager(tm.dir, codec=_jcodec()).restore()
    want = {**_flat({"params": jax_own["params"], "opt": jax_own["opt"]})}
    assert want
    for r in (port_own, port_of_jax, jax_of_port):
        assert r["step"] == 1 and r["extra"] == {"seed": 0}
        assert not r["quarantined"] and not r["fallback_from"]
        got = _flat({"params": r["params"], "opt": r["opt"]})
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert _dtype(got[k]) == _dtype(w), k
            assert tuple(got[k].shape) == tuple(np.shape(w)), k
            assert _bytes(got[k]) == _bytes(w), k
    for leaf in _flat(port_own["params"]).values():
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"


def test_compressed_leaves_within_bound_and_equal_the_archive(tmp_path):
    tm, _ = _save_both(tmp_path)
    arrays = _flat(_port_tree(_arrays()))
    r = tm.restore()
    got = _flat({"params": r["params"], "opt": r["opt"]})
    with Archive(os.path.join(tm.dir, STEP, man.ARCHIVE_NAME),
                 codec=_codec()) as ar:
        for name in ar.names:
            c = ar.read_chunk(name)
            assert _bytes(got[name]) == _bytes(ar.read_tensor(name))
            err = float((got[name].double()
                         - arrays[name].double()).abs().max())
            assert err <= c.eb_effective
    for raw in ("params.layers.b", "params.layers.s", "params.n",
                "opt.step"):
        assert torch.equal(got[raw], torch.as_tensor(arrays[raw]))


def test_async_save_is_a_snapshot(tmp_path):
    """An in-place write made after ``save`` returns does not reach the
    checkpoint: the manager copied the leaves first."""
    arrays = _arrays()
    tree = _port_tree(arrays)
    mgr = man.CheckpointManager(str(tmp_path), codec=_codec(),
                                compress_min_size=MIN_SIZE,
                                asynchronous=True, device="cpu")
    mgr.save(1, tree["params"])
    for leaf in _flat(tree["params"]).values():
        leaf.fill_(0) if isinstance(leaf, torch.Tensor) else None
    mgr.wait()
    sync = man.CheckpointManager(str(tmp_path / "sync"), codec=_codec(),
                                 compress_min_size=MIN_SIZE)
    sync.save(1, _port_tree(arrays)["params"])
    assert _files(os.path.join(mgr.dir, STEP)) == \
        _files(os.path.join(sync.dir, STEP))
    assert mgr.restore()["params"]["layers"]["b"].abs().sum() > 0


# ---------------------------------------------------------------------------
# Salvage, against the reference
# ---------------------------------------------------------------------------


def _two_steps(tmp_path):
    """Steps 1 and 2 of the same tree in both packages."""
    arrays = _arrays(raw_bf16=False)
    out = []
    for name, mgr, tree in (
            ("port", man.CheckpointManager(str(tmp_path / "port"),
                                           codec=_codec(),
                                           compress_min_size=MIN_SIZE),
             _port_tree(arrays)),
            ("jax", jman.CheckpointManager(str(tmp_path / "jax"),
                                           codec=_jcodec(),
                                           compress_min_size=MIN_SIZE),
             _jax_tree(arrays))):
        mgr.save(1, tree["params"])
        mgr.save(2, tree["params"])
        out.append(mgr)
    return out


def _corrupt(d, case):
    step2 = os.path.join(d, "step_00000002")
    if case == "chunk":
        apath = os.path.join(step2, man.ARCHIVE_NAME)
        with Archive(apath, codec=_codec()) as ar:
            rec = ar.chunk("params.w")
        flip_bit(apath, rec.units.offset + rec.units.length // 2, 3)
    elif case == "archive":
        os.unlink(os.path.join(step2, man.ARCHIVE_NAME))
    elif case == "manifest":
        mpath = os.path.join(step2, "manifest.json")
        with open(mpath, "r+b") as f:
            f.truncate(os.path.getsize(mpath) // 2)
    elif case == "raw":
        npy = os.path.join(step2, "params.n.npy")
        flip_bit(npy, os.path.getsize(npy) - 1, 0)
    elif case == "raw_truncated":
        npy = os.path.join(step2, "params.layers.b.npy")
        with open(npy, "r+b") as f:
            f.truncate(os.path.getsize(npy) // 2)


@pytest.mark.parametrize("case", ["chunk", "archive", "manifest", "raw",
                                  "raw_truncated"])
@pytest.mark.parametrize("policy", ["raise", "skip", "zero_fill"])
def test_salvage_as_the_reference(tmp_path, case, policy):
    tm, jm = _two_steps(tmp_path)
    for m in (tm, jm):
        _corrupt(m.dir, case)
    if policy == "raise":
        with pytest.raises(jman.CheckpointIntegrityError) as want:
            jm.restore()
        with pytest.raises(man.CheckpointIntegrityError) as got:
            tm.restore()
        assert str(got.value).replace(tm.dir, "") == \
            str(want.value).replace(jm.dir, "")
        return
    want, got = jm.restore(policy=policy), tm.restore(policy=policy)
    assert got["step"] == want["step"]
    assert sorted(got["quarantined"]) == sorted(want["quarantined"])
    assert [f["step"] for f in got["fallback_from"]] == \
        [f["step"] for f in want["fallback_from"]]
    if case == "manifest":
        assert got["step"] == 1 and got["fallback_from"]
    wflat, gflat = _flat(want["params"]), _flat(got["params"])
    assert sorted(gflat) == sorted(wflat)
    for k, w in wflat.items():
        assert _bytes(gflat[k]) == _bytes(w), k
        if f"params.{k}" in got["quarantined"] and policy == "zero_fill":
            assert not gflat[k].any()


def test_manifest_versions_as_the_reference(tmp_path):
    tm, jm = _two_steps(tmp_path)
    for bump, match in ((4, "newer than this reader"),
                        (1, "pre-store manifest")):
        msgs = []
        for mgr, err in ((tm, man.CheckpointIntegrityError),
                         (jm, jman.CheckpointIntegrityError)):
            mpath = os.path.join(mgr.dir, "step_00000002", "manifest.json")
            m = json.load(open(mpath))
            m["version"] = bump
            json.dump(m, open(mpath, "w"))
            with pytest.raises(err, match=match) as e:
                mgr.restore(2)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert man.MANIFEST_VERSION == jman.MANIFEST_VERSION


def test_structurally_invalid_manifest_is_named(tmp_path):
    tm, _ = _two_steps(tmp_path)
    mpath = os.path.join(tm.dir, "step_00000002", "manifest.json")
    json.dump({"entries": {"params.w": 3}}, open(mpath, "w"))
    with pytest.raises(man.CheckpointIntegrityError,
                       match="structurally invalid"):
        tm.restore(2)
    os.unlink(mpath)
    with pytest.raises(man.CheckpointIntegrityError, match="missing"):
        tm.restore(2)


# ---------------------------------------------------------------------------
# The reference's own checkpoint cases
# ---------------------------------------------------------------------------


def _small_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn((128, 64), generator=g),
                       "b": torch.zeros((64,))},
            "embed": torch.from_numpy(np.asarray(
                smooth_field((512, 32), seed=seed), np.float32))}


def test_raw_roundtrip_and_latest_step(tmp_path):
    mgr = man.CheckpointManager(str(tmp_path), device="cpu")
    assert mgr.latest_step() is None
    params = _small_tree()
    opt = {"m": {k: torch.zeros_like(v) for k, v in params["layers"].items()},
           "step": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 5, 3):
        mgr.save(s, params, opt)
    assert mgr.latest_step() == 5
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    r = mgr.restore()
    assert r["step"] == 5 and int(r["opt"]["step"]) == 7
    for k, v in _flat(params).items():
        assert torch.equal(_flat(r["params"])[k], v)


def test_one_archive_a_step_and_plan_cache_on_rerestore(tmp_path):
    mgr = man.CheckpointManager(str(tmp_path), codec=_codec(),
                                compress_min_size=MIN_SIZE)
    mgr.save(0, _small_tree())
    d = os.path.join(str(tmp_path), "step_00000000")
    files = sorted(os.listdir(d))
    assert man.ARCHIVE_NAME in files
    with Archive(os.path.join(d, man.ARCHIVE_NAME), codec=_codec()) as ar:
        assert "params.embed" in ar
    be = hp.get_backend("ref")
    mgr.restore()
    be.reset_stats()
    mgr.restore()
    assert be.stats["plan_builds"] == 0


@pytest.mark.parametrize("case,match", [
    ("chunk", None), ("truncated", None), ("missing", "missing"),
    ("raw", "params.layers.b"), ("raw_truncated", None)])
def test_integrity_errors_are_named(tmp_path, case, match):
    mgr = man.CheckpointManager(str(tmp_path), codec=_codec(),
                                compress_min_size=MIN_SIZE)
    mgr.save(0, _small_tree())
    d = os.path.join(str(tmp_path), "step_00000000")
    apath = os.path.join(d, man.ARCHIVE_NAME)
    raw = os.path.join(d, "params.layers.b.npy")
    if case == "chunk":
        with Archive(apath, codec=_codec()) as ar:
            rec = ar.chunk("params.embed")
        flip_bit(apath, rec.units.offset, 7)
    elif case == "truncated":
        with open(apath, "r+b") as f:
            f.truncate(os.path.getsize(apath) - 64)
    elif case == "missing":
        os.unlink(apath)
    elif case == "raw":
        flip_bit(raw, os.path.getsize(raw) - 1, 7)
    else:
        with open(raw, "r+b") as f:
            f.truncate(os.path.getsize(raw) // 2)
    with pytest.raises(man.CheckpointIntegrityError, match=match):
        mgr.restore()


# ---------------------------------------------------------------------------
# The mesh-sharded layout
# ---------------------------------------------------------------------------

#: The reference's (4, 2) mesh as a layout: its save needs no devices.
LAYOUT = SimpleNamespace(shape={"data": 4, "model": 2},
                         axis_names=("data", "model"))


def _cross_topology_tree(seed=0):
    """The tree of the reference's ``test_cross_topology_restore_bit_exact``
    with an optimizer state beside it (numpy)."""
    rng = np.random.default_rng(seed)
    params = {
        "layers": {"0": {
            "attn": {"wq": rng.normal(size=(256, 512)).astype(np.float32)},
            "mlp": {"wg": rng.normal(size=(256, 1024)).astype(np.float32)}}},
        "norm": rng.normal(size=(64,)).astype(np.float32)}
    return params, {"m": _map(params, lambda k, a: a * np.float32(0.5)),
                    "step": np.int32(3)}


def _qwen3_tree():
    """A reduced qwen3-0.6b from the port's ``init_model``, stacked by
    ``convert.stack_layers`` (numpy, the port's key order)."""
    cfg = PCFG.get_config("qwen3-0.6b").reduced()
    params = _map(convert.stack_layers(T.init_model(0, cfg, "cpu")),
                  lambda k, t: t.numpy())
    return params, {"m": _map(params, lambda k, a: a * np.float32(0.5)),
                    "step": np.int32(3)}


def _spec_tree(params, P, axis):
    """Every leaf split on dim 0 over ``axis``: specs the rules would not
    pick, so a test sees they are the ones used."""
    return _map(params, lambda k, a: P(axis) if np.ndim(a) else P())


def _sharded_kwargs(case, params, opt, P):
    if case == "mesh":
        return {"mesh": LAYOUT}
    if case == "shard_count":
        return {"mesh": LAYOUT, "shard_count": 4}
    if case == "shardings":
        return {"mesh": LAYOUT, "shardings": _spec_tree(params, P, "model")}
    return {"mesh": LAYOUT, "opt_shardings": _spec_tree(opt, P, "data")}


def _save_sharded_both(tmp_path, case="shard_count", tree="cross"):
    from jax.sharding import PartitionSpec as JP

    from repro_torch.runtime.sharding import P

    params, opt = (_cross_topology_tree() if tree == "cross"
                   else _qwen3_tree())
    tm = man.CheckpointManager(str(tmp_path / "port"), codec=_codec(),
                               compress_min_size=MIN_SIZE)
    jm = jman.CheckpointManager(str(tmp_path / "jax"), codec=_jcodec(),
                                compress_min_size=MIN_SIZE)
    tparams = _map(params, lambda k, a: torch.from_numpy(np.array(a)))
    tm.save(1, tparams, opt, extra={"case": case},
            **_sharded_kwargs(case, params, opt, P))
    jm.save(1, params, opt, extra={"case": case},
            **_sharded_kwargs(case, params, opt, JP))
    return tm, jm, params, opt


def _assert_same_trees(got, want):
    got = _flat({"params": got["params"], "opt": got["opt"]})
    want = _flat({"params": want["params"], "opt": want["opt"]})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if hasattr(g, "to_local"):
            g = g.to_local()
        assert _dtype(g) == _dtype(w), k
        assert tuple(g.shape) == tuple(np.shape(w)), k
        assert _bytes(g) == _bytes(w), k


@pytest.mark.parametrize("case,tree", [
    ("mesh", "cross"), ("shardings", "cross"), ("opt_shardings", "cross"),
    ("shard_count", "cross"), ("shard_count", "qwen3")])
def test_sharded_step_directories_as_the_reference(tmp_path, case, tree):
    """``save(mesh=, shardings=, opt_shardings=, shard_count=)``: the same
    step directory byte for byte, and each package restores the other's
    bit for bit; the port also into a one-rank CPU mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh

    tm, jm, params, _ = _save_sharded_both(tmp_path, case, tree)
    got, want = (_files(os.path.join(m.dir, STEP)) for m in (tm, jm))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    manifest = json.loads(want["manifest.json"])
    assert manifest["version"] == man.MANIFEST_VERSION == 3
    kinds = {k: e["kind"] for k, e in manifest["entries"].items()}
    assert "sz-sharded" in kinds.values() and "raw" in kinds.values()
    assert manifest["n_shards"] == (4 if case == "shard_count" else 1)
    jown = jm.restore()
    for r in (tm.restore(),
              man.CheckpointManager(jm.dir, codec=_codec()).restore(),
              jman.CheckpointManager(tm.dir, codec=_jcodec()).restore()):
        assert r["step"] == 1 and r["extra"] == {"case": case}
        assert not r["quarantined"]
        _assert_same_trees(r, jown)
    try:
        mesh = make_host_mesh(device_type="cpu")
        r = man.CheckpointManager(jm.dir, codec=_codec()).restore(mesh=mesh)
        _assert_same_trees(r, jown)
        assert all(isinstance(v, DTensor) for v in _flat(r["params"]).values())
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _corrupt_shard(step_dir, case):
    path = os.path.join(step_dir, "shard_00001.szt")
    if case == "missing":
        os.unlink(path)
    elif case == "corrupt":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            f.write(b"\xff" * 4096)


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """Both packages' step directories of the cross-topology tree on the
    (4, 2) layout in 4 shards, written once for the salvage cases."""
    tm, jm, _, _ = _save_sharded_both(tmp_path_factory.mktemp("sharded"),
                                      "shard_count")
    return tm.dir, jm.dir


@pytest.mark.parametrize("case", ["intact", "corrupt", "missing"])
@pytest.mark.parametrize("policy", ["raise", "skip", "zero_fill"])
def test_sharded_salvage_as_the_reference(tmp_path, sharded_steps, policy,
                                          case):
    """A sharded step restores under every policy as the reference's does,
    either package reading either package's step: the same quarantined
    entries (every reason naming the shard file), zeros for them under
    ``zero_fill`` and every other entry bit for bit."""
    import shutil

    dirs = []
    for src, name in zip(sharded_steps, ("port", "jax")):
        shutil.copytree(src, tmp_path / name)
        dirs.append(str(tmp_path / name))
        _corrupt_shard(os.path.join(dirs[-1], STEP), case)
    readers = [lambda d: man.CheckpointManager(d, codec=_codec()),
               lambda d: jman.CheckpointManager(d, codec=_jcodec())]
    if policy == "raise" and case != "intact":
        for reader in readers:
            for d in dirs:
                with pytest.raises(Exception, match="shard_00001.szt") as e:
                    reader(d).restore(policy=policy)
                assert type(e.value).__name__ == "CheckpointIntegrityError"
        return
    results = [reader(d).restore(policy=policy) for reader in readers
               for d in dirs]
    want = results[-1]
    if case == "intact":
        assert not want["quarantined"]
    else:
        assert want["quarantined"]
        assert all("shard_00001.szt" in why
                   for why in want["quarantined"].values())
    for r in results:
        assert sorted(r["quarantined"]) == sorted(want["quarantined"])
        _assert_same_trees(r, want)
    flat = _flat({"params": want["params"], "opt": want["opt"]})
    for k in want["quarantined"]:
        assert (k in flat) == (policy == "zero_fill")
        if policy == "zero_fill":
            assert not np.asarray(flat[k]).any()


def test_raw_only_manager_needs_a_device(tmp_path):
    mgr = man.CheckpointManager(str(tmp_path))
    mgr.save(1, _small_tree())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default restores there")
    with pytest.raises(RuntimeError, match="is_available"):
        mgr.restore()
    r = man.CheckpointManager(str(tmp_path), device="cpu").restore()
    assert r["params"]["layers"]["w"].device.type == "cpu"


# ---------------------------------------------------------------------------
# A reduced qwen3-0.6b, stacked into the reference's layout
# ---------------------------------------------------------------------------


def _names_and_shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in _flat(tree).items()}


def test_stack_layers_is_the_inverse_of_params_from_jax():
    jcfg = JCFG.get_config("qwen3-0.6b").reduced()
    pcfg = PCFG.get_config("qwen3-0.6b").reduced()
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    stacked = convert.stack_layers(convert.params_from_jax(tree, pcfg,
                                                           "cpu"))
    want = _flat(tree)
    got = _flat(stacked)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert _bytes(got[k]) == _bytes(w), k
    own = convert.stack_layers(T.init_model(0, pcfg, "cpu"))
    assert _names_and_shapes(own) == _names_and_shapes(tree)


def test_reduced_qwen3_parameters_round_trip(tmp_path):
    cfg = PCFG.get_config("qwen3-0.6b").reduced()
    params = convert.stack_layers(T.init_model(0, cfg, "cpu"))
    codec = _codec(eb=1e-4)
    mgr = man.CheckpointManager(str(tmp_path), codec=codec,
                                compress_min_size=MIN_SIZE)
    mgr.save(1, params)
    manifest = json.load(open(os.path.join(str(tmp_path), STEP,
                                           "manifest.json")))
    assert manifest["entries"]["params.layers.attn.wq"]["shape"][0] == \
        cfg.n_layers
    r = mgr.restore()
    got, want = _flat(r["params"]), _flat(params)
    assert sorted(got) == sorted(want)
    with Archive(os.path.join(str(tmp_path), STEP, man.ARCHIVE_NAME),
                 codec=codec) as ar:
        for k, w in want.items():
            name = f"params.{k}"
            assert got[k].dtype == w.dtype and got[k].shape == w.shape
            if manifest["entries"][name]["kind"] == "raw":
                assert torch.equal(got[k], w), k
            else:
                bound = ar.read_chunk(name).eb_effective
                assert float((got[k] - w).abs().max()) <= bound, k
