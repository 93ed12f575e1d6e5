"""The port's codec surface against the JAX package's: the recovery fields
of ``CodecConfig``, ``RecoveryPolicy`` and the rest of
``runtime/fault_tolerance.py``, the module-level shims, the pytree round
trip (``compress_tree`` / ``decompress_tree``), ``core/api.py`` and the
codebook cache of ``PlanCache``.

The port runs on the CPU by request (``backend="ref"`` or
``device="cpu"``).  Every comparison is exact: the same names, the same
error types and messages, the same bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.cache import PlanCache as JPlanCache
from repro.runtime import fault_tolerance as jft

from repro_torch.core import api
from repro_torch.core import cache as tcache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.sz import compressor
from repro_torch.data.pipeline import smooth_field
from repro_torch.runtime import fault_tolerance as ft

from test_torch_stream import as_bytes, jax_arrays


def _raises(fn):
    """(type, message) of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:      # noqa: BLE001 -- compared, not handled
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# CodecConfig's recovery fields, RecoveryPolicy
# ---------------------------------------------------------------------------


def test_recovery_fields_default_as_the_reference():
    got, want = CodecConfig(backend="ref"), japi.CodecConfig()
    for f in ("recovery", "io_retries", "io_backoff"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("bad", [
    {"recovery": "retry"}, {"recovery": "RAISE"}, {"io_retries": -1},
    {"io_backoff": -0.5}])
def test_recovery_fields_rejected_as_the_reference(bad):
    got = _raises(lambda: CodecConfig(backend="ref", **bad))
    want = _raises(lambda: japi.CodecConfig(**bad))
    assert got is not None and got == want


@pytest.mark.parametrize("good", [
    {"recovery": "skip"}, {"recovery": "zero_fill", "io_retries": 0},
    {"io_backoff": 0.0, "io_retries": 5}])
def test_recovery_policy_of_a_codec(good):
    codec = Codec(CodecConfig(backend="ref", **good))
    want = japi.Codec(japi.CodecConfig(**good)).recovery_policy()
    assert dataclasses.asdict(codec.recovery_policy()) == \
        dataclasses.asdict(want)
    assert codec.recovery_policy("raise").on_error == "raise"
    pol = ft.RecoveryPolicy(on_error="skip", retries=1)
    assert codec.recovery_policy(pol) is pol


@pytest.mark.parametrize("policy", [None, "raise", "skip", "zero_fill",
                                    "bogus"])
@pytest.mark.parametrize("config", [None, "skip-3", "zero-0"])
def test_recovery_policy_resolve(policy, config):
    def cfg(mod):
        if config is None:
            return None
        on, n = config.split("-")
        on = {"skip": "skip", "zero": "zero_fill"}[on]
        return mod(recovery=on, io_retries=int(n), io_backoff=0.25)

    got = _raises(lambda: ft.RecoveryPolicy.resolve(
        policy, cfg(lambda **k: CodecConfig(backend="ref", **k))))
    want = _raises(lambda: jft.RecoveryPolicy.resolve(
        policy, cfg(japi.CodecConfig)))
    assert got == want
    if got is None:
        a = ft.RecoveryPolicy.resolve(
            policy, cfg(lambda **k: CodecConfig(backend="ref", **k)))
        b = jft.RecoveryPolicy.resolve(policy, cfg(japi.CodecConfig))
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("kw", [{"on_error": "nope"}, {"retries": -1},
                                {"backoff": -1.0}, {}])
def test_recovery_policy_checks(kw):
    assert _raises(lambda: ft.RecoveryPolicy(**kw)) == \
        _raises(lambda: jft.RecoveryPolicy(**kw))
    assert ft.VALID_RECOVERY == jft.VALID_RECOVERY


# ---------------------------------------------------------------------------
# runtime/fault_tolerance.py, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fails,retries", [(0, 0), (1, 2), (2, 2), (3, 2),
                                           (1, 0)])
def test_with_retries(fails, retries):
    """Transient OSErrors retry with doubling backoff; the last failure
    re-raises unchanged; on_retry is called before each sleep."""
    def run(mod):
        log = {"calls": 0, "sleeps": [], "retries": []}

        def fn():
            log["calls"] += 1
            if log["calls"] <= fails:
                raise OSError(f"flaky {log['calls']}")
            return "done"

        pol = mod.RecoveryPolicy(retries=retries, backoff=0.1)
        try:
            out = mod.with_retries(fn, pol, sleep=log["sleeps"].append,
                                   on_retry=lambda a, e: log["retries"]
                                   .append((a, str(e))))
        except OSError as e:
            out = f"raised {e}"
        return out, log

    assert run(ft) == run(jft)


def test_with_retries_does_not_retry_corruption():
    for mod in (ft, jft):
        calls = []

        def fn():
            calls.append(1)
            raise ValueError("corrupt")

        with pytest.raises(ValueError):
            mod.with_retries(fn, mod.RecoveryPolicy(retries=3),
                             sleep=lambda s: None)
        assert len(calls) == 1


def test_heartbeat_dead_detection():
    for mod in (ft, jft):
        t = [0.0]
        mon = mod.HeartbeatMonitor(["a", "b"], timeout=10,
                                   clock=lambda: t[0])
        mon.beat("a")
        t[0] = 15.0
        mon.beat("b")
        assert mon.dead() == ["a"]


def test_straggler_detection():
    def run(mod):
        mon = mod.HeartbeatMonitor(["w0", "w1", "w2", "w3"], timeout=1e9)
        for i in range(40):
            for w in ("w0", "w1", "w2"):
                mon.beat(w, step_time=1.0 + 0.01 * i)
            mon.beat("w3", step_time=5.0)
        return (mod.StragglerMitigator(factor=2.0).stragglers(mon),
                [len(st.step_times) for st in mon.workers.values()],
                mod.StragglerMitigator().stragglers(
                    mod.HeartbeatMonitor(["x"])))

    assert run(ft) == run(jft)
    assert run(ft)[0] == ["w3"]


@pytest.mark.parametrize("n", [512, 511, 256, 255, 15, 16, 1000, 4096])
def test_plan_elastic_remesh(n):
    assert ft.plan_elastic_remesh(n) == jft.plan_elastic_remesh(n)
    assert ft.plan_elastic_remesh(n, 4) == jft.plan_elastic_remesh(n, 4)


@pytest.mark.parametrize("n,dead", [(8, [2, 5]), (4, [0]), (6, [1, 2, 3]),
                                    (3, [])])
def test_reassign_shards(n, dead):
    assert ft.reassign_shards(n, dead) == jft.reassign_shards(n, dead)


# ---------------------------------------------------------------------------
# The module-level shims, core/api.py
# ---------------------------------------------------------------------------


def test_shims_match_a_codec_and_the_reference():
    x = smooth_field((32, 96), seed=9)
    c = api.compress(x, device="cpu")
    assert c.device.type == "cpu"
    jc = japi.compress(x)
    assert np.array_equal(c.stream.units.numpy(), np.asarray(jc.stream.units))
    got = api.decompress(c, backend="ref")
    assert as_bytes(got) == np.asarray(japi.decompress(jc)).tobytes()
    assert as_bytes(got) == as_bytes(
        Codec(CodecConfig(backend="ref")).decompress(c))
    batch = api.decompress_batch([c, c], backend="ref")
    assert all(as_bytes(b) == as_bytes(got) for b in batch)
    assert api.roundtrip_error(x, c, got) == \
        japi.roundtrip_error(x, jc, japi.decompress(jc))


@pytest.mark.parametrize("flag", ["use_tiles", "use_kernels", "tuned"])
def test_removed_flags_raise_typeerror(flag):
    x = smooth_field((16, 32), seed=10)
    c = api.compress(x, device="cpu")
    for fn, args in ((api.decompress, (c,)), (api.decompress_batch, ([c],)),
                     (api.compress, (x,))):
        with pytest.raises(TypeError, match="CodecConfig") as ei:
            fn(*args, **{flag: True})
        assert flag in str(ei.value)


def test_unknown_kwarg_still_typeerror():
    for mod in (api, japi):
        with pytest.raises(TypeError, match="frobnicate"):
            mod.compress(np.zeros((4, 4), np.float32), frobnicate=1)


def test_shim_codecs_share_the_default_plan_cache():
    from repro_torch.core import codec as tc

    a = tc._codec_for(CodecConfig(backend="ref", eb=1e-2))
    b = tc._codec_for(CodecConfig(backend="ref", eb=1e-2))
    assert a is b and a.plan_cache is tcache.DEFAULT_PLAN_CACHE
    assert tc._replace_some(CodecConfig(backend="ref"), eb=None) == \
        CodecConfig(backend="ref")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tc.default_codec()


def test_api_exports_the_reference_names():
    want = {n for n in dir(japi) if not n.startswith("_")
            and n not in ("annotations",)}
    missing = {n for n in want if not hasattr(api, n)}
    assert not missing, missing
    import repro.core as jcore
    import repro_torch.core as tcore

    names = {n for n in vars(jcore) if not n.startswith("_")
             and not isinstance(vars(jcore)[n], type(jcore))}
    assert names and all(hasattr(tcore, n) for n in names), names


# ---------------------------------------------------------------------------
# Pytrees
# ---------------------------------------------------------------------------


def _tree(seed=0):
    """The same tree for both packages: float32 leaves (one tiny), a bf16
    leaf, an int32 array, a Python int and a None."""
    f32 = {"w": smooth_field((64, 48), seed=seed),
           "b": smooth_field((256,), seed=seed + 1),
           "s": smooth_field((32, 32), seed=seed + 2),
           "tiny": np.ones((4,), np.float32)}
    half = smooth_field((16, 40), seed=seed + 3)
    ints = np.arange(5, dtype=np.int32)
    jtree = {"layers": {"w": f32["w"], "b": f32["b"]},
             "stack": [f32["s"], ints, None], "step": 7, "none": None,
             "half": jnp.asarray(half).astype(jnp.bfloat16),
             "tiny": f32["tiny"]}
    ttree = {"layers": {"w": torch.from_numpy(f32["w"]),
                        "b": torch.from_numpy(f32["b"])},
             "stack": [torch.from_numpy(f32["s"]), ints, None], "step": 7,
             "none": None,
             "half": torch.from_numpy(half).to(torch.bfloat16),
             "tiny": torch.from_numpy(f32["tiny"])}
    return jtree, ttree


@pytest.mark.parametrize("min_size", [1, 16])
def test_compress_tree_against_the_reference(min_size):
    jtree, ttree = _tree()
    codec = Codec(CodecConfig(backend="ref"))
    jcodec = japi.Codec()
    ct = codec.compress_tree(ttree, min_size=min_size)
    jct = jcodec.compress_tree(jtree, min_size=min_size)
    for path in (("layers", "w"), ("layers", "b"), ("half",), ("tiny",)):
        a, b = ct, jct
        for p in path:
            a, b = a[p], b[p]
        if path == ("tiny",) and min_size > 4:
            assert a is ttree["tiny"] and isinstance(b, np.ndarray)
            continue
        assert isinstance(a, compressor.Compressed)
        ja = jax_arrays(b)
        ta = compressor.compressed_to_arrays(a)
        for key in ("units", "gaps", "outlier_pos", "outlier_val"):
            assert np.array_equal(ta[key], ja[key]), (path, key)
        for key in ("total_bits", "eb", "dtype", "shape", "rel_range"):
            assert ta[key] == ja[key], (path, key)
    assert ct["stack"][1] is ttree["stack"][1]
    assert ct["step"] == 7 and ct["none"] is None and ct["stack"][2] is None


def test_compress_tree_predicate_never_sees_none():
    seen, jseen = [], []
    jtree, ttree = _tree()
    Codec(CodecConfig(backend="ref")).compress_tree(
        ttree, predicate=lambda leaf: seen.append(leaf) or False)
    japi.Codec().compress_tree(
        jtree, predicate=lambda leaf: jseen.append(leaf) or False)
    assert all(leaf is not None for leaf in seen)
    assert len(seen) == len(jseen) == 7


def test_decompress_tree_one_batch_against_the_reference():
    """Every Compressed leaf decodes through exactly one decompress_batch
    call, bit for bit the reference's tree; other leaves come back as the
    same objects."""
    jtree, ttree = _tree(5)
    codec = Codec(CodecConfig(backend="ref"))
    jcodec = japi.Codec()
    ct = codec.compress_tree(ttree)
    calls = []
    batch = codec.decompress_batch
    codec.decompress_batch = lambda cs, **kw: calls.append(len(cs)) or \
        batch(cs, **kw)
    codec.reset_stats()
    back = codec.decompress_tree(ct)
    assert calls == [5]
    assert 0 < codec.stats["decode_write_dispatches"] <= \
        codec.config.t_high + 1
    jback = jcodec.decompress_tree(jcodec.compress_tree(jtree))
    for path in (("layers", "w"), ("layers", "b"), ("half",), ("tiny",)):
        a, b = back, jback
        for p in path:
            a, b = a[p], b[p]
        assert as_bytes(a) == np.asarray(b).tobytes(), path
    assert back["half"].dtype == torch.bfloat16
    assert back["stack"][0].dtype == torch.float32
    assert back["stack"][1] is ttree["stack"][1] and back["step"] == 7
    assert back["none"] is None and back["stack"][2] is None
    assert list(back) == list(ttree)


@pytest.mark.parametrize("case", ["mirror_with_none", "data_leaves_only",
                                  "too_few", "too_many", "nested_none"])
def test_decompress_tree_shardings_raise_where_the_reference_does(case):
    """The shardings leaf count is checked as JAX counts: the tree's leaves
    without its ``None``s, the shardings' leaves with theirs."""
    x = smooth_field((24, 40), seed=7)
    jc = japi.Codec().compress(x)
    tc = Codec(CodecConfig(backend="ref")).compress(torch.from_numpy(x))
    jdev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    tdev = torch.device("cpu")
    trees = {
        "mirror_with_none": (lambda c: {"a": c, "b": None},
                             lambda d: {"a": d, "b": None}),
        "data_leaves_only": (lambda c: {"a": c, "b": None, "n": [1, 2]},
                             lambda d: {"a": d, "n": [None, d]}),
        "too_few": (lambda c: {"a": c, "n": [1, 2]}, lambda d: {"a": d}),
        "too_many": (lambda c: [c], lambda d: [d, None]),
        "nested_none": (lambda c: {"a": [c, None, (3, None)]},
                        lambda d: {"a": [d, (None,)]}),
    }
    tree, shard = trees[case]
    got = _raises(lambda: Codec(CodecConfig(backend="ref")).decompress_tree(
        tree(tc), shardings=shard(tdev)))
    want = _raises(lambda: japi.Codec().decompress_tree(
        tree(jc), shardings=shard(jdev)))
    assert got == want
    if got is None:
        out = Codec(CodecConfig(backend="ref")).decompress_tree(
            tree(tc), shardings=shard(tdev))
        jout = japi.Codec().decompress_tree(tree(jc), shardings=shard(jdev))
        a, b = jax.tree_util.tree_leaves(jout), [
            leaf for leaf in torch.utils._pytree.tree_leaves(out)
            if leaf is not None]
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert isinstance(v, torch.Tensor) == isinstance(u, jax.Array)
            if isinstance(v, torch.Tensor):
                assert np.array_equal(v.numpy(), np.asarray(u))
                if v.is_floating_point():
                    assert as_bytes(v) == np.asarray(u).tobytes()
            else:
                assert v == u


def test_decompress_tree_other_placements_name_a9():
    c = Codec(CodecConfig(backend="ref")).compress(
        torch.from_numpy(smooth_field((8, 64), seed=1)))
    with pytest.raises(NotImplementedError, match="A9"):
        Codec(CodecConfig(backend="ref")).decompress_tree(
            {"a": c}, shardings={"a": "cuda:0"})


# ---------------------------------------------------------------------------
# PlanCache.get_codebook
# ---------------------------------------------------------------------------


def test_get_codebook_hits_and_misses_as_the_reference():
    def run(cache):
        built = []
        for key in ("a", "b", "a", "a", "c", "b"):
            cache.get_codebook(key, lambda k=key: built.append(k) or k * 2)
        out = dict(cache.stats), list(built), len(cache)
        cache.clear()
        cache.get_codebook("a", lambda: "again")
        return out, cache.stats["lut_misses"]

    assert run(tcache.PlanCache()) == run(JPlanCache())
    assert run(tcache.PlanCache())[0][0]["lut_hits"] == 3
    assert set(tcache.DEFAULT_PLAN_CACHE.stats) == \
        set(JPlanCache().stats)


# ---------------------------------------------------------------------------
# Every public name of the reference's core, store and fault tolerance
# ---------------------------------------------------------------------------

#: Public names of those reference modules with no twin in the port:
#: ``functools.partial`` (imported for ``jax.jit``) and ``pack_bits``, whose
#: work the port's ``encode.pack_units`` does.
NO_TWIN = {"partial", "pack_bits"}


def _reference_modules():
    import pkgutil

    import repro.core

    return ([m.name for m in pkgutil.walk_packages(repro.core.__path__,
                                                   "repro.core.")]
            + ["repro.core", "repro.store", "repro.store.format",
               "repro.store.reader", "repro.store.writer",
               "repro.store.paging", "repro.runtime.fault_tolerance"])


@pytest.mark.parametrize("name", _reference_modules())
def test_every_public_name_has_a_twin(name):
    import importlib
    import types

    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    # Modules a module imports are no names of it; a package's submodules
    # are.
    missing = [n for n, v in vars(ref).items()
               if not n.startswith("_") and n not in NO_TWIN
               and not (isinstance(v, types.ModuleType)
                        and not v.__name__.startswith(name + "."))
               and not hasattr(port, n)]
    assert not missing, missing
