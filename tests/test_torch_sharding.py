"""The port's sharding rules and compressed collectives against the JAX
package's.

* For every config of the registry, full and reduced, the reference's
  shape tree (``jax.eval_shape`` of its ``init_model``) goes through both
  packages' ``param_shardings`` on layout meshes (4, 2), (2, 4), (16, 16)
  and (2, 16, 16), with ``REPRO_MOE_SHARDING`` unset and set to ``ep``:
  equal specs leaf for leaf.  The same for ``opt_state_shardings``
  (int8 and float32 AdamW states), ``batch_shardings`` and
  ``cache_shardings``.  The reference's ``NamedSharding`` name is
  monkeypatched to hand back its spec, since a layout has no devices;
  nothing in the JAX package changes.
* ``_fit``, ``quantize_ef``, ``dequantize`` and ``wire_bytes`` agree bit
  for bit, ``quantize_ef`` on exact ties and through the reference's
  error-feedback loop.

Shape trees reach the port as ``meta`` tensors.  The multi-rank gradient
sync is in ``test_torch_ranks.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from jax.sharding import PartitionSpec as JP

from repro import configs
from repro.models import decode as JD
from repro.models import transformer as JT
from repro.optim import adamw
from repro.runtime import collectives as JC
from repro.runtime import sharding as jsh

from repro_torch.runtime import collectives as C
from repro_torch.runtime import sharding as sh

from test_torch_stream import as_bytes

LAYOUTS = {
    "4x2": {"data": 4, "model": 2},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _layout(name):
    ax = LAYOUTS[name]
    return SimpleNamespace(shape=dict(ax), axis_names=tuple(ax))


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's rules with ``NamedSharding(mesh, spec)`` giving the
    spec back."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)


def _to_meta(jtree):
    return jax.tree.map(
        lambda x: torch.empty(tuple(x.shape), device="meta"), jtree)


def _ref_leaves(tree):
    return [(jax.tree_util.keystr(kp), tuple(s)) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]]


def _port_leaves(tree):
    out = []
    for kp, s in pytree.tree_flatten_with_path(tree)[0]:
        assert isinstance(s, sh.NamedSharding)
        out.append((sh._path_str(kp), tuple(s.spec)))
    return out


def _assert_same(port_tree, ref_tree):
    got, want = _port_leaves(port_tree), _ref_leaves(ref_tree)
    assert len(got) == len(want) > 0
    for (gp, gs), (wp, ws) in zip(got, want):
        assert gs == ws, (gp, wp, gs, ws)


def _shape_tree(cfg):
    return jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), cfg))


CONFIGS = [(arch, reduced) for arch in configs.REGISTRY
           for reduced in (False, True)]


@pytest.mark.parametrize("arch,reduced", CONFIGS)
def test_param_and_opt_specs_as_the_reference(arch, reduced, ref_specs,
                                              monkeypatch):
    cfg = configs.get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    ps = _shape_tree(cfg)
    pmeta = _to_meta(ps)
    states = {dt: jax.eval_shape(lambda p=ps, dt=dt: adamw.init(
        p, adamw.AdamWConfig(state_dtype=dt))) for dt in ("int8", "float32")}
    n_sharded = 0
    for moe in (None, "ep"):
        if moe is None:
            monkeypatch.delenv("REPRO_MOE_SHARDING", raising=False)
        else:
            monkeypatch.setenv("REPRO_MOE_SHARDING", moe)
        for name in LAYOUTS:
            mesh = _layout(name)
            got = sh.param_shardings(pmeta, mesh)
            _assert_same(got, jsh.param_shardings(ps, mesh))
            n_sharded += sum(any(a is not None for a in s.spec)
                             for s in pytree.tree_leaves(got))
            for st in states.values():
                _assert_same(sh.opt_state_shardings(_to_meta(st), mesh),
                             jsh.opt_state_shardings(st, mesh))
    assert n_sharded > 0                    # the rules fire


@pytest.mark.parametrize("arch", list(configs.REGISTRY))
def test_cache_and_batch_specs_as_the_reference(arch, ref_specs):
    cfg = configs.get_config(arch)
    batch = {"tokens": jax.ShapeDtypeStruct((8, 256), jnp.int32),
             "labels": jax.ShapeDtypeStruct((8, 256), jnp.int32),
             "one": jax.ShapeDtypeStruct((1, 256), jnp.int32),
             "pos": jax.ShapeDtypeStruct((6,), jnp.int32),
             "t": jax.ShapeDtypeStruct((), jnp.int32)}
    for name in LAYOUTS:
        mesh = _layout(name)
        _assert_same(sh.batch_shardings(_to_meta(batch), mesh),
                     jsh.batch_shardings(batch, mesh))
        for c in (cfg, cfg.reduced()):
            for b in (8, 1):
                cs = {k: jax.ShapeDtypeStruct(shape, dt) for k, (shape, dt)
                      in JD.cache_spec(c, b, 256).items()}
                _assert_same(sh.cache_shardings(_to_meta(cs), mesh, c),
                             jsh.cache_shardings(cs, mesh, c))


def test_fit_as_the_reference():
    rng = np.random.default_rng(0)
    for name in LAYOUTS:
        mesh = _layout(name)
        for axes in (None, "model", "data", ("data",), ("data", "model"),
                     ("pod", "data"), ()):
            if axes and any(a not in LAYOUTS[name] for a in
                            ((axes,) if isinstance(axes, str) else axes)):
                continue
            for dim in [int(d) for d in rng.integers(1, 600, 30)] + [
                    7, 8, 12, 16, 256]:
                assert sh._fit(mesh, dim, axes) == jsh._fit(mesh, dim, axes)
    mesh = SimpleNamespace(shape={"data": 4, "model": 2})
    assert sh._fit(mesh, 8, "model") == "model"
    assert sh._fit(mesh, 7, "model") is None
    assert sh._fit(mesh, 16, ("data", "model")) == ("data", "model")
    assert sh._fit(mesh, 12, ("data", "model")) is None
    assert sh._fit(mesh, 8, None) is None


# ---------------------------------------------------------------------------
# Compressed collectives: the arithmetic
# ---------------------------------------------------------------------------


def _pair(x):
    return torch.from_numpy(np.array(x)), jnp.asarray(x)


@pytest.mark.parametrize("eb", [1e-6, 1e-3, 0.05])
def test_quantize_ef_and_dequantize_bit_for_bit(eb):
    rng = np.random.default_rng(int(eb * 1e7))
    x = (rng.standard_normal(8192) * 200 * eb).astype(np.float32)
    r = (rng.standard_normal(8192) * eb).astype(np.float32)
    # exact ties: odd multiples of eb, on the lattice's half steps
    step = np.float32(2 * eb)
    x[:512] = (np.arange(-256, 256, dtype=np.float32) + 0.5) * step
    r[:512] = 0
    for res in (np.zeros_like(r), r):
        (tx, jx), (tr, jr) = _pair(x), _pair(res)
        tq, tres = C.quantize_ef(tx, tr, eb)
        jq, jres = JC.quantize_ef(jx, jr, eb)
        assert tq.dtype == torch.int8
        assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
        assert as_bytes(tres) == np.asarray(jres).tobytes()
        assert as_bytes(C.dequantize(tq, eb)) == np.asarray(
            JC.dequantize(jq, eb)).tobytes()


def test_quantize_bound_as_the_reference():
    """The reference's ``test_bound``, its inputs and tolerance."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 1e-4
    eb = 1e-6
    q, _ = C.quantize_ef(x, torch.zeros_like(x), eb)
    deq = C.dequantize(q, eb)
    unsaturated = x.abs().numpy() < 126 * 2 * eb
    err = (deq - x).abs().numpy()
    assert err[unsaturated].max() <= eb + 1e-12


def test_error_feedback_loop_as_the_reference():
    """The reference's ``test_error_feedback_accumulates``: a constant
    gradient below half a step flows through the residual, the same codes
    and residuals at every step."""
    eb = 1e-3
    g = np.full((8,), 0.4 * 2 * eb, np.float32)
    tres, jres = torch.zeros(8), jnp.zeros((8,))
    total = np.zeros(8)
    for _ in range(10):
        tq, tres = C.quantize_ef(torch.from_numpy(g), tres, eb)
        jq, jres = JC.quantize_ef(jnp.asarray(g), jres, eb)
        assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
        assert as_bytes(tres) == np.asarray(jres).tobytes()
        total += C.dequantize(tq, eb).numpy()
    assert np.allclose(total, 10 * g, atol=2 * eb)


def test_wire_bytes_as_the_reference():
    for n in (1, 10_000_000, 596_049_920):
        for scheme in ("allreduce_f32", "allreduce_bf16", "rs_bf16_ag_int8"):
            assert C.wire_bytes(n, scheme) == JC.wire_bytes(n, scheme)
    with pytest.raises(ValueError):
        C.wire_bytes(1, "nope")
