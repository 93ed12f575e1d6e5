"""The port's mixture-of-experts block (``repro_torch.models.moe``) against
the JAX package's ``repro.models.moe``.

The reference's expert weights (``init_moe`` of the reduced qwen2-moe:
8 experts, top-2, width 64, one shared expert) cross to the port as numpy
arrays; the inputs are made with numpy from a seed, cast to the compute
type on both sides.  The reference runs eagerly on the CPU (its
``pspec.shard`` is the identity without a mesh), the port on CPU tensors.

Tolerances, stated where used:

* Outputs, scaled by ``max(1, max|want|)`` (the reference's expert
  weights are drawn with ``fan_in = n_experts``, so the block's outputs
  reach ~100 on unit inputs): float32 within 1e-5; bfloat16 within 2**-5,
  a few bfloat16 ulps (the frameworks round the expert products and the
  activation at other places).  The aux loss within 1e-6 relative.
* float32 gradients of the router, the experts and the shared expert (and
  of the input) from ``torch.autograd`` against ``jax.grad``: rtol 1e-4,
  atol 1e-6 of the gradient's scale.

Every case first checks that no token's k-th and (k+1)-th gates lie within
``TIE_GAP`` of each other: the two float32 routers sum in other orders, so
a closer pair could route apart and no tolerance would then decide.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JCFG
from repro.models import moe as JM

from repro_torch import configs as PCFG
from repro_torch.models import convert
from repro_torch.models import moe as M

ARCH = "qwen2-moe-a2.7b"
TIE_GAP = 1e-5
CAPACITY_FACTORS = [4.0, 1.0, 0.5]


def _pair(dtype="float32", **over):
    jcfg = JCFG.get_config(ARCH).reduced(compute_dtype=dtype, **over)
    pcfg = PCFG.get_config(ARCH).reduced(compute_dtype=dtype, **over)
    tree = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(0), jcfg))
    return jcfg, pcfg, tree


def _port_params(tree):
    return {k: ({n: convert.to_torch(a, "cpu") for n, a in v.items()}
                if isinstance(v, dict) else convert.to_torch(v, "cpu"))
            for k, v in tree.items()}


def _x(cfg, b=2, s=24, seed=1):
    """Unit-normal inputs (B, S, d), float32, rounded to the compute type
    so both sides start from the same values."""
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return np.array(jnp.asarray(x).astype(cfg.compute_dtype).astype(
        jnp.float32))


def _assert_no_near_ties(x, tree, cfg):
    """Each token's k-th gate exceeds its (k+1)-th by more than
    ``TIE_GAP`` (float64 router from the same float32 values)."""
    logits = x.reshape(-1, cfg.d_model).astype(np.float64) @ \
        tree["router"].astype(np.float64)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g = np.sort(g / g.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    gap = g[:, cfg.top_k - 1] - g[:, cfg.top_k]
    assert gap.min() > TIE_GAP, gap.min()


def _both(jcfg, pcfg, tree, x):
    _assert_no_near_ties(x, tree, jcfg)
    want = JM.moe_block(jnp.asarray(x).astype(jcfg.cdt),
                        jax.tree.map(jnp.asarray, tree), jcfg)
    got = M.moe_block(torch.from_numpy(x).to(pcfg.cdt), _port_params(tree),
                      pcfg)
    return got, want


def _check(got, want, dtype):
    (go, ga), (wo, wa) = got, want
    go, wo = convert.to_numpy(go), np.asarray(wo, np.float32)
    assert go.shape == wo.shape
    scale = max(1.0, float(np.abs(wo).max()))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    assert np.abs(go - wo).max() <= tol * scale, (np.abs(go - wo).max(),
                                                 scale)
    assert ga.dtype == torch.float32 and ga.shape == ()
    assert abs(float(ga) - float(wa)) <= 1e-6 * abs(float(wa))


def _dropped(x, tree, pcfg):
    """The share of assignments ``route`` drops on these inputs."""
    logits = torch.from_numpy(x.reshape(-1, pcfg.d_model)) @ \
        torch.from_numpy(tree["router"])
    return 1.0 - float(M.route(logits, pcfg).keep.float().mean())


# ---------------------------------------------------------------------------
# moe_block against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_reference(dtype, cf):
    """out and aux at capacity factors 4 (no drop), 1 and 0.5 (drops)."""
    jcfg, pcfg, tree = _pair(dtype, capacity_factor=cf)
    x = _x(pcfg)
    _check(*_both(jcfg, pcfg, tree, x), dtype)
    dropped = _dropped(x, tree, pcfg)
    if cf == 4.0:
        assert dropped == 0.0
    if cf == 0.5:
        assert dropped > 0.3


@pytest.mark.parametrize("cf", [4.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_moe_block_matches_reference(monkeypatch, dtype, cf):
    """``MOE_TOKEN_CHUNK`` 16 on both sides: 80 tokens run as 5 chunks,
    each with its own capacity, the aux their mean; 70 tokens (no whole
    number of chunks) run as one block."""
    monkeypatch.setattr(JM, "MOE_TOKEN_CHUNK", 16)
    monkeypatch.setattr(M, "MOE_TOKEN_CHUNK", 16)
    jcfg, pcfg, tree = _pair(dtype, capacity_factor=cf)
    for s in (40, 35):
        _check(*_both(jcfg, pcfg, tree, _x(pcfg, s=s, seed=s)), dtype)
    # the chunks' capacities differ from the whole block's
    calls = []
    real = M.route
    monkeypatch.setattr(M, "route", lambda lg, c: calls.append(lg.shape[0])
                        or real(lg, c))
    M.moe_block(torch.from_numpy(_x(pcfg, s=40)), _port_params(tree), pcfg)
    assert calls == [16] * 5


def test_moe_block_gradients_match_reference():
    """float32, capacity factor 0.5 (drops): the gradients of ``sum(out *
    cot) + aux`` with respect to every weight and the input."""
    jcfg, pcfg, tree = _pair("float32", capacity_factor=0.5)
    x = _x(pcfg)
    _assert_no_near_ties(x, tree, jcfg)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        out, aux = JM.moe_block(xx, p, jcfg)
        return jnp.sum(out * cot) + aux

    wp, wx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    params = _port_params(tree)
    leaves = [params["router"], params["wg"], params["wu"], params["wd"],
              *params["shared"].values()]
    for t in leaves:
        t.requires_grad_(True)
    px = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_block(px, params, pcfg)
    (out * torch.from_numpy(cot)).sum().add(aux).backward()
    want = {"router": wp["router"], "wg": wp["wg"], "wu": wp["wu"],
            "wd": wp["wd"], "x": wx,
            **{f"shared.{k}": v for k, v in wp["shared"].items()}}
    got = {"router": params["router"].grad, "wg": params["wg"].grad,
           "wu": params["wu"].grad, "wd": params["wd"].grad, "x": px.grad,
           **{f"shared.{k}": v.grad for k, v in params["shared"].items()}}
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(1e-30, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy() / scale, w / scale,
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(params["router"].grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# route, experts and combine alone
# ---------------------------------------------------------------------------


def _route_by_loop(topi, t, e, cap):
    """Slots handed out token by token, expert by expert: the plain
    reading of the exclusive-cumsum ranks."""
    used = np.zeros(e, np.int64)
    keep = np.zeros(topi.shape, bool)
    tok_ids = np.full((e, cap), t, np.int64)
    for i in range(t):
        for j, ex in enumerate(topi[i]):
            if used[ex] < cap:
                keep[i, j] = True
                tok_ids[ex, used[ex]] = i
            used[ex] += 1
    return keep, tok_ids


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_route_matches_a_loop_and_top_k(cf):
    """topi and topv as ``jax.lax.top_k`` of the same gates; keep and
    tok_ids as a token-by-token loop hands out the slots."""
    _, pcfg, tree = _pair("float32", capacity_factor=cf)
    x = _x(pcfg, s=40)
    logits = torch.from_numpy(x.reshape(-1, pcfg.d_model)) @ \
        torch.from_numpy(tree["router"])
    r = M.route(logits, pcfg)
    t, e = logits.shape
    cap = M.capacity(t, pcfg)
    assert r.tok_ids.shape == (e, cap) and r.tok_ids.dtype == torch.int32
    jv, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1),
                           pcfg.top_k)
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(
        r.topv.numpy() * np.asarray(jv).sum(-1, keepdims=True),
        np.asarray(jv), rtol=1e-6)
    keep, tok_ids = _route_by_loop(r.topi.numpy(), t, e, cap)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.tok_ids.numpy(), tok_ids)
    np.testing.assert_array_equal(r.assign.numpy().sum(1), pcfg.top_k)


def test_route_breaks_ties_as_top_k():
    """Exactly equal gates: the lower expert first, as ``jax.lax.top_k``."""
    _, pcfg, _ = _pair("float32")
    logits = torch.tensor([[0.0] * 8, [1.0, 2.0, 2.0, 0.0, 2.0, 1.0, 1.0,
                                       0.0], [3.0, 1.0, 3.0, 1.0, 0.0, 0.0,
                                              3.0, 3.0]])
    r = M.route(logits, pcfg)
    _, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1),
                          pcfg.top_k)
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(ji))
    assert r.topi.tolist() == [[0, 1], [1, 2], [0, 2]]


@pytest.mark.parametrize("t,k,e,cf,want", [
    (4, 4, 60, 1.25, 1), (4096, 4, 60, 1.25, 341), (1, 4, 60, 15.0, 1),
    (5, 2, 8, 2.0, 2), (15, 2, 8, 2.0, 8), (10, 1, 8, 2.0, 2)])
def test_capacity_is_the_references(t, k, e, cf, want):
    """Python's ``round``: half to even (5 x 2 / 8 x 2 = 2.5 -> 2)."""
    cfg = PCFG.get_config(ARCH).reduced(top_k=k, n_experts=e,
                                        capacity_factor=cf)
    assert M.capacity(t, cfg) == want == int(max(1, round(t * k / e * cf)))


def test_combine_sums_in_expert_order_from_zero():
    """combine equals a float32 scatter-add of the slots in (expert, slot)
    order into zeros, bit for bit, the reference's combine."""
    _, pcfg, tree = _pair("float32", capacity_factor=0.5)
    x = _x(pcfg)
    xt = torch.from_numpy(x.reshape(-1, pcfg.d_model))
    r = M.route(xt @ torch.from_numpy(tree["router"]), pcfg)
    ye = M.experts(xt, r.tok_ids, _port_params(tree), pcfg)
    got = M.combine(ye, r).numpy()
    t = xt.shape[0]
    gate = np.zeros((t, pcfg.n_experts), np.float32)
    np.put_along_axis(gate, r.topi.numpy(), r.topv.numpy(), axis=1)
    want = np.zeros((t + 1, pcfg.d_model), np.float32)
    ids = r.tok_ids.numpy()
    for ex in range(pcfg.n_experts):
        for c in range(ids.shape[1]):
            i = ids[ex, c]
            w = gate[i, ex] if i < t else np.float32(0)
            want[i] += ye[ex, c].numpy() * w
    np.testing.assert_array_equal(got, want[:t])


def test_empty_slots_gather_the_zero_row():
    _, pcfg, tree = _pair("float32", capacity_factor=4.0)
    xt = torch.from_numpy(_x(pcfg, s=4).reshape(-1, pcfg.d_model))
    r = M.route(xt @ torch.from_numpy(tree["router"]), pcfg)
    assert bool((r.tok_ids == xt.shape[0]).any())
    ye = M.experts(xt, r.tok_ids, _port_params(tree), pcfg)
    assert bool((ye[r.tok_ids == xt.shape[0]] == 0).all())


# ---------------------------------------------------------------------------
# Init and names
# ---------------------------------------------------------------------------


def test_init_moe_shapes_dtypes_and_scales():
    jcfg, pcfg, tree = _pair()
    p = M.init_moe(torch.Generator().manual_seed(0), pcfg)
    got = convert.tree_to_numpy(p)
    assert set(got) == set(tree) and set(got["shared"]) == set(
        tree["shared"])
    for k in ("router", "wg", "wu", "wd"):
        assert got[k].shape == tree[k].shape
        assert p[k].dtype == torch.float32
        assert abs(got[k].std() - tree[k].std()) <= 0.1 * tree[k].std(), k
    # the 3-D expert weights draw fan_in = n_experts, as the reference's
    assert abs(got["wg"].std() - pcfg.n_experts ** -0.5) < 0.02


def test_every_public_name_has_a_twin():
    import types
    missing = [n for n, v in vars(JM).items()
               if not n.startswith("_") and not isinstance(
                   v, types.ModuleType)
               and getattr(v, "__module__", JM.__name__).startswith("repro")
               and not hasattr(M, n)]
    assert not missing, missing
    assert M.MOE_TOKEN_CHUNK == JM.MOE_TOKEN_CHUNK
