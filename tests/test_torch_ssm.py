"""The port's hybrid_ssm family (zamba2-7b: ``repro_torch.models.ssm``, the
weight-shared attention block, the ``ssm`` / per-invocation ``k``, ``v``
decode cache) against the JAX package's.

The reference's weights (``init_ssm`` / ``init_model`` from a PRNG key,
numpy arrays) cross to the port through ``models/convert.py``; inputs are
made with numpy from a seed and rounded to the compute type on both sides.
The reference runs under ``jax.jit`` on the CPU, the port on CPU tensors,
so the shared block's attention runs the ``flash_attention`` kernel's
plain version (the kernel is held against it on the card by
``chip_smoke.py``'s hybrid phase).  ``a_log`` and ``dt_bias`` are drawn at
random (the init's zeros give every head the same decay), one head's
``a_log`` at 6 so whole chunks decay to 0.  Most model tests run the
reduced config at 5 layers with the block every 2: invocations after
layers 1 and 3, then a trailing layer without one.

Tolerances, stated where used:

* ``_segsum``: the same ``-inf`` pattern, the finite sums within 1e-6 of
  their scale (float32 cumsums).
* ``ssd_scan`` in float32 within 1e-5 of the output's scale (the same sums,
  the three-operand products grouped as two GEMMs); against a step-by-step
  recurrence within 1e-5.
* Module outputs (``ssm_block``, ``ssm_decode`` and its state), scaled by
  ``max(1, max|want|)``: float32 within 1e-5, bfloat16 within 2**-5 (a
  few bfloat16 ulps: the frameworks round at other places).
* Model logits and caches (five layers, float32): within 1e-4 of their
  scale (``test_torch_models.py``'s).
* float32 gradients (float32 parameters) leaf by leaf against
  ``jax.grad``: within 1e-4 of each leaf's scale (seen: 2.2e-5).
* bfloat16 gradients of ``ssm_block`` against float32 ones: within 2**-5
  of each leaf's scale, on both sides (seen: 1.8e-2 on each).
* One AdamW step: metrics within 1e-5 relative, every parameter within
  2 lr plus one float32 ulp, all but a thousandth within 0.1 lr.
* serve.main (float32 compute, the reference's weights and prompt handed
  to the port, ``--kv-backend ref``): equal tokens, ratios within 1e-3.
"""

import dataclasses
import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.checkpoint import manager as jman
from repro.launch import serve as jserve
from repro.models import decode as JD
from repro.models import ssm as JSSM
from repro.models import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw as JO

from repro_torch import configs as PCFG
from repro_torch.checkpoint import manager as man
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.models import decode as D
from repro_torch.models import ssm as M
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as O

from test_torch_checkpoint import _files
from test_torch_train import _leaves_with_keys

ARCH = "zamba2-7b"
DTYPES = ["float32", "bfloat16"]
#: Five layers, the shared block after layers 1 and 3, none after 4.
FIVE = {"n_layers": 5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (beside other
    test processes, torch's thread a core makes them slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 2.0 ** -5


def _close(got, want, tol, what=""):
    got = convert.to_numpy(got) if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _cfgs(dtype="float32", **over):
    return (JCFG.get_config(ARCH).reduced(compute_dtype=dtype, **over),
            PCFG.get_config(ARCH).reduced(compute_dtype=dtype, **over))


def _randomize(ssm, seed=0):
    """Random ``a_log`` and ``dt_bias`` (numpy, in place) in an ``ssm``
    group, stacked or not; the first head of each layer decays fast
    (``a_log`` 6: ``exp(a dt)`` underflows within a chunk)."""
    rng = np.random.default_rng(seed)
    for k in ("a_log", "dt_bias"):
        ssm[k] = rng.normal(0, 1.0, ssm[k].shape).astype(np.float32)
    ssm["a_log"][..., 0] = 6.0
    return ssm


def _ssm_pair(dtype, **over):
    jcfg, pcfg = _cfgs(dtype, **over)
    tree = _randomize(jax.tree.map(np.asarray, JSSM.init_ssm(
        jax.random.PRNGKey(0), jcfg)))
    return jcfg, pcfg, tree, {k: convert.to_torch(a, "cpu")
                              for k, a in tree.items()}


@functools.lru_cache(maxsize=None)
def _ref_tree(jcfg, seed=0):
    """The reference's ``init_model`` as numpy arrays, ``a_log`` and
    ``dt_bias`` randomized; made once a config."""
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(seed),
                                                  jcfg))
    _randomize(tree["layers"]["ssm"], seed)
    return tree


def _model_pair(dtype="float32", **over):
    jcfg, pcfg = _cfgs(dtype, **over)
    tree = _ref_tree(jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), pcfg,
            convert.params_from_jax(tree, pcfg, "cpu"), tree)


def _x(dtype, shape, seed=1):
    """Unit-normal inputs rounded to ``dtype`` (numpy float32)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _batch(cfg, b=2, s=40, seed=1):
    toks = _tokens(cfg, (b, s), seed)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[0, 3] = -1                      # an ignored position mid-row
    return {"tokens": toks, "labels": labels}


# ---------------------------------------------------------------------------
# models/ssm.py against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over", [{}, {"ssm_heads": 0}])
def test_init_ssm_shapes_and_scales(over):
    """``init_ssm``'s tree: the reference's keys, shapes and dtypes; the
    projections drawn at ``fan_in ** -0.5``, the constants equal (a_log 0,
    d_skip 1, dt_bias 0, norm 1); ``ssm_dims`` as the reference's (with
    ``ssm_heads`` 0 the heads are ``2 d / 64``)."""
    jcfg, pcfg = _cfgs(**over)
    assert M.ssm_dims(pcfg) == JSSM.ssm_dims(jcfg)
    want = JSSM.init_ssm(jax.random.PRNGKey(0), jcfg)
    got = M.init_ssm(T.generator(0, "cpu"), pcfg)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
        if k in ("win", "wout"):
            std = float(g.float().std())
            assert abs(std - w.shape[0] ** -0.5) <= 0.05 * std, k
        else:
            np.testing.assert_array_equal(convert.to_numpy(g),
                                          np.asarray(w, np.float32), k)


@pytest.mark.parametrize("q", [1, 7, 32])
def test_segsum_matches_reference(q):
    a = -np.abs(np.random.default_rng(q).standard_normal(
        (2, 3, 4, q))).astype(np.float32)
    want = np.asarray(JSSM._segsum(jnp.asarray(a)))
    got = M._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2 * 3 * 4 * q * (q - 1) // 2
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want[fin]).max()))


@pytest.mark.parametrize("s,q", [(1, 1), (7, 7), (40, 8), (41, 1), (64, 32),
                                 (96, 32), (100, 4), (32, 32)])
def test_chunk_clamp(s, q):
    """``chunk_len(s, 32)``: capped at s, halved until it divides s (S 40
    -> 8, an odd S past the chunk -> 1); no padding."""
    assert M.chunk_len(s, 32) == q


def _scan_inputs(s, seed=2, b=2, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    b_in = rng.standard_normal((b, s, n)).astype(np.float32)
    c_in = rng.standard_normal((b, s, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(0, 1, h)).astype(np.float32)
    a[0] = -400.0            # a head whose chunks decay to 0
    return x, b_in, c_in, dt, a


def _recurrence(x, b_in, c_in, dt, a):
    """The SSD as its step-by-step recurrence (float64 numpy): h = exp(dt
    a) h + dt B (x) x, y = C . h."""
    bsz, s, h, p = x.shape
    state = np.zeros((bsz, h, b_in.shape[-1], p))
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t] * a)
        state = state * da[..., None, None] + np.einsum(
            "bn,bhp->bhnp", b_in[:, t], x[:, t] * dt[:, t, :, None])
        ys.append(np.einsum("bn,bhnp->bhp", c_in[:, t], state))
    return np.stack(ys, 1)


@pytest.mark.parametrize("s", [1, 7, 40, 64, 96])
def test_ssd_scan_matches_reference(s):
    """Against chunk 32: S 1 and 7 (odd: chunks of 1), 40 (chunks of 8),
    64 (2 chunks), 96 (3): the reference's ``ssd_scan`` within 1e-5 of the
    output's scale, and a float64 step-by-step recurrence within 1e-5."""
    args = _scan_inputs(s)
    want = np.asarray(jax.jit(lambda *t: JSSM.ssd_scan(*t, 32))(
        *map(jnp.asarray, args)))
    got = M.ssd_scan(*map(torch.from_numpy, args), 32).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 1e-5 * scale
    rec = _recurrence(*(t.astype(np.float64) for t in args))
    assert np.abs(got - rec).max() <= 1e-5 * scale


def test_ssd_scan_gradients_are_finite_where_chunks_decay_to_zero():
    """A head with ``a`` -400 decays to exactly 0 inside every chunk
    (``exp`` underflows): the ``-inf`` of ``_segsum`` and the underflow
    give no nan in any input's gradient, and the gradients match
    ``jax.grad`` of the reference's ``ssd_scan`` within 1e-5 of their
    scale."""
    args = _scan_inputs(64, seed=3)
    ct = np.random.default_rng(4).standard_normal(
        args[0].shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda *t: jnp.sum(JSSM.ssd_scan(*t, 32) * ct),
                            argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in args]
    (M.ssd_scan(*leaves, 32) * torch.from_numpy(ct)).sum().backward()
    for t, w in zip(leaves, want):
        g = t.grad.numpy()
        w = np.asarray(w)
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_block_matches_reference(dtype):
    jcfg, pcfg, tree, pp = _ssm_pair(dtype)
    x = _x(dtype, (2, 40, pcfg.d_model))
    want = jax.jit(lambda x, p: JSSM.ssm_block(x, p, jcfg))(
        jnp.asarray(x).astype(jcfg.cdt), jax.tree.map(jnp.asarray, tree))
    got = M.ssm_block(torch.from_numpy(x).to(pcfg.cdt), pp, pcfg)
    assert got.dtype == pcfg.cdt
    _close(got, want, _tol(dtype), "ssm_block")


def _block_grads(cfg, tree, x, ct, dtype, port):
    """Gradients of ``sum(ssm_block(x) * ct)`` w.r.t. x and every
    parameter (numpy float32), in ``dtype``: bf16 rounds x and the bf16
    parameters, float32 computes everything in float32."""
    if port:
        pp = {k: convert.to_torch(a, "cpu").to(
            torch.float32 if dtype == "float32" else None).requires_grad_(
                True) for k, a in tree.items()}
        px = torch.from_numpy(x).to(cfg.cdt).requires_grad_(True)
        (M.ssm_block(px, pp, cfg).float() * torch.from_numpy(ct)).sum() \
            .backward()
        return {"x": px.grad.float().numpy(),
                **{k: v.grad.float().numpy() for k, v in pp.items()}}
    p = {k: jnp.asarray(a).astype(jnp.float32) if dtype == "float32"
         else jnp.asarray(a) for k, a in tree.items()}
    gx, gp = jax.jit(jax.grad(lambda x, p: jnp.sum(JSSM.ssm_block(
        x, p, cfg).astype(jnp.float32) * ct), argnums=(0, 1)))(
            jnp.asarray(x).astype(cfg.cdt), p)
    return {"x": np.asarray(gx, np.float32),
            **{k: np.asarray(v, np.float32) for k, v in gp.items()}}


def test_ssm_block_gradients_match_reference():
    """float32 (float32 parameters): every gradient within 1e-5 of its
    scale of ``jax.grad``'s.  bfloat16: each side's gradients within 2**-5
    of each leaf's scale of the float32 ones (the frameworks round apart,
    so bf16 is held to the float32 truth, not to the reference's bf16)."""
    jcfg, pcfg, tree, _ = _ssm_pair("bfloat16")
    j32, p32 = _cfgs("float32", param_dtype="float32")
    x = _x("bfloat16", (2, 32, pcfg.d_model))
    ct = _x("bfloat16", (2, 32, pcfg.d_model), seed=5)
    truth = _block_grads(j32, tree, x, ct, "float32", port=False)
    got32 = _block_grads(p32, tree, x, ct, "float32", port=True)
    jb = _block_grads(jcfg, tree, x, ct, "bfloat16", port=False)
    pb = _block_grads(pcfg, tree, x, ct, "bfloat16", port=True)
    assert sorted(truth) == sorted(pb) == ["a_log", "d_skip", "dt_bias",
                                           "norm", "win", "wout", "x"]
    for k, w in truth.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        assert np.abs(got32[k] - w).max() <= 1e-5 * scale, k
        for side in (jb, pb):
            assert np.abs(side[k] - w).max() <= 2.0 ** -5 * scale, k


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_matches_reference(dtype):
    """Six steps from a random float32 state: each step's output and the
    (B, H, N, P) state; the caller's state tensor is not written."""
    jcfg, pcfg, tree, pp = _ssm_pair(dtype)
    dv, h, ph = M.ssm_dims(pcfg)
    rng = np.random.default_rng(3)
    st = rng.standard_normal((2, h, pcfg.ssm_state, ph)).astype(np.float32)
    jst, pst = jnp.asarray(st), torch.from_numpy(st.copy())
    x = _x(dtype, (2, 6, pcfg.d_model), seed=4)
    jstep = jax.jit(lambda x, p, s: JSSM.ssm_decode(x, p, jcfg, s))
    jp = jax.tree.map(jnp.asarray, tree)
    for t in range(6):
        jo, jst = jstep(jnp.asarray(x[:, t:t + 1]).astype(jcfg.cdt), jp, jst)
        before = pst.clone()
        po, new = M.ssm_decode(torch.from_numpy(x[:, t:t + 1]).to(pcfg.cdt),
                               pp, pcfg, pst)
        assert torch.equal(pst, before)
        assert new.dtype == torch.float32 and tuple(new.shape) == (
            2, h, pcfg.ssm_state, ph)
        pst = new
        _close(po, jo, _tol(dtype), f"out {t}")
        _close(pst, jst, _tol(dtype), f"state {t}")


def test_decode_continues_the_block():
    """The recurrence after a prefill: ``ssm_decode`` over 40 tokens from a
    zero state gives ``ssm_block``'s output at every position (float32,
    within 1e-5), and the state it ends with, continued 8 more steps,
    gives ``ssm_block``'s last 8 outputs over all 48 tokens."""
    _, pcfg, _, pp = _ssm_pair("float32")
    dv, h, ph = M.ssm_dims(pcfg)
    x = torch.from_numpy(_x("float32", (2, 48, pcfg.d_model), seed=6))
    full = M.ssm_block(x, pp, pcfg)
    first = M.ssm_block(x[:, :40], pp, pcfg)
    st = torch.zeros((2, h, pcfg.ssm_state, ph))
    outs = []
    for t in range(48):
        o, st = M.ssm_decode(x[:, t:t + 1], pp, pcfg, st)
        outs.append(o)
        if t == 39:
            _close(torch.cat(outs, 1), first.numpy(), 1e-5, "prefill")
    _close(torch.cat(outs, 1)[:, 40:], full[:, 40:].numpy(), 1e-5,
           "continued")


# ---------------------------------------------------------------------------
# The family: forward, decode by invocation, gradients
# ---------------------------------------------------------------------------


def test_the_family_is_ported():
    assert "hybrid_ssm" in T.FAMILIES and T.UNPORTED_FAMILIES == {}
    for cfg in (PCFG.get_config(ARCH), PCFG.get_config(ARCH).reduced()):
        T.check_family(cfg)
    assert D.n_invocations(PCFG.get_config(ARCH)) == 13
    assert D.n_invocations(_cfgs(**FIVE)[1]) == 2


def _shared_calls(monkeypatch):
    """Record the parameters of each dense-block run of the forward."""
    seen = []
    real_dense = T._dense_layer

    def dense(x, p, cfg, positions, **kw):
        seen.append(p)
        return real_dense(x, p, cfg, positions, **kw)

    monkeypatch.setattr(T, "_dense_layer", dense)
    return seen


def test_forward_at_five_layers_matches_reference(monkeypatch):
    """Five layers, the block every 2, float32: the prefill logits against
    the reference's within 1e-4 of their scale; the shared block runs
    twice, with the one ``shared_attn`` dict.  (bfloat16 runs at the
    reduced two layers in ``test_torch_models.py``: over five layers the
    frameworks' bf16 roundings add up past its 5e-2.)"""
    jcfg, jp, pcfg, pp, _ = _model_pair("float32", **FIVE)
    assert len(pp["layers"]) == 5 and "shared_attn" in pp
    toks = _tokens(pcfg, (2, 40))
    want = jax.jit(JS.make_prefill_step(jcfg))(jp, jnp.asarray(toks))
    seen = _shared_calls(monkeypatch)
    got = S.make_prefill_step(pcfg)(pp, torch.from_numpy(toks))
    assert len(seen) == 2 and all(p is pp["shared_attn"] for p in seen)
    assert got.dtype == pcfg.cdt and tuple(got.shape) == (2, 40, pcfg.vocab)
    _close(got, want, 1e-4, "logits")


def test_decode_by_invocation_past_the_window_matches_reference():
    """Five layers, the block every 2, float32, 40 steps into a 48-token
    request (the cache capped at the reduced window, 32): each step's
    logits and the whole cache (``ssm`` per layer, ``k`` and ``v`` per
    invocation) against the reference's within 1e-4 of their scale; both
    invocations' entries are written, the clamp ``min(idx // every,
    n_attn - 1)`` never binds."""
    jcfg, jp, pcfg, pp, _ = _model_pair("float32", **FIVE)
    toks = _tokens(pcfg, (2, 40), seed=2)
    spec = D.cache_spec(pcfg, 2, 48)
    assert {k: v[0] for k, v in spec.items()} == {
        "ssm": (5, 2, 4, 16, 64), "k": (2, 2, 32, 2, 32),
        "v": (2, 2, 32, 2, 32)}
    jcache = JD.init_cache(jcfg, 2, 48)
    pcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    jstep = jax.jit(JS.make_serve_step(jcfg))
    pstep = S.make_serve_step(pcfg)
    tol = 1e-4
    for t in range(40):
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        pl, pcache = pstep(pp, torch.from_numpy(toks[:, t:t + 1]), pcache, t)
        _close(pl, jl, tol, f"logits {t}")
        for k in ("ssm", "k", "v"):
            _close(pcache[k], jcache[k], tol, f"{k} {t}")
    for k in ("k", "v"):
        assert all(bool(pcache[k][i].ne(0).any(-1).all()) for i in (0, 1))
    assert pcache["ssm"].dtype == torch.float32


def test_decode_past_the_window_departs_from_forward_on_both_sides():
    """The reference's hybrid decode passes no window to ``decode_attn``:
    past the window (32) a step writes the last slot and attends every
    slot, where the forward masks by the window.  Up to the window the
    port's decode gives the forward's logits (float32, 1e-4); past it
    both packages' decodes depart from their forwards alike (ROADMAP §C
    records the reference's fault, which the port keeps)."""
    jcfg, jp, pcfg, pp, _ = _model_pair("float32")
    toks = _tokens(pcfg, (1, 40), seed=7)
    full = S.make_prefill_step(pcfg)(pp, torch.from_numpy(toks)).numpy()
    jfull = np.asarray(jax.jit(JS.make_prefill_step(jcfg))(
        jp, jnp.asarray(toks)))
    cache = D.init_cache(pcfg, 1, 48, "cpu")
    jcache = JD.init_cache(jcfg, 1, 48)
    step, jstep = S.make_serve_step(pcfg), jax.jit(JS.make_serve_step(jcfg))
    off, joff = [], []
    for t in range(40):
        lg, cache = step(pp, torch.from_numpy(toks[:, t:t + 1]), cache, t)
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        off.append(float(np.abs(lg[0, 0].numpy() - full[0, t]).max()))
        joff.append(float(np.abs(np.asarray(jl[0, 0]) - jfull[0, t]).max()))
    assert max(off[:32]) <= 1e-4 and max(joff[:32]) <= 1e-4
    assert min(off[33:]) > 1e-2 and min(joff[33:]) > 1e-2
    np.testing.assert_allclose(off, joff, rtol=1e-2, atol=1e-4)


def test_float32_gradients_match_reference():
    """Five layers, float32 parameters and compute, remat on: the loss and
    every gradient leaf, ``shared_attn``'s the sum over its two
    invocations (each recomputed under the checkpoint), against
    ``jax.grad`` within 1e-4 of each leaf's scale; no nan (a head whose
    chunks decay to 0), and every ``ssm`` and ``shared_attn`` leaf of
    every layer gets a gradient."""
    jcfg, jp, pcfg, pp, _ = _model_pair("float32", param_dtype="float32",
                                        **FIVE)
    assert pcfg.remat
    batch = _batch(pcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(p, b, jcfg), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (pl, _), pg = S.grads_of(pp, {k: torch.from_numpy(v) for k, v in
                                  batch.items()}, pcfg)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    want = _leaves_with_keys(jax.tree.map(np.asarray, jg))
    got = _leaves_with_keys(convert.params_to_numpy(pg))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("shared_attn.") for k in got)
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = float(np.abs(w).max())
        assert np.abs(got[k] - w).max() <= 1e-4 * scale, k
        if ".ssm." in k:
            assert all(float(np.abs(w_l).max()) > 0 for w_l in got[k]), k
        if k.startswith("shared_attn."):
            assert scale > 0, k


def test_remat_checkpoints_each_layer_with_its_block(monkeypatch):
    """Under ``remat`` each of the five layers runs inside one
    ``torch.utils.checkpoint`` (its SSM layer and, after layers 1 and 3,
    the shared block); the gradients equal those without remat bit for
    bit."""
    from torch.utils import checkpoint as ckpt

    _, _, pcfg, pp, _ = _model_pair("float32", param_dtype="float32", **FIVE)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pcfg).items()}
    calls = []
    real = ckpt.checkpoint

    def spy(fn, *a, **kw):
        if fn is T._hybrid_layer:
            calls.append(a[3])
        return real(fn, *a, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", spy)
    (_, _), on = S.grads_of(pp, batch, pcfg)
    monkeypatch.undo()
    assert calls == [0, 1, 2, 3, 4]
    off_cfg = dataclasses.replace(pcfg, remat=False)
    (_, _), off = S.grads_of(pp, batch, off_cfg)
    a = _leaves_with_keys(convert.params_to_numpy(on))
    b = _leaves_with_keys(convert.params_to_numpy(off))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_step_matches_reference():
    """One float32 AdamW step (float32 parameters, five layers): the
    metrics within 1e-5 relative; every parameter within 2 lr plus one
    float32 ulp of the reference's, all but a thousandth within 0.1 lr
    plus one ulp (AdamW's first step moves a parameter by about ``lr *
    sign(g)``: a near-zero gradient whose sign the two frameworks'
    float32 sums set apart moves it by up to 2 lr, as
    ``test_torch_train.py``'s new families see)."""
    lr = 1e-3
    jcfg, jp, pcfg, pp, _ = _model_pair("float32", param_dtype="float32",
                                        **FIVE)
    batch = _batch(pcfg)
    jstep = jax.jit(JS.make_train_step(jcfg, JO.AdamWConfig(lr=lr)))
    jnew, _, jmet = jstep(jp, JO.init(jp, JO.AdamWConfig(lr=lr)),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    ocfg = O.AdamWConfig(lr=lr)
    pnew, pst, pmet = S.make_train_step(pcfg, ocfg)(
        pp, O.init(pp, ocfg), {k: torch.from_numpy(v) for k, v in
                               batch.items()})
    assert sorted(pmet) == sorted(jmet)
    for k in ("ce", "aux", "loss", "grad_norm"):
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    want = _leaves_with_keys(jax.tree.map(np.asarray, jnew))
    got = _leaves_with_keys(convert.params_to_numpy(pnew))
    assert sorted(got) == sorted(want)
    n = off = 0
    for k, w in want.items():
        ulp = 2.0 ** -23 * np.abs(w)
        d = np.abs(got[k] - w)
        assert (d <= 2 * lr + ulp).all(), k
        n, off = n + d.size, off + int((d > 0.1 * lr + ulp).sum())
    assert off <= 1e-3 * n, (off, n)
    assert int(pst["step"]) == 1


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def test_train_main_preempts_and_resumes(tmp_path, capsys):
    """launch/train.py on the reduced zamba2: preempted after step 0 (exit
    17), resumed from its raw checkpoint; two steps with finite losses,
    those of an uninterrupted run; the checkpoint holds the shared block
    as one group (``params.shared_attn.*``, no layer axis)."""
    base = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-every", "1", "--log-every", "1",
            "--device", "cpu"]

    def losses(out):
        return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
            r"\[train\] step=(\d+) loss=([-\d.]+)", out)}

    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as e:
        train.main(base + ["--ckpt-dir", d, "--preempt-at", "0"])
    assert e.value.code == 17
    before = losses(capsys.readouterr().out)
    train.main(base + ["--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "[train] resumed from step 0" in out
    resumed = losses(out)
    train.main(base + ["--ckpt-dir", str(tmp_path / "whole")])
    whole = losses(capsys.readouterr().out)
    assert sorted(whole) == [0, 1] and all(np.isfinite(v) for v in
                                           whole.values())
    assert whole == {**before, **resumed}
    entries = json.load(open(os.path.join(d, "step_00000001",
                                          "manifest.json")))["entries"]
    cfg = PCFG.get_config(ARCH).reduced()
    assert entries["params.shared_attn.attn.wq"]["shape"] == [
        cfg.d_model, cfg.n_heads, cfg.head_dim]
    assert entries["params.layers.ssm.win"]["shape"][0] == cfg.n_layers


def test_checkpoint_round_trip_byte_identical(tmp_path):
    """The reduced zamba2 (five layers) and its AdamW state after one
    reference step, saved by both packages' managers (the port's tree
    through ``convert.stack_layers``): the same files byte for byte; the
    port's restore of either directory gives the leaves back bit for bit,
    and ``unstack_layers`` gives five layers and the ``shared_attn``
    group as it was."""
    from test_torch_stream import as_bytes

    jcfg, jp, pcfg, _, tree = _model_pair("float32", **FIVE)
    jocfg = JO.AdamWConfig()
    _, jstate, _ = jax.jit(JS.make_train_step(jcfg, jocfg))(
        jp, JO.init(jp, jocfg), {k: jnp.asarray(v) for k, v in
                                 _batch(pcfg).items()})
    jstate = jax.tree.map(np.asarray, jstate)
    params = convert.params_from_jax(tree, pcfg, "cpu")
    state = convert.opt_state_from_jax(jstate, pcfg, "cpu")
    tm = man.CheckpointManager(str(tmp_path / "port"), device="cpu")
    jm = jman.CheckpointManager(str(tmp_path / "jax"))
    tm.save(1, convert.sorted_tree(convert.stack_layers(params)),
            convert.opt_state_stacked(state))
    jm.save(1, jp, jax.tree.map(jnp.asarray, jstate))
    got, want = (_files(os.path.join(m.dir, "step_00000001"))
                 for m in (tm, jm))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    entries = json.loads(want["manifest.json"])["entries"]
    assert {"params.shared_attn.mlp.wg", "params.layers.ssm.a_log",
            "opt.m.shared_attn.attn.wo"} <= set(entries)
    for src in (tm.dir, jm.dir):
        r = man.CheckpointManager(src, device="cpu").restore()
        back = convert.unstack_layers(r["params"])
        assert len(back["layers"]) == 5
        for k, v in _leaves_with_keys(convert.tree_to_numpy(
                back["shared_attn"])).items():
            w = convert.to_numpy(_get(params["shared_attn"], k))
            assert as_bytes(torch.from_numpy(v)) == as_bytes(
                torch.from_numpy(w)), k
        for i in (0, 4):
            assert torch.equal(back["layers"][i]["ssm"]["win"],
                               params["layers"][i]["ssm"]["win"])


def _get(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("flag", [[], ["--compress-kv"],
                                  ["--kv-offload", "--kv-block", "4"]])
def test_serve_main_matches_reference(flag, monkeypatch):
    """Both packages' serve.main on the reduced zamba2: plain, with the
    whole cache (``ssm`` state, ``k``, ``v``) compressed
    (``--compress-kv``), or with ``k`` and ``v`` paged through the store
    (``--kv-offload``; the ``ssm`` state has no token axis): the
    reference's weights and prompt handed to the port, float32 compute,
    ``--kv-backend ref``: the same tokens and pages; the ratio within
    1e-3 relative (the two frameworks' float32 caches round apart, the
    ``ssm`` state's sums most, and a few codes then fall on the other side
    of a quantization step: a few bytes of payload)."""
    argv = ["--arch", ARCH, "--reduced", "--kv-backend", "ref", "--batch",
            "2", "--prompt-len", "8", "--gen-len", "3", *flag]
    for mod in (serve, jserve):
        real = mod.configs.get_config
        monkeypatch.setattr(mod.configs, "get_config", lambda a, real=real:
                            dataclasses.replace(real(a),
                                                compute_dtype="float32"))
    cfg = JCFG.get_config(ARCH).reduced()
    key = jax.random.PRNGKey(0)
    tree = jax.tree.map(np.asarray, JT.init_model(key, cfg))
    prompt = np.asarray(jax.random.randint(key, (2, 8), 0, cfg.vocab))
    monkeypatch.setattr(serve.T, "init_model", lambda seed, c, device:
                        convert.params_from_jax(tree, c, device))
    monkeypatch.setattr(serve, "_prompt", lambda *a, **kw:
                        torch.from_numpy(prompt.astype(np.int64)))
    got = serve.main([*argv, "--device", "cpu"])
    want = jserve.main(argv)
    assert got["tokens"].shape == want["tokens"].shape == (2, 4)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    if flag:
        assert got["ratio"] == pytest.approx(want["ratio"], rel=1e-3)
        assert got["ratio"] > 0
    if "--kv-offload" in flag:
        # two blocks of 4 tokens, each of k and v (the ssm state stays)
        assert got["page_stats"]["pages_out"] == \
            want["page_stats"]["pages_out"] == 2


def test_sharding_rules_on_the_ports_tree(monkeypatch):
    """The ``ssm/win`` and ``ssm/wout`` rules and the shared block's
    attention and MLP rules on the port's own tree, stacked by
    ``convert.stack_layers``: the reference's specs on its tree leaf for
    leaf; as the port's list of layers, each layer's spec is the
    reference's without its leading layer axis; the ``ssm`` cache's spec
    is the reference's."""
    from types import SimpleNamespace

    import torch.utils._pytree as pytree

    from repro.runtime import sharding as jsh

    from repro_torch.runtime import sharding as sh

    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    jcfg = JCFG.get_config(ARCH).reduced()
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    own = T.init_model(0, PCFG.get_config(ARCH).reduced(), "cpu")
    for ax in ({"data": 4, "model": 2}, {"data": 2, "model": 4}):
        mesh = SimpleNamespace(shape=dict(ax), axis_names=tuple(ax))
        want = {jax.tree_util.keystr(kp).replace("['", "").replace(
            "']", "/").rstrip("/"): tuple(s) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                jsh.param_shardings(shapes, mesh),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            [0]}
        assert want["layers/ssm/win"] != ()
        stacked = sh.param_shardings(
            convert.sorted_tree(convert.stack_layers(own)), mesh)
        for kp, s in pytree.tree_flatten_with_path(stacked)[0]:
            assert tuple(s.spec) == want[sh._path_str(kp)], kp
        listed = sh.param_shardings(own, mesh)
        for kp, s in pytree.tree_flatten_with_path(listed)[0]:
            path = sh._path_str(kp).split("/")
            if path[0] == "layers":
                ref = want["/".join([path[0]] + path[2:])]
                assert not ref or ref[0] is None, path
                assert tuple(s.spec) == tuple(ref[1:]), path
            else:
                assert tuple(s.spec) == want["/".join(path)], path
        cs = {k: jax.ShapeDtypeStruct(shape, dt) for k, (shape, dt) in
              JD.cache_spec(jcfg, 8, 64).items()}
        got = sh.cache_shardings({k: torch.empty(v.shape, device="meta")
                                  for k, v in cs.items()}, mesh, jcfg)
        ref = jsh.cache_shardings(cs, mesh, jcfg)
        for k in ("ssm", "k", "v"):
            assert tuple(got[k].spec) == tuple(ref[k]), k
