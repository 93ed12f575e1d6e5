"""The port's RWKV-6 recurrence (``gla_time_mix``), ``time_mix`` and
``channel_mix`` against the JAX package's.

The same inputs, made with numpy from a seed, go through the Pallas kernel
``repro.kernels.rwkv_gla.gla_time_mix`` in interpret mode (as its own tests
run it) and the port's wrapper on CPU tensors, which runs the plain version
(the CUDA kernel itself is held against the plain version on the card:
``tests/test_torch_cuda.py``, ``chip_smoke.py``); and through the
reference's ``models/rwkv.py`` functions under ``jax.jit`` and the port's.
Tolerances: the recurrence 1e-4 (the reference test's; float32 sums over
dk in another order); ``time_mix`` and ``channel_mix`` 1e-5 in float32.

Training: ``gla_time_mix_trainable``'s six gradients (r, k, v, w, u and the
state in) against autograd through the plain recurrence in one piece,
1e-5 of their scale (the same recurrence, differentiated by hand, chunk
by chunk: float32 sums in another order); ``time_mix``'s
gradients against ``jax.grad`` through the reference's ``time_mix`` (its
checkpointed chunk scan), rtol 1e-4 / atol 1e-6 of each gradient's
largest value (random weights give gradients up to ~10, whose float32
sums in another order move the entries near zero by a few 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JCFG
from repro.kernels.rwkv_gla import gla_time_mix as jgla
from repro.models import rwkv as JR

from repro_torch import configs as PCFG
from repro_torch.kernels import rwkv_gla as GLA
from repro_torch.models import rwkv as R


def _inputs(bh, s, dk, dv, seed, w=None):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((bh, s, dk)).astype(np.float32)
    k = rng.standard_normal((bh, s, dk)).astype(np.float32)
    v = rng.standard_normal((bh, s, dv)).astype(np.float32)
    w = (rng.uniform(0.1, 0.999, (bh, s, dk)).astype(np.float32) if w is None
         else np.full((bh, s, dk), w, np.float32))
    u = rng.standard_normal((bh, dk)).astype(np.float32)
    return r, k, v, w, u


def _port(*arrays, state=None):
    before = GLA.gla_time_mix.launches
    y, st = GLA.gla_time_mix(*map(torch.from_numpy, arrays),
                             None if state is None
                             else torch.from_numpy(state))
    assert GLA.gla_time_mix.launches == before     # CPU: the plain version
    return y.numpy(), st.numpy()


def _numpy_ref(r, k, v, w, u, state):
    """The recurrence step by step in numpy, state in and out."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append((r[:, t, :, None] * (state + u[:, :, None] * kv)).sum(1))
        state = w[:, t, :, None] * state + kv
    return np.stack(ys, 1), state


@pytest.mark.parametrize("bh,s,dk,dv,chunk", [
    (2, 64, 8, 8, 16),
    (4, 128, 16, 16, 32),
    (1, 96, 32, 16, 32),   # dk != dv, s not a power of two
    (3, 64, 64, 64, 64),   # full rwkv6 head dims, single chunk
])
def test_plain_matches_pallas(bh, s, dk, dv, chunk):
    r, k, v, w, u = _inputs(bh, s, dk, dv, bh * s + dk)
    want = np.asarray(jgla(*map(jnp.asarray, (r, k, v, w, u)), chunk=chunk))
    y, _ = _port(r, k, v, w, u)
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)


def test_extreme_decay_stable():
    """w near 0 (hard forget) must not produce NaN/inf."""
    r, k, v, w, _ = _inputs(2, 64, 16, 16, 0, w=1e-6)
    u = np.zeros((2, 16), np.float32)
    want = np.asarray(jgla(*map(jnp.asarray, (r, k, v, w, u)), chunk=16))
    y, st = _port(r, k, v, w, u)
    assert np.isfinite(y).all() and np.isfinite(st).all()
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch,heads", [(1, 4), (3, 2)])
def test_per_head_u_matches_pallas(batch, heads):
    """u (H, dk) is shared by the batch: row bh uses u[bh % H], which the
    Pallas kernel computes from u tiled to (B * H, dk)."""
    bh = batch * heads
    r, k, v, w, _ = _inputs(bh, 32, 16, 16, bh)
    u = np.random.default_rng(9).standard_normal((heads, 16)).astype(
        np.float32)
    want = np.asarray(jgla(*map(jnp.asarray, (r, k, v, w,
                                               np.tile(u, (batch, 1)))),
                           chunk=16))
    y, _ = _port(r, k, v, w, u)
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_state_in_and_out(s):
    """A non-zero state in: y and the state out against the recurrence in
    numpy; a zero state in is the reference kernel's."""
    r, k, v, w, u = _inputs(3, s, 16, 8, 100 + s)
    state = np.random.default_rng(s).standard_normal((3, 16, 8)).astype(
        np.float32)
    y, st = _port(r, k, v, w, u, state=state)
    want_y, want_st = _numpy_ref(r, k, v, w, u, state)
    np.testing.assert_allclose(y, want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st, want_st, rtol=1e-4, atol=1e-4)
    y0, _ = _port(r, k, v, w, u, state=np.zeros_like(state))
    y_none, _ = _port(r, k, v, w, u)
    np.testing.assert_array_equal(y0, y_none)


def test_wrapper_checks():
    r = torch.zeros((4, 5, 16))
    u = torch.zeros((2, 16))
    with pytest.raises(TypeError):
        GLA.gla_time_mix(r.double(), r.double(), r.double(), r.double(),
                         u.double())
    with pytest.raises(ValueError, match="u must be"):
        GLA.gla_time_mix(r, r, r, r, torch.zeros((3, 16)))
    with pytest.raises(ValueError, match="state"):
        GLA.gla_time_mix(r, r, r, r, u, torch.zeros((4, 16, 8)))
    with pytest.raises(ValueError, match="dk"):
        wide = torch.zeros((4, 5, 65))
        GLA.gla_time_mix(wide, wide, r, wide, torch.zeros((2, 65)))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((4, 16, 5)).transpose(1, 2)
        GLA.gla_time_mix(t, r, r, r, u)


# ---------------------------------------------------------------------------
# time_mix and channel_mix against the reference's
# ---------------------------------------------------------------------------


def _layer_params(cfg, seed):
    """Random time-mix and channel-mix parameters (numpy, float32), with
    u != 0 and decays that vary, unlike the init."""
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.d_ff
    h, dh = JR.rwkv_dims(cfg)

    def n(*shape, scale=None):
        scale = shape[0] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tmix = {"mix": rng.uniform(0, 1, (5, d)).astype(np.float32),
            "wr": n(d, d), "wk": n(d, d), "wv": n(d, d), "wg": n(d, d),
            "w0": rng.uniform(-6, -1, d).astype(np.float32),
            "w_lora_a": n(d, 64), "w_lora_b": n(64, d, scale=0.3),
            "u": n(h, dh, scale=0.5), "wo": n(d, d),
            "ln_x": rng.uniform(0.5, 1.5, d).astype(np.float32)}
    cmix = {"mix": rng.uniform(0, 1, (2, d)).astype(np.float32),
            "wk": n(d, ff), "wv": n(ff, d), "wr": n(d, d)}
    return tmix, cmix


@pytest.mark.parametrize("s", [1, 24, 128])
def test_time_mix_matches_reference(s):
    jcfg = JCFG.get_config("rwkv6-3b").reduced(compute_dtype="float32")
    pcfg = PCFG.get_config("rwkv6-3b").reduced(compute_dtype="float32")
    tmix, _ = _layer_params(jcfg, s)
    h, dh = JR.rwkv_dims(jcfg)
    rng = np.random.default_rng(s + 1)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, h, dh, dh)).astype(np.float32)
    jy, jprev, jst = jax.jit(lambda *a: JR.time_mix(*a, jcfg))(
        jnp.asarray(x), jnp.asarray(x_prev), jnp.asarray(state),
        jax.tree.map(jnp.asarray, tmix))
    py, pprev, pst = R.time_mix(
        torch.from_numpy(x), torch.from_numpy(x_prev),
        torch.from_numpy(state), {k: torch.from_numpy(v)
                                  for k, v in tmix.items()}, pcfg)
    for got, want in ((py, jy), (pprev, jprev), (pst, jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 24])
def test_channel_mix_matches_reference(s):
    jcfg = JCFG.get_config("rwkv6-3b").reduced(compute_dtype="float32")
    pcfg = PCFG.get_config("rwkv6-3b").reduced(compute_dtype="float32")
    _, cmix = _layer_params(jcfg, 50 + s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    jy, jprev = jax.jit(lambda *a: JR.channel_mix(*a, jcfg))(
        jnp.asarray(x), jnp.asarray(x_prev), jax.tree.map(jnp.asarray, cmix))
    py, pprev = R.channel_mix(torch.from_numpy(x), torch.from_numpy(x_prev),
                              {k: torch.from_numpy(v)
                               for k, v in cmix.items()}, pcfg)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pprev.numpy(), np.asarray(jprev))


def test_recurrence_inputs_layout():
    """time_mix hands the kernel (B * H, S, 64) rows, b-major, and u (H,
    64): the layout the per-head u indexing assumes."""
    cfg = PCFG.get_config("rwkv6-3b").reduced(compute_dtype="float32")
    h, dh = R.rwkv_dims(cfg)
    x = torch.arange(2 * 3 * cfg.d_model, dtype=torch.float32).reshape(
        2, 3, cfg.d_model)
    p = {"u": torch.zeros((h, dh))}
    r, k, v, w, u = R.recurrence_inputs(x, x, x, x, p, cfg)
    assert r.shape == (2 * h, 3, dh) and r.is_contiguous()
    assert u is p["u"]
    b, hh, t = 1, 1, 2
    torch.testing.assert_close(r[b * h + hh, t],
                               x[b, t, hh * dh:(hh + 1) * dh])


# ---------------------------------------------------------------------------
# Training: gla_time_mix_trainable and time_mix's gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,s,dk,dv,h,chunk,with_state", [
    (4, 150, 16, 8, 2, 64, True),      # three chunks, a ragged tail
    (2, 40, 8, 8, 1, 64, False),       # one chunk, shorter than CHUNK
    (6, 33, 16, 24, 3, 8, True),       # many chunks, dv != dk
])
def test_gla_trainable_matches_autograd_of_plain(bh, s, dk, dv, h, chunk,
                                                 with_state):
    r, k, v, w, _ = _inputs(bh, s, dk, dv, bh * s + chunk)
    rng = np.random.default_rng(s)
    u = rng.standard_normal((h, dk)).astype(np.float32)
    state = rng.standard_normal((bh, dk, dv)).astype(np.float32)
    dy = rng.standard_normal((bh, s, dv)).astype(np.float32)
    dst = rng.standard_normal((bh, dk, dv)).astype(np.float32)

    def run(fn, **kw):
        ins = [torch.from_numpy(a).requires_grad_(True)
               for a in (r, k, v, w, u)]
        st = (torch.from_numpy(state).requires_grad_(True) if with_state
              else None)
        y, st_out = fn(*ins, st, **kw)
        (y * torch.from_numpy(dy)).sum().add_(
            (st_out * torch.from_numpy(dst)).sum()).backward()
        grads = [t.grad for t in ins] + ([st.grad] if with_state else [])
        return y.detach(), st_out.detach(), grads

    before = GLA.gla_time_mix.launches
    y, st, got = run(GLA.gla_time_mix_trainable, chunk=chunk)
    assert GLA.gla_time_mix.launches == before       # CPU: the plain version
    py, pst, want = run(GLA.gla_time_mix_plain)
    np.testing.assert_array_equal(y.numpy(), py.numpy())
    np.testing.assert_array_equal(st.numpy(), pst.numpy())
    assert len(got) == 6 if with_state else 5
    for g, ww in zip(got, want):
        assert g.shape == ww.shape
        np.testing.assert_allclose(g.numpy(), ww.numpy(), rtol=0,
                                   atol=1e-5 * max(1, float(
                                       ww.abs().max())))


def test_time_mix_trainable_only_while_recording(monkeypatch):
    cfg = PCFG.get_config("rwkv6-3b").reduced(compute_dtype="float32")
    tmix, _ = _layer_params(cfg, 3)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in tmix.items()}
    calls = []
    real = GLA.gla_time_mix_trainable
    monkeypatch.setattr(GLA, "gla_time_mix_trainable",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.randn(1, 5, cfg.d_model)
    prev = torch.zeros(1, cfg.d_model)
    R.time_mix(x, prev, None, p, cfg)
    assert calls == [1]
    with torch.no_grad():
        R.time_mix(x, prev, None, p, cfg)
    assert calls == [1]


@pytest.mark.parametrize("s", [24, 130])
def test_time_mix_gradients_match_reference(s):
    """Every parameter's, x's, x_prev's and the state's gradient through
    time_mix against jax.grad of the reference's, for y and the state
    out."""
    jcfg = JCFG.get_config("rwkv6-3b").reduced(compute_dtype="float32")
    pcfg = PCFG.get_config("rwkv6-3b").reduced(compute_dtype="float32")
    tmix, _ = _layer_params(jcfg, 70 + s)
    h, dh = JR.rwkv_dims(jcfg)
    rng = np.random.default_rng(s + 2)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, h, dh, dh)).astype(np.float32)
    wy = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    ws = rng.standard_normal((2, h, dh, dh)).astype(np.float32)

    def jloss(x, x_prev, state, p):
        y, _, st = JR.time_mix(x, x_prev, state, p, jcfg)
        return (y * wy).sum() + (st * ws).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(x), jnp.asarray(x_prev), jnp.asarray(state),
        jax.tree.map(jnp.asarray, tmix))
    tx, tprev, tst = (torch.from_numpy(a).requires_grad_(True)
                      for a in (x, x_prev, state))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in tmix.items()}
    y, _, st = R.time_mix(tx, tprev, tst, tp, pcfg)
    ((y * torch.from_numpy(wy)).sum()
     + (st * torch.from_numpy(ws)).sum()).backward()
    pairs = [("x", tx.grad, want[0]), ("x_prev", tprev.grad, want[1]),
             ("state", tst.grad, want[2])] + [
        (k, t.grad, want[3][k]) for k, t in tp.items()]
    for name, got, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-6 * max(
            1.0, np.abs(w).max()), err_msg=name)
