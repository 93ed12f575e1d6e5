"""The port's training half (``data/pipeline.py``, ``configs/shapes.py``,
``optim/adamw.py``, ``models/steps.py``, ``models/convert.py``'s optimizer
state, ``launch/train.py``) against the JAX package's.

The reference's weights (``T.init_model`` from a PRNG key) cross to the
port through ``models/convert.py``; batches and gradients are made with
numpy from a seed.  The JAX side runs under ``jax.jit`` on the CPU, the
port on CPU tensors (attention and the RWKV recurrence run their kernels'
plain versions inside their ``torch.autograd.Function``s).  Reference
results are computed once a module (cached).

Tolerances, stated where used:

* AdamW given the same gradients: the int8 state's ``q`` bit for bit; the
  parameters within 2e-7 of their scale, the float32 state and scales
  within 4e-7 relative plus 2e-7 of their scale (XLA may fuse the moment
  updates, which moves a value by an ulp; where ``b * m`` and ``(1 - b) *
  g`` nearly cancel, that ulp is one of the terms').
* ``loss_fn`` in float32: the loss within 1e-5 relative, every gradient
  within rtol 1e-4 / atol 1e-6.  In bfloat16 the loss within 5e-4 relative
  and every gradient within 6e-2 of its leaf's largest value: the
  frameworks round bfloat16 at other places (the reference rounds
  ``exp(s - m)`` to bfloat16 before ``e @ v``, the port keeps it in
  float32), and a gradient sums those differences over the batch.
* A train step (float32 compute and state): loss and grad norm within
  1e-5 relative, parameters within 5e-2 of the learning rate a step
  (AdamW's first steps move each parameter by about ``lr * sign(g)``, so a
  gradient near zero turns a float32 rounding into a visible step).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro import configs as JCFG
from repro.checkpoint import manager as jman
from repro.core import Codec as JCodec, CodecConfig as JCodecConfig
from repro.core.cache import PlanCache as JPlanCache
from repro.launch import train as jtrain
from repro.models import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw as JO

from repro_torch import configs as PCFG
from repro_torch.checkpoint import manager as man
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as O

ARCHS = ["qwen3-0.6b", "rwkv6-3b"]
#: The families of the attention options (sliding window, encdec, vlm):
#: their loss, gradients and a train step against the reference's.
NEW_ARCHS = ["h2o-danube-1.8b", "whisper-base", "qwen2-vl-72b",
             "qwen2-moe-a2.7b"]
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors, restored after
    it: beside other test processes on the same cores, torch's default of
    a thread a core makes these steps many times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32", remat=True):
    """The reference's reduced config and weights (numpy), and the port's
    config; rwkv's ``u`` made non-zero so the bonus term matters."""
    jcfg = JCFG.get_config(arch).reduced(compute_dtype=dtype, remat=remat)
    pcfg = PCFG.get_config(arch).reduced(compute_dtype=dtype, remat=remat)
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    if jcfg.family == "rwkv":
        u = tree["layers"]["tmix"]["u"]
        tree["layers"]["tmix"]["u"] = np.random.default_rng(0).normal(
            0, 0.5, u.shape).astype(np.float32)
    return jcfg, pcfg, tree


def _batch(vocab, b=4, s=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[0, 3] = -1                      # an ignored position mid-row
    return {"tokens": toks, "labels": labels}


def _batch_of(cfg):
    """``_batch`` for ``cfg``'s family: 48 tokens past danube's reduced
    window of 32; seeded, non-zero stub embeddings for vlm (8 patches, the
    labels left-padded by -1 over them, as the reference's train.py pads)
    and encdec (``encoder_seq`` frames)."""
    batch = _batch(cfg.vocab, s=48 if cfg.swa_window else 32)
    n = {"vlm": 8, "encdec": cfg.encoder_seq}.get(cfg.family)
    if n is not None:
        rng = np.random.default_rng(2)
        batch["extra_embeds"] = rng.standard_normal(
            (4, n, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["labels"] = np.concatenate(
            [np.full((4, n), -1, np.int32), batch["labels"]], 1)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _leaves_with_keys(np_tree, prefix=""):
    if isinstance(np_tree, dict):
        out = {}
        for k, v in np_tree.items():
            out.update(_leaves_with_keys(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(np_tree)}


@functools.lru_cache(maxsize=None)
def _ref_grads(arch, dtype):
    jcfg, _, tree = _pair(arch, dtype)
    batch = _batch_of(jcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(p, b, jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), _jb(batch))
    return (float(loss), _leaves_with_keys(jax.tree.map(np.asarray, grads)),
            float(metrics["aux"]))


@functools.lru_cache(maxsize=None)
def _ref_steps(arch, state_dtype, n_micro, n_steps=2):
    """The reference's params, state and metrics after ``n_steps`` train
    steps on one batch (float32 compute)."""
    jcfg, _, tree = _pair(arch)
    ocfg = JO.AdamWConfig(lr=LR, state_dtype=state_dtype)
    step = jax.jit(JS.make_train_step(jcfg, ocfg, n_micro=n_micro))
    p = jax.tree.map(jnp.asarray, tree)
    st = JO.init(p, ocfg)
    batch = _jb(_batch_of(jcfg))
    metrics = []
    for _ in range(n_steps):
        p, st, m = step(p, st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return (_leaves_with_keys(jax.tree.map(np.asarray, p)),
            jax.tree.map(np.asarray, st), metrics)


def _port_steps(arch, state_dtype, n_micro, n_steps=2, remat=True):
    _, pcfg, tree = _pair(arch, "float32", remat)
    ocfg = O.AdamWConfig(lr=LR, state_dtype=state_dtype)
    step = S.make_train_step(pcfg, ocfg, n_micro=n_micro)
    p = convert.params_from_jax(tree, pcfg, "cpu")
    st = O.init(p, ocfg)
    batch = _pb(_batch_of(pcfg))
    metrics = []
    for _ in range(n_steps):
        p, st, m = step(p, st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return (_leaves_with_keys(convert.params_to_numpy(p)),
            convert.opt_state_to_numpy(st), metrics)


# ---------------------------------------------------------------------------
# Data and shape cells
# ---------------------------------------------------------------------------


def _lm(**kw):
    return SyntheticLM(DataConfig(**{"vocab": 500, "seq_len": 32,
                                     "global_batch": 4, **kw}),
                       device="cpu")


def test_synthetic_lm_deterministic():
    a, b = _lm(seed=3).batch_at(7), _lm(seed=3).batch_at(7)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 32)
    assert not torch.equal(a["tokens"], _lm(seed=4).batch_at(7)["tokens"])


def test_synthetic_lm_steps_differ():
    d = _lm()
    assert not torch.equal(d.batch_at(0)["tokens"], d.batch_at(1)["tokens"])


def test_synthetic_lm_shards_differ():
    a = _lm(global_batch=8, n_shards=2, shard_id=0).batch_at(0)
    b = _lm(global_batch=8, n_shards=2, shard_id=1).batch_at(0)
    assert a["tokens"].shape == (4, 32)
    assert not torch.equal(a["tokens"], b["tokens"])


def test_synthetic_lm_skip_ahead():
    """A batch depends on (seed, shard, step) alone: a pipeline that has
    drawn other batches, or a fresh one, gives the same."""
    d = _lm(seed=5)
    for s in range(4):
        d.batch_at(s)
    assert torch.equal(d.batch_at(9)["tokens"],
                       _lm(seed=5).batch_at(9)["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticLM(DataConfig(vocab=100, seq_len=16, global_batch=2),
                    device="cpu").batch_at(0)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()


@pytest.mark.parametrize("mode", ["zipf", "uniform"])
def test_marginals(mode):
    """Zipf(1.1): the head dominates the tail, as the reference test asks;
    every token within the vocabulary; uniform: no such skew."""
    d = SyntheticLM(DataConfig(vocab=1000, seq_len=256, global_batch=8,
                               mode=mode), device="cpu")
    toks = d.batch_at(0)["tokens"].reshape(-1).numpy()
    assert toks.min() >= 0 and toks.max() < 1000
    counts = np.bincount(toks, minlength=1000)
    if mode == "zipf":
        assert counts[:10].sum() > counts[500:510].sum()
        p = 1.0 / np.arange(1, 1001) ** 1.1
        assert abs(counts[0] / toks.size - p[0] / p.sum()) < 0.02
    else:
        assert counts[:10].sum() < 4 * max(counts[500:510].sum(), 1)


def test_shard_batch_must_divide():
    with pytest.raises(AssertionError):
        _lm(global_batch=5, n_shards=2).batch_at(0)


def test_prefetch_yields_batch_at():
    d = _lm(seed=2)
    it = d.prefetch(3)
    for want_step in (3, 4, 5):
        step, batch = next(it)
        assert step == want_step
        assert torch.equal(batch["tokens"], d.batch_at(step)["tokens"])
    it.close()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticLM(DataConfig(vocab=10, seq_len=4, global_batch=1))


def test_shape_cells_match_reference():
    assert {k: vars(v) for k, v in PCFG.SHAPES.items()} == \
        {k: vars(v) for k, v in JCFG.SHAPES.items()}
    for skipped in (False, True):
        assert PCFG.cells(skipped) == JCFG.cells(skipped)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

_SHAPES = {"a": (4, 256), "b": (1000,), "c": (3, 2, 128), "d": ()}


def _opt_inputs(seed, grad_scale):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in _SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in _SHAPES.items()} for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_update_matches_reference(state_dtype, grad_scale):
    """Four updates from the same gradients: the int8 state's q bit for bit
    (with the clip off, 1e-3, and on, 10), the rest within 2e-7 of its
    scale."""
    params, grads = _opt_inputs(int(grad_scale * 1000), grad_scale)
    jcfg = JO.AdamWConfig(state_dtype=state_dtype)
    pcfg = O.AdamWConfig(state_dtype=state_dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = JO.init(jp, jcfg), O.init(tp, pcfg)
    for g in grads:
        jp, js, jm = JO.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp, jcfg)
        tp, ts, tm = O.update({k: _t(v) for k, v in g.items()}, ts, tp,
                              pcfg)
    assert int(ts["step"]) == int(js["step"]) == 4
    assert ts["step"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for k in _SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=2e-7 * max(
                                       1, np.abs(params[k]).max()))
    want = _leaves_with_keys(jax.tree.map(np.asarray, {"m": js["m"],
                                                       "v": js["v"]}))
    got = _leaves_with_keys(convert.tree_to_numpy({"m": ts["m"],
                                                   "v": ts["v"]}))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k.endswith(".q"):
            assert got[k].dtype == np.int8
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=4e-7,
                                       atol=2e-7 * np.abs(w).max(),
                                       err_msg=k)


@pytest.mark.parametrize("shape", [(8, 1024), (3, 5, 256), (128,)])
def test_quantize_state_bit_exact_with_ties(shape):
    """Random blocks, and blocks whose values sit exactly halfway between
    two codes (max 127 * 2**e, so the scale is 2**e): q and scale equal
    the reference's bit for bit, ties rounded to even."""
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    ties = (rng.integers(-126, 126, shape) + 0.5).astype(np.float32)
    ties[..., ::128] = 127.0
    ties *= np.float32(2.0 ** -7)
    for a in (x, ties, np.zeros(shape, np.float32)):
        want = JO.quantize_state(jnp.asarray(a))
        got = O.quantize_state(_t(a))
        np.testing.assert_array_equal(got["q"].numpy(),
                                      np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))
        back = O.dequantize_state(got, shape)
        np.testing.assert_array_equal(back.numpy(), np.asarray(
            JO.dequantize_state(want, shape)))
    q = O.quantize_state(_t(ties))["q"].numpy()
    assert (q[..., 1:128] % 2 == 0).all()          # halves to even


def _quad_loss(p):
    return ((p["w"] - 3.0) ** 2).sum() + ((p["b"] + 1.0) ** 2).sum()


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_converges_on_quadratic(state_dtype):
    cfg = O.AdamWConfig(lr=0.05, weight_decay=0.0, state_dtype=state_dtype)
    params = {"w": torch.zeros(130), "b": torch.ones(257)}
    state = O.init(params, cfg)
    for _ in range(300):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        g = torch.autograd.grad(_quad_loss(p), list(p.values()))
        params, state, _ = O.update(dict(zip(p, g)), state, params, cfg)
    assert float(_quad_loss(params)) < 1e-2


def test_int8_tracks_fp32():
    params = {"w": torch.linspace(-1, 1, 256)}
    g = {"w": torch.ones(256) * 0.1}
    cfg32 = O.AdamWConfig(lr=1e-2, weight_decay=0.0)
    cfg8 = O.AdamWConfig(lr=1e-2, weight_decay=0.0, state_dtype="int8")
    p32, s32 = dict(params), O.init(params, cfg32)
    p8, s8 = dict(params), O.init(params, cfg8)
    for _ in range(20):
        p32, s32, _ = O.update(g, s32, p32, cfg32)
        p8, s8, _ = O.update(g, s8, p8, cfg8)
    assert float((p32["w"] - p8["w"]).abs().max()) < 5e-3


def test_quantize_state_bounds_and_fallback():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 1024)).astype(np.float32))
    s = O.quantize_state(x)
    assert s["q"].dtype == torch.int8 and s["q"].shape == x.shape
    err = (O.dequantize_state(s, (8, 1024)) - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127 + 1e-7
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        1000).astype(np.float32))
    s = O.quantize_state(y)
    assert "f" in s and torch.equal(O.dequantize_state(s, (1000,)), y)


def test_grad_clip_and_no_writes():
    """The norm is reported before the clip; the arguments are not
    written."""
    cfg = O.AdamWConfig(lr=1e-3, grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    state = O.init(params, cfg)
    huge = {"w": torch.full((4,), 1e6)}
    before = ({"w": params["w"].clone()}, {"w": huge["w"].clone()})
    new, new_state, m = O.update(huge, state, params, cfg)
    assert float(m["grad_norm"]) > 1e5
    assert torch.equal(params["w"], before[0]["w"])
    assert torch.equal(huge["w"], before[1]["w"])
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert float(new["w"].abs().max()) <= 1.001e-3   # one clipped step


# ---------------------------------------------------------------------------
# Cross entropy and loss_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(48, 1024), (40, 16), (41, 16)])
def test_chunked_softmax_xent_matches_reference(dtype, s, chunk):
    """One chunk, two chunks, and two chunks with a one-token tail."""
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 32)).astype(np.float32)
    u = (rng.standard_normal((300, 32)) * 0.3).astype(np.float32)
    lab = rng.integers(-1, 300, (2, s)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JS.chunked_softmax_xent(jnp.asarray(h, jdt), jnp.asarray(u, jdt),
                                   jnp.asarray(lab), seq_chunk=chunk)
    got = S.chunked_softmax_xent(_t(h).to(tdt), _t(u).to(tdt), _t(lab),
                                 seq_chunk=chunk)
    assert got[0].dtype == torch.float32
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert int(got[1]) == int(want[1]) == int((lab >= 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    jcfg, pcfg, tree = _pair(arch, dtype)
    want_loss, want, want_aux = _ref_grads(arch, dtype)
    params = convert.params_from_jax(tree, pcfg, "cpu")
    (loss, metrics), grads = S.grads_of(params, _pb(_batch_of(pcfg)), pcfg)
    got = _leaves_with_keys(convert.params_to_numpy(grads))
    assert sorted(got) == sorted(want)
    if pcfg.family == "moe":
        # the router's aux loss, which the loss adds: float32 1e-6
        # relative, bfloat16 1e-3 (the routers past the first layer see
        # hidden states rounded to bfloat16 at other places)
        assert want_aux > 0
        tol = 1e-6 if dtype == "float32" else 1e-3
        assert abs(float(metrics["aux"]) - want_aux) <= tol * want_aux
    else:
        assert float(metrics["aux"]) == want_aux == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        for k, w in want.items():
            # a bfloat16 parameter's gradient (qwen2-vl) is rounded to
            # bfloat16 once on each side: within one bfloat16 ulp, at most
            # 2**-7 of the value
            tol = 2.0 ** -7 if w.dtype.name == "bfloat16" else 1e-4
            np.testing.assert_allclose(got[k], w.astype(np.float32),
                                       rtol=tol, atol=1e-6, err_msg=k)
    else:
        np.testing.assert_allclose(float(loss), want_loss, rtol=5e-4)
        if pcfg.family == "moe":
            # Not comparable leaf by leaf: the second layer's router sees
            # hidden states the frameworks round to bfloat16 apart, and on
            # this batch 2 of its 128 tokens take another expert on each
            # side, which moves every leaf's gradient by up to a third of
            # its scale.  The float32 case holds the moe gradients.
            return
        for k, w in want.items():
            assert np.abs(got[k] - w).max() <= 6e-2 * np.abs(w).max(), k


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
def test_eval_step_is_the_loss(arch):
    _, pcfg, tree = _pair(arch)
    params = convert.params_from_jax(tree, pcfg, "cpu")
    batch = _pb(_batch_of(pcfg))
    metrics = S.make_eval_step(pcfg)(params, batch)
    want_loss, _, _ = _ref_grads(arch, "float32")
    np.testing.assert_allclose(float(metrics["ce"]) + float(metrics["aux"]),
                               want_loss, rtol=1e-5)
    assert not metrics["ce"].requires_grad


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, n_micro):
    """Two steps of float32 AdamW on one batch, with one and two
    micro-batches."""
    want_p, want_s, want_m = _ref_steps(arch, "float32", n_micro)
    got_p, got_s, got_m = _port_steps(arch, "float32", n_micro)
    for w, g in zip(want_m, got_m):
        assert sorted(g) == sorted(w) == ["aux", "ce", "grad_norm", "loss"]
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert sorted(got_p) == sorted(want_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=2 * 5e-2 * LR,
                                   err_msg=k)
    assert int(got_s["step"]) == 2


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_step_of_new_families_matches_reference(arch):
    """Two steps of float32 AdamW on one batch (float32 compute): loss and
    grad norm within 1e-5 relative; every parameter within 2 lr plus one
    ulp of its type of the reference's, and all but a thousandth within
    0.1 lr plus one ulp.  The reference's parameter test holds every
    element to 0.1 lr; here a near-zero gradient whose sign the two
    frameworks' float32 sums set apart moves its parameter by up to 2 lr
    (seen: one of danube's 16,384 ``wv`` entries), and qwen2-vl's bfloat16
    parameters round each update to a bfloat16 ulp."""
    want_p, _, want_m = _ref_steps(arch, "float32", 1)
    got_p, got_s, got_m = _port_steps(arch, "float32", 1)
    for w, g in zip(want_m, got_m):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert sorted(got_p) == sorted(want_p)
    n = off = 0
    for k, w in want_p.items():
        ulp = (2.0 ** -7 if w.dtype.name == "bfloat16" else 2.0 ** -23) \
            * np.abs(w.astype(np.float32))
        d = np.abs(got_p[k] - w.astype(np.float32))
        assert (d <= 2 * LR + ulp).all(), k
        n, off = n + d.size, off + int((d > 0.1 * LR + ulp).sum())
    assert off <= 1e-3 * n, (off, n)
    assert int(got_s["step"]) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_int8_state(arch):
    """int8 state: loss and norm as the reference's; the new state's codes
    agree at nearly every element (a code one off where the gradients
    differ by a rounding, which moves the parameter: a v code of 0 divides
    m by eps alone)."""
    want_p, want_s, want_m = _ref_steps(arch, "int8", 1)
    got_p, got_s, got_m = _port_steps(arch, "int8", 1)
    for w, g in zip(want_m, got_m):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-5)
    want = _leaves_with_keys(want_s)
    got = _leaves_with_keys(got_s)
    assert sorted(got) == sorted(want)
    n = off = 0
    for k, w in want.items():
        if k.endswith(".q"):
            d = np.abs(got[k].astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1, k
            n, off = n + d.size, off + int((d > 0).sum())
    assert off <= 1e-3 * n, (off, n)
    close = sum(int((np.abs(got_p[k] - w) <= 0.1 * LR).sum())
                for k, w in want_p.items())
    assert close >= (1 - 1e-3) * sum(w.size for w in want_p.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_step(arch):
    """remat on and off: the same gradients, so the same step, bit for bit
    (the recompute repeats the forward's operations)."""
    on = _port_steps(arch, "float32", 1, n_steps=1, remat=True)
    off = _port_steps(arch, "float32", 1, n_steps=1, remat=False)
    assert on[2] == off[2]
    for k in on[0]:
        np.testing.assert_array_equal(on[0][k], off[0][k], err_msg=k)


def test_remat_checkpoints_each_layer(monkeypatch):
    """With remat, each layer body runs under torch.utils.checkpoint once a
    layer while autograd records, then the loss's one vocabulary chunk;
    nothing under no_grad."""
    _, pcfg, tree = _pair("qwen3-0.6b")
    params = convert.params_from_jax(tree, pcfg, "cpu")
    calls = []
    real = T._checkpoint.checkpoint

    def spy(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(T._checkpoint, "checkpoint", spy)
    S.grads_of(params, _pb(_batch(pcfg.vocab)), pcfg)
    assert calls == ["_dense_layer"] * pcfg.n_layers + ["_chunk_nll"]
    calls.clear()
    S.make_eval_step(pcfg)(params, _pb(_batch(pcfg.vocab)))
    assert calls == []


@pytest.fixture
def cpu_world():
    """A one-rank gloo world for the test, torn down after it."""
    made = not dist.is_initialized()
    yield
    if made and dist.is_initialized():
        dist.destroy_process_group()


def test_grad_shardings_place_the_accumulators(cpu_world):
    """grad_shardings puts each accumulator on its NamedSharding (a DTensor
    on a one-rank host mesh); the step equals the one without it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import pspec
    from repro_torch.runtime.sharding import NamedSharding, P

    mesh = make_host_mesh(device_type="cpu")
    _, pcfg, tree = _pair("qwen3-0.6b")
    params = convert.params_from_jax(tree, pcfg, "cpu")
    shardings = O.tree_map(lambda p: NamedSharding(mesh, P()), params)
    seen = []
    real = pspec.place

    def spy(x, s):
        out = real(x, s)
        seen.append(isinstance(out, DTensor))
        return out

    ocfg = O.AdamWConfig(lr=LR)
    batch = _pb(_batch(pcfg.vocab))
    plain = S.make_train_step(pcfg, ocfg, n_micro=2)(
        params, O.init(params, ocfg), batch)
    pspec.place = spy
    try:
        placed = S.make_train_step(pcfg, ocfg, n_micro=2,
                                   grad_shardings=shardings)(
            params, O.init(params, ocfg), batch)
    finally:
        pspec.place = real
    n = len(O.tree_leaves(params))
    assert len(seen) == 3 * n and all(seen)
    assert placed[2]["loss"] == plain[2]["loss"]
    for a, b in zip(O.tree_leaves(placed[0]), O.tree_leaves(plain[0])):
        assert not isinstance(a, DTensor)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loss_decreases():
    """25 steps of the reduced qwen3 on SyntheticLM bring the loss down, as
    the reference's test_system.py asks."""
    cfg = PCFG.get_config("qwen3-0.6b").reduced()
    ocfg = O.AdamWConfig(lr=1e-3)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=4, seed=0), device="cpu")
    step_fn = S.make_train_step(cfg, ocfg)
    params = T.init_model(0, cfg, "cpu")
    opt = O.init(params, ocfg)
    losses = []
    for s in range(25):
        params, opt, m = step_fn(params, opt, data.batch_at(s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# Optimizer state across, and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_opt_state_crosses_both_ways(state_dtype):
    jcfg, pcfg, tree = _pair("qwen3-0.6b")
    _, want, _ = _ref_steps("qwen3-0.6b", state_dtype, 1)
    st = convert.opt_state_from_jax(want, pcfg, "cpu")
    assert isinstance(st["m"]["layers"], list)
    assert len(st["m"]["layers"]) == pcfg.n_layers
    assert st["step"].dtype == torch.int32
    back = convert.opt_state_to_numpy(st)
    a, b = _leaves_with_keys(back), _leaves_with_keys(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _codecs():
    return (Codec(CodecConfig(backend="ref", eb=1e-4), plan_cache=PlanCache()),
            JCodec(JCodecConfig(eb=1e-4), plan_cache=JPlanCache()))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("compress", [False, True])
def test_step_directories_byte_identical(tmp_path, state_dtype, compress):
    """One state (the reference's after a step) saved by each package's
    manager, in the reference's layout: the same files, byte for byte."""
    jcfg, pcfg, tree = _pair("qwen3-0.6b")
    _, jstate, _ = _ref_steps("qwen3-0.6b", state_dtype, 1)
    pc, jc = _codecs() if compress else (None, None)
    tm = man.CheckpointManager(str(tmp_path / "port"), codec=pc,
                               device="cpu")
    jm = jman.CheckpointManager(str(tmp_path / "jax"), codec=jc)
    params = convert.params_from_jax(tree, pcfg, "cpu")
    state = convert.opt_state_from_jax(jstate, pcfg, "cpu")
    tm.save(1, convert.sorted_tree(convert.stack_layers(params)),
            convert.opt_state_stacked(state))
    jm.save(1, jax.tree.map(jnp.asarray, tree),
            jax.tree.map(jnp.asarray, jstate))
    got, want = (_files(os.path.join(m.dir, "step_00000001"))
                 for m in (tm, jm))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    kinds = {e["kind"] for e in json.loads(want["manifest.json"])[
        "entries"].values()}
    assert kinds == ({"raw", "sz"} if compress else {"raw"})


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's train.py: 2 steps of the reduced qwen3 (bfloat16
    compute), checkpointed at step 1 (raw: the reference's jnp decode of a
    compressed step takes ~1 min on the CPU; compressed steps cross in
    the byte-identity test above)."""
    d = str(tmp_path_factory.mktemp("jax_train"))
    jtrain.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--ckpt-dir", d,
                 "--ckpt-every", "2", "--log-every", "1"])
    return d


def test_port_resumes_a_reference_checkpoint(ref_run):
    """The reference's train.py checkpoint restored by the port: every
    leaf as the reference restores it, bit for bit, and the reference's
    next-step loss on one batch (5e-4 relative: bfloat16 compute, as
    above) and grad norm (5e-3)."""
    cfg = JCFG.get_config("qwen3-0.6b").reduced()
    pcfg = PCFG.get_config("qwen3-0.6b").reduced()
    r = jman.CheckpointManager(ref_run).restore()
    assert r["step"] == 1
    ocfg = JO.AdamWConfig(lr=3e-4)
    batch = _batch(cfg.vocab, 2, 16, seed=9)
    _, _, jm = jax.jit(JS.make_train_step(cfg, ocfg))(
        r["params"], r["opt"], _jb(batch))
    got = man.CheckpointManager(ref_run, codec=_codecs()[0],
                                device="cpu").restore()
    assert got["step"] == 1
    params = convert.unstack_layers(got["params"])
    opt = got["opt"]
    state = {"m": convert.unstack_layers(opt["m"]),
             "v": convert.unstack_layers(opt["v"]), "step": opt["step"]}
    assert int(state["step"]) == 2 and len(params["layers"]) == 2
    want = _leaves_with_keys(jax.tree.map(np.asarray, {
        "params": r["params"], "opt": r["opt"]}))
    have = _leaves_with_keys(convert.tree_to_numpy({"params": got["params"],
                                                    "opt": got["opt"]}))
    assert sorted(have) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(have[k], w, err_msg=k)
    _, new_state, pm = S.make_train_step(pcfg, O.AdamWConfig(lr=3e-4))(
        params, state, _pb(batch))
    assert int(new_state["step"]) == 3
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=5e-4)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=5e-3)


def test_reference_resumes_a_port_checkpoint(tmp_path):
    """The port's train.py checkpoint (float32 state) restored by the
    reference's manager: the port's parameters and state bit for bit
    within the codec's bound."""
    d = str(tmp_path / "ck")
    train.main(["--arch", "rwkv6-3b", "--reduced", "--steps", "2",
                "--batch", "2", "--seq", "16", "--ckpt-dir", d,
                "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"])
    r = jman.CheckpointManager(d).restore()
    got = man.CheckpointManager(d, device="cpu").restore()
    assert r["step"] == got["step"] == 1
    a = _leaves_with_keys(jax.tree.map(np.asarray, {"params": r["params"],
                                                    "opt": r["opt"]}))
    b = _leaves_with_keys(convert.tree_to_numpy({"params": got["params"],
                                                 "opt": got["opt"]}))
    assert sorted(a) == sorted(b)
    assert "opt.m.layers.tmix.wr" in a and a["opt.step"] == 2
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,extra", [
    ("qwen3-0.6b", ["--ckpt-compress-eb", "1e-4"]),
    ("rwkv6-3b", ["--opt-int8", "--n-micro", "2"]),
    ("qwen2-moe-a2.7b", [])])
def test_train_main_preempts_and_resumes(tmp_path, capsys, arch, extra):
    """--preempt-at 1 exits with 17 after step 1's checkpoint; a rerun
    resumes at step 2.  From a raw checkpoint the resumed run prints the
    losses of an uninterrupted one; from a compressed one (eb 1e-4 of each
    leaf's range, AdamW's v included, whose small entries that bound
    swamps) only finite ones."""
    base = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--log-every", "1",
            "--device", "cpu", *extra]
    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as e:
        train.main(base + ["--ckpt-dir", d, "--preempt-at", "1"])
    assert e.value.code == 17
    out = capsys.readouterr().out
    assert "simulated preemption at step 1" in out
    before = _losses(out)
    train.main(base + ["--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "[train] resumed from step 1" in out
    resumed = _losses(out)
    assert sorted(before) == [0, 1] and sorted(resumed) == [2, 3]
    assert all(np.isfinite(v) for v in resumed.values())
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000003"]
    if "--ckpt-compress-eb" not in extra:
        train.main(base + ["--ckpt-dir", str(tmp_path / "whole")])
        whole = _losses(capsys.readouterr().out)
        assert whole == {**before, **resumed}


def _losses(out):
    """{step: loss} of the ``[train] step=`` lines."""
    import re
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[train\] step=(\d+) loss=([-\d.]+)", out)}


def test_train_main_sharded_resume(tmp_path, capsys, cpu_world):
    """--ckpt-sharded writes the mesh-sharded layout and resumes through
    the host mesh."""
    d = str(tmp_path / "ck")
    base = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--log-every", "1", "--device", "cpu",
            "--ckpt-dir", d, "--ckpt-sharded"]
    train.main(base + ["--steps", "2"])
    manifest = json.load(open(os.path.join(d, "step_00000001",
                                           "manifest.json")))
    assert "sz-sharded" in {e["kind"] for e in manifest["entries"].values()}
    capsys.readouterr()
    first, _ = train.main(base + ["--steps", "3"])
    assert "resumed from step 1" in capsys.readouterr().out
    assert np.isfinite(first)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "zamba2-7b"])
def test_unported_families_raise(arch, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        train.main(["--arch", arch, "--reduced", "--steps", "1",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    cfg = PCFG.get_config(arch).reduced()
    step = S.make_train_step(cfg, O.AdamWConfig())
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        step({}, {}, _pb(_batch(cfg.vocab)))
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_main_runs_the_new_families(tmp_path, capsys, arch):
    """launch/train.py feeds the reference's stubs (vlm: 8 zero patches,
    labels left-padded; encdec: encoder_seq zero frames): two steps with
    finite, equal-length loss lines; the vlm's labels cover its patches."""
    real = S.make_train_step
    seen = []

    def spy(*a, **kw):
        step = real(*a, **kw)

        def run(params, opt, batch):
            seen.append({k: tuple(v.shape) for k, v in batch.items()})
            return step(params, opt, batch)

        return run

    S_make = S.make_train_step
    try:
        S.make_train_step = spy
        train.main(["--arch", arch, "--reduced", "--steps", "2", "--batch",
                    "2", "--seq", "16", "--log-every", "1", "--device",
                    "cpu"])
    finally:
        S.make_train_step = S_make
    losses = _losses(capsys.readouterr().out)
    assert sorted(losses) == [0, 1] and all(np.isfinite(v)
                                            for v in losses.values())
    cfg = PCFG.get_config(arch).reduced()
    extra = {"vlm": 8, "encdec": cfg.encoder_seq}.get(cfg.family)
    for shapes in seen:
        if extra is None:
            assert "extra_embeds" not in shapes
            continue
        assert shapes["extra_embeds"] == (2, extra, cfg.d_model)
        assert shapes["labels"] == (2, 16 + (extra if cfg.family == "vlm"
                                             else 0))


def test_whisper_step_directories_byte_identical(tmp_path):
    """whisper-base's state (the reference's init and AdamW state), the
    encoder group included, saved by each package's manager: the same
    files byte for byte; each package restores the other's directory to
    the same leaves."""
    jcfg, pcfg, tree = _pair("whisper-base")
    jstate = jax.tree.map(np.asarray, JO.init(
        jax.tree.map(jnp.asarray, tree), JO.AdamWConfig()))
    tm = man.CheckpointManager(str(tmp_path / "port"), device="cpu")
    jm = jman.CheckpointManager(str(tmp_path / "jax"))
    params = convert.params_from_jax(tree, pcfg, "cpu")
    assert len(params["encoder"]) == pcfg.encoder_layers == 2
    state = convert.opt_state_from_jax(jstate, pcfg, "cpu")
    tm.save(0, convert.sorted_tree(convert.stack_layers(params)),
            convert.opt_state_stacked(state))
    jm.save(0, jax.tree.map(jnp.asarray, tree),
            jax.tree.map(jnp.asarray, jstate))
    got, want = (_files(os.path.join(m.dir, "step_00000000"))
                 for m in (tm, jm))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert "params.encoder.attn.wq" in json.loads(want["manifest.json"])[
        "entries"]
    for src in (tm.dir, jm.dir):
        r = jman.CheckpointManager(src).restore()
        p = man.CheckpointManager(src, device="cpu").restore()
        a = _leaves_with_keys(jax.tree.map(np.asarray, {
            "params": r["params"], "opt": r["opt"]}))
        b = _leaves_with_keys(convert.tree_to_numpy({"params": p["params"],
                                                     "opt": p["opt"]}))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        back = convert.unstack_layers(p["params"])
        assert len(back["encoder"]) == 2 and len(back["layers"]) == 2


def test_reference_resumes_a_port_whisper_checkpoint(tmp_path):
    """The port's train.py checkpoint of whisper-base restored by the
    reference's manager, leaf for leaf as the port restores it."""
    d = str(tmp_path / "ck")
    train.main(["--arch", "whisper-base", "--reduced", "--steps", "1",
                "--batch", "2", "--seq", "16", "--ckpt-dir", d,
                "--log-every", "1", "--device", "cpu"])
    r = jman.CheckpointManager(d).restore()
    got = man.CheckpointManager(d, device="cpu").restore()
    assert r["step"] == got["step"] == 0
    a = _leaves_with_keys(jax.tree.map(np.asarray, {"params": r["params"],
                                                    "opt": r["opt"]}))
    b = _leaves_with_keys(convert.tree_to_numpy({"params": got["params"],
                                                 "opt": got["opt"]}))
    assert sorted(a) == sorted(b)
    assert "params.encoder.xattn.wq" not in a
    assert "params.layers.xattn.wq" in a and "opt.m.enc_norm" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


#: Public names of the reference's training modules with no twin yet: the
#: MTP head's loss weight belongs to the mla_moe family (ROADMAP A10).
_NOT_YET = {"MTP_WEIGHT"}


@pytest.mark.parametrize("name", [
    "repro.data.pipeline", "repro.optim.adamw", "repro.configs",
    "repro.configs.shapes", "repro.models.steps", "repro.launch.train"])
def test_every_public_name_has_a_twin(name):
    """Every public name the reference module defines (not one it
    imports) has a twin in the port's."""
    import importlib
    import types

    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    missing = [n for n, v in vars(ref).items()
               if not n.startswith("_") and n not in _NOT_YET
               and not isinstance(v, types.ModuleType)
               and getattr(v, "__module__", name).startswith("repro")
               and not hasattr(port, n)]
    assert not missing, missing
