"""The port's mla_moe family (deepseek-v3-671b: ``repro_torch.models.mla``,
the MTP head, the ``latent`` decode cache) against the JAX package's.

The reference's weights (``init_mla`` / ``init_model`` from a PRNG key,
numpy arrays) cross to the port through ``models/convert.py``; inputs are
made with numpy from a seed and rounded to the compute type on both sides.
The reference runs on the CPU, the port on CPU tensors, so attention runs
the ``flash_attention`` kernel's plain version (the kernel itself is held
against it on the card: ``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Two head layouts: the reduced config's (qk_nope 16 + qk_rope 16 = D 32,
v_head 32) and an override with D != Dv (qk_nope 32 + qk_rope 16 = D 48,
v_head 32).

Tolerances, stated where used:

* Module outputs (``_latents``, ``_expand_kv``, ``mla_block``,
  ``mla_decode`` and its latent cache), scaled by ``max(1, max|want|)``:
  float32 within 1e-5, bfloat16 within 2**-5 (a few bfloat16 ulps: the
  frameworks round at other places), the moe tests' own.
* Model logits (forward, ``mtp_logits``, decode): float32 within 1e-5 of
  their scale; bfloat16 within 2**-5 of it with equal argmax wherever the
  reference's top-2 gap exceeds that tolerance.
* Greedy decode against the port's own forward: max |delta| < 5e-2 and
  the same argmax (the reference's ``TestDecodeConsistency``).
* ``loss_fn``: loss, ce, aux and mtp within 1e-5 relative in float32 and
  2**-5 relative in bfloat16 (the routers see hidden states the
  frameworks round to bfloat16 apart, so a token may take another expert:
  ce and aux move by up to 1e-3 and 1e-2 relative on these batches).
* float32 gradients (float32 parameters) leaf by leaf against
  ``jax.grad``: every element within rtol 1e-4 plus 1e-5 of the leaf's
  gradient scale, and all but a thousandth of a leaf's elements within
  rtol 1e-4 plus 1e-6 of it (an element whose terms cancel keeps the
  float32 rounding of the terms: seen, one of ``wo``'s 16,384 at 1.1e-6).
* serve.main (float32 compute, the reference's weights and prompt handed
  to the port, ``--kv-backend ref``): equal tokens and ratios.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.checkpoint import manager as jman
from repro.launch import serve as jserve
from repro.models import decode as JD
from repro.models import mla as JMLA
from repro.models import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw as JO

from repro_torch import configs as PCFG
from repro_torch.checkpoint import manager as man
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.models import decode as D
from repro_torch.models import mla as M
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as O

from test_torch_checkpoint import _files, _flat
from test_torch_stream import as_bytes
from test_torch_train import _leaves_with_keys

ARCH = "deepseek-v3-671b"
DTYPES = ["float32", "bfloat16"]
#: The reduced head layout, and one with a query/key head wider than the
#: value head (D 48, Dv 32).
DIMS = {"reduced": {}, "d48_dv32": {"qk_nope_dim": 32, "qk_rope_dim": 16,
                                    "v_head_dim": 32}}
SEQ = 24


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 2.0 ** -5


def _close(got, want, dtype, what=""):
    got = convert.to_numpy(got) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= _tol(dtype) * scale, (what, err, scale)


def _cfgs(dtype="float32", **over):
    return (JCFG.get_config(ARCH).reduced(compute_dtype=dtype, **over),
            PCFG.get_config(ARCH).reduced(compute_dtype=dtype, **over))


def _mla_pair(dtype, dims):
    jcfg, pcfg = _cfgs(dtype, **DIMS[dims])
    tree = jax.tree.map(np.asarray, JMLA.init_mla(jax.random.PRNGKey(0),
                                                  jcfg))
    return jcfg, pcfg, tree, {k: convert.to_torch(a, "cpu")
                              for k, a in tree.items()}


@functools.lru_cache(maxsize=None)
def _ref_tree(jcfg, seed):
    """The reference's ``init_model`` as numpy arrays, made once a config."""
    return jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(seed),
                                                  jcfg))


def _model_pair(dtype="float32", seed=0, **over):
    jcfg, pcfg = _cfgs(dtype, **over)
    tree = _ref_tree(jcfg, seed)
    return (jcfg, jax.tree.map(jnp.asarray, tree), pcfg,
            convert.params_from_jax(tree, pcfg, "cpu"), tree)


def _x(cfg, shape, seed=1):
    """Unit-normal inputs rounded to the compute type (numpy float32)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(cfg.compute_dtype).astype(
        jnp.float32))


def _both_x(jcfg, pcfg, x):
    return (jnp.asarray(x).astype(jcfg.cdt),
            torch.from_numpy(x).to(pcfg.cdt))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _same_argmax(got, want, tol):
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


# ---------------------------------------------------------------------------
# The family is ported
# ---------------------------------------------------------------------------


def test_the_family_is_ported():
    assert "mla_moe" in T.FAMILIES
    assert T.UNPORTED_FAMILIES == {} and len(T.FAMILIES) == 7
    for cfg in (PCFG.get_config(ARCH), PCFG.get_config(ARCH).reduced()):
        T.check_family(cfg)
    assert S.MTP_WEIGHT == JS.MTP_WEIGHT == 0.3


# ---------------------------------------------------------------------------
# models/mla.py against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", list(DIMS))
def test_init_mla_shapes_and_scales(dims):
    """The port's own ``init_mla``: the reference's keys, shapes, dtypes and
    scales (norms 1, the rest ``fan_in ** -0.5``)."""
    _, pcfg, tree, _ = _mla_pair("float32", dims)
    own = M.init_mla(T.generator(0, "cpu"), pcfg)
    assert sorted(own) == sorted(tree)
    for k, want in tree.items():
        got = own[k]
        assert tuple(got.shape) == want.shape, k
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, k
        if k.endswith("norm"):
            assert bool((got == 1).all()), k
        else:
            std = got.double().std().item()
            assert abs(std - want.shape[0] ** -0.5) <= 0.1 * \
                want.shape[0] ** -0.5, k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", list(DIMS))
def test_latents_and_expand_kv_match_reference(dims, dtype):
    jcfg, pcfg, tree, pp = _mla_pair(dtype, dims)
    jx, px = _both_x(jcfg, pcfg, _x(pcfg, (2, SEQ, pcfg.d_model)))
    jpos = jnp.arange(SEQ, dtype=jnp.int32)
    ppos = torch.arange(SEQ, dtype=torch.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    want = JMLA._latents(jx, jp, jcfg, jpos)
    got = M._latents(px, pp, pcfg, ppos)
    d = pcfg.qk_nope_dim + pcfg.qk_rope_dim
    assert tuple(got[0].shape) == (2, SEQ, pcfg.n_heads, d)
    assert tuple(got[1].shape) == (2, SEQ, pcfg.kv_lora_rank)
    assert tuple(got[2].shape) == (2, SEQ, 1, pcfg.qk_rope_dim)
    for name, g, w in zip(("q", "c_kv", "k_rope"), got, want):
        assert g.dtype == pcfg.cdt, name
        _close(g, w, dtype, name)
    # _expand_kv from the same latents on both sides
    c_kv, k_rope = (np.asarray(a, np.float32) for a in want[1:])
    wk, wv = JMLA._expand_kv(jnp.asarray(c_kv).astype(jcfg.cdt),
                             jnp.asarray(k_rope).astype(jcfg.cdt), jp,
                             jcfg, jcfg.cdt)
    gk, gv = M._expand_kv(torch.from_numpy(c_kv).to(pcfg.cdt),
                          torch.from_numpy(k_rope).to(pcfg.cdt), pp, pcfg,
                          pcfg.cdt)
    assert tuple(gk.shape) == (2, SEQ, pcfg.n_heads, d)
    assert tuple(gv.shape) == (2, SEQ, pcfg.n_heads, pcfg.v_head_dim)
    _close(gk, wk, dtype, "k")
    _close(gv, wv, dtype, "v")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", list(DIMS))
def test_mla_block_matches_reference(dims, dtype):
    """Causal MLA over 24 tokens, through ``blockwise_attn`` (the kernel's
    plain version here) at D ``qk_nope + qk_rope`` over Dv ``v_head``."""
    jcfg, pcfg, tree, pp = _mla_pair(dtype, dims)
    jx, px = _both_x(jcfg, pcfg, _x(pcfg, (2, SEQ, pcfg.d_model)))
    want = JMLA.mla_block(jx, jax.tree.map(jnp.asarray, tree), jcfg,
                          jnp.arange(SEQ, dtype=jnp.int32))
    got = M.mla_block(px, pp, pcfg, torch.arange(SEQ, dtype=torch.int32))
    assert got.dtype == pcfg.cdt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", list(DIMS))
def test_mla_decode_matches_reference(dims, dtype):
    """Eight absorbed decode steps into a 12-slot latent cache: each step's
    output and the whole cache after it; the port writes the caller's
    cache in place."""
    jcfg, pcfg, tree, pp = _mla_pair(dtype, dims)
    width = pcfg.kv_lora_rank + pcfg.qk_rope_dim
    jp = jax.tree.map(jnp.asarray, tree)
    jcache = jnp.zeros((2, 12, width), jcfg.cdt)
    pcache = torch.zeros((2, 12, width), dtype=pcfg.cdt)
    xs = _x(pcfg, (8, 2, 1, pcfg.d_model), seed=5)
    for t in range(8):
        jx, px = _both_x(jcfg, pcfg, xs[t])
        wo, jcache = JMLA.mla_decode(jx, jp, jcfg, jcache, jnp.int32(t))
        go, back = M.mla_decode(px, pp, pcfg, pcache, t)
        assert back is pcache and go.dtype == pcfg.cdt
        _close(go, wo, dtype, f"out {t}")
        _close(pcache, jcache, dtype, f"cache {t}")
    assert bool(pcache[:, 8:].eq(0).all()) and bool(pcache[:, :8].ne(0).any())


@pytest.mark.parametrize("dims", list(DIMS))
def test_mla_decode_matches_mla_block(dims):
    """The absorbed decode over a prompt against the expanded prefill, the
    port alone, float32: each step's output is the block's at its row."""
    _, pcfg, _, pp = _mla_pair("float32", dims)
    x = torch.from_numpy(_x(pcfg, (2, 10, pcfg.d_model), seed=7))
    full = M.mla_block(x, pp, pcfg, torch.arange(10, dtype=torch.int32))
    cache = torch.zeros((2, 10, pcfg.kv_lora_rank + pcfg.qk_rope_dim))
    for t in range(10):
        out, _ = M.mla_decode(x[:, t:t + 1], pp, pcfg, cache, t)
        _close(out[:, 0], full[:, t].numpy(), "float32", f"step {t}")


# ---------------------------------------------------------------------------
# The mla_moe model: forward, MTP head, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_mtp_logits_match_reference(dtype):
    """At D 48 over Dv 32 (the reduced head layout's forward is in
    ``test_torch_models.py``'s ARCHS): the prefill forward's logits and aux
    (the dense prefix's layer and the MoE layer), then ``mtp_logits`` on
    the embedding stream."""
    jcfg, jp, pcfg, pp, _ = _model_pair(dtype, **DIMS["d48_dv32"])
    assert len(pp["dense_layers"]) == 1 and len(pp["layers"]) == 1
    assert sorted(pp["mtp"]) == ["block", "fuse", "norm"]
    toks = _tokens(pcfg, (2, 40))

    def ref(p, t):
        logits, aux = JT.forward(p, t, jcfg)
        return logits, aux, JT.mtp_logits(p, t, p["embed"][t].astype(
            jcfg.cdt), jcfg)

    jl, jaux, jm = jax.jit(ref)(jp, jnp.asarray(toks))
    pl, paux = T.forward(pp, torch.from_numpy(toks), pcfg)
    assert pl.dtype == pcfg.cdt and tuple(pl.shape) == (2, 40, pcfg.vocab)
    _close(pl, jl, dtype, "logits")
    tol = _tol(dtype) * max(1.0, float(jnp.abs(jl).max()))
    _same_argmax(convert.to_numpy(pl), np.asarray(jl, np.float32), tol)
    assert float(jaux) > 0
    aux_tol = 1e-6 if dtype == "float32" else 1e-3
    assert abs(float(paux) - float(jaux)) <= aux_tol * float(jaux)
    ph = pp["embed"][torch.from_numpy(toks)].to(pcfg.cdt)
    pm = T.mtp_logits(pp, torch.from_numpy(toks), ph, pcfg)
    assert tuple(pm.shape) == (2, 40, pcfg.vocab)
    _close(pm, jm, dtype, "mtp")
    no_mtp = {k: v for k, v in pp.items() if k != "mtp"}
    assert T.mtp_logits(no_mtp, torch.from_numpy(toks), ph, pcfg) is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_logits_and_latent_match_reference(dtype):
    """At D 48 over Dv 32 (the reduced head layout's decode is in
    ``test_torch_models.py``'s ARCHS): eight serve steps from the
    reference's zero cache, each step's logits and the whole ``latent``
    cache (the prefix layer's entries first)."""
    jcfg, jp, pcfg, pp, _ = _model_pair(dtype, **DIMS["d48_dv32"])
    toks = _tokens(pcfg, (2, 8), seed=2)
    jcache = JD.init_cache(jcfg, 2, 12)
    pcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    spec = D.cache_spec(pcfg, 2, 12)
    assert list(spec) == ["latent"] and spec["latent"][0] == (
        2, 2, 12, pcfg.kv_lora_rank + pcfg.qk_rope_dim)
    assert tuple(pcache["latent"].shape) == spec["latent"][0]
    jstep = jax.jit(JS.make_serve_step(jcfg))
    pstep = S.make_serve_step(pcfg)
    for t in range(8):
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        pl, pcache = pstep(pp, torch.from_numpy(toks[:, t:t + 1]), pcache, t)
        _close(pl, jl, dtype, f"logits {t}")
        _close(pcache["latent"], jcache["latent"], dtype, f"latent {t}")


@pytest.mark.parametrize("dims", list(DIMS))
def test_greedy_decode_matches_forward(dims):
    """The reference's TestDecodeConsistency on the port: 2 layers, B 1,
    8 prompt tokens into a 16-slot cache; the last step's logits against
    the forward's last row within 5e-2, the same argmax."""
    cfg = PCFG.get_config(ARCH).reduced(n_layers=2, **DIMS[dims])
    params = T.init_model(0, cfg, "cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 8), seed=2))
    full = S.make_prefill_step(cfg)(params, toks)
    cache = D.init_cache(cfg, 1, 16, "cpu")
    step = S.make_serve_step(cfg)
    for t in range(8):
        lg, cache = step(params, toks[:, t:t + 1], cache, t)
    a, b = lg[0, 0].float(), full[0, -1].float()
    assert (a - b).abs().max().item() < 5e-2
    assert a.argmax() == b.argmax()


def test_greedy_generation_continues_the_forward():
    """Greedy generation past the prompt, the port alone, float32: four
    generated tokens, each step's logits equal to the forward's over the
    whole sequence within 1e-4 (tokens are chosen by the decode)."""
    cfg = PCFG.get_config(ARCH).reduced(compute_dtype="float32")
    params = T.init_model(1, cfg, "cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 6), seed=3)).long()
    cache = D.init_cache(cfg, 2, 10, "cpu")
    step = S.make_serve_step(cfg)
    steps = []
    for t in range(10):
        lg, cache = step(params, toks[:, t:t + 1], cache, t)
        steps.append(lg[:, 0])
        if t >= 5 and t < 9:
            toks = torch.cat([toks, lg[:, 0].argmax(-1, keepdim=True)], 1)
    full = S.make_prefill_step(cfg)(params, toks)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Training: loss_fn with the MTP head, float32 gradients
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, s=32, seed=1):
    toks = _tokens(cfg, (b, s), seed)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[0, 3] = -1                      # an ignored position mid-row
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_fn_with_mtp_matches_reference(dtype):
    jcfg, jp, pcfg, pp, _ = _model_pair(dtype)
    batch = _batch(pcfg)
    jl, jm = jax.jit(lambda p, b: JS.loss_fn(p, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pl, pm = S.loss_fn(pp, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, pcfg)
    assert sorted(pm) == sorted(jm) == ["aux", "ce", "mtp"]
    rtol = _tol(dtype)
    for k in ("ce", "aux", "mtp"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    np.testing.assert_allclose(float(pl), float(jl), rtol=rtol)
    np.testing.assert_allclose(
        float(pl), float(pm["ce"]) + S.MTP_WEIGHT * float(pm["mtp"])
        + float(pm["aux"]), rtol=1e-6)
    # without the group the loss is the CE and the aux alone
    no_mtp = {k: v for k, v in pp.items() if k != "mtp"}
    l2, m2 = S.loss_fn(no_mtp, {k: torch.from_numpy(v) for k, v in
                                batch.items()}, pcfg)
    assert "mtp" not in m2
    np.testing.assert_allclose(float(l2), float(m2["ce"] + m2["aux"]),
                               rtol=1e-6)


def test_float32_gradients_match_reference():
    """Float32 parameters and compute: the loss (CE + 0.3 MTP + aux) and
    every gradient leaf, MLA, experts, router and the MTP head, against
    ``jax.grad``; every MLA and MTP leaf gets a gradient."""
    jcfg, jp, pcfg, pp, _ = _model_pair("float32", param_dtype="float32")
    batch = _batch(pcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(p, b, jcfg), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (pl, pm), pg = S.grads_of(pp, {k: torch.from_numpy(v) for k, v in
                                   batch.items()}, pcfg)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    want = _leaves_with_keys(jax.tree.map(np.asarray, jg))
    got = _leaves_with_keys(convert.params_to_numpy(pg))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("mtp.") for k in got)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = np.abs(got[k] - w) - 1e-4 * np.abs(w)
        assert (err <= 1e-5 * scale).all(), k
        assert (err > 1e-6 * scale).sum() <= 1e-3 * w.size, k
        if ".attn." in k or k.startswith("mtp."):
            assert scale > 0, k


def test_train_step_with_mtp_matches_reference():
    """One float32 AdamW step (float32 parameters): the metrics ``ce``,
    ``aux``, ``mtp``, ``loss`` and ``grad_norm`` within 1e-5 relative,
    every parameter within 0.1 lr plus one float32 ulp."""
    lr = 1e-3
    jcfg, jp, pcfg, pp, _ = _model_pair("float32", param_dtype="float32")
    batch = _batch(pcfg)
    jstep = jax.jit(JS.make_train_step(jcfg, JO.AdamWConfig(lr=lr)))
    jnew, _, jmet = jstep(jp, JO.init(jp, JO.AdamWConfig(lr=lr)),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    ocfg = O.AdamWConfig(lr=lr)
    pnew, pst, pmet = S.make_train_step(pcfg, ocfg)(
        pp, O.init(pp, ocfg), {k: torch.from_numpy(v) for k, v in
                               batch.items()})
    assert sorted(pmet) == sorted(jmet)
    for k in ("ce", "aux", "mtp", "loss", "grad_norm"):
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    want = _leaves_with_keys(jax.tree.map(np.asarray, jnew))
    got = _leaves_with_keys(convert.params_to_numpy(pnew))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        ulp = 2.0 ** -23 * np.abs(w)
        assert (np.abs(got[k] - w) <= 0.1 * lr + ulp).all(), k
    assert int(pst["step"]) == 1


def test_train_main_runs_deepseek(tmp_path, capsys):
    """launch/train.py on the reduced deepseek, int8 AdamW state, two
    micro-batches: preempted after step 0 (exit 17), resumed from its raw
    checkpoint, the losses those of an uninterrupted run."""
    import re

    base = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-every", "1", "--log-every", "1",
            "--device", "cpu", "--opt-int8", "--n-micro", "2"]

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
    manifest = json.load(open(os.path.join(d, "step_00000001",
                                           "manifest.json")))
    names = manifest["entries"]
    assert {"params.mtp.fuse", "opt.m.mtp.fuse.q", "opt.v.mtp.fuse.scale",
            "params.dense_layers.attn.wuk", "params.layers.attn.wuv",
            "params.layers.moe.wg"} <= set(names)


# ---------------------------------------------------------------------------
# serve.main with the latent cache compressed and paged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [["--compress-kv"],
                                  ["--kv-offload", "--kv-block", "4"]])
def test_serve_main_matches_reference(flag, monkeypatch):
    """Both packages' serve.main on the reduced deepseek with the latent
    cache compressed (``--compress-kv``) or paged through the store
    (``--kv-offload``): the reference's weights and prompt handed to the
    port, float32 compute, ``--kv-backend ref``: the same tokens and the
    same ratio."""
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
    # the reduced latent cache is a few KiB: the stream's headers outweigh
    # its payload, so the ratio is below 1 on both sides
    assert got["ratio"] == pytest.approx(want["ratio"]) and got["ratio"] > 0
    if "--kv-offload" in flag:
        assert got["page_stats"]["pages_out"] == \
            want["page_stats"]["pages_out"] == 2


# ---------------------------------------------------------------------------
# The latent cache through models/kvcache.py and the store
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def latent_cache():
    """The port's bf16 latent cache after 16 decode steps of the reduced
    deepseek with the reference's weights."""
    _, _, pcfg, pp, _ = _model_pair("bfloat16", seed=1)
    toks = torch.from_numpy(_tokens(pcfg, (2, 16), seed=3))
    cache = D.init_cache(pcfg, 2, 16, "cpu")
    step = S.make_serve_step(pcfg)
    for t in range(16):
        _, cache = step(pp, toks[:, t:t + 1], cache, t)
    assert cache["latent"].dtype == torch.bfloat16
    assert bool(cache["latent"].ne(0).all())
    return cache


def _kv_pair(cache):
    from repro.core import Codec as JCodec, CodecConfig as JCodecConfig
    from repro.core.cache import PlanCache as JPlanCache

    from repro_torch.core.cache import PlanCache
    from repro_torch.core.codec import Codec, CodecConfig

    port = {k: v.clone() for k, v in cache.items()}
    jax_ = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
            for k, v in cache.items()}
    return (port, Codec(CodecConfig(backend="ref"), plan_cache=PlanCache()),
            jax_, JCodec(JCodecConfig(), plan_cache=JPlanCache()))


def _same_bytes(port, jax_):
    assert set(port) == set(jax_)
    for k in jax_:
        assert as_bytes(port[k]) == np.asarray(jax_[k]).tobytes(), k


def test_compress_cache_takes_the_latent(latent_cache):
    from repro.models import kvcache as jkv

    from repro_torch.models import kvcache

    port, codec, jax_, jcodec = _kv_pair(latent_cache)
    cc = kvcache.compress_cache(port, codec=codec)
    jcc = jkv.compress_cache(jax_, codec=jcodec)
    assert list(cc.blobs) == ["latent"]
    assert cc.ratio == jcc.ratio and cc.ratio > 0
    _same_bytes(kvcache.decompress_cache(cc, codec=codec),
                jkv.decompress_cache(jcc, codec=jcodec))


def test_kv_pager_pages_the_latent(latent_cache, tmp_path):
    """``offload_prefix`` of 12 tokens in blocks of 4 and the batched
    page-in: the same ratio and stats, and the same bf16 values back, as
    the reference's; the evicted span is zeroed in place before."""
    from repro.models import kvcache as jkv
    from repro.store import KVPager as JKVPager

    from repro_torch.models import kvcache
    from repro_torch.store import KVPager

    port, codec, jax_, jcodec = _kv_pair(latent_cache)
    pager = KVPager(str(tmp_path / "port"), codec=codec)
    jpager = JKVPager(str(tmp_path / "jax"), codec=jcodec)
    port, ids = kvcache.offload_prefix(port, pager, 12, block_tokens=4)
    jax_, jids = jkv.offload_prefix(jax_, jpager, 12, block_tokens=4)
    assert ids == jids and len(ids) == 3
    assert bool(port["latent"][:, :, :12].eq(0).all())
    assert pager.ratio == jpager.ratio > 0
    port = kvcache.page_in_blocks_batched(port, pager, ids)
    jax_ = jkv.page_in_blocks_batched(jax_, jpager, ids)
    _same_bytes(port, jax_)
    assert pager.stats == jpager.stats
    err = float((port["latent"].float() - latent_cache["latent"].float())
                .abs().max())
    assert 0 < err <= float(latent_cache["latent"].float().abs().max())


# ---------------------------------------------------------------------------
# Checkpoints and sharding rules on the deepseek tree
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _int8_state():
    """The reduced deepseek (float32 parameters) and its int8 AdamW state
    after one reference step, as numpy trees."""
    jcfg, jp, pcfg, _, tree = _model_pair("float32", param_dtype="float32")
    jocfg = JO.AdamWConfig(state_dtype="int8")
    _, jstate, _ = jax.jit(JS.make_train_step(jcfg, jocfg))(
        jp, JO.init(jp, jocfg), {k: jnp.asarray(v) for k, v in
                                 _batch(pcfg).items()})
    return jcfg, jp, pcfg, tree, jax.tree.map(np.asarray, jstate)


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_checkpoint_round_trips_params_and_int8_state(tmp_path, layout):
    """The reduced deepseek's parameters (float32, so that the sharded
    layout takes them) and an int8 AdamW state after one reference step
    (``q`` and ``scale`` not zero), saved by both packages' managers
    through a codec (the float32 leaves of at least the default 65,536
    values, the embedding and the unembedding, compressed),
    into one archive or on a (4, 2) mesh layout in 4 shards: the same
    step directory byte for byte; the port's restore of either directory
    gives every raw leaf back bit for bit and every compressed one within
    its bound, and ``convert.unstack_layers`` gives back the ``mtp``
    group and both layer stacks."""
    from types import SimpleNamespace

    from repro.core import Codec as JCodec, CodecConfig as JCodecConfig
    from repro.core.cache import PlanCache as JPlanCache

    from repro_torch.core.cache import PlanCache
    from repro_torch.core.codec import Codec, CodecConfig

    jcfg, jp, pcfg, tree, jstate = _int8_state()
    state = convert.opt_state_from_jax(jstate, pcfg, "cpu")
    assert sorted(state["m"]["mtp"]["fuse"]) == ["q", "scale"]
    assert bool(state["m"]["mtp"]["fuse"]["q"].ne(0).any())
    params = convert.params_from_jax(tree, pcfg, "cpu")

    def codecs():
        return (Codec(CodecConfig(backend="ref"), plan_cache=PlanCache()),
                JCodec(JCodecConfig(), plan_cache=JPlanCache()))

    kw = {}
    if layout == "sharded":
        kw = {"mesh": SimpleNamespace(shape={"data": 4, "model": 2},
                                      axis_names=("data", "model")),
              "shard_count": 4}
    codec, jcodec = codecs()
    tm = man.CheckpointManager(str(tmp_path / "port"), codec=codec)
    jm = jman.CheckpointManager(str(tmp_path / "jax"), codec=jcodec)
    tm.save(1, convert.sorted_tree(convert.stack_layers(params)),
            convert.opt_state_stacked(state), **kw)
    jm.save(1, jp, jax.tree.map(jnp.asarray, jstate), **kw)
    step = "step_00000001"
    got, want = (_files(os.path.join(m.dir, step)) for m in (tm, jm))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    entries = json.loads(want["manifest.json"])["entries"]
    kinds = {e["kind"] for e in entries.values()}
    assert ("sz-sharded" if layout == "sharded" else "sz") in kinds
    assert {"params.mtp.fuse", "params.dense_layers.attn.wuk",
            "params.layers.moe.wg", "opt.m.mtp.fuse.q"} <= set(entries)
    saved = _flat({"params": convert.sorted_tree(convert.stack_layers(
        params)), "opt": convert.opt_state_stacked(state)})
    codec, _ = codecs()
    for src in (tm.dir, jm.dir):
        r = man.CheckpointManager(src, codec=codec).restore()
        flat = _flat({"params": r["params"], "opt": r["opt"]})
        assert sorted(flat) == sorted(saved)
        for k, v in flat.items():
            w = saved[k]
            assert v.dtype == w.dtype and v.shape == w.shape, k
            if entries[k]["kind"] == "raw":
                assert as_bytes(v) == as_bytes(w), k
            else:       # within the bound the codec gives the leaf
                bound = codec.compress(w).eb_effective
                assert 0 < float((v - w).abs().max()) <= bound, k
        back = convert.unstack_layers(r["params"])
        assert len(back["dense_layers"]) == 1 and len(back["layers"]) == 1
        assert sorted(back["mtp"]) == ["block", "fuse", "norm"]


def _stacked_spec(spec):
    """A stacked leaf's spec without its layer axis's leading None (a
    replicated leaf's is empty)."""
    if not spec:
        return ()
    assert spec[0] is None
    return tuple(spec[1:])


def test_sharding_rules_on_the_ports_list_of_layers_tree(monkeypatch):
    """The MLA (``wdq``, ``wuq``, ``wdkv``, ``wuk``, ``wuv``), expert,
    router and ``mtp/fuse`` rules on the port's own tree: stacked by
    ``convert.stack_layers``, the reference's specs on its tree leaf for
    leaf; as the port's list of layers, each layer's spec is the
    reference's without its leading layer axis; the ``latent`` cache's
    spec is the reference's."""
    import torch.utils._pytree as pytree

    from repro.runtime import sharding as jsh

    from repro_torch.runtime import sharding as sh

    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.delenv("REPRO_MOE_SHARDING", raising=False)
    jcfg = JCFG.get_config(ARCH).reduced()
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    own = T.init_model(0, PCFG.get_config(ARCH).reduced(), "cpu")
    seen = set()
    for ax in ({"data": 4, "model": 2}, {"data": 2, "model": 4},
               {"pod": 2, "data": 16, "model": 16}):
        from types import SimpleNamespace
        mesh = SimpleNamespace(shape=dict(ax), axis_names=tuple(ax))
        want = {jax.tree_util.keystr(kp).replace("['", "").replace(
            "']", "/").rstrip("/"): tuple(s) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                jsh.param_shardings(shapes, mesh),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            [0]}
        stacked = sh.param_shardings(
            convert.sorted_tree(convert.stack_layers(own)), mesh)
        for kp, s in pytree.tree_flatten_with_path(stacked)[0]:
            assert tuple(s.spec) == want[sh._path_str(kp)], kp
        listed = sh.param_shardings(own, mesh)
        n = 0
        for kp, s in pytree.tree_flatten_with_path(listed)[0]:
            path = sh._path_str(kp).split("/")
            if path[0] in ("layers", "dense_layers"):
                ref = want["/".join([path[0]] + path[2:])]
                assert tuple(s.spec) == _stacked_spec(ref), path
                n += 1
            else:
                assert tuple(s.spec) == want["/".join(path)], path
            seen.add(path[-1])
        assert n > 0
        cs = {k: jax.ShapeDtypeStruct(shape, dt) for k, (shape, dt) in
              JD.cache_spec(jcfg, 8, 64).items()}
        got = sh.cache_shardings({k: torch.empty(v.shape, device="meta")
                                  for k, v in cs.items()}, mesh, jcfg)
        assert tuple(got["latent"].spec) == tuple(
            jsh.cache_shardings(cs, mesh, jcfg)["latent"])
    assert {"wdq", "wuq", "wdkv", "wuk", "wuv", "fuse", "router"} <= seen
