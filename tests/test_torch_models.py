"""The port's model stack (``repro_torch.models``, ``configs``,
``launch.serve``) against the JAX package's.

The reference's weights (``T.init_model`` from a PRNG key, numpy arrays)
cross to the port through ``models/convert.py``; tokens are made with numpy
from a seed; the JAX side runs under ``jax.jit`` on the CPU, the port on CPU
tensors (so attention and the RWKV recurrence run their kernels' plain
versions).  Tolerances: float32 logits 1e-4 (sums in another order; the
port's attention keeps ``exp(s - m)`` in float32 as the reference does in
float32); bfloat16 logits 5e-2 with equal argmax, the reference test's
(the frameworks round bfloat16 at other places: XLA may keep an
elementwise chain in float32, torch rounds every op); caches in float32
1e-4, in bfloat16 5e-2 of their scale.  The vlm and encdec families get
seeded, non-zero stub embeddings (``extra_embeds``); sequences are longer
than the reduced danube's window of 32, so the window masks.

``apply_mrope`` and ``layer_norm`` agree with the reference's within 1e-6
(a few float32 ulps, not bit for bit: torch's and XLA's ``sin`` / ``cos``
and their sums round apart); ``_quantize_heads`` gives the reference's
codes and scales bit for bit on the same input.  The int8 KV cache
(``kv_quant``) in decode: float32 compute, logits within 1e-4 and the
scales within 1e-6 of the reference's, the int8 codes equal at all but a
thousandth of the elements and within one code there (a key a float32
rounding away from a half-way point rounds to the other code); against the
port's own bfloat16 cache the reference's family-wide tolerance (equal
argmax, logits within 0.25).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JCFG
from repro.launch import serve as jserve
from repro.models import attention as JA
from repro.models import config as JMC
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import steps as JS
from repro.models import transformer as JT

from repro_torch import configs as PCFG
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import config as PMC
from repro_torch.models import convert
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import steps as S
from repro_torch.models import transformer as T

ARCHS = ["qwen3-0.6b", "rwkv6-3b", "h2o-danube-1.8b", "whisper-base",
         "qwen2-vl-72b", "qwen2-moe-a2.7b", "deepseek-v3-671b", "zamba2-7b"]
DTYPES = ["float32", "bfloat16"]
#: The families the port once left unported, each with an arch of it.
UNPORTED = {"zamba2-7b": "hybrid_ssm"}
#: Tokens of the forward tests: past the reduced danube's window (32).
SEQ = 40


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(arch, dtype, seed=0, random_u=True, **over):
    """The reference's reduced config and weights, and the port's."""
    jcfg = JCFG.get_config(arch).reduced(compute_dtype=dtype, **over)
    pcfg = PCFG.get_config(arch).reduced(compute_dtype=dtype, **over)
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(seed),
                                                  jcfg))
    if jcfg.family == "rwkv" and random_u:
        # the init's u is 0; a bonus that matters exercises the recurrence
        u = tree["layers"]["tmix"]["u"]
        tree["layers"]["tmix"]["u"] = np.random.default_rng(seed).normal(
            0, 0.5, u.shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, pcfg, convert.params_from_jax(tree, pcfg, "cpu")


def _extra(cfg, b, seed=3):
    """Seeded, non-zero stub embeddings of the vlm (8 patches) and encdec
    (``encoder_seq`` frames) families, numpy float32; None for the rest."""
    n = {"vlm": 8, "encdec": cfg.encoder_seq}.get(cfg.family)
    if n is None:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)


def _jx(a):
    return None if a is None else jnp.asarray(a)


def _tx(a):
    return None if a is None else _t(a)


def _close(got, want, dtype, scale_tol=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        tol = scale_tol if scale_tol is not None else 5e-2
        assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _same_argmax(got, want, tol):
    """Equal argmax at every position whose reference top-2 gap exceeds the
    logits' tolerance (a closer pair may swap within the tolerance)."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def test_registry_holds_the_ten_configs():
    assert list(PCFG.REGISTRY) == list(JCFG.REGISTRY)
    assert len(PCFG.REGISTRY) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        PCFG.get_config("gpt-2")


@pytest.mark.parametrize("arch", list(JCFG.REGISTRY))
def test_config_fields_and_counts_match(arch):
    j, p = JCFG.get_config(arch), PCFG.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(p.reduced())
    assert JMC.count_params(j) == PMC.count_params(p)
    assert str(j.pdt) == str(p.pdt).replace("torch.", "")
    assert str(j.cdt) == str(p.cdt).replace("torch.", "")
    assert p.head_dim == j.head_dim and \
        p.is_subquadratic == j.is_subquadratic


def test_full_width_sizes():
    """The two configs this slice serves: 0.60 B and 3.80 B parameters."""
    assert round(PMC.count_params(PCFG.get_config("qwen3-0.6b")), -7) \
        == 600_000_000
    assert round(PMC.count_params(PCFG.get_config("rwkv6-3b")), -7) \
        == 3_800_000_000


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale))
    got = L.rms_norm(_t(x).to(getattr(torch, dtype)), _t(scale))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("pos_shape", [(7,), (3, 1)])
def test_rope_matches(theta, pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, pos_shape[-1], 2, 32)).astype(np.float32)
    pos = np.arange(np.prod(pos_shape), dtype=np.int32).reshape(pos_shape) \
        + 100
    np.testing.assert_allclose(L.rope_freqs(32, theta).numpy(),
                               np.asarray(JL.rope_freqs(32, theta)),
                               rtol=1e-6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind,act", [("gated", "silu"), ("gated", "relu"),
                                      ("plain", "gelu")])
def test_mlp_matches(kind, act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    names = ("wg", "wu", "wd") if kind == "gated" else ("wi", "wo")
    shapes = {"wg": (16, 24), "wu": (16, 24), "wd": (24, 16),
              "wi": (16, 24), "wo": (24, 16)}
    p = {n: (rng.standard_normal(shapes[n]) * 0.3).astype(np.float32)
         for n in names}
    want = JL.mlp_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, p), act)
    got = L.mlp_apply(_t(x), {k: _t(v) for k, v in p.items()}, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2.5-3b"])
def test_project_qkv_matches(arch):
    """qk-norm (qwen3), QKV bias (qwen2.5) and rope."""
    jcfg, jparams, pcfg, pparams = _pair(arch, "float32")
    x = np.random.default_rng(4).standard_normal(
        (2, 6, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    if "bq" in jp:
        jp = dict(jp, bq=jnp.full(jp["bq"].shape, 0.1),
                  bk=jnp.full(jp["bk"].shape, -0.2),
                  bv=jnp.full(jp["bv"].shape, 0.3))
    pp = {k: _t(v) for k, v in jp.items()}
    pos = np.arange(6, dtype=np.int32)
    want = JA._project_qkv(jnp.asarray(x), jp, jcfg, jnp.asarray(pos))
    got = A._project_qkv(_t(x), pp, pcfg, _t(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Init and weights across
# ---------------------------------------------------------------------------


def test_apply_mrope_matches():
    """Three position streams that differ, sections (4, 6, 6)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 3, 7)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 6, 6), 1e6)
    got = L.apply_mrope(_t(x), _t(pos), (4, 6, 6), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    same = np.repeat(pos[:, :1], 3, axis=1)       # text: equal streams
    np.testing.assert_allclose(
        L.apply_mrope(_t(x), _t(same), (4, 6, 6), 1e6).numpy(),
        L.apply_rope(_t(x), _t(same[:, 0]), 1e6).numpy(), rtol=1e-6,
        atol=1e-6)
    with pytest.raises(ValueError, match="sum"):
        L.apply_mrope(_t(x), _t(pos), (4, 6, 5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches(dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 5, 64)) * 3 + 1).astype(np.float32)
    sc, b = rng.standard_normal((2, 64)).astype(np.float32)
    want = JL.layer_norm(jnp.asarray(x, dtype), jnp.asarray(sc),
                         jnp.asarray(b))
    got = L.layer_norm(_t(x).to(getattr(torch, dtype)), _t(sc), _t(b))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_quantize_heads_bit_exact():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 9, 4, 32)) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0                              # the 1e-12 floor
    x[1, 2, 3, :4] = [1.5, -2.5, 127.0, 0.5]      # ties, half to even
    jq, js = JA._quantize_heads(jnp.asarray(x))
    q, scale = A._quantize_heads(_t(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))


@pytest.mark.parametrize("pos,window", [(5, None), (20, None), (37, 16)])
def test_decode_attn_int8_matches_reference(pos, window):
    """One int8 decode step of the reduced qwen2-vl's attention (bias,
    M-RoPE) over a seeded, partly written cache (a 16-slot ring buffer
    past its wrap with the window): the output within 1e-5, the written
    codes and scales equal (float32: the projections agree to rounding,
    and no value of this seed lies that close to a half-way point)."""
    jcfg, jparams, pcfg, pparams = _pair("qwen2-vl-72b", "float32")
    jcfg = dataclasses.replace(jcfg, kv_quant=True)
    pcfg = dataclasses.replace(pcfg, kv_quant=True)
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    shape = (2, 16, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {"k": rng.integers(-127, 128, shape).astype(np.int8),
             "v": rng.integers(-127, 128, shape).astype(np.int8),
             "k_scale": rng.uniform(1e-3, 2e-2, shape[:3]).astype(np.float32),
             "v_scale": rng.uniform(1e-3, 2e-2, shape[:3]).astype(np.float32)}
    jp = jax.tree.map(lambda a: a[0].astype(jnp.float32),
                      jparams["layers"]["attn"])
    pp = {k: _t(v) for k, v in jp.items()}
    want, wc = JA.decode_attn_int8(jnp.asarray(x), jp, jcfg,
                                   jax.tree.map(jnp.asarray, cache), pos,
                                   window=window)
    pc = {k: _t(v) for k, v in cache.items()}
    got, pc = A.decode_attn_int8(_t(x), pp, pcfg, pc, pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in cache:
        np.testing.assert_array_equal(pc[k].numpy(), np.asarray(wc[k]),
                                      err_msg=k)


def test_repeat_kv_and_kv_layout_match():
    k = np.random.default_rng(9).standard_normal((2, 5, 2, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(A.repeat_kv(_t(k), 6).numpy(),
                                  np.asarray(JA.repeat_kv(jnp.asarray(k), 6)))
    assert A.repeat_kv(_t(k), 2) is not None and \
        torch.equal(A.repeat_kv(_t(k), 2), _t(k))
    assert dataclasses.asdict(A.KVLayout(64, 8, 128)) == \
        dataclasses.asdict(JA.KVLayout(64, 8, 128))


def test_project_qkv_cross_and_mrope_match():
    """K and V from ``kv_x`` (cross-attention, no positions) and M-RoPE
    (qwen2-vl: bias and (3, S) positions)."""
    jcfg, jparams, pcfg, pparams = _pair("qwen2-vl-72b", "float32")
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    kv_x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0].astype(jnp.float32),
                      jparams["layers"]["attn"])       # bfloat16 params
    jp = dict(jp, bq=jnp.full(jp["bq"].shape, 0.1),
              bk=jnp.full(jp["bk"].shape, -0.2))
    pp = {k: _t(v) for k, v in jp.items()}
    pos = rng.integers(0, 50, (3, 6)).astype(np.int32)
    for jargs, pargs in (((jnp.asarray(pos),), (_t(pos),)),
                         ((None, jnp.asarray(kv_x)), (None, _t(kv_x)))):
        want = JA._project_qkv(jnp.asarray(x), jp, jcfg, *jargs)
        got = A._project_qkv(_t(x), pp, pcfg, *pargs)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_shapes_and_scales(arch):
    jcfg = JCFG.get_config(arch).reduced()
    pcfg = PCFG.get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    params = T.init_model(0, pcfg, "cpu")
    ref = convert.params_from_jax(tree, pcfg, "cpu")
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [k for k, _ in flat_p] == [k for k, _ in flat_r]
    for (path, a), (_, b) in zip(flat_p, flat_r):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        std_a, std_b = a.double().std().item(), b.double().std().item()
        if std_b == 0:       # constants: norms, mixes, w0, u
            assert torch.equal(a, b), path
        else:
            assert abs(std_a - std_b) <= 0.1 * std_b, (path, std_a, std_b)
    assert abs(params["embed"].std().item() - 0.02) < 0.002
    if arch == "rwkv6-3b":
        tm = params["layers"][0]["tmix"]
        assert (tm["w0"] == -6).all() and (tm["u"] == 0).all()
        assert (tm["mix"] == 0.5).all()
        assert abs(tm["w_lora_b"].std().item() - 1e-2) < 1e-3


def test_init_is_seeded():
    cfg = PCFG.get_config("qwen3-0.6b").reduced()
    a, b = T.init_model(3, cfg, "cpu"), T.init_model(3, cfg, "cpu")
    c = T.init_model(4, cfg, "cpu")
    assert torch.equal(a["layers"][1]["attn"]["wq"],
                       b["layers"][1]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])


def test_params_from_jax_is_a_rename_and_an_unstack():
    jcfg, jparams, pcfg, pparams = _pair("qwen3-0.6b", "float32")
    for i in range(jcfg.n_layers):
        np.testing.assert_array_equal(
            pparams["layers"][i]["attn"]["wq"].numpy(),
            np.asarray(jparams["layers"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            pparams["layers"][i]["mlp"]["wd"].numpy(),
            np.asarray(jparams["layers"]["mlp"]["wd"][i]))
    assert "unembed" not in pparams          # tied embeddings
    bf = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = convert.to_torch(bf, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.to_numpy(t),
                                  bf.astype(np.float32))


# ---------------------------------------------------------------------------
# Forward and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    jcfg, jparams, pcfg, pparams = _pair(arch, dtype)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, SEQ),
                                             dtype=np.int32)
    extra = _extra(jcfg, 2)
    want = jax.jit(JS.make_prefill_step(jcfg))(jparams, jnp.asarray(toks),
                                               _jx(extra))
    got = S.make_prefill_step(pcfg)(pparams, _t(toks), _tx(extra))
    s_total = SEQ + (8 if jcfg.family == "vlm" else 0)
    assert got.dtype == pcfg.cdt and \
        tuple(got.shape) == (2, s_total, jcfg.vocab)
    got, want = convert.to_numpy(got), np.asarray(want, np.float32)
    _close(got, want, dtype)
    _same_argmax(got, want, 1e-4 if dtype == "float32" else 5e-2)
    _check_aux(jcfg, jparams, pcfg, pparams, toks, extra)


def _check_aux(jcfg, jparams, pcfg, pparams, toks, extra=None):
    """The forward's aux loss: the moe and mla_moe families' router loss
    (the layers' Switch losses summed, times ``router_aux_coef``) within
    1e-6 relative of the reference's in float32; in bfloat16 within 1e-3
    relative (the routers past the first layer see hidden states that the
    frameworks round to bfloat16 at other places, 2**-8 relative an
    element); 0 for every other family."""
    _, jaux = JT.forward(jparams, jnp.asarray(toks), jcfg,
                         extra_embeds=_jx(extra))
    _, paux = T.forward(pparams, _t(toks), pcfg, extra_embeds=_tx(extra))
    assert paux.dtype == torch.float32 and paux.shape == ()
    if pcfg.family not in ("moe", "mla_moe"):
        assert float(paux) == float(jaux) == 0.0
        return
    assert float(jaux) > 0
    tol = 1e-6 if pcfg.compute_dtype == "float32" else 1e-3
    assert abs(float(paux) - float(jaux)) <= tol * float(jaux)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_with_a_dense_prefix_matches_reference(dtype):
    """The reduced qwen2-moe with ``first_k_dense=1`` (deepseek's layout:
    a dense-MLP layer before the expert layers): the forward's logits and
    aux against the reference's; its decode raises on both sides."""
    jcfg, jparams, pcfg, pparams = _pair("qwen2-moe-a2.7b", dtype,
                                         first_k_dense=1)
    assert len(pparams["dense_layers"]) == 1 and len(pparams["layers"]) == 1
    assert "mlp" in pparams["dense_layers"][0]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, SEQ),
                                             dtype=np.int32)
    want = jax.jit(JS.make_prefill_step(jcfg))(jparams, jnp.asarray(toks))
    got = S.make_prefill_step(pcfg)(pparams, _t(toks))
    got, want = convert.to_numpy(got), np.asarray(want, np.float32)
    _close(got, want, dtype)
    _same_argmax(got, want, 1e-4 if dtype == "float32" else 5e-2)
    _check_aux(jcfg, jparams, pcfg, pparams, toks)
    jcache = JD.init_cache(jcfg, 2, 8)
    with pytest.raises(NotImplementedError):
        JD.forward_decode(jparams, jnp.asarray(toks[:, :1]), jcache,
                          jnp.int32(0), jcfg)
    pcache = D.init_cache(pcfg, 2, 8, "cpu")
    with pytest.raises(NotImplementedError, match="first_k_dense"):
        D.forward_decode(pparams, _t(toks[:, :1]), pcache, 0, pcfg)
    assert not any(bool(v.any()) for v in pcache.values())


def _decode_against_reference(jcfg, jparams, pcfg, pparams, toks, kv_len,
                              dtype):
    """Serve steps over ``toks`` on both sides from the reference's zero
    cache (encdec's cross entries seeded, non-zero): the logits of each
    step and the whole cache after it, at the module's tolerances; under
    ``kv_quant`` the logits within 1e-3 (a code one off moves its key or
    value by a quantization step, ``scale``, and the logits with it)."""
    b, n = toks.shape
    jcache = JD.init_cache(jcfg, b, kv_len)
    if jcfg.family == "encdec":
        rng = np.random.default_rng(4)
        jcache = dict(jcache, **{
            k: jnp.asarray(rng.standard_normal(jcache[k].shape), jcfg.cdt)
            for k in ("xk", "xv")})
    pcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()} \
        == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in pcache.items()}
    jstep = jax.jit(JS.make_serve_step(jcfg))
    pstep = S.make_serve_step(pcfg)
    codes = [0, 0]
    for t in range(n):
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        pl, pcache = pstep(pparams, _t(toks[:, t:t + 1]), pcache, t)
        if pcfg.kv_quant:
            np.testing.assert_allclose(convert.to_numpy(pl),
                                       np.asarray(jl), rtol=1e-3, atol=1e-3)
        else:
            _close(convert.to_numpy(pl), jl, dtype)
        want = jax.tree.map(lambda a: np.asarray(a), jcache)
        got = convert.cache_to_numpy(pcache)
        assert set(got) == set(want)
        for k in want:
            if want[k].dtype == np.int8:          # kv_quant codes
                d = np.abs(got[k].astype(np.int32) - want[k])
                assert got[k].dtype == np.int8 and d.max() <= 1, k
                codes[0] += int((d > 0).sum())
                codes[1] += d.size
                continue
            w = want[k].astype(np.float32)
            scale = max(1.0, float(np.abs(w).max()))
            _close(got[k] / scale, w / scale, dtype)
    assert codes[0] <= 1e-3 * codes[1], codes
    return pl, pcache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_decode_matches_reference(arch, dtype):
    """Eight serve steps: the logits of each and the whole cache after it."""
    jcfg, jparams, pcfg, pparams = _pair(arch, dtype)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8),
                                             dtype=np.int32)
    _decode_against_reference(jcfg, jparams, pcfg, pparams, toks, 12, dtype)


def test_swa_decode_past_the_wrap_matches_reference():
    """Reduced danube (window 32): 40 steps into a 64-token request, whose
    cache is a 32-slot ring buffer that wraps at step 32, step for step
    against the reference."""
    jcfg, jparams, pcfg, pparams = _pair("h2o-danube-1.8b", "float32")
    assert pcfg.swa_window == 32
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 40),
                                              dtype=np.int32)
    _, cache = _decode_against_reference(jcfg, jparams, pcfg, pparams, toks,
                                         64, "float32")
    assert cache["k"].shape[2] == 32


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "h2o-danube-1.8b",
                                  "qwen2-vl-72b"])
def test_int8_kv_decode_matches_reference(arch):
    """kv_quant: the reference's TestKVQuantFamilywide case (2 layers, B 1,
    8 steps, a 16-token cache; danube 40 steps, past its ring buffer's
    wrap), float32 compute, step for step against the reference; then the
    port's int8 cache against its own bfloat16 one at the reference test's
    tolerance."""
    jcfg, jparams, pcfg, pparams = _pair(arch, "float32")
    jq = dataclasses.replace(jcfg, n_layers=2, kv_quant=True)
    pq = dataclasses.replace(pcfg, n_layers=2, kv_quant=True)
    n = 40 if pcfg.swa_window else 8
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, (1, n),
                                              dtype=np.int32)
    _, cache = _decode_against_reference(jq, jparams, pq, pparams, toks,
                                         16, "float32")
    assert cache["k"].dtype == torch.int8 and \
        cache["k_scale"].dtype == torch.float32
    bcfg = PCFG.get_config(arch).reduced()       # bfloat16, 2 layers
    params = pparams
    qcfg = dataclasses.replace(bcfg, kv_quant=True)
    ca, cb = D.init_cache(bcfg, 1, 16, "cpu"), D.init_cache(qcfg, 1, 16,
                                                             "cpu")
    sa, sb = S.make_serve_step(bcfg), S.make_serve_step(qcfg)
    for t in range(8):
        la, ca = sa(params, _t(toks[:, t:t + 1]), ca, t)
        lb, cb = sb(params, _t(toks[:, t:t + 1]), cb, t)
    a, b = la[0, 0].float().numpy(), lb[0, 0].float().numpy()
    assert a.argmax() == b.argmax()
    assert np.abs(a - b).max() < 0.25, np.abs(a - b).max()


def test_whisper_decode_matches_forward_with_real_encoder():
    """whisper-base: xk and xv from a real encoder output
    (``transformer.encode`` of seeded frames, ``decode.cross_cache``);
    step decode over the tokens against the forward's logits at every
    position, float32."""
    cfg = PCFG.get_config("whisper-base").reduced(compute_dtype="float32")
    params = T.init_model(0, cfg, "cpu")
    frames = _t(_extra(cfg, 2))
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (2, 12)))
    full = S.make_prefill_step(cfg)(params, toks, frames)
    cache = D.init_cache(cfg, 2, 16, "cpu")
    with torch.inference_mode():
        cache.update(D.cross_cache(params, T.encode(params, frames, cfg),
                                   cfg))
    assert float(cache["xk"].abs().max()) > 0
    step = S.make_serve_step(cfg)
    for t in range(12):
        lg, cache = step(params, toks[:, t:t + 1], cache, t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own step decode over a prompt against its forward, as
    the reference's TestDecodeConsistency holds the reference (danube 40
    tokens, past its window; whisper's cross entries from its encoder; the
    vlm decodes text, so its forward has no patches).  zamba2 decodes its
    window's 32 tokens: the reference's hybrid decode writes the shared
    block's cache with no window, so past it decode and forward part on
    both sides (ROADMAP §C; ``test_torch_ssm.py`` holds the port to the
    reference there)."""
    cfg = PCFG.get_config(arch).reduced(n_layers=2)
    params = T.init_model(0, cfg, "cpu")
    n = 8
    if cfg.swa_window:
        n = cfg.swa_window if cfg.family == "hybrid_ssm" else 40
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, n)))
    frames = _tx(_extra(cfg, 1)) if cfg.family == "encdec" else None
    full = S.make_prefill_step(cfg)(params, toks, frames)
    cache = D.init_cache(cfg, 1, 2 * n, "cpu")
    if frames is not None:
        with torch.inference_mode():
            cache.update(D.cross_cache(
                params, T.encode(params, frames, cfg), cfg))
    step = S.make_serve_step(cfg)
    for t in range(n):
        lg, cache = step(params, toks[:, t:t + 1], cache, t)
    a, b = lg[0, 0].float(), full[0, -1].float()
    assert (a - b).abs().max().item() < 5e-2
    assert a.argmax() == b.argmax()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches_reference(arch):
    jcfg = JCFG.get_config(arch)
    pcfg = PCFG.get_config(arch)
    want = JD.cache_spec(jcfg, 4, 64)
    got = D.cache_spec(pcfg, 4, 64)
    assert {k: (s, str(jnp.dtype(d))) for k, (s, d) in want.items()} == \
        {k: (s, str(d).replace("torch.", "")) for k, (s, d) in got.items()}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "h2o-danube-1.8b",
                                  "qwen2-vl-72b", "whisper-base",
                                  "qwen2-moe-a2.7b"])
def test_cache_spec_kv_quant_and_window_match_reference(arch):
    """kv_quant (int8 k, v and float32 scales; ignored by encdec and moe,
    as the reference ignores it) on the reduced configs, whose danube
    window (32) caps a 64-token cache."""
    jcfg = dataclasses.replace(JCFG.get_config(arch).reduced(),
                               kv_quant=True)
    pcfg = dataclasses.replace(PCFG.get_config(arch).reduced(),
                               kv_quant=True)
    want = JD.cache_spec(jcfg, 4, 64)
    got = D.cache_spec(pcfg, 4, 64)
    assert {k: (s, str(jnp.dtype(d))) for k, (s, d) in want.items()} == \
        {k: (s, str(d).replace("torch.", "")) for k, (s, d) in got.items()}


def test_cross_entropy_matches():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 6)).astype(np.int32)
    want = float(JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(S.cross_entropy(_t(logits), _t(labels)))
    assert abs(got - want) <= 1e-6


# ---------------------------------------------------------------------------
# serve.main
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "4",
            "--gen-len", "3"]
    got = serve.main(argv + ["--device", "cpu"])
    want = jserve.main(argv)
    assert got["tokens"].shape == want["tokens"].shape == (2, 4)
    assert got["tokens"].dtype == want["tokens"].dtype
    assert set(got) == set(want)
    assert ((0 <= got["tokens"]) & (got["tokens"] < 512)).all()
    again = serve.main(argv + ["--device", "cpu"])
    np.testing.assert_array_equal(got["tokens"], again["tokens"])


@pytest.mark.parametrize("flag,item", [
    (["--compress-kv"], "A10"), (["--kv-recovery", "skip"], "A10"),
    (["--kv-offload"], "A10"), (["--concurrency", "2"], "A8")])
def test_serve_unported_flags_raise(flag, item, monkeypatch):
    """The KV flags run on every ported family: ``models/kvcache.py`` (A12,
    split out of ``item`` A10) and the serving scheduler (A8) on qwen3, and
    on whisper-base, whose cross-attention (A10) is ported now: its cross
    K/V come from zero frames as the reference's serve.py makes them,
    ``--compress-kv`` skips them, the offload pages only ``k`` and ``v``.
    With the reference's weights and prompt handed to the port, and both
    computing in float32 (bfloat16 logits tie at the argmax too often for
    the two frameworks' roundings to pick the same token), the
    ``--kv-backend ref`` tokens equal the reference's."""
    argv = ["--reduced", "--kv-backend", "ref", "--batch", "2",
            "--prompt-len", "8", "--gen-len", "2", *flag]
    if item == "A8":
        argv += ["--kv-offload", "--kv-block", "4"]
    got = serve.main(["--arch", "qwen3-0.6b", "--device", "cpu", *argv])
    assert got["tokens"].shape == (2, 3)
    if item == "A8":
        assert got["page_stats"]["scheduler"]["blocks_decoded"] == 2
    for mod in (serve, jserve):
        real = mod.configs.get_config
        monkeypatch.setattr(mod.configs, "get_config", lambda a, real=real:
                            dataclasses.replace(real(a),
                                                compute_dtype="float32"))
    cfg = JCFG.get_config("whisper-base").reduced()
    key = jax.random.PRNGKey(0)
    tree = jax.tree.map(np.asarray, JT.init_model(key, cfg))
    prompt = np.asarray(jax.random.randint(key, (2, 8), 0, cfg.vocab))
    monkeypatch.setattr(serve.T, "init_model", lambda seed, c, device:
                        convert.params_from_jax(tree, c, device))
    monkeypatch.setattr(serve, "_prompt", lambda *a, **kw:
                        torch.from_numpy(prompt.astype(np.int64)))
    got = serve.main(["--arch", "whisper-base", "--device", "cpu", *argv])
    want = jserve.main(["--arch", "whisper-base", *argv])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    if item == "A8":
        assert got["page_stats"]["scheduler"]["blocks_decoded"] == 2
    if flag == ["--compress-kv"]:
        assert got["ratio"] == pytest.approx(want["ratio"])


# ---------------------------------------------------------------------------
# What is not ported, and the card as the default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(UNPORTED))
def test_unported_families_raise(arch, monkeypatch):
    """No family is unported any more: ``UNPORTED_FAMILIES`` is empty and
    ``FAMILIES`` holds the reference's seven, so the arch's family runs
    (init, ``cache_spec``, a forward and a decode step on the CPU).  The
    mechanism stays: a family entered in ``UNPORTED_FAMILIES`` raises
    ``NotImplementedError`` naming its ROADMAP item from every entry
    point, and an unknown family raises ``ValueError``."""
    assert T.UNPORTED_FAMILIES == {}
    assert sorted(T.FAMILIES) == sorted(
        {c.family for c in JCFG.REGISTRY.values()}) and len(T.FAMILIES) == 7
    cfg = PCFG.get_config(arch).reduced()
    assert cfg.family == UNPORTED[arch]
    params = T.init_model(0, cfg, "cpu")
    toks = torch.zeros((1, 2), dtype=torch.long)
    logits, _ = T.forward(params, toks, cfg)
    assert tuple(logits.shape) == (1, 2, cfg.vocab)
    cache = D.init_cache(cfg, 1, 8, "cpu")
    lg, _ = D.forward_decode(params, toks[:, :1], cache, 0, cfg)
    assert bool(torch.isfinite(lg).all())
    monkeypatch.setattr(T, "UNPORTED_FAMILIES",
                        {cfg.family: "A10 (a test's entry)"})
    with pytest.raises(NotImplementedError, match="ROADMAP A10") as e:
        T.init_model(0, cfg, "cpu")
    assert UNPORTED[arch] in str(e.value)
    for call in (lambda: D.cache_spec(cfg, 1, 8),
                 lambda: T.forward({}, torch.zeros((1, 2), dtype=torch.long),
                                   cfg),
                 lambda: D.forward_decode({}, None, {}, 0, cfg)):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            call()
    monkeypatch.undo()
    bogus = dataclasses.replace(cfg, family="bogus")
    for call in (lambda: T.check_family(bogus),
                 lambda: T.init_model(0, bogus, "cpu"),
                 lambda: D.cache_spec(bogus, 1, 8)):
        with pytest.raises(ValueError, match="bogus"):
            call()


def test_default_device_is_the_card():
    """Without a GPU the default entry points raise; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    cfg = PCFG.get_config("qwen3-0.6b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_model(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced"])
