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
1e-4, in bfloat16 5e-2 of their scale.
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

ARCHS = ["qwen3-0.6b", "rwkv6-3b"]
DTYPES = ["float32", "bfloat16"]
UNPORTED = {"qwen2-moe-a2.7b": "moe", "deepseek-v3-671b": "mla_moe",
            "zamba2-7b": "hybrid_ssm", "whisper-base": "encdec",
            "qwen2-vl-72b": "vlm", "h2o-danube-1.8b": "sliding-window"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(arch, dtype, seed=0, random_u=True):
    """The reference's reduced config and weights, and the port's."""
    jcfg = JCFG.get_config(arch).reduced(compute_dtype=dtype)
    pcfg = PCFG.get_config(arch).reduced(compute_dtype=dtype)
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(seed),
                                                  jcfg))
    if jcfg.family == "rwkv" and random_u:
        # the init's u is 0; a bonus that matters exercises the recurrence
        u = tree["layers"]["tmix"]["u"]
        tree["layers"]["tmix"]["u"] = np.random.default_rng(seed).normal(
            0, 0.5, u.shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, pcfg, convert.params_from_jax(tree, pcfg, "cpu")


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
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 24),
                                             dtype=np.int32)
    want = jax.jit(JS.make_prefill_step(jcfg))(jparams, jnp.asarray(toks))
    got = S.make_prefill_step(pcfg)(pparams, _t(toks))
    assert got.dtype == pcfg.cdt and tuple(got.shape) == (2, 24, jcfg.vocab)
    got, want = convert.to_numpy(got), np.asarray(want, np.float32)
    _close(got, want, dtype)
    _same_argmax(got, want, 1e-4 if dtype == "float32" else 5e-2)
    jlog, jaux = JT.forward(jparams, jnp.asarray(toks), jcfg)
    plog, paux = T.forward(pparams, _t(toks), pcfg)
    assert float(paux) == float(jaux) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_decode_matches_reference(arch, dtype):
    """Eight serve steps: the logits of each and the whole cache after it."""
    jcfg, jparams, pcfg, pparams = _pair(arch, dtype)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8),
                                             dtype=np.int32)
    jcache = JD.init_cache(jcfg, 2, 12)
    pcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()} \
        == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in pcache.items()}
    jstep = jax.jit(JS.make_serve_step(jcfg))
    pstep = S.make_serve_step(pcfg)
    for t in range(8):
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        pl, pcache = pstep(pparams, _t(toks[:, t:t + 1]), pcache, t)
        _close(convert.to_numpy(pl), jl, dtype)
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
        got = convert.cache_to_numpy(pcache)
        assert set(got) == set(want)
        for k in want:
            scale = max(1.0, float(np.abs(want[k]).max()))
            _close(got[k] / scale, want[k] / scale, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own step decode over a prompt against its forward, as
    the reference's TestDecodeConsistency holds the reference."""
    cfg = PCFG.get_config(arch).reduced(n_layers=2)
    params = T.init_model(0, cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 8)))
    full = S.make_prefill_step(cfg)(params, toks)
    cache = D.init_cache(cfg, 1, 16, "cpu")
    step = S.make_serve_step(cfg)
    for t in range(8):
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
def test_serve_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                    *flag])


# ---------------------------------------------------------------------------
# What is not ported, and the card as the default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(UNPORTED))
def test_unported_families_raise(arch):
    cfg = PCFG.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP A10") as e:
        T.init_model(0, cfg, "cpu")
    assert UNPORTED[arch] in str(e.value)
    for call in (lambda: D.cache_spec(cfg, 1, 8),
                 lambda: T.forward({}, torch.zeros((1, 2), dtype=torch.long),
                                   cfg),
                 lambda: D.forward_decode({}, None, {}, 0, cfg)):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
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
