"""The port's flash attention and blockwise attention against the JAX
package's.

The same inputs, made with numpy from a seed, go through the Pallas kernel
``repro.kernels.flash_attn.flash_attention`` in interpret mode (as its own
tests run it) and the port's wrapper on CPU tensors, which runs the plain
version (the CUDA kernel itself is held against the plain version on the
card: ``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerances:
float32 2e-5, the reference test's (sums in another order); bfloat16
2e-2 (both round a float32 result to bfloat16 once, the Pallas kernel from
its own bf16 products).  The port's ``blockwise_attn`` against the
reference's: float32 1e-5; bfloat16 3e-2, since the reference rounds
``exp(s - m)`` to bfloat16 before ``e @ v`` and the port keeps it in
float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attn import flash_attention as jflash
from repro.models import attention as JA

from repro_torch.kernels import flash_attn as FA
from repro_torch.models import attention as A


def _inputs(shape_q, shape_k, shape_v, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in (shape_q, shape_k, shape_v))


def _port(q, k, v, dtype=torch.float32, **kw):
    before = FA.flash_attention.launches
    out = FA.flash_attention(*(torch.from_numpy(a).to(dtype)
                               for a in (q, k, v)), **kw)
    assert FA.flash_attention.launches == before   # CPU: the plain version
    return out.float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,skv,d,dv,bq,bk", [
    (2, 128, 128, 32, 32, 64, 64),
    (1, 256, 128, 64, 64, 64, 128),   # rectangular (cross-attn shape)
    (3, 128, 128, 16, 32, 32, 64),    # dv != d (MLA value dims)
    (2, 512, 512, 128, 128, 128, 128),  # full TPU tile shapes
])
def test_plain_matches_pallas(causal, bh, sq, skv, d, dv, bq, bk):
    q, k, v = _inputs((bh, sq, d), (bh, skv, d), (bh, skv, dv), sq + skv + d)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                             block_q=bq, block_k=bk))
    np.testing.assert_allclose(_port(q, k, v, causal=causal), want,
                               rtol=2e-5, atol=2e-5)


def test_plain_bf16_io():
    q, k, v = _inputs((2, 128, 32), (2, 128, 32), (2, 128, 32), 7)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  causal=True, block_q=64, block_k=64)
    assert want.dtype == jnp.bfloat16
    out = FA.flash_attention(*(torch.from_numpy(a).bfloat16()
                               for a in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_extreme_logits_stable():
    """Large-magnitude scores must not overflow the softmax."""
    q = np.full((1, 64, 16), 30.0, np.float32)
    v = np.ones((1, 64, 16), np.float32)
    out = _port(q, q, v, causal=True)
    want = np.asarray(jflash(*map(jnp.asarray, (q, q, v)), causal=True,
                             block_q=32, block_k=32))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 1.0, rtol=1e-5)
    np.testing.assert_allclose(out, want, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 8])
def test_gqa_matches_pallas_on_repeated_kv(causal, groups):
    """Query row bh reads kv row bh // groups: the Pallas kernel on kv rows
    repeated ``groups`` times computes the same."""
    q, k, v = _inputs((16, 128, 64), (16 // groups, 128, 64),
                      (16 // groups, 128, 64), groups)
    rep = [np.repeat(a, groups, axis=0) for a in (k, v)]
    want = np.asarray(jflash(*map(jnp.asarray, (q, *rep)), causal=causal,
                             block_q=64, block_k=64))
    np.testing.assert_allclose(_port(q, k, v, causal=causal), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("scale", [1.0, 0.05])
def test_scale_matches_pallas(scale):
    """``scale`` multiplies q in float32 as the kernel's d ** -0.5 does: the
    Pallas kernel on q * scale / d ** -0.5 computes the same."""
    d = 32
    q, k, v = _inputs((2, 64, d), (2, 64, d), (2, 64, d), 11)
    qs = (q * np.float32(scale / d ** -0.5)).astype(np.float32)
    want = np.asarray(jflash(*map(jnp.asarray, (qs, k, v)), causal=True,
                             block_q=32, block_k=32))
    np.testing.assert_allclose(_port(q, k, v, causal=True, scale=scale),
                               want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(77, 77), (77, 100), (100, 77), (1, 9)])
def test_ragged_lengths_match_pallas(causal, sq, skv):
    """Any Sq and Skv: the Pallas kernel with one block the whole length."""
    q, k, v = _inputs((2, sq, 32), (2, skv, 32), (2, skv, 16), sq * skv)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                             block_q=sq, block_k=skv))
    np.testing.assert_allclose(_port(q, k, v, causal=causal), want,
                               rtol=2e-5, atol=2e-5)


def test_wrapper_checks():
    q = torch.zeros((2, 8, 32))
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        FA.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="up to"):
        big = torch.zeros((2, 8, 256))
        FA.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        FA.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="BH % BHkv"):
        FA.flash_attention(q, torch.zeros((3, 8, 32)),
                           torch.zeros((3, 8, 32)))
    with pytest.raises(ValueError, match="do not match"):
        FA.flash_attention(q, q, torch.zeros((2, 9, 32)))
    with pytest.raises(ValueError, match="non-empty"):
        FA.flash_attention(q[:, :0], q, q)


# ---------------------------------------------------------------------------
# blockwise_attn (the model's attention) against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,sq", [(4, 4, 64), (4, 2, 96), (8, 1, 40)])
def test_blockwise_attn_matches_reference(dtype, causal, hq, hkv, sq):
    d = 32
    q, k, v = _inputs((2, sq, hq, d), (2, sq, hkv, d), (2, sq, hkv, d),
                      hq * 7 + hkv + sq)
    jdt = jnp.dtype(dtype)
    want = JA.blockwise_attn(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             causal=causal, chunk=32)
    tdt = getattr(torch, dtype)
    got = A.blockwise_attn(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_attn_kernel_inputs_keep_the_reference_rounding():
    """q is scaled by d ** -0.5 in its own type before the kernel, as the
    reference's blockwise_attn scales it (attention.py:102)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 4, 128)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 128)).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16) * (128 ** -0.5)
    q3, k3, v3 = A.attn_kernel_inputs(torch.from_numpy(q).bfloat16(),
                                      torch.from_numpy(k).bfloat16(),
                                      torch.from_numpy(k).bfloat16())
    assert q3.shape == (8, 5, 128) and k3.shape == (4, 5, 128)
    assert q3.is_contiguous() and k3.is_contiguous()
    want = np.asarray(jq.transpose(0, 2, 1, 3), np.float32).reshape(8, 5, 128)
    np.testing.assert_array_equal(q3.float().numpy(), want)


def test_unported_attention_options_raise():
    """Sliding windows and cross-attention name their ROADMAP item."""
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP A10.*sliding"):
        A.blockwise_attn(q, q, q, causal=True, window=4)
    from repro_torch import configs
    cfg = configs.get_config("qwen3-0.6b").reduced()
    x = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(NotImplementedError, match="ROADMAP A10.*cross"):
        A.attn_block(x, {}, cfg, None, kv_x=x)
