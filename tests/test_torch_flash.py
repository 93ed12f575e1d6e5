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

Training: ``flash_attention_trainable``'s gradients against ``jax.grad`` of
the reference's ``flash_attention_trainable`` (interpret-mode forward, XLA
backward) at the reference test's rtol 2e-4 / atol 2e-5 in float32 (GQA
through the reference on kv rows repeated, whose gradient sums each
group); in bfloat16 within 3e-2 of each gradient's scale (both round the
float32 gradients to bfloat16 once, from inputs rounded alike); and the
model's ``blockwise_attn`` gradients against ``jax.grad`` of the
reference's in float32 at 1e-4.

The sliding window and ``q_offset`` (the masking arguments of the
reference's XLA ``blockwise_attn``; the Pallas kernel has neither): the
wrapper on CPU tensors (its plain version), on every case of
``repro_torch.testing.kernel_cases.FLASH_CASES``, against the reference's
``blockwise_attn`` in float32 at 1e-5; the windowed backward against
autograd through ``dense_attention`` at 1e-5 / 1e-6 (as the chunk test).

Multi-head latent attention's head (D up to 192 over Dv up to 128): the
plain version against ``dense_attention`` at D 192 over Dv 128 and D 48
over Dv 32 (float32 1e-5, bfloat16 one bf16 ulp of the output's scale),
the wrapper's refusal of D 193 and Dv 129, and the trainable wrapper's
gradients at (192, 128) against autograd through the plain version.
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
from repro_torch.testing import kernel_cases as KC


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


def _reference_rows(q, k, v, **kw):
    """The reference's blockwise_attn on (BH, S, D) rows laid out as one
    batch of BH heads (its repeat_kv maps head h to kv head h // G, as the
    kernel does), in one query chunk."""
    out = JA.blockwise_attn(*(jnp.asarray(a)[None].transpose(0, 2, 1, 3)
                              for a in (q, k, v)),
                            chunk=q.shape[1], **kw)
    return np.asarray(out)[0].transpose(1, 0, 2)


@pytest.mark.parametrize("case", [c for c in KC.FLASH_CASES
                                  if c[8] is None], ids=lambda c: c[0])
def test_flash_cases_match_reference_blockwise(case):
    """Every kernel case (the window ones included) through the wrapper's
    plain version against the reference's blockwise_attn with the same
    causal, window and q_offset, float32."""
    q, k, v = (t.numpy() for t in KC.flash_inputs(case, torch.float32,
                                                  "cpu"))
    kw = KC.flash_kwargs(case)
    want = _reference_rows(q, k, v, causal=kw["causal"],
                           window=kw["window"], q_offset=kw["q_offset"])
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,q_offset,sq,skv", [
    (True, 16, 0, 96, 96), (True, 1, 0, 64, 64), (True, 200, 0, 96, 96),
    (False, 16, 0, 96, 96), (True, 32, 64, 32, 96), (True, None, 64, 32,
                                                      96)])
def test_blockwise_attn_window_matches_reference(dtype, causal, window,
                                                 q_offset, sq, skv):
    """The model's attention with a window and q_offset, GQA 2, against
    the reference's: float32 1e-5, bfloat16 3e-2 (as above)."""
    q, k, v = _inputs((2, sq, 4, 32), (2, skv, 2, 32), (2, skv, 2, 32),
                      sq + skv + (window or 0))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JA.blockwise_attn(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             causal=causal, chunk=32, window=window,
                             q_offset=q_offset)
    got = A.blockwise_attn(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           causal=causal, window=window, q_offset=q_offset)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    if window is not None and window >= skv and q_offset == 0:
        np.testing.assert_array_equal(
            got.float().numpy(), A.blockwise_attn(
                *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                causal=causal).float().numpy())


def test_fully_masked_rows_raise_and_plain_is_the_reference():
    """A query row that sees no key: the wrapper raises (the kernel takes
    no such shape); the plain version gives the reference's answer, the
    mean of v (its mask is a finite -1e30)."""
    q, k, v = _inputs((2, 40, 32), (2, 24, 32), (2, 24, 32), 51)
    for kw in ({"causal": True, "q_offset": -3},
               {"causal": True, "window": 8, "q_offset": 40},
               {"causal": False, "window": 4, "q_offset": 20}):
        with pytest.raises(ValueError, match="sees no key"):
            _port(q, k, v, **kw)
        got = FA.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                       **kw).numpy()
        np.testing.assert_allclose(got, _reference_rows(q, k, v, **kw),
                                   rtol=1e-5, atol=1e-5)
    for bad in ({"window": 0}, {"window": 2.5}, {"q_offset": 1 << 30}):
        with pytest.raises(ValueError):
            _port(q, k, v, **bad)


# ---------------------------------------------------------------------------
# flash_attention_trainable against the reference's
# ---------------------------------------------------------------------------


def _grads_port(q, k, v, w, dtype=torch.float32, fn=None, **kw):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
          for a in (q, k, v)]
    fn = fn or FA.flash_attention_trainable
    before = FA.flash_attention.launches
    out = fn(*ts, **kw)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert FA.flash_attention.launches == before    # CPU: the plain version
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,skv,d,dv,groups", [
    (2, 128, 128, 32, 32, 1),
    (4, 128, 128, 64, 64, 2),      # GQA
    (8, 64, 128, 32, 16, 4),       # Sq < Skv, Dv != D, GQA
    (2, 128, 64, 16, 32, 1),       # Sq > Skv
])
def test_trainable_gradients_match_reference(causal, bh, sq, skv, d, dv,
                                             groups):
    from repro.kernels.flash_attn import flash_attention_trainable as jft

    q, k, v = _inputs((bh, sq, d), (bh // groups, skv, d),
                      (bh // groups, skv, dv), bh * sq + skv + groups)
    w = np.random.default_rng(5).standard_normal((bh, sq, dv)).astype(
        np.float32)

    def loss(q, k, v):
        rep = [jnp.repeat(a, groups, axis=0) for a in (k, v)]
        return (jft(q, *rep, causal, 64, 64) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    out, got = _grads_port(q, k, v, w, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jflash(jnp.asarray(q), *(jnp.repeat(jnp.asarray(a), groups, 0)
                                 for a in (k, v)), causal=causal,
               block_q=64, block_k=64)), rtol=2e-5, atol=2e-5)
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), rtol=2e-4,
                                   atol=2e-5)


def test_trainable_gradients_bf16():
    from repro.kernels.flash_attn import flash_attention_trainable as jft

    q, k, v = _inputs((4, 128, 32), (2, 128, 32), (2, 128, 32), 21)
    w = np.random.default_rng(6).standard_normal((4, 128, 32)).astype(
        np.float32)

    def loss(q, k, v):
        rep = [jnp.repeat(a, 2, axis=0) for a in (k, v)]
        return (jft(q, *rep, True, 64, 64).astype(jnp.float32) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    _, got = _grads_port(q, k, v, w, torch.bfloat16)
    for g, ww in zip(got, want):
        assert g.dtype == torch.bfloat16 and ww.dtype == jnp.bfloat16
        ww = np.asarray(ww, np.float32)
        err = np.abs(g.float().numpy() - ww).max()
        assert err <= 3e-2 * np.abs(ww).max(), err


@pytest.mark.parametrize("chunk", [7, 16, 50, 512])
def test_backward_chunks_agree(chunk):
    """The backward's query chunk sets only how many score rows live at
    once: every chunk size gives autograd's gradients through the dense
    attention (within float32 rounding)."""
    q, k, v = _inputs((4, 100, 32), (2, 120, 32), (2, 120, 24), 31)
    w = np.random.default_rng(7).standard_normal((4, 100, 24)).astype(
        np.float32)
    _, got = _grads_port(q, k, v, w, causal=True, chunk=chunk)
    _, want = _grads_port(q, k, v, w, fn=FA.dense_attention, causal=True)
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ww.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("causal,window,q_offset,chunk", [
    (True, 16, 0, 50), (True, 1, 0, 512), (False, 24, 0, 33),
    (True, 40, 70, 16), (True, None, 70, 7)])
def test_backward_window_matches_autograd(causal, window, q_offset, chunk):
    """The recomputed backward under a window and q_offset: the gradients
    of autograd through the dense attention under the same mask."""
    q, k, v = _inputs((4, 100, 32), (2, 170, 32), (2, 170, 24), 61)
    w = np.random.default_rng(9).standard_normal((4, 100, 24)).astype(
        np.float32)
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    _, got = _grads_port(q, k, v, w, chunk=chunk, **kw)
    _, want = _grads_port(q, k, v, w, fn=FA.dense_attention, **kw)
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ww.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_dense_attention_is_the_references_xla_attention():
    from repro.kernels.flash_attn import _xla_attention

    q, k, v = _inputs((2, 64, 32), (2, 64, 32), (2, 64, 32), 41)
    for causal in (True, False):
        want = _xla_attention(*map(jnp.asarray, (q, k, v)), causal)
        got = FA.dense_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hq,hkv,sq", [(4, 4, 64), (4, 2, 96), (8, 1, 40)])
def test_blockwise_attn_gradients_match_reference(hq, hkv, sq):
    """The model's attention under autograd (through
    flash_attention_trainable) against jax.grad of the reference's
    blockwise_attn, float32."""
    _blockwise_gradients(hq, hkv, sq, None)


def test_blockwise_attn_window_gradients_match_reference():
    """As above, under a window of 20 (GQA 2, 96 tokens)."""
    _blockwise_gradients(4, 2, 96, 20)


def _blockwise_gradients(hq, hkv, sq, window):
    q, k, v = _inputs((2, sq, hq, 32), (2, sq, hkv, 32), (2, sq, hkv, 32),
                      hq + hkv + sq)
    w = np.random.default_rng(8).standard_normal((2, sq, hq, 32)).astype(
        np.float32)
    want = jax.grad(lambda *a: (JA.blockwise_attn(
        *a, causal=True, chunk=32, window=window) * w).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (A.blockwise_attn(*ts, causal=True, chunk=32, window=window)
     * torch.from_numpy(w)).sum().backward()
    for t, ww in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ww),
                                   rtol=1e-4, atol=1e-5)


def test_trainable_only_while_recording(monkeypatch):
    """blockwise_attn goes through the autograd Function only when a
    gradient is recorded; under no_grad or inference_mode it calls the
    kernel wrapper alone."""
    calls = []
    real = FA.flash_attention_trainable
    monkeypatch.setattr(FA, "flash_attention_trainable",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    A.blockwise_attn(q, q, q, causal=True)
    assert calls == [1]
    with torch.no_grad():
        A.blockwise_attn(q, q, q, causal=True)
    with torch.inference_mode():
        A.blockwise_attn(q.detach(), q.detach(), q.detach(), causal=True)
    A.blockwise_attn(q.detach(), q.detach(), q.detach(), causal=True)
    assert calls == [1]


# ---------------------------------------------------------------------------
# Multi-head latent attention's head: D up to 192 over Dv up to 128
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,dv", [(192, 128), (48, 32)])
@pytest.mark.parametrize("sq,skv", [(77, 77), (130, 201)])
def test_plain_matches_dense_at_mla_heads(sq, skv, d, dv, dtype):
    """The wrapper (its plain version on CPU tensors) at deepseek-v3's
    head (D 192 over Dv 128) and the reduced override's (D 48 over Dv 32),
    causal, ragged lengths, against ``dense_attention`` (the reference's
    ``_xla_attention``) on the same inputs: float32 within 1e-5; bfloat16
    within one bf16 ulp of the output's scale (each rounds a float32
    result once; the plain version scales q before the product, the dense
    one the scores after it)."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(
        (3, sq, d), (3, skv, d), (3, skv, dv), sq + skv + d))
    got = FA.flash_attention(q, k, v, causal=True)
    want = FA.dense_attention(q, k, v, causal=True)
    assert got.dtype == dtype and tuple(got.shape) == (3, sq, dv)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= KC.bf16_ulp(want.float().abs().max().item()), err


@pytest.mark.parametrize("d,dv,match", [
    (193, 128, "query/key head D up to 192, got D 193"),
    (192, 129, "value head Dv up to 128, got Dv 129")])
def test_wrapper_refuses_past_the_mla_head(d, dv, match):
    """D 192 and Dv 128 are the kernel's widest; one past either raises,
    and the message names the limit the call broke."""
    assert (FA.MAX_HEAD_DIM, FA.MAX_V_HEAD_DIM) == (192, 128)
    q = torch.zeros((2, 8, d))
    v = torch.zeros((2, 8, dv))
    with pytest.raises(ValueError, match=match):
        FA.flash_attention(q, q, v)
    assert FA.flash_attention(*(t[..., :192].contiguous() for t in (q, q)),
                              v[..., :128].contiguous()).shape == (2, 8, 128)


@pytest.mark.parametrize("causal", [True, False])
def test_trainable_gradients_at_the_mla_head(causal):
    """``flash_attention_trainable`` at D 192 over Dv 128 (ragged, Sq !=
    Skv): its output and dq, dk, dv against autograd through the plain
    version, float32, within 1e-5 / 1e-6 (as the chunk test)."""
    q, k, v = _inputs((4, 90, 192), (4, 130, 192), (4, 130, 128), 77)
    w = np.random.default_rng(8).standard_normal((4, 90, 128)).astype(
        np.float32)
    out, got = _grads_port(q, k, v, w, causal=causal, chunk=32)
    ref, want = _grads_port(q, k, v, w, fn=FA.flash_attention_plain,
                            causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for g, ww in zip(got, want):
        assert g.shape == ww.shape
        np.testing.assert_allclose(g.numpy(), ww.numpy(), rtol=1e-5,
                                   atol=1e-6)
