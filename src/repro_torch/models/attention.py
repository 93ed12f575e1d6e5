"""Attention: GQA / MQA, sliding window, qk-norm, QKV bias, RoPE / M-RoPE,
cross-attention, KV-cache decode (dense and int8).

Port of ``src/repro/models/attention.py``.  Training and prefill run
``blockwise_attn``, whose counterpart on the card is the hand-written
``flash_attention`` kernel (``kernels/flash_attn.py``, the TPU kernel
written to replace the reference's XLA blockwise loop; under autograd
inside ``flash_attention_trainable``); a CPU tensor runs its plain
version.  The kernel takes the reference's ``window`` and ``q_offset``.
Decode is the reference's dense one-token attention over the cache, in
torch ops (the reference's is XLA): a ring buffer of the last
``swa_window`` entries for sliding-window models, and int8 codes with
per-(position, head) scales under ``kv_quant``.  The decode functions
write the new key and value into the caller's cache tensors in place
(the reference returns updated copies).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import flash_attn as FA
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30
#: Attention options of the reference not ported yet: none.
UNPORTED: dict = {}
#: The int8 decode takes its dot products of int8 codes in float32 (cuBLAS
#: has no int32 GEMM): |code| <= 127, so a head's product is at most
#: 127 * 127 * D, which float32 holds exactly below 2**24, i.e. for D up to
#: this bound.  The result then equals the reference's int32 einsum.
INT8_MAX_HEAD_DIM = (1 << 24) // (127 * 127)


def check_config(cfg: ModelConfig):
    """Raise ``ValueError`` for a config the port's attention cannot run as
    the reference does: the int8 KV cache past ``INT8_MAX_HEAD_DIM``."""
    if cfg.kv_quant and cfg.head_dim > INT8_MAX_HEAD_DIM:
        raise ValueError(
            f"kv_quant takes head_dim up to {INT8_MAX_HEAD_DIM} (float32 "
            f"holds int8 dot products exactly below 2**24), got "
            f"{cfg.head_dim}")


def init_attn(gen, cfg: ModelConfig, bias: bool | None = None):
    d, dh = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    bias = cfg.qkv_bias if bias is None else bias
    p = {
        "wq": L.dense_init(gen, (d, nq, dh), cfg.pdt),
        "wk": L.dense_init(gen, (d, nkv, dh), cfg.pdt),
        "wv": L.dense_init(gen, (d, nkv, dh), cfg.pdt),
        "wo": L.dense_init(gen, (nq, dh, d), cfg.pdt),
    }
    if bias:
        p["bq"] = L.full(gen, (nq, dh), 0.0, cfg.pdt)
        p["bk"] = L.full(gen, (nkv, dh), 0.0, cfg.pdt)
        p["bv"] = L.full(gen, (nkv, dh), 0.0, cfg.pdt)
    if cfg.qk_norm:
        p["q_norm"] = L.full(gen, (dh,), 1.0, cfg.pdt)
        p["k_norm"] = L.full(gen, (dh,), 1.0, cfg.pdt)
    return p


def _project_qkv(x, p, cfg: ModelConfig, positions, kv_x=None):
    """Returns q (B,S,Hq,D), k,v (B,Skv,Hkv,D) with rope + qk-norm applied.

    ``kv_x`` (B, Skv, d): K and V come from it (cross-attention), else
    from ``x``.  ``positions``: (S,) or (B, S) for RoPE, (3, S) or (B, 3,
    S) for M-RoPE (``cfg.mrope``); None for no rotation."""
    kv_x = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhe->bshe", kv_x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhe->bshe", kv_x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if "q_norm" in p:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    if positions is not None:
        if cfg.mrope:
            q = L.apply_mrope(q, positions, cfg.mrope_sections,
                              cfg.rope_theta)
            k = L.apply_mrope(k, positions, cfg.mrope_sections,
                              cfg.rope_theta)
        else:
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def repeat_kv(k, hq: int):
    """Expand kv heads (B, S, Hkv, D) to the full query head count: each kv
    head repeated ``hq // Hkv`` times in place (``jnp.repeat``'s order).
    The port's attention never needs it (the kernel maps query head h to kv
    head h // G); kept as the reference keeps it."""
    hkv = k.shape[2]
    if hkv == hq:
        return k
    return torch.repeat_interleave(k, hq // hkv, dim=2)


def attn_kernel_inputs(q, k, v):
    """The ``flash_attention`` inputs ``blockwise_attn`` makes of q (B, Sq,
    Hq, D) and k, v (B, Skv, Hkv, D): q scaled by ``D ** -0.5`` in its own
    type (the reference's rounding, ``attention.py:102``), then each laid
    out as (B * H, S, D), contiguous.  The kv heads are not repeated: the
    kernel maps query head h to kv head h // (Hq / Hkv)."""
    b, sq, hq, d = q.shape
    q = q * torch.tensor(d ** -0.5, dtype=q.dtype, device=q.device)

    def rows(t):
        return t.transpose(1, 2).reshape(b * t.shape[2], t.shape[1],
                                         t.shape[3]).contiguous()

    return rows(q), rows(k), rows(v)


def blockwise_attn(q, k, v, *, causal: bool, chunk: int = 512,
                   window: int | None = None, q_offset: int = 0):
    """Flash-style attention through the ``flash_attention`` kernel.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``window``: sliding-window radius (keys older than ``window`` masked).
    ``q_offset``: absolute position of q[0] relative to k[0] (prefill=0).
    The scores, softmax and ``p @ v`` stay in float32 (the reference rounds
    ``exp(s - m)`` to the working type before ``e @ v``; in bfloat16 the two
    differ by that rounding).  When autograd records (grad mode on and an
    input that requires a gradient), the kernel runs inside
    ``flash_attention_trainable``, whose backward recomputes the softmax
    ``chunk`` query rows at a time (the reference's checkpointed query
    chunk) under the same mask; otherwise the kernel runs alone.  Returns
    (B, Sq, Hq, Dv).
    """
    b, sq, hq, _ = q.shape
    dv = v.shape[-1]
    q3, k3, v3 = attn_kernel_inputs(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FA.flash_attention_trainable(q3, k3, v3, causal, 1.0, chunk,
                                           window, q_offset)
    else:
        out = FA.flash_attention(q3, k3, v3, causal=causal, scale=1.0,
                                 window=window, q_offset=q_offset)
    return out.reshape(b, hq, sq, dv).transpose(1, 2)


def attn_block(x, p, cfg: ModelConfig, positions, *, causal=True,
               kv_x=None, window=None):
    q, k, v = _project_qkv(x, p, cfg, positions, kv_x=kv_x)
    out = blockwise_attn(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                         window=window if window is not None
                         else cfg.swa_window)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVLayout:
    """Static description of a layer's KV cache."""

    kv_len: int
    n_kv_heads: int
    head_dim: int


def _decode_positions(cfg: ModelConfig, b: int, pos: int, device):
    """The one position of a decode step: (B, 1), or (B, 3, 1) for
    M-RoPE (all three streams at ``pos``)."""
    shape = (b, 3, 1) if cfg.mrope else (b, 1)
    return torch.full(shape, pos, dtype=torch.int32, device=device)


def _slot_and_valid(pos: int, s_cache: int, window, device):
    """The cache slot a step writes and the slots it attends to.  With a
    window the cache is a ring buffer (slot ``pos % s_cache``): every slot
    holds one of the last ``s_cache`` positions once the buffer has
    wrapped, so all are valid from ``pos >= s_cache``; before that, and
    without a window, only slots <= pos have been written."""
    slot = pos % s_cache if window else min(pos, s_cache - 1)
    valid = torch.arange(s_cache, device=device) <= pos
    if window and pos >= s_cache:
        valid = torch.ones_like(valid)
    return slot, valid


def _quantize_heads(x):
    """Per-(batch, pos, head) symmetric int8: x (B,S,H,D) -> (q, scale).

    The scale is ``max|x| / 127`` (at least 1e-12), divided by a float32
    tensor (a Python-scalar divisor is a reciprocal multiply on the card),
    and the codes ``round(x / scale)`` half to even, clipped to +-127: the
    reference's codes and scales bit for bit."""
    xf = x.to(torch.float32)
    div = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    scale = (xf.abs().amax(-1) / div).clamp(min=1e-12)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def decode_attn_int8(x, p, cfg: ModelConfig, cache, pos: int, *,
                     window=None):
    """Single-token decode over an int8-quantized KV cache.

    The cache stores int8 codes + per-(pos, head) scales; the scores are
    the int8 x int8 dot products (exact in float32 up to
    ``INT8_MAX_HEAD_DIM``, which ``check_config`` holds the model to)
    times both scales.  cache: dict with k/v int8 (B,S,Hkv,D) and
    k_scale/v_scale float32 (B,S,Hkv), written in place.  Returns (out
    (B,1,d), cache).
    """
    b = x.shape[0]
    q, k, v = _project_qkv(x, p, cfg,
                           _decode_positions(cfg, b, pos, x.device))
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    d = cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[1]
    slot, valid = _slot_and_valid(pos, s_cache, window, x.device)
    kq, ks = _quantize_heads(k)
    vq, vs = _quantize_heads(v)
    ck[:, slot] = kq[:, 0]
    cv[:, slot] = vq[:, 0]
    cache["k_scale"][:, slot] = ks[:, 0]
    cache["v_scale"][:, slot] = vs[:, 0]

    qq, qs = _quantize_heads(q)                       # (B,1,Hq,D)
    qg = qq.reshape(b, 1, hkv, g, d)
    s_int = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                         ck.to(torch.float32))
    qs_g = qs.reshape(b, 1, hkv, g)
    s = s_int * torch.einsum("bqhg,bkh->bhgqk", qs_g,
                             cache["k_scale"]) * (d ** -0.5)
    s = torch.where(valid, s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", a,
                       cv.to(torch.float32) * cache["v_scale"][..., None])
    out = out.reshape(b, 1, hq, d).to(x.dtype)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype)), cache


def decode_attn(x, p, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                window=None):
    """Single-token decode.

    x: (B, 1, d); cache_k/v: (B, S, Hkv, D); pos: the current position.
    For sliding-window models (``window``) the cache is a ring buffer
    (slot ``pos % S``).  Writes the new key and value into ``cache_k`` /
    ``cache_v`` in place (the reference returns updated copies) and
    returns (out (B,1,d), cache_k, cache_v).
    """
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    q, k, v = _project_qkv(x, p, cfg,
                           _decode_positions(cfg, b, pos, x.device))

    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    d = cfg.head_dim
    slot, valid = _slot_and_valid(pos, s_cache, window, x.device)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    qg = q.reshape(b, 1, hkv, g, d)
    # the reference's einsum with preferred_element_type=float32
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     cache_k.float()) * d ** -0.5
    s = torch.where(valid, s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", a, cache_v).reshape(b, 1, hq, d)
    return (torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype)),
            cache_k, cache_v)


def cross_decode_attn(x, p, cfg: ModelConfig, xk, xv):
    """One decode step's cross-attention over cached encoder K and V.

    x: (B, 1, d) (normalised); xk, xv: (B, T_enc, Hkv, D).  As the
    reference's decode (``decode.py:90-101``): q from ``wq`` alone (no
    bias, q-norm or rope), float32 scores and softmax, no mask.  Returns
    (B, 1, d)."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    g = hq // hkv
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.reshape(b, 1, hkv, g, dh).to(torch.float32),
                     xk.to(torch.float32)) * dh ** -0.5
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", a,
                     xv.to(torch.float32)).reshape(b, 1, hq, dh)
    return torch.einsum("bshe,hed->bsd", o.to(x.dtype),
                        p["wo"].to(x.dtype))


def cross_kv(enc, p):
    """The cross-attention K and V of encoder features ``enc`` (B, T, d)
    for one decoder layer's ``xattn`` parameters: (B, T, Hkv, D) each, in
    enc's type (the reference's serve.py, inline there)."""
    k = torch.einsum("bsd,dhe->bshe", enc, p["wk"].to(enc.dtype))
    v = torch.einsum("bsd,dhe->bshe", enc, p["wv"].to(enc.dtype))
    return k, v
