"""Attention: GQA / MQA, qk-norm, QKV bias, RoPE, KV-cache decode.

Port of ``src/repro/models/attention.py``.  Training and prefill run
``blockwise_attn``, whose counterpart on the card is the hand-written
``flash_attention`` kernel (``kernels/flash_attn.py``, the TPU kernel
written to replace the reference's XLA blockwise loop; under autograd
inside ``flash_attention_trainable``); a CPU tensor runs its plain
version.
Decode is the reference's dense one-token attention over the cache, in
torch ops (the reference's is XLA).  Sliding windows (SWA), the int8 KV
cache (``kv_quant``), cross-attention (``kv_x``) and M-RoPE come later
(ROADMAP A10) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attn as FA
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30
#: The ROADMAP item that ports each attention option not ported yet.
UNPORTED = {"window": "A10 (sliding-window attention, h2o-danube)",
            "kv_quant": "A10 (the int8 KV cache, kv_quant)",
            "kv_x": "A10 (cross-attention, the encdec family)",
            "mrope": "A10 (M-RoPE, the vlm family)"}


def unported(option: str):
    return NotImplementedError(f"{option} is not ported yet: ROADMAP "
                               f"{UNPORTED[option]}")


def check_config(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for an attention option of ``cfg`` that
    is not ported yet."""
    if cfg.swa_window is not None:
        raise unported("window")
    if cfg.kv_quant:
        raise unported("kv_quant")
    if cfg.mrope:
        raise unported("mrope")


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
    """Returns q (B,S,Hq,D), k,v (B,Skv,Hkv,D) with rope + qk-norm applied."""
    if kv_x is not None:
        raise unported("kv_x")
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if "q_norm" in p:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    if positions is not None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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
                   window: int | None = None):
    """Flash-style attention through the ``flash_attention`` kernel.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.  The
    scores, softmax and ``p @ v`` stay in float32 (the reference rounds
    ``exp(s - m)`` to the working type before ``e @ v``; in bfloat16 the two
    differ by that rounding).  When autograd records (grad mode on and an
    input that requires a gradient), the kernel runs inside
    ``flash_attention_trainable``, whose backward recomputes the softmax
    ``chunk`` query rows at a time (the reference's checkpointed query
    chunk); otherwise the kernel runs alone.  Returns (B, Sq, Hq, Dv).
    """
    if window is not None:
        raise unported("window")
    b, sq, hq, _ = q.shape
    dv = v.shape[-1]
    q3, k3, v3 = attn_kernel_inputs(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FA.flash_attention_trainable(q3, k3, v3, causal, 1.0, chunk)
    else:
        out = FA.flash_attention(q3, k3, v3, causal=causal, scale=1.0)
    return out.reshape(b, hq, sq, dv).transpose(1, 2)


def attn_block(x, p, cfg: ModelConfig, positions, *, causal=True,
               kv_x=None):
    q, k, v = _project_qkv(x, p, cfg, positions, kv_x=kv_x)
    out = blockwise_attn(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                         window=cfg.swa_window)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------


def decode_attn(x, p, cfg: ModelConfig, cache_k, cache_v, pos: int):
    """Single-token decode.

    x: (B, 1, d); cache_k/v: (B, S, Hkv, D); pos: the current position.
    Writes the new key and value into ``cache_k`` / ``cache_v`` in place
    (the reference returns updated copies) and returns (out (B,1,d),
    cache_k, cache_v).
    """
    if cfg.swa_window:
        raise unported("window")
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions)

    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    d = cfg.head_dim
    slot = min(pos, s_cache - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    qg = q.reshape(b, 1, hkv, g, d)
    # the reference's einsum with preferred_element_type=float32
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     cache_k.float()) * d ** -0.5
    valid = torch.arange(s_cache, device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", a, cache_v).reshape(b, 1, hq, d)
    return (torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype)),
            cache_k, cache_v)
