"""Multi-head Latent Attention (DeepSeek-V3).

Port of ``src/repro/models/mla.py``.  Queries and keys/values are
projected through low-rank latents; only the compressed latent ``c_kv``
(``kv_lora_rank``) and the shared rotary key ``k_rope`` (``qk_rope_dim``)
are cached at decode time, so MLA is itself a learned KV-cache
compression, which the error-bounded cache compression
(``models/kvcache.py``) can compress once more.

Training and prefill (``mla_block``) expand the latent to full keys and
values and run ``attention.blockwise_attn``, so the ``flash_attention``
kernel on the card, at a query/key head of ``qk_nope_dim + qk_rope_dim``
(deepseek-v3: 192) over a value head of ``v_head_dim`` (128).  Decode
(``mla_decode``) attends the latent cache directly in torch ops, as the
reference's is jnp: ``W_uk`` absorbed into the query and ``W_uv`` into
the output, the absorbed products in float32 as the reference keeps
them.  It writes the step's ``[c_kv | k_rope]`` entry into the caller's
cache in place (the reference returns an updated copy).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_mla(gen, cfg: ModelConfig):
    d = cfg.d_model
    h = cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wdq": L.dense_init(gen, (d, qr), cfg.pdt),
        "q_norm": L.full(gen, (qr,), 1.0, cfg.pdt),
        "wuq": L.dense_init(gen, (qr, h, dn + dr), cfg.pdt),
        "wdkv": L.dense_init(gen, (d, kvr + dr), cfg.pdt),
        "kv_norm": L.full(gen, (kvr,), 1.0, cfg.pdt),
        "wuk": L.dense_init(gen, (kvr, h, dn), cfg.pdt),
        "wuv": L.dense_init(gen, (kvr, h, dv), cfg.pdt),
        "wo": L.dense_init(gen, (h, dv, d), cfg.pdt),
    }


def _latents(x, p, cfg: ModelConfig, positions):
    """Project to q (B,S,H,dn+dr), c_kv (B,S,kvr), k_rope (B,S,1,dr)."""
    dn, kvr = cfg.qk_nope_dim, cfg.kv_lora_rank
    cq = L.rms_norm(x @ p["wdq"].to(x.dtype), p["q_norm"])
    q = torch.einsum("bsr,rhe->bshe", cq, p["wuq"].to(x.dtype))
    q_rope = L.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    q = torch.cat([q[..., :dn], q_rope], dim=-1)

    ckv_full = x @ p["wdkv"].to(x.dtype)
    c_kv = L.rms_norm(ckv_full[..., :kvr], p["kv_norm"])
    k_rope = L.apply_rope(ckv_full[..., kvr:][..., None, :], positions,
                          cfg.rope_theta)
    return q, c_kv, k_rope


def _expand_kv(c_kv, k_rope, p, cfg: ModelConfig, dtype):
    """Latent -> full k (B,S,H,dn+dr) and v (B,S,H,dv)."""
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["wuk"].to(dtype))
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["wuv"].to(dtype))
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3],
                                         cfg.qk_rope_dim)], dim=-1)
    return k, v


def mla_block(x, p, cfg: ModelConfig, positions):
    """x (B, S, d) -> (B, S, d): causal attention of the expanded latent
    through ``blockwise_attn`` (the ``flash_attention`` kernel on the card,
    D ``qk_nope_dim + qk_rope_dim``, Dv ``v_head_dim``)."""
    q, c_kv, k_rope = _latents(x, p, cfg, positions)
    k, v = _expand_kv(c_kv, k_rope, p, cfg, x.dtype)
    out = A.blockwise_attn(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))


def mla_decode(x, p, cfg: ModelConfig, cache_latent, pos: int):
    """Decode step with the compressed latent cache (absorbed matmuls).

    cache_latent: (B, S, kvr + dr) storing ``[c_kv | k_rope]``, written at
    slot ``min(pos, S - 1)`` in place (the reference's
    ``dynamic_update_slice`` clamps alike).  The up-projection ``W_uk`` is
    absorbed into the query and ``W_uv`` into the output, so the latent
    cache is attended directly:
      score = (q_nope W_uk) . c_kv + q_rope . k_rope
      out   = (attn @ c_kv) W_uv W_o
    ``q_nope W_uk``, the scores, the softmax and ``attn @ c_kv`` are
    float32 from float32 operands (bfloat16 products are exact in float32:
    the reference's ``preferred_element_type=float32``); the context is
    then cast to x's type.  Returns (out (B, 1, d), cache_latent).
    """
    b = x.shape[0]
    dn, dr, kvr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, c_kv, k_rope = _latents(x, p, cfg, positions)
    s_cache = cache_latent.shape[1]
    entry = torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1)
    cache_latent[:, min(pos, s_cache - 1)] = entry[:, 0].to(
        cache_latent.dtype)

    c_all = cache_latent[..., :kvr].to(x.dtype).float()       # (B,S,r)
    kr_all = cache_latent[..., kvr:].to(x.dtype).float()      # (B,S,dr)
    q_c = torch.einsum("bqhn,rhn->bqhr", q[..., :dn].float(),
                       p["wuk"].float())
    scores = (torch.einsum("bqhr,bkr->bhqk", q_c, c_all)
              + torch.einsum("bqhe,bke->bhqk", q[..., dn:].float(), kr_all)
              ) * (dn + dr) ** -0.5
    valid = torch.arange(s_cache, device=x.device) <= pos
    scores = torch.where(valid, scores, A.NEG_INF)
    a = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkr->bqhr", a, c_all).to(x.dtype)
    v_ctx = torch.einsum("bqhr,rhe->bqhe", ctx, p["wuv"].to(x.dtype))
    return (torch.einsum("bshe,hed->bsd", v_ctx, p["wo"].to(x.dtype)),
            cache_latent)
